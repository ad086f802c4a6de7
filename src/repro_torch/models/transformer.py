"""Model assembly: segment plan, prefill and decode.

The layer stack compiles to a list of *segments*, as in the reference
package: homogeneous runs of layers (``"scan"``) whose parameters and caches
are stacked on a leading layer axis, and ``"single"`` layers where the stack
is heterogeneous (xLSTM's sLSTM blocks), stored without that axis.  A
segment runs as a Python loop over its layers.

Families ported: dense (GQA + SwiGLU), MoE without MLA (GQA + MoE FFN,
leading dense layers per ``first_k_dense``), SSM (xLSTM: groups of mLSTM
blocks and one sLSTM block, no FFN) and hybrid (hymba: attention and SSD
heads side by side in every layer, averaged; sliding-window attention in
scanned runs, full attention in the ``"single"`` global layers).  The
others raise ``NotImplementedError`` naming their ROADMAP.md item.

Modes:
* ``prefill`` / ``prefill_batch`` : forward that also builds the caches
* ``decode_step`` : one token in, one logits row out, caches updated
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..configs.base import ArchConfig
from . import attention as A
from . import layers as L
from . import moe as M
from . import ssm as S
from .weights import tree_map


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str        # "scan" | "single"
    n: int
    mixer: str       # "attn" | "hybrid" | "mlstm" | "slstm"
    ffn: str         # "swiglu" | "moe" | "none"
    window: int = 0
    cross: bool = False


_WAITING = {
    "audio": "enc-dec/VLM",
    "vlm": "enc-dec/VLM",
}


def build_plan(cfg: ArchConfig) -> list:
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA is not ported yet (ROADMAP.md, queue 1: MLA)")
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP.md, queue 1: {_WAITING[cfg.family]})")
    if cfg.family == "ssm":                     # xlstm: 5 mLSTM + 1 sLSTM per group
        k = cfg.ssm.slstm_every
        plan = []
        if k and cfg.n_layers >= k:
            groups = cfg.n_layers // k
            for _ in range(groups):
                plan.append(Segment("scan", k - 1, "mlstm", "none"))
                plan.append(Segment("single", 1, "slstm", "none"))
            rem = cfg.n_layers - groups * k
        else:
            rem = cfg.n_layers
        if rem:
            plan.append(Segment("scan", rem, "mlstm", "none"))
        return plan
    if cfg.family == "hybrid":                  # hymba
        plan = []
        prev = 0
        for g in sorted(cfg.global_attn_layers):
            if g > prev:
                plan.append(Segment("scan", g - prev, "hybrid", "swiglu",
                                    window=cfg.sliding_window))
            plan.append(Segment("single", 1, "hybrid", "swiglu", window=0))
            prev = g + 1
        if prev < cfg.n_layers:
            plan.append(Segment("scan", cfg.n_layers - prev, "hybrid", "swiglu",
                                window=cfg.sliding_window))
        return plan
    if cfg.moe is not None:
        plan = []
        if cfg.first_k_dense:
            plan.append(Segment("scan", cfg.first_k_dense, "attn", "swiglu"))
        plan.append(Segment("scan", cfg.n_layers - cfg.first_k_dense, "attn",
                            "moe"))
        return plan
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: unknown family {cfg.family}")
    return [Segment("scan", cfg.n_layers, "attn", "swiglu")]


def _lead(seg: Segment) -> tuple:
    """The stacked layer axis of a scanned segment; none for a single."""
    return (seg.n,) if seg.kind == "scan" else ()


# ---------------------------------------------------------------------------
# layer init / apply
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg: ArchConfig, seg: Segment, lead: tuple = ()):
    dev = gen.device
    p = {"norm1": L.rmsnorm_init(cfg.d_model, cfg.dtype, dev, lead=lead)}
    if seg.mixer in ("attn", "hybrid"):
        p["attn"] = A.gqa_init(gen, cfg, lead=lead)
    if seg.mixer == "hybrid":
        p["ssd"] = S.ssd_init(gen, cfg, lead=lead)
    elif seg.mixer == "mlstm":
        p["mixer"] = S.mlstm_init(gen, cfg, lead=lead)
    elif seg.mixer == "slstm":
        p["mixer"] = S.slstm_init(gen, cfg, lead=lead)
    if seg.ffn != "none":
        p["norm2"] = L.rmsnorm_init(cfg.d_model, cfg.dtype, dev, lead=lead)
    if seg.ffn == "swiglu":
        p["ffn"] = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype, lead=lead)
    elif seg.ffn == "moe":
        p["ffn"] = M.moe_init(gen, cfg, lead=lead)
    return p


def _apply_mixer_seq(cfg, seg, lp, xn, positions, *, want_cache, smax,
                     kv_quant):
    """Full-sequence mixer; returns (y, cache_leaf or None)."""
    if seg.mixer == "attn":
        if want_cache:
            y, kv = A.gqa_forward(cfg, lp["attn"], xn, positions,
                                  window=seg.window, return_cache=True)
            return y, A.gqa_prefill_cache(cfg, smax, kv["k"], kv["v"],
                                          seg.window, quant=kv_quant)
        return A.gqa_forward(cfg, lp["attn"], xn, positions,
                             window=seg.window), None
    if seg.mixer == "hybrid":
        if want_cache:
            ya, kv = A.gqa_forward(cfg, lp["attn"], xn, positions,
                                   window=seg.window, return_cache=True)
            ys, st = S.ssd_forward(cfg, lp["ssd"], xn, return_state=True)
            cache = {"kv": A.gqa_prefill_cache(cfg, smax, kv["k"], kv["v"],
                                               seg.window, quant=kv_quant),
                     "ssd": st}
            return 0.5 * (ya + ys), cache
        ya = A.gqa_forward(cfg, lp["attn"], xn, positions, window=seg.window)
        return 0.5 * (ya + S.ssd_forward(cfg, lp["ssd"], xn)), None
    if seg.mixer == "mlstm":
        if want_cache:
            return S.mlstm_forward(cfg, lp["mixer"], xn, return_state=True)
        return S.mlstm_forward(cfg, lp["mixer"], xn), None
    if seg.mixer == "slstm":
        if want_cache:
            return S.slstm_forward(cfg, lp["mixer"], xn, return_state=True)
        return S.slstm_forward(cfg, lp["mixer"], xn), None
    raise ValueError(seg.mixer)


def _apply_ffn(cfg, seg, lp, x, capacity_factor):
    if seg.ffn == "swiglu":
        return x + L.swiglu(lp["ffn"], L.rmsnorm(lp["norm2"], x, cfg.norm_eps))
    if seg.ffn == "moe":
        y, _ = M.moe_forward(cfg, lp["ffn"],
                             L.rmsnorm(lp["norm2"], x, cfg.norm_eps),
                             capacity_factor=capacity_factor)
        return x + y
    return x


def _apply_layer_seq(cfg, seg, lp, x, positions, *, want_cache=False,
                     smax=0, kv_quant=False, capacity_factor=1.25):
    """x -> x', cache_leaf (or None)."""
    xn = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    y, cache = _apply_mixer_seq(cfg, seg, lp, xn, positions,
                                want_cache=want_cache, smax=smax,
                                kv_quant=kv_quant)
    x = _apply_ffn(cfg, seg, lp, x + y, capacity_factor)
    return x, cache


def _apply_layer_decode(cfg, seg, lp, x, cache, pos, *, out=None,
                        capacity_factor=2.0):
    xn = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    if seg.mixer == "attn":
        y, new_cache = A.gqa_decode(cfg, lp["attn"], xn, cache, pos,
                                    window=seg.window, out=out)
    elif seg.mixer == "hybrid":
        ya, kv = A.gqa_decode(cfg, lp["attn"], xn, cache["kv"], pos,
                              window=seg.window,
                              out=None if out is None else out["kv"])
        ys, st = S.ssd_decode(cfg, lp["ssd"], xn, cache["ssd"],
                              out=None if out is None else out["ssd"])
        y, new_cache = 0.5 * (ya + ys), {"kv": kv, "ssd": st}
    elif seg.mixer == "mlstm":
        y, new_cache = S.mlstm_decode(cfg, lp["mixer"], xn, cache, out=out)
    elif seg.mixer == "slstm":
        y, new_cache = S.slstm_decode(cfg, lp["mixer"], xn, cache, out=out)
    else:
        raise ValueError(seg.mixer)
    x = _apply_ffn(cfg, seg, lp, x + y, capacity_factor)
    return x, new_cache


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _layers(seg: Segment, tree) -> list:
    """A segment's per-layer trees: slices of the stacked axis, or the one
    tree of a single layer."""
    if seg.kind == "scan":
        return [_layer(tree, i) for i in range(seg.n)]
    return [tree]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """Decoder LM built from an ArchConfig.

    The parameter tree is the reference's nested-dict layout; the model owns
    the tree it made or was given (``adopt``), and its methods take the tree
    explicitly, as the reference's do, so the serving engine and the tests
    drive both packages alike.
    """

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 kv_quant: bool = False, capacity_factor: float | None = None):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.kv_quant = kv_quant
        # MoE capacity factor; None takes the reference's defaults, 1.25 for
        # sequences and 2.0 for decode steps.
        self.capacity_factor = capacity_factor
        self.plan = build_plan(cfg)
        self.params = None

    def _cf(self, default: float) -> float:
        return self.capacity_factor if self.capacity_factor is not None else default

    # ------------------------------------------------------------- params
    def init_params(self, generator: torch.Generator | None = None,
                    seed: int = 0):
        """Random weights from ``generator`` (one on the model's device,
        seeded with ``seed``, when none is given)."""
        cfg = self.cfg
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        segs = [_layer_init(gen, cfg, seg, lead=_lead(seg)) for seg in self.plan]
        params = {
            "embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model, cfg.dtype),
            "final_norm": L.rmsnorm_init(cfg.d_model, cfg.dtype, gen.device),
            "segments": segs,
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.linear_init(gen, cfg.d_model, cfg.vocab_size,
                                              cfg.dtype)
        return self.adopt(params)

    def adopt(self, params):
        """Register ``params``' leaves as this module's buffers (so
        ``state_dict`` sees them) and keep the tree as ``self.params``."""
        def walk(node, prefix):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{prefix}{k}__")
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(v, f"{prefix}{i}__")
            else:
                self.register_buffer(prefix[:-2], node)
        walk(params, "")
        self.params = params
        return params

    # ------------------------------------------------------------ helpers
    def _logits(self, params, x):
        x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return L.unembed(params["embed"], x)
        return L.linear(params["lm_head"], x).float()

    def _tokens(self, t):
        return torch.as_tensor(t, device=self.device)

    def _backbone_seq(self, params, x, positions, *, want_cache, smax):
        cfg = self.cfg
        caches = []
        for seg, sp in zip(self.plan, params["segments"]):
            layer_caches = []
            for lp in _layers(seg, sp):
                x, c = _apply_layer_seq(cfg, seg, lp, x, positions,
                                        want_cache=want_cache, smax=smax,
                                        kv_quant=self.kv_quant,
                                        capacity_factor=self._cf(1.25))
                layer_caches.append(c)
            if not want_cache:
                caches.append(None)
            elif seg.kind == "scan":
                caches.append(tree_map(lambda *a: torch.stack(a), *layer_caches))
            else:
                caches.append(layer_caches[0])
        return x, caches

    # ------------------------------------------------------------ prefill
    def prefill(self, params, batch, smax: int):
        """tokens (B, S) -> logits (B, 1, V) at the last position, caches."""
        tokens = self._tokens(batch["tokens"])
        x = L.embed(params["embed"], tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, caches = self._backbone_seq(params, x, positions, want_cache=True,
                                       smax=smax)
        return self._logits(params, x[:, -1:]), caches

    def prefill_batch(self, params, batch, smax: int):
        """Batched ragged prefill for the serving engine's batched
        admission: one padded forward over B right-padded prompts.

        ``batch``: ``tokens`` (B, S) right-padded, ``lengths`` (B,) true
        prompt lengths.  Row ``i``'s logits are taken at position
        ``lengths[i]-1`` (its last *real* token).  Cache positions beyond a
        row's length hold pad-token K/V, as in the reference: decode attends
        under a mask up to the row's own length.
        """
        tokens = self._tokens(batch["tokens"])
        x = L.embed(params["embed"], tokens)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, caches = self._backbone_seq(params, x, positions, want_cache=True,
                                       smax=smax)
        last = self._tokens(batch["lengths"]).long() - 1
        x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        return self._logits(params, x_last), caches

    # ------------------------------------------------------------- decode
    def decode_step(self, params, caches, token, pos: int):
        """token: (B, 1); ``pos``: host int shared by the batch.  Returns
        logits (B, 1, V) and new caches; ``caches`` is not written."""
        cfg = self.cfg
        x = L.embed(params["embed"], self._tokens(token))
        new_caches = []
        for seg, sp, sc in zip(self.plan, params["segments"], caches):
            out = tree_map(torch.empty_like, sc)    # every layer writes here
            for lp, lc, lo in zip(_layers(seg, sp), _layers(seg, sc),
                                  _layers(seg, out)):
                x, _ = _apply_layer_decode(cfg, seg, lp, x, lc, pos, out=lo,
                                           capacity_factor=self._cf(2.0))
            new_caches.append(out)
        return self._logits(params, x), new_caches

    # ---------------------------------------------------------- cache spec
    def init_cache(self, batch_size: int, smax: int, dtype=None, device=None):
        """Zero caches; ``device="meta"`` gives shapes without memory."""
        dev = torch.device(device) if device is not None else self.device
        dt = L.dtype_of(dtype or self.cfg.dtype)
        return [self._seg_cache_leaf(seg, batch_size, smax, dt, dev, _lead(seg))
                for seg in self.plan]

    def _seg_cache_leaf(self, seg: Segment, b: int, smax: int, dt, dev,
                        lead: tuple = ()):
        cfg = self.cfg
        kh, hd = cfg.n_kv_heads, cfg.hd
        s = seg.window if seg.window else smax

        def z(shape, dtype):
            return torch.zeros((*lead, *shape), dtype=dtype, device=dev)

        if seg.mixer == "mlstm":
            h = cfg.n_heads
            hdm = cfg.ssm.expand * cfg.d_model // h
            return {"c": z((b, h, hdm, hdm), torch.float32),
                    "n": z((b, h, hdm), torch.float32)}
        if seg.mixer == "slstm":
            return {"c": z((b, cfg.d_model), torch.float32),
                    "n": z((b, cfg.d_model), torch.float32)}
        if seg.mixer == "hybrid":   # no int8 variant here, as in the reference
            h, n = cfg.n_heads, cfg.ssm.state_dim
            return {"kv": {"k": z((b, s, kh, hd), dt), "v": z((b, s, kh, hd), dt)},
                    "ssd": {"c": z((b, h, n, hd), torch.float32),
                            "n": z((b, h, n), torch.float32)}}
        if self.kv_quant:
            return {"k": z((b, s, kh, hd), torch.int8),
                    "v": z((b, s, kh, hd), torch.int8),
                    "k_scale": z((b, s, kh), torch.float32),
                    "v_scale": z((b, s, kh), torch.float32)}
        return {"k": z((b, s, kh, hd), dt), "v": z((b, s, kh, hd), dt)}
