"""Model assembly for the dense decoder family: prefill and decode.

The layer stack compiles to a list of *segments*, homogeneous runs of layers
whose parameters and caches are stacked on a leading layer axis, as in the
reference package.  A segment runs as a Python loop over that axis.  The
dense plan is one segment of ``n_layers`` layers.

Modes:
* ``prefill`` / ``prefill_batch`` : forward that also builds the caches
* ``decode_step`` : one token in, one logits row out, caches updated

Only the dense plan is ported; the other families raise
``NotImplementedError`` naming their ROADMAP.md item.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..configs.base import ArchConfig
from . import attention as A
from . import layers as L
from .weights import tree_map


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str        # "scan" | "single"
    n: int
    mixer: str       # "attn"
    ffn: str         # "swiglu"
    window: int = 0
    cross: bool = False


_WAITING = {
    "ssm": "SSM/hybrid (mlstm_scan kernel)",
    "hybrid": "SSM/hybrid (mlstm_scan kernel)",
    "moe": "MoE (moe_topk kernel)",
    "audio": "enc-dec/VLM",
    "vlm": "enc-dec/VLM",
}


def build_plan(cfg: ArchConfig) -> list:
    family = "moe" if cfg.moe is not None else cfg.family
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MLA is not ported yet (ROADMAP.md, queue 1: MLA)")
    if family in _WAITING:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP.md, queue 1: {_WAITING[family]})")
    if family != "dense":
        raise NotImplementedError(f"{cfg.name}: unknown family {cfg.family}")
    return [Segment("scan", cfg.n_layers, "attn", "swiglu")]


# ---------------------------------------------------------------------------
# layer init / apply
# ---------------------------------------------------------------------------

def _layer_init(gen, cfg: ArchConfig, seg: Segment, lead: tuple = ()):
    dev = gen.device
    return {
        "norm1": L.rmsnorm_init(cfg.d_model, cfg.dtype, dev, lead=lead),
        "attn": A.gqa_init(gen, cfg, lead=lead),
        "norm2": L.rmsnorm_init(cfg.d_model, cfg.dtype, dev, lead=lead),
        "ffn": L.swiglu_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype, lead=lead),
    }


def _apply_layer_seq(cfg, seg, lp, x, positions, *, want_cache=False,
                     smax=0, kv_quant=False):
    """x -> x', cache_leaf (or None)."""
    xn = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    cache = None
    if want_cache:
        y, kv = A.gqa_forward(cfg, lp["attn"], xn, positions,
                              window=seg.window, return_cache=True)
        cache = A.gqa_prefill_cache(cfg, smax, kv["k"], kv["v"], seg.window,
                                    quant=kv_quant)
    else:
        y = A.gqa_forward(cfg, lp["attn"], xn, positions, window=seg.window)
    x = x + y
    x = x + L.swiglu(lp["ffn"], L.rmsnorm(lp["norm2"], x, cfg.norm_eps))
    return x, cache


def _apply_layer_decode(cfg, seg, lp, x, cache, pos, *, out=None):
    xn = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    y, new_cache = A.gqa_decode(cfg, lp["attn"], xn, cache, pos,
                                window=seg.window, out=out)
    x = x + y
    x = x + L.swiglu(lp["ffn"], L.rmsnorm(lp["norm2"], x, cfg.norm_eps))
    return x, new_cache


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """Dense decoder LM built from an ArchConfig.

    The parameter tree is the reference's nested-dict layout; the model owns
    the tree it made or was given (``adopt``), and its methods take the tree
    explicitly, as the reference's do, so the serving engine and the tests
    drive both packages alike.
    """

    def __init__(self, cfg: ArchConfig, *, device="cuda",
                 kv_quant: bool = False):
        super().__init__()
        self.cfg = cfg
        self.device = torch.device(device)
        self.kv_quant = kv_quant
        self.plan = build_plan(cfg)
        self.params = None

    # ------------------------------------------------------------- params
    def init_params(self, generator: torch.Generator | None = None,
                    seed: int = 0):
        """Random weights from ``generator`` (one on the model's device,
        seeded with ``seed``, when none is given)."""
        cfg = self.cfg
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        segs = [_layer_init(gen, cfg, seg, lead=(seg.n,)) for seg in self.plan]
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
            for i in range(seg.n):
                x, c = _apply_layer_seq(cfg, seg, _layer(sp, i), x, positions,
                                        want_cache=want_cache, smax=smax,
                                        kv_quant=self.kv_quant)
                layer_caches.append(c)
            caches.append(tree_map(lambda *a: torch.stack(a), *layer_caches)
                          if want_cache else None)
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
            out = tree_map(torch.empty_like, sc)    # one copy per step
            for i in range(seg.n):
                x, _ = _apply_layer_decode(cfg, seg, _layer(sp, i), x,
                                           _layer(sc, i), pos, out=_layer(out, i))
            new_caches.append(out)
        return self._logits(params, x), new_caches

    # ---------------------------------------------------------- cache spec
    def init_cache(self, batch_size: int, smax: int, dtype=None, device=None):
        """Zero caches; ``device="meta"`` gives shapes without memory."""
        dev = torch.device(device) if device is not None else self.device
        dt = L.dtype_of(dtype or self.cfg.dtype)
        return [self._seg_cache_leaf(seg, batch_size, smax, dt, dev, (seg.n,))
                for seg in self.plan]

    def _seg_cache_leaf(self, seg: Segment, b: int, smax: int, dt, dev,
                        lead: tuple = ()):
        cfg = self.cfg
        kh, hd = cfg.n_kv_heads, cfg.hd
        s = seg.window if seg.window else smax

        def z(shape, dtype):
            return torch.zeros((*lead, *shape), dtype=dtype, device=dev)

        if self.kv_quant:
            return {"k": z((b, s, kh, hd), torch.int8),
                    "v": z((b, s, kh, hd), torch.int8),
                    "k_scale": z((b, s, kh), torch.float32),
                    "v_scale": z((b, s, kh), torch.float32)}
        return {"k": z((b, s, kh, hd), dt), "v": z((b, s, kh, hd), dt)}
