"""Model assembly: segment plan, prefill and decode.

The layer stack compiles to a list of *segments*, as in the reference
package: homogeneous runs of layers (``"scan"``) whose parameters and caches
are stacked on a leading layer axis, and ``"single"`` layers where the stack
is heterogeneous (xLSTM's sLSTM blocks), stored without that axis.  A
segment runs as a Python loop over its layers.

Every registered family builds, as in the reference: dense (GQA +
SwiGLU), MoE (GQA or MLA + MoE FFN, leading dense layers per
``first_k_dense``), SSM (xLSTM: groups of mLSTM blocks and one sLSTM block,
no FFN), hybrid (hymba: attention and SSD heads side by side in every
layer, averaged; sliding-window attention in scanned runs, full attention
in the ``"single"`` global layers), audio (seamless: an encoder stack over
stub frame embeddings, and a cross-attention block in every decoder layer)
and vlm (internvl2: the dense plan, with stub vision embeddings in place of
the first ``vision_tokens`` token embeddings).

Modes:
* ``train_loss``  : full-sequence forward + causal CE (+ MoE aux loss)
* ``prefill`` / ``prefill_batch`` : forward that also builds the caches
* ``decode_step`` : one token in, one logits row out, caches updated
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.trace import span
from ..distributed.sharding import cache_leaf_spec, constrain, settle
from . import attention as A
from . import layers as L
from . import moe as M
from . import ssm as S
from .weights import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str        # "scan" | "single"
    n: int
    mixer: str       # "attn" | "mla" | "hybrid" | "mlstm" | "slstm"
    ffn: str         # "swiglu" | "moe" | "none"
    window: int = 0
    cross: bool = False


def build_plan(cfg: ArchConfig) -> list:
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
    mixer = "mla" if cfg.mla is not None else "attn"
    cross = cfg.family == "audio"
    if cfg.moe is not None:
        plan = []
        if cfg.first_k_dense:
            plan.append(Segment("scan", cfg.first_k_dense, mixer, "swiglu",
                                cross=cross))
        plan.append(Segment("scan", cfg.n_layers - cfg.first_k_dense, mixer,
                            "moe", cross=cross))
        return plan
    return [Segment("scan", cfg.n_layers, mixer, "swiglu", cross=cross)]


def _encoder_segment(cfg: ArchConfig) -> Segment:
    return Segment("scan", cfg.encoder_layers, "attn", "swiglu")


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
    if seg.mixer == "mla":
        p["attn"] = A.mla_init(gen, cfg, lead=lead)
    if seg.mixer == "hybrid":
        p["ssd"] = S.ssd_init(gen, cfg, lead=lead)
    elif seg.mixer == "mlstm":
        p["mixer"] = S.mlstm_init(gen, cfg, lead=lead)
    elif seg.mixer == "slstm":
        p["mixer"] = S.slstm_init(gen, cfg, lead=lead)
    if seg.cross:
        p["normc"] = L.rmsnorm_init(cfg.d_model, cfg.dtype, dev, lead=lead)
        p["cross"] = A.gqa_init(gen, cfg, lead=lead)
    if seg.ffn != "none":
        p["norm2"] = L.rmsnorm_init(cfg.d_model, cfg.dtype, dev, lead=lead)
    if seg.ffn == "swiglu":
        p["ffn"] = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, cfg.dtype, lead=lead)
    elif seg.ffn == "moe":
        p["ffn"] = M.moe_init(gen, cfg, lead=lead)
    return p


def _apply_mixer_seq(cfg, seg, lp, xn, positions, *, want_cache, smax,
                     kv_quant, shardmap_attn=None, attn_constraint=None):
    """Full-sequence mixer; returns (y, cache_leaf or None).
    ``shardmap_attn`` (a ``distributed.shardmap_attention`` mixer) takes
    the GQA mixer's place, as in the reference; ``attn_constraint`` places
    the GQA mixer's flash layout (``attention._grouped_flash``)."""
    if seg.mixer == "attn" and shardmap_attn is not None:
        y = shardmap_attn(lp["attn"], xn, positions, seg.window)
        if want_cache:
            # cache K/V via the plain projections (cheap vs attention)
            k = A._split_heads(L.linear(lp["attn"]["wk"], xn),
                               cfg.n_kv_heads, cfg.hd)
            v = A._split_heads(L.linear(lp["attn"]["wv"], xn),
                               cfg.n_kv_heads, cfg.hd)
            k = L.apply_rope(k, positions, cfg.rope_theta)
            return y, A.gqa_prefill_cache(cfg, smax, k, v, seg.window,
                                          quant=kv_quant)
        return y, None
    if seg.mixer == "attn":
        if want_cache:
            y, kv = A.gqa_forward(cfg, lp["attn"], xn, positions,
                                  window=seg.window, return_cache=True,
                                  attn_constraint=attn_constraint)
            return y, A.gqa_prefill_cache(cfg, smax, kv["k"], kv["v"],
                                          seg.window, quant=kv_quant)
        return A.gqa_forward(cfg, lp["attn"], xn, positions,
                             window=seg.window,
                             attn_constraint=attn_constraint), None
    if seg.mixer == "mla":
        if want_cache:
            y, c = A.mla_forward(cfg, lp["attn"], xn, positions,
                                 return_cache=True)
            return y, A.mla_prefill_cache(cfg, smax, c)
        return A.mla_forward(cfg, lp["attn"], xn, positions), None
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
    """x -> (x', aux): aux is the MoE layer's load-balance loss, None for
    other layers."""
    if seg.ffn == "swiglu":
        return (x + L.swiglu(lp["ffn"], L.rmsnorm(lp["norm2"], x, cfg.norm_eps)),
                None)
    if seg.ffn == "moe":
        y, aux = M.moe_forward(cfg, lp["ffn"],
                               L.rmsnorm(lp["norm2"], x, cfg.norm_eps),
                               capacity_factor=capacity_factor)
        return x + y, aux
    return x, None


def _apply_layer_seq(cfg, seg, lp, x, positions, *, want_cache=False,
                     smax=0, kv_quant=False, capacity_factor=1.25,
                     enc_out=None, shardmap_attn=None, act_constraint=None,
                     attn_constraint=None):
    """x -> x', aux (the MoE loss, or None), cache_leaf (or None).  A cross
    segment given the encoder's output attends to it, unmasked and without
    RoPE, after its mixer; its cache leaf then holds the encoder K/V beside
    the mixer's own.  ``act_constraint`` places the layer's input (a
    sharding spec of (B, S, d); a no-op on plain tensors)."""
    x = constrain(x, act_constraint)
    xn = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    y, cache = _apply_mixer_seq(cfg, seg, lp, xn, positions,
                                want_cache=want_cache, smax=smax,
                                kv_quant=kv_quant,
                                shardmap_attn=shardmap_attn,
                                attn_constraint=attn_constraint)
    x = x + y
    if seg.cross and enc_out is not None:
        xc = L.rmsnorm(lp["normc"], x, cfg.norm_eps)
        ck = A._split_heads(L.linear(lp["cross"]["wk"], enc_out),
                            cfg.n_kv_heads, cfg.hd)
        cv = A._split_heads(L.linear(lp["cross"]["wv"], enc_out),
                            cfg.n_kv_heads, cfg.hd)
        x = x + A.gqa_forward(cfg, lp["cross"], xc, positions, causal=False,
                              kv_override=(ck, cv))
        if want_cache:
            cache = {"self": cache, "cross_k": ck, "cross_v": cv}
    x, aux = _apply_ffn(cfg, seg, lp, x, capacity_factor)
    return x, aux, cache


def _apply_layer_decode(cfg, seg, lp, x, cache, pos, *, out=None,
                        capacity_factor=2.0, kv_constraint=None):
    self_cache = cache["self"] if seg.cross else cache
    if seg.cross and out is not None:
        out = out["self"]
    xn = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
    if seg.mixer == "attn":
        y, new_cache = A.gqa_decode(cfg, lp["attn"], xn, self_cache, pos,
                                    window=seg.window, out=out,
                                    kv_constraint=kv_constraint)
    elif seg.mixer == "mla":
        y, new_cache = A.mla_decode(cfg, lp["attn"], xn, self_cache, pos,
                                    out=out)
    elif seg.mixer == "hybrid":
        ya, kv = A.gqa_decode(cfg, lp["attn"], xn, self_cache["kv"], pos,
                              window=seg.window,
                              out=None if out is None else out["kv"])
        ys, st = S.ssd_decode(cfg, lp["ssd"], xn, self_cache["ssd"],
                              out=None if out is None else out["ssd"])
        y, new_cache = 0.5 * (ya + ys), {"kv": kv, "ssd": st}
    elif seg.mixer == "mlstm":
        y, new_cache = S.mlstm_decode(cfg, lp["mixer"], xn, self_cache,
                                      out=out)
    elif seg.mixer == "slstm":
        y, new_cache = S.slstm_decode(cfg, lp["mixer"], xn, self_cache,
                                      out=out)
    else:
        raise ValueError(seg.mixer)
    x = x + settle(y, x)
    if seg.cross:
        # Cross-attend to the encoder K/V cached at prefill, at positions
        # of zeros (no RoPE reaches it), as the reference does.
        ck, cv = cache["cross_k"], cache["cross_v"]
        xc = L.rmsnorm(lp["normc"], x, cfg.norm_eps)
        zeros = torch.zeros((x.shape[0], 1), dtype=torch.int32,
                            device=x.device)
        x = x + A.gqa_forward(cfg, lp["cross"], xc, zeros, causal=False,
                              kv_override=(ck, cv))
        new_cache = {"self": new_cache, "cross_k": ck, "cross_v": cv}
    if seg.ffn == "swiglu":
        with span("layer.mlp"):
            x, _ = _apply_ffn(cfg, seg, lp, x, capacity_factor)
    else:
        x, _ = _apply_ffn(cfg, seg, lp, x, capacity_factor)
    return x, new_cache


def _layer(tree, i: int):
    return tree_map(lambda a: a[i], tree)


def _layers(seg: Segment, tree) -> list:
    """A segment's per-layer trees: slices of the stacked axis, or the one
    tree of a single layer."""
    if seg.kind == "scan":
        return [_layer(tree, i) for i in range(seg.n)]
    return [tree]


def _decode_out(seg: Segment, cache):
    """Tensors of a segment's cache shapes for a decode step's new cache,
    which every layer writes into.  No step writes the encoder K/V of a
    cross segment, so the new cache holds the same tensors there."""
    if seg.cross:
        return {"self": tree_map(torch.empty_like, cache["self"]),
                "cross_k": cache["cross_k"], "cross_v": cache["cross_v"]}
    return tree_map(torch.empty_like, cache)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class Model(nn.Module):
    """Decoder LM / enc-dec / VLM backbone built from an ArchConfig.

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
        # The reference's explicit tensor-parallel mixer
        # (``distributed.shardmap_attention.make_shardmap_gqa``): when set,
        # every "attn" layer's full-sequence mixer runs through it.
        self.shardmap_attn = None
        # The reference's sharding hooks, as specs (``distributed.sharding``
        # tuples) that a DTensor program is redistributed to, and no-ops on
        # plain tensors: each layer's input (B, S, d); the GQA flash layout
        # (B, S, heads, hd); the decode step's new K/V (B, 1, KH, hd)
        # before the cache write.  Layers run one by one here, so the
        # reference's ``unroll`` has no counterpart.
        self.act_constraint = None
        self.attn_layout_constraint = None
        self.kv_update_constraint = None

    def _cf(self, default: float) -> float:
        return self.capacity_factor if self.capacity_factor is not None else default

    # ------------------------------------------------------------- params
    def init_params(self, generator: torch.Generator | None = None,
                    seed: int = 0):
        """Random weights from ``generator`` (one on the model's device,
        seeded with ``seed``, when none is given).  A model on the ``meta``
        device makes the tree's shapes alone, without memory."""
        cfg = self.cfg
        gen = generator
        if gen is None and self.device.type == "meta":
            gen = L.MetaGenerator()
        elif gen is None:
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
        if cfg.encoder_layers:
            eseg = _encoder_segment(cfg)
            params["encoder"] = {
                "layers": _layer_init(gen, cfg, eseg, lead=_lead(eseg)),
                "final_norm": L.rmsnorm_init(cfg.d_model, cfg.dtype,
                                             gen.device),
            }
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

    def _embed_inputs(self, params, batch):
        """Token embeddings; a VLM's stub vision embeddings, when the batch
        has them, take the place of the first ``vision_tokens`` (a prompt
        shorter than that gives a sequence of the prefix's length, as in
        the reference)."""
        cfg = self.cfg
        x = L.embed(params["embed"], self._tokens(batch["tokens"]))
        if cfg.vision_tokens and "vision_embeds" in batch:
            vis = self._tokens(batch["vision_embeds"]).to(x.dtype)
            x = torch.cat([vis, x[:, cfg.vision_tokens:]], dim=1)
        return x

    def _remat(self, params) -> bool:
        """``cfg.remat`` while a gradient of ``params`` is recorded: each
        layer is then recomputed in the backward pass, as the reference's
        checkpointed layer body is, so its forward kernels run twice a
        step.  Serving, which records none, runs the layers plainly."""
        return (self.cfg.remat and torch.is_grad_enabled()
                and any(t.requires_grad for t in tree_leaves(params)))

    def _encode(self, params, frames):
        """Encoder stack over stub frame embeddings (B, encoder_len,
        d_model): unmasked GQA and SwiGLU layers at positions 0 ...
        encoder_len - 1, then the encoder's final norm."""
        cfg = self.cfg
        enc = params["encoder"]
        x = self._tokens(frames).to(L.dtype_of(cfg.dtype))
        positions = torch.arange(x.shape[1], device=x.device)[None, :]

        def body(x, lp):
            xn = L.rmsnorm(lp["norm1"], x, cfg.norm_eps)
            x = x + A.gqa_forward(cfg, lp["attn"], xn, positions, causal=False)
            return x + L.swiglu(lp["ffn"],
                                L.rmsnorm(lp["norm2"], x, cfg.norm_eps))
        remat = self._remat(enc)
        for lp in _layers(_encoder_segment(cfg), enc["layers"]):
            x = (checkpoint(body, x, lp, use_reentrant=False) if remat
                 else body(x, lp))
        return L.rmsnorm(enc["final_norm"], x, cfg.norm_eps)

    def _backbone_seq(self, params, x, positions, *, want_cache, smax,
                      enc_out=None):
        """x -> (x', aux), caches: aux is the MoE layers' summed
        load-balance loss (0 for the other families); without
        ``want_cache`` each segment's cache is None."""
        cfg = self.cfg
        remat = self._remat(params["segments"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        for seg, sp in zip(self.plan, params["segments"]):
            def body(x, aux, lp, seg=seg):
                x, a, c = _apply_layer_seq(
                    cfg, seg, lp, x, positions, want_cache=want_cache,
                    smax=smax, kv_quant=self.kv_quant,
                    capacity_factor=self._cf(1.25), enc_out=enc_out,
                    shardmap_attn=self.shardmap_attn,
                    act_constraint=self.act_constraint,
                    attn_constraint=self.attn_layout_constraint)
                return x, aux if a is None else aux + a, c
            layer_caches = []
            for lp in _layers(seg, sp):
                x, aux, c = (checkpoint(body, x, aux, lp, use_reentrant=False)
                             if remat else body(x, aux, lp))
                layer_caches.append(c)
            if not want_cache:
                caches.append(None)
            elif seg.kind == "scan":
                caches.append(tree_map(lambda *a: torch.stack(a), *layer_caches))
            else:
                caches.append(layer_caches[0])
        return (x, aux), caches

    # -------------------------------------------------------------- train
    def train_loss(self, params, batch):
        """batch: tokens (B, S), labels (B, S) [+ frames / vision_embeds].
        Returns ``(loss + 0.01 aux, {"loss", "aux"})``: the mean
        cross-entropy of ``labels[:, 1:]`` under the logits of positions
        ``:-1``, and the MoE layers' summed load-balance loss (0 for the
        other families)."""
        x = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        enc_out = None
        if self.cfg.encoder_layers:
            enc_out = self._encode(params, batch["frames"])
        (x, aux), _ = self._backbone_seq(params, x, positions,
                                         want_cache=False, smax=0,
                                         enc_out=enc_out)
        logits = self._logits(params, x)
        labels = self._tokens(batch["labels"]).long()
        loss = L.cross_entropy(logits[:, :-1], labels[:, 1:])
        return loss + 0.01 * aux, {"loss": loss, "aux": aux}

    # ------------------------------------------------------------ prefill
    def _forward_seq(self, params, batch, smax: int):
        """The batch's inputs through encoder and backbone: the final
        hidden states (B, S, d) and the caches."""
        x = self._embed_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        enc_out = None
        if self.cfg.encoder_layers:
            enc_out = self._encode(params, batch["frames"])
        (x, _), caches = self._backbone_seq(params, x, positions,
                                            want_cache=True, smax=smax,
                                            enc_out=enc_out)
        return x, caches

    def prefill(self, params, batch, smax: int):
        """tokens (B, S) [+ frames (B, encoder_len, d) for an enc-dec,
        vision_embeds (B, vision_tokens, d) for a VLM] -> logits (B, 1, V)
        at the last position, caches."""
        x, caches = self._forward_seq(params, batch, smax)
        return self._logits(params, x[:, -1:]), caches

    def prefill_batch(self, params, batch, smax: int):
        """Batched ragged prefill for the serving engine's batched
        admission: one padded forward over B right-padded prompts.

        ``batch``: ``tokens`` (B, S) right-padded, ``lengths`` (B,) true
        prompt lengths.  Row ``i``'s logits are taken at position
        ``lengths[i]-1`` (its last *real* token).  Cache positions beyond a
        row's length hold pad-token K/V, as in the reference: decode attends
        under a mask up to the row's own length.  Frames and vision
        embeddings are read as in ``prefill``.
        """
        x, caches = self._forward_seq(params, batch, smax)
        last = self._tokens(batch["lengths"]).long() - 1
        x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
        return self._logits(params, x_last), caches

    # ------------------------------------------------------------- decode
    def decode_step(self, params, caches, token, pos: int):
        """token: (B, 1); ``pos``: host int shared by the batch.  Returns
        logits (B, 1, V) and new caches; ``caches`` is not written.  Spans:
        ``model.decode_step`` holding ``model.embed``, ``model.views`` (a
        segment's new cache tensors and each layer's views of the stacked
        parameters and caches), ``model.layer`` (index) and
        ``model.logits``."""
        cfg = self.cfg
        with span("model.decode_step"):
            with span("model.embed"):
                x = L.embed(params["embed"], self._tokens(token))
            new_caches = []
            index = 0
            for seg, sp, sc in zip(self.plan, params["segments"], caches):
                with span("model.views"):
                    out = _decode_out(seg, sc)      # every layer writes here
                    views = list(zip(_layers(seg, sp), _layers(seg, sc),
                                     _layers(seg, out)))
                for lp, lc, lo in views:
                    with span("model.layer", "index", index):
                        x, _ = _apply_layer_decode(
                            cfg, seg, lp, x, lc, pos, out=lo,
                            capacity_factor=self._cf(2.0),
                            kv_constraint=self.kv_update_constraint)
                    index += 1
                new_caches.append(out)
            with span("model.logits"):
                logits = self._logits(params, x)
        return logits, new_caches

    # ---------------------------------------------------------- cache spec
    def init_cache(self, batch_size: int, smax: int, dtype=None, device=None):
        """Zero caches; ``device="meta"`` gives shapes without memory."""
        dev = torch.device(device) if device is not None else self.device
        dt = L.dtype_of(dtype or self.cfg.dtype)
        return [self._seg_cache_leaf(seg, batch_size, smax, dt, dev, _lead(seg))
                for seg in self.plan]

    def cache_pspecs(self, mesh, batch_size: int, smax: int):
        """The sharding spec tree of ``init_cache(batch_size, smax)``, the
        reference's entry for entry: batch over the data axes (the
        sequence for batch-1 long context), a heads-like dim over model;
        the stacked layer dim of a scanned segment never sharded
        (``distributed.sharding.cache_leaf_spec``)."""
        shapes = self.init_cache(batch_size, smax, device="meta")
        return [tree_map(lambda leaf, sc=seg.kind == "scan":
                         cache_leaf_spec(tuple(leaf.shape), mesh, sc), sp)
                for seg, sp in zip(self.plan, shapes)]

    def _seg_cache_leaf(self, seg: Segment, b: int, smax: int, dt, dev,
                        lead: tuple = ()):
        cfg = self.cfg
        kh, hd = cfg.n_kv_heads, cfg.hd

        def z(shape, dtype):
            return torch.zeros((*lead, *shape), dtype=dtype, device=dev)

        leaf = self._mixer_cache_leaf(seg, b, smax, dt, z)
        if seg.cross:
            leaf = {"self": leaf,
                    "cross_k": z((b, cfg.encoder_len, kh, hd), dt),
                    "cross_v": z((b, cfg.encoder_len, kh, hd), dt)}
        return leaf

    def _mixer_cache_leaf(self, seg: Segment, b: int, smax: int, dt, z):
        cfg = self.cfg
        kh, hd = cfg.n_kv_heads, cfg.hd
        s = seg.window if seg.window else smax
        if seg.mixer == "mla":
            m = cfg.mla
            return {"c": z((b, smax, m.kv_lora_rank), dt),
                    "kr": z((b, smax, m.qk_rope_head_dim), dt)}
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


def make_model(name_or_cfg, *, device="cuda", **kw) -> Model:
    """The reference's ``make_model``: a ``Model`` of a registered arch name
    or of an ``ArchConfig``, on ``device``; ``kw`` are ``Model``'s own
    (``kv_quant``, ``capacity_factor``).  The reference's ``backend`` has no
    counterpart: the port picks each kernel or its plain version by the
    device of the tensors it is given."""
    from ..configs.base import get_arch
    cfg = (name_or_cfg if isinstance(name_or_cfg, ArchConfig)
           else get_arch(name_or_cfg))
    return Model(cfg, device=device, **kw)
