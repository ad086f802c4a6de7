"""Attention mixers: GQA (with RoPE / QKV bias / sliding window) and MLA
(DeepSeek multi-head latent attention with the absorbed-latent decode path).

Cache conventions (per layer; stacked along a leading layer axis by the
transformer):

* GQA full attention : {"k": (B, S_max, KH, hd), "v": ...}
* GQA sliding window : ring buffer {"k": (B, W, KH, hd), "v": ...}
* int8 ``kv_quant``  : adds {"k_scale": (B, S, KH), "v_scale": ...} float32
* MLA                : {"c": (B, S_max, kv_lora), "kr": (B, S_max, rope_dim)}

Decode positions are one host integer ``pos`` shared by the whole batch (the
serving engine aligns batches; rows with shorter prompts read the longest
row's positions, as in the reference).

Prefill attention runs the flash kernel on the grouped layout as it is, and
decode attention the decode kernel on the ``(B, S, KH, hd)`` cache: the
kernels read KV head ``h // G`` themselves, so no K/V is repeated.  The
decode cache update is out of place: a step returns new cache tensors and
never writes the ones it was given, because the serving engine keeps
superseded snapshots alive and discards stale decode results.

MLA's prefill runs the flash kernel at query-key dim 192 (128 without and
64 with RoPE) and value dim 128, on K rebuilt per head from the latent, as
the reference does; its decode attends over the latent cache itself through
float32 products with the up-projections absorbed, plain ops in both
packages (the reference has no Pallas kernel there).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.trace import span
from ..distributed.sharding import (constrain, head_layout, shardwise,
                                    whole)
from ..kernels import ops
from . import layers as L


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_init(gen, cfg, lead: tuple = ()):
    hd = cfg.hd
    return {
        "wq": L.linear_init(gen, cfg.d_model, cfg.n_heads * hd, cfg.dtype,
                            bias=cfg.qkv_bias, lead=lead),
        "wk": L.linear_init(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.dtype,
                            bias=cfg.qkv_bias, lead=lead),
        "wv": L.linear_init(gen, cfg.d_model, cfg.n_kv_heads * hd, cfg.dtype,
                            bias=cfg.qkv_bias, lead=lead),
        "wo": L.linear_init(gen, cfg.n_heads * hd, cfg.d_model, cfg.dtype,
                            lead=lead),
    }


def _split_heads(x, n_heads, hd):
    """(B, S, heads hd) -> (B, S, heads, hd); a DTensor whose last dim is
    split into shards that cut heads is made whole on it first."""
    b, s, _ = x.shape
    return whole(x, -1, n_heads).reshape(b, s, n_heads, hd)


def gqa_forward(cfg, p, x, positions, *, window: int = 0, causal: bool = True,
                return_cache: bool = False, kv_override=None,
                attn_constraint=None):
    """Full-sequence attention (prefill / encoder).

    ``kv_override``: (k, v) head tensors for cross-attention (RoPE-free).
    ``attn_constraint``: see ``_grouped_flash``.
    """
    b, s, _ = x.shape
    hd = cfg.hd
    q = _split_heads(L.linear(p["wq"], x), cfg.n_heads, hd)
    if kv_override is None:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = _split_heads(L.linear(p["wk"], x), cfg.n_kv_heads, hd)
        v = _split_heads(L.linear(p["wv"], x), cfg.n_kv_heads, hd)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        q, k, v = head_layout(q), head_layout(k), head_layout(v)
    else:
        k, v = kv_override
    out = _grouped_flash(q, k, v, causal=causal, window=window,
                         attn_constraint=attn_constraint)
    y = L.linear(p["wo"], out.reshape(b, s, cfg.n_heads * hd))
    if return_cache:
        return y, {"k": k, "v": v}
    return y


def _grouped_flash(q, k, v, *, causal, window, attn_constraint=None):
    """q: (B,S,H,hd); k,v: (B,Sk,KH,hd) with H = KH * G, passed to the
    kernel as they are.

    ``attn_constraint``: a sharding spec of this (B, S, heads, hd) layout
    that q, k, v and the output are placed by on a DTensor program (batch
    over data and heads over model keeps the whole kernel shard-local: the
    reference's head-sharded flash layout, on its flattened (B*H, S, hd)
    form); a no-op on plain tensors."""
    q, k, v = (constrain(t, attn_constraint) for t in (q, k, v))
    out = ops.grouped_flash(q, k, v, causal=causal, window=window)
    return constrain(out, attn_constraint)


def gqa_prefill_cache(cfg, smax: int, k, v, window: int, quant: bool = False):
    """Place prefill K/V into the (padded or ring) cache layout.

    Ring convention: position p lives at slot ``p % window`` (matches
    ``gqa_decode``); softmax attention is permutation-invariant so ring
    order never needs unwinding."""
    def place(t):
        s = t.shape[1]
        if window > 0:
            if s >= window:
                return torch.roll(t[:, -window:], s % window, dims=1)
            return F.pad(t, (0, 0, 0, 0, 0, window - s))
        return F.pad(t, (0, 0, 0, 0, 0, smax - s))
    kk, vv = shardwise(place, k, (1,)), shardwise(place, v, (1,))
    if quant:
        kq, ks = _kv_quantize(kk)
        vq, vs = _kv_quantize(vv)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": kk, "v": vv}


def _kv_quantize(k):
    """Per-(token, head) symmetric int8 quantization of a K/V slice."""
    kf = k.float()
    scale = (kf.abs().amax(dim=-1) / 127.0).clamp(min=1e-8)
    q = torch.clamp(torch.round(kf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequant(q, scale, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def gqa_decode(cfg, p, x, cache, pos: int, *, window: int = 0, out=None,
               kv_constraint=None):
    """Single-token decode. x: (B, 1, d); cache per conventions above;
    ``pos`` = number of tokens already in the cache.

    Returns ``(y, new_cache)``.  ``new_cache`` holds new tensors (``out``,
    when given, is a dict of tensors of the cache's shapes to write them
    into); ``cache`` itself is never written.  A ``pos`` past the cache end
    writes the last slot, as the reference's dynamic-update-slice clamps
    its start index.  Quantized caches are dequantized whole and then
    go through the same decode kernel, as in the reference.
    ``kv_constraint``: a sharding spec of the new (B, 1, KH, hd) K/V that
    they are placed by before the cache write on a DTensor program (the
    cache's own placement keeps the write shard-local); a no-op on plain
    tensors.

    Spans, in order: ``attn.qkv``, ``attn.rope``, ``attn.cache_copy``,
    ``attn.kv_write``, ``attn.k2`` (the decode kernel and its wrapper) and
    ``attn.out``.
    """
    b = x.shape[0]
    hd = cfg.hd
    with span("attn.qkv"):
        q = _split_heads(L.linear(p["wq"], x), cfg.n_heads, hd)
        k = _split_heads(L.linear(p["wk"], x), cfg.n_kv_heads, hd)
        v = _split_heads(L.linear(p["wv"], x), cfg.n_kv_heads, hd)
    with span("attn.rope"):
        posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q = L.apply_rope(q, posv, cfg.rope_theta)
        k = L.apply_rope(k, posv, cfg.rope_theta)
    k, v = constrain(k, kv_constraint), constrain(v, kv_constraint)

    slot = pos % window if window > 0 else pos
    slot = min(slot, cache["k"].shape[1] - 1)
    length = min(pos + 1, window) if window > 0 else pos + 1
    with span("attn.cache_copy"):
        new = out if out is not None else {n: torch.empty_like(t)
                                           for n, t in cache.items()}
        for n, t in cache.items():
            new[n].copy_(t)
    if "k_scale" in cache:
        with span("attn.kv_write"):
            kq, ks = _kv_quantize(k)
            vq, vs = _kv_quantize(v)
            new["k"][:, slot] = kq[:, 0]
            new["v"][:, slot] = vq[:, 0]
            new["k_scale"][:, slot] = ks[:, 0]
            new["v_scale"][:, slot] = vs[:, 0]
        with span("attn.k2"):
            o = _grouped_decode(
                q, _kv_dequant(new["k"], new["k_scale"], x.dtype),
                _kv_dequant(new["v"], new["v_scale"], x.dtype), length)
    else:
        with span("attn.kv_write"):
            new["k"][:, slot] = k[:, 0].to(new["k"].dtype)
            new["v"][:, slot] = v[:, 0].to(new["v"].dtype)
        # ring order does not matter for softmax attention (permutation
        # invariant); mask by live length.
        with span("attn.k2"):
            o = _grouped_decode(q, new["k"], new["v"], length)
    with span("attn.out"):
        y = L.linear(p["wo"], o.reshape(b, 1, cfg.n_heads * hd))
    return y, new


def _grouped_decode(q, ck, cv, length: int):
    """Grouped-query decode attention through the decode kernel.
    q: (B,1,H,hd); ck/cv: (B,S,KH,hd); every row's live length is
    ``length``."""
    return ops.grouped_decode(q, ck.to(q.dtype), cv.to(q.dtype), length)


# ---------------------------------------------------------------------------
# MLA (DeepSeek)
# ---------------------------------------------------------------------------

def mla_init(gen, cfg, lead: tuple = ()):
    m = cfg.mla
    h = cfg.n_heads
    dev = gen.device
    return {
        "wq_a": L.linear_init(gen, cfg.d_model, m.q_lora_rank, cfg.dtype,
                              lead=lead),
        "q_norm": L.rmsnorm_init(m.q_lora_rank, cfg.dtype, dev, lead=lead),
        "wq_b": L.linear_init(gen, m.q_lora_rank,
                              h * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                              cfg.dtype, lead=lead),
        "wkv_a": L.linear_init(gen, cfg.d_model,
                               m.kv_lora_rank + m.qk_rope_head_dim, cfg.dtype,
                               lead=lead),
        "kv_norm": L.rmsnorm_init(m.kv_lora_rank, cfg.dtype, dev, lead=lead),
        "wkv_b": L.linear_init(gen, m.kv_lora_rank,
                               h * (m.qk_nope_head_dim + m.v_head_dim),
                               cfg.dtype, lead=lead),
        "wo": L.linear_init(gen, h * m.v_head_dim, cfg.d_model, cfg.dtype,
                            lead=lead),
    }


def _mla_q(cfg, p, x, positions):
    """Per-head queries without and with RoPE.  The latent norms take
    ``rmsnorm``'s default eps, not ``cfg.norm_eps``, as in the reference."""
    m = cfg.mla
    b, s, _ = x.shape
    q = L.linear(p["wq_b"], L.rmsnorm(p["q_norm"], L.linear(p["wq_a"], x)))
    q = q.reshape(b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(cfg, p, x, positions):
    """The cached latent ``c`` (normed) and the shared rotary key ``kr``."""
    m = cfg.mla
    c, kr = L.linear(p["wkv_a"], x).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c = L.rmsnorm(p["kv_norm"], c)
    kr = L.apply_rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return c, kr


def mla_forward(cfg, p, x, positions, *, return_cache: bool = False):
    """Prefill: per-head K/V rebuilt from the latent, causal attention
    through the flash kernel at query-key dim nope + rope and value dim
    ``v_head_dim``, all heads their own KV head (G = 1).  The value heads
    are a strided view of the up-projection's output, passed as they are."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c, kr = _mla_latent(cfg, p, x, positions)
    kv = L.linear(p["wkv_b"], c).reshape(b, s, h,
                                         m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(b, s, h,
                                                    m.qk_rope_head_dim)],
                  dim=-1)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    out = ops.grouped_flash(q, k, v, causal=True, scale=scale)
    y = L.linear(p["wo"], out.reshape(b, s, h * m.v_head_dim))
    if return_cache:
        return y, {"c": c, "kr": kr}
    return y


def mla_prefill_cache(cfg, smax: int, cache):
    pad = smax - cache["c"].shape[1]
    return {n: shardwise(lambda t: F.pad(t, (0, 0, 0, pad)), cache[n], (1,))
            for n in ("c", "kr")}


def mla_decode(cfg, p, x, cache, pos: int, *, out=None):
    """Absorbed-latent decode: attention runs over the compressed latent
    cache (kv_lora + rope dims per position), never materializing per-head
    K/V for the whole context.  Float32 products, as in the reference.

    Returns ``(y, new_cache)``; the new latent row is written out of place
    into ``out`` (or new tensors), as ``gqa_decode`` does, and a ``pos``
    past the cache end writes the last row, as the reference's
    dynamic-update-slice clamps it."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, posv)            # (B, 1, H, *)
    c_new, kr_new = _mla_latent(cfg, p, x, posv)
    new = out if out is not None else {n: torch.empty_like(t)
                                       for n, t in cache.items()}
    for n, t in cache.items():
        new[n].copy_(t)
    slot = min(pos, cache["c"].shape[1] - 1)
    new["c"][:, slot] = c_new[:, 0].to(new["c"].dtype)
    new["kr"][:, slot] = kr_new[:, 0].to(new["kr"].dtype)
    cc, ckr = new["c"].float(), new["kr"].float()

    wkv_b = p["wkv_b"]["w"].reshape(m.kv_lora_rank, h,
                                    m.qk_nope_head_dim + m.v_head_dim).float()
    w_uk = wkv_b[..., :m.qk_nope_head_dim]               # (r, H, nope)
    w_uv = wkv_b[..., m.qk_nope_head_dim:]               # (r, H, v)
    # absorb W_uk into q: q_eff (B, 1, H, r)
    q_eff = torch.einsum("bthd,rhd->bthr", q_nope.float(), w_uk)
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s_lat = torch.einsum("bthr,bsr->bhs", q_eff, cc)
    s_rope = torch.einsum("bthd,bsd->bhs", q_rope.float(), ckr)
    scores = (s_lat + s_rope) * scale
    mask = torch.arange(cc.shape[1], device=x.device)[None, None, :] < pos + 1
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", w, cc)            # (B, H, r)
    o = torch.einsum("bhr,rhd->bhd", ctx, w_uv)
    y = L.linear(p["wo"], o.reshape(b, 1, h * m.v_head_dim).to(x.dtype))
    return y, new
