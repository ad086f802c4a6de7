"""Grouped-query attention (with RoPE / QKV bias / sliding window).

Cache conventions (per layer; stacked along a leading layer axis by the
transformer):

* GQA full attention : {"k": (B, S_max, KH, hd), "v": ...}
* GQA sliding window : ring buffer {"k": (B, W, KH, hd), "v": ...}
* int8 ``kv_quant``  : adds {"k_scale": (B, S, KH), "v_scale": ...} float32

Decode positions are one host integer ``pos`` shared by the whole batch (the
serving engine aligns batches; rows with shorter prompts read the longest
row's positions, as in the reference).

Prefill attention runs the flash kernel on the grouped layout as it is, and
decode attention the decode kernel on the ``(B, S, KH, hd)`` cache: the
kernels read KV head ``h // G`` themselves, so no K/V is repeated.  The
decode cache update is out of place: a step returns new cache tensors and
never writes the ones it was given, because the serving engine keeps
superseded snapshots alive and discards stale decode results.
MLA waits for a later slice (ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, hd)


def gqa_forward(cfg, p, x, positions, *, window: int = 0, causal: bool = True,
                return_cache: bool = False, kv_override=None):
    """Full-sequence attention (prefill / encoder).

    ``kv_override``: (k, v) head tensors for cross-attention (RoPE-free).
    """
    b, s, _ = x.shape
    hd = cfg.hd
    q = _split_heads(L.linear(p["wq"], x), cfg.n_heads, hd)
    if kv_override is None:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = _split_heads(L.linear(p["wk"], x), cfg.n_kv_heads, hd)
        v = _split_heads(L.linear(p["wv"], x), cfg.n_kv_heads, hd)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    else:
        k, v = kv_override
    out = _grouped_flash(q, k, v, causal=causal, window=window)
    y = L.linear(p["wo"], out.reshape(b, s, cfg.n_heads * hd))
    if return_cache:
        return y, {"k": k, "v": v}
    return y


def _grouped_flash(q, k, v, *, causal, window):
    """q: (B,S,H,hd); k,v: (B,Sk,KH,hd) with H = KH * G, passed to the
    kernel as they are."""
    return ops.grouped_flash(q, k, v, causal=causal, window=window)


def gqa_prefill_cache(cfg, smax: int, k, v, window: int, quant: bool = False):
    """Place prefill K/V into the (padded or ring) cache layout.

    Ring convention: position p lives at slot ``p % window`` (matches
    ``gqa_decode``); softmax attention is permutation-invariant so ring
    order never needs unwinding."""
    s = k.shape[1]
    if window > 0:
        if s >= window:
            kk = torch.roll(k[:, -window:], s % window, dims=1)
            vv = torch.roll(v[:, -window:], s % window, dims=1)
        else:
            kk = F.pad(k, (0, 0, 0, 0, 0, window - s))
            vv = F.pad(v, (0, 0, 0, 0, 0, window - s))
    else:
        kk = F.pad(k, (0, 0, 0, 0, 0, smax - s))
        vv = F.pad(v, (0, 0, 0, 0, 0, smax - s))
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


def gqa_decode(cfg, p, x, cache, pos: int, *, window: int = 0, out=None):
    """Single-token decode. x: (B, 1, d); cache per conventions above;
    ``pos`` = number of tokens already in the cache.

    Returns ``(y, new_cache)``.  ``new_cache`` holds new tensors (``out``,
    when given, is a dict of tensors of the cache's shapes to write them
    into); ``cache`` itself is never written.  A ``pos`` past the cache end
    writes the last slot, as the reference's dynamic-update-slice clamps
    its start index.  Quantized caches are dequantized whole and then
    go through the same decode kernel, as in the reference.
    """
    b = x.shape[0]
    hd = cfg.hd
    q = _split_heads(L.linear(p["wq"], x), cfg.n_heads, hd)
    k = _split_heads(L.linear(p["wk"], x), cfg.n_kv_heads, hd)
    v = _split_heads(L.linear(p["wv"], x), cfg.n_kv_heads, hd)
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = L.apply_rope(q, posv, cfg.rope_theta)
    k = L.apply_rope(k, posv, cfg.rope_theta)

    slot = pos % window if window > 0 else pos
    slot = min(slot, cache["k"].shape[1] - 1)
    length = min(pos + 1, window) if window > 0 else pos + 1
    new = out if out is not None else {n: torch.empty_like(t)
                                       for n, t in cache.items()}
    for n, t in cache.items():
        new[n].copy_(t)
    if "k_scale" in cache:
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        new["k"][:, slot] = kq[:, 0]
        new["v"][:, slot] = vq[:, 0]
        new["k_scale"][:, slot] = ks[:, 0]
        new["v_scale"][:, slot] = vs[:, 0]
        o = _grouped_decode(q, _kv_dequant(new["k"], new["k_scale"], x.dtype),
                            _kv_dequant(new["v"], new["v_scale"], x.dtype),
                            length)
    else:
        new["k"][:, slot] = k[:, 0].to(new["k"].dtype)
        new["v"][:, slot] = v[:, 0].to(new["v"].dtype)
        # ring order does not matter for softmax attention (permutation
        # invariant); mask by live length.
        o = _grouped_decode(q, new["k"], new["v"], length)
    y = L.linear(p["wo"], o.reshape(b, 1, cfg.n_heads * hd))
    return y, new


def _grouped_decode(q, ck, cv, length: int):
    """Grouped-query decode attention through the decode kernel.
    q: (B,1,H,hd); ck/cv: (B,S,KH,hd); every row's live length is
    ``length``."""
    lengths = torch.full((q.shape[0],), length, dtype=torch.int32,
                         device=q.device)
    return ops.grouped_decode(q, ck.to(q.dtype), cv.to(q.dtype), lengths)
