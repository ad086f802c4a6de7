"""Kernel entry points, dispatched by the device of the tensors they get.

A CUDA tensor goes to the hand-written Hopper kernel, which launches or
raises; a CPU tensor goes to the plain version in ``ref``.  There is no
backend switch that could pick the plain path on the card, and no fallback
from a failed build or launch.

* ``grouped_flash`` / ``flash_attention``   -- prefill attention (K1)
* ``grouped_decode`` / ``decode_attention`` -- decode attention (K2)
* ``mlstm_scan``                            -- chunkwise mLSTM scan (K3)
* ``moe_route``                             -- MoE router and dispatch plan (K4)
* ``moe_topk``                              -- the router's top k alone (K4)

The ``grouped_*`` forms take the model's layout (``(B, S, H, hd)`` queries,
``(B, S, KH, hd)`` keys and values); the others the reference package's
``(BH, S, D)`` signatures.
"""
from __future__ import annotations

from . import ref
from .decode_attention import decode_attention as _decode_cuda
from .flash_attention import flash_attention as _flash_cuda
from .mlstm_scan import mlstm_scan as _mlstm_cuda
from .moe_topk import moe_route as _moe_route_cuda
from .moe_topk import moe_topk as _moe_topk_cuda


def _on_cuda(t, op: str) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no path for tensors on {t.device}")


def grouped_flash(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """q: (B, Sq, H, hd); k: (B, Sk, KH, hd); v: (B, Sk, KH, hdv) ->
    (B, Sq, H, hdv); hdv differs from hd only for MLA (192, 128)."""
    if _on_cuda(q, "grouped_flash"):
        return _flash_cuda(q, k, v, causal=causal, window=window, scale=scale)
    return ref.grouped_flash_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)


def grouped_decode(q, k, v, lengths, *, scale: float | None = None):
    """q: (B, 1, H, hd); k, v: (B, S, KH, hd); lengths: (B,) int32."""
    if _on_cuda(q, "grouped_decode"):
        return _decode_cuda(q, k, v, lengths, scale=scale)
    return ref.grouped_decode_ref(q, k, v, lengths, scale=scale)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (BH, Sq, D); k: (BH, Sk, D); v: (BH, Sk, Dv) -> (BH, Sq, Dv)."""
    return grouped_flash(q[:, :, None], k[:, :, None], v[:, :, None],
                         causal=causal, window=window, scale=scale)[:, :, 0]


def decode_attention(q, k, v, lengths, *, scale: float | None = None):
    """q: (BH, 1, D); k, v: (BH, S, D); lengths: (BH,) int32."""
    return grouped_decode(q[:, :, None], k[:, :, None], v[:, :, None],
                          lengths, scale=scale)[:, :, 0]


def mlstm_scan(q, k, v, logf, i, *, scale: float | None = None):
    """q, k: (BH, S, dk); v: (BH, S, dv); logf, i: (BH, S) -> h (BH, S, dv).
    ``scale`` defaults to dk ** -0.5."""
    if _on_cuda(q, "mlstm_scan"):
        return _mlstm_cuda(q, k, v, logf, i, scale=scale)
    return ref.mlstm_chunkwise_ref(q, k, v, logf, i, scale=scale)


def moe_topk(logits, top_k: int, n_valid: int | None = None):
    """logits: (T, E) -> (weights (T, k) float32, indices (T, k) int32)."""
    if _on_cuda(logits, "moe_topk"):
        return _moe_topk_cuda(logits, top_k, n_valid=n_valid)
    return ref.moe_topk_ref(logits, top_k, n_valid=n_valid)


def moe_route(logits, top_k: int, *, capacity: int, n_valid: int | None = None,
              router_scale: float = 1.0):
    """logits: (T, E) -> ``ref.Route``: weights, idx, slot (T, k), slot_tok
    (E, capacity), prob_sum and counts (E,)."""
    if _on_cuda(logits, "moe_route"):
        return _moe_route_cuda(logits, top_k, capacity=capacity,
                               n_valid=n_valid, router_scale=router_scale)
    return ref.moe_route_ref(logits, top_k, capacity=capacity, n_valid=n_valid,
                             router_scale=router_scale)
