"""Kernel entry points, dispatched by the device of the tensors they get.

A CUDA tensor goes to the hand-written Hopper kernel, which launches or
raises; a CPU tensor goes to the plain version in ``ref``.  There is no
backend switch that could pick the plain path on the card, and no fallback
from a failed build or launch.

* ``grouped_flash`` / ``flash_attention``   -- prefill attention (K1)
* ``grouped_decode`` / ``decode_attention`` -- decode attention (K2)

The ``grouped_*`` forms take the model's layout (``(B, S, H, hd)`` queries,
``(B, S, KH, hd)`` keys and values); the others the reference package's
``(BH, S, D)`` signatures.
"""
from __future__ import annotations

from . import ref
from .decode_attention import decode_attention as _decode_cuda
from .flash_attention import flash_attention as _flash_cuda


def _on_cuda(t, op: str) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no path for tensors on {t.device}")


def grouped_flash(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd) -> (B, Sq, H, hd)."""
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
    """q: (BH, Sq, D); k, v: (BH, Sk, D) -> (BH, Sq, D)."""
    return grouped_flash(q[:, :, None], k[:, :, None], v[:, :, None],
                         causal=causal, window=window, scale=scale)[:, :, 0]


def decode_attention(q, k, v, lengths, *, scale: float | None = None):
    """q: (BH, 1, D); k, v: (BH, S, D); lengths: (BH,) int32."""
    return grouped_decode(q[:, :, None], k[:, :, None], v[:, :, None],
                          lengths, scale=scale)[:, :, 0]
