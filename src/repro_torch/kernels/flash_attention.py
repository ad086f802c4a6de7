"""Flash attention forward (prefill) -- the Hopper kernel's wrapper.

The kernel is ``csrc/flash_attention.cu``, hand-written CUDA C++ for
``sm_90a``.  It replaces the reference package's Pallas TPU kernel
``flash_attention_pallas`` (kernels/flash_attention.py): an online softmax
over KV tiles with float32 running max, sum and accumulator, causal
(queries at the last Sq key positions), sliding-window or unmasked.

Unlike the Pallas kernel it reads grouped-query K/V directly (query head
``h`` uses KV head ``h // G``), so the caller needs no repeated K/V copy, and
it masks ragged tails instead of asserting block multiples.  What bounds it
on the card and what the design does about it is written at the top of the
CUDA source.  The plain version is ``ref.grouped_flash_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KH, hd) CUDA tensors with H a
    multiple of KH.  Returns (B, Sq, H, hd) in q's dtype."""
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, sq, sk, h, kh,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.stride(0), out.stride(1), out.stride(2),
             float(scale), int(bool(causal)), int(window), DTYPES[q.dtype], hd,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    launches.add()
    return out


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             "the kernel takes CUDA tensors")
        if t.device != q.device:
            raise ValueError("flash_attention: q, k, v on different devices")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            "kernel takes float32 or bfloat16, all alike")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D "
                             f"(B, S, heads, hd), got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             "contiguous")
    b, _, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {k.shape[2]} KV heads")
