"""Single-token decode attention -- the Hopper kernel's wrapper.

The kernel is ``csrc/decode_attention.cu``, hand-written CUDA C++ for
``sm_90a``.  It replaces the reference package's Pallas TPU kernel
``decode_attention_pallas`` (kernels/decode_attention.py): one query token per
row attends to the cache positions below the row's live length, as an
online softmax in float32.

One block serves one (batch row, KV head) and all G query heads of that
group, so each K/V byte is read once per step.  What bounds it on the card
and what the design does about it is written at the top of the CUDA source.
The plain version is ``ref.grouped_decode_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 16          # query heads per KV head (MAXG in the CUDA source)

launches = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 10 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def decode_attention(q, k, v, lengths, *, scale: float | None = None):
    """q: (B, 1, H, hd); k, v: (B, S, KH, hd) caches; lengths: (B,) int32
    live lengths, all CUDA tensors.  Returns (B, 1, H, hd) in q's dtype."""
    _check(q, k, v, lengths)
    b, _, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    fn = build.function("decode_attention", "decode_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), b, s, h, kh,
             q.stride(0), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.stride(0), out.stride(2),
             float(scale), DTYPES[q.dtype], hd,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "decode_attention")
    launches.add()
    return out


def _check(q, k, v, lengths) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_cuda:
            raise ValueError(f"decode_attention: {name} is on {t.device}, "
                             "the kernel takes CUDA tensors")
        if t.device != q.device:
            raise ValueError("decode_attention: inputs on different devices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"decode_attention: {name} is {t.dtype}; the "
                            "kernel takes float32 or bfloat16, all alike")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name} must be 4-D with a "
                             f"contiguous head dim, got {tuple(t.shape)}")
    b, one, h, hd = q.shape
    if one != 1:
        raise ValueError(f"decode_attention: q holds {one} tokens per row, "
                         "the kernel takes one")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not in {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"decode_attention: cache {tuple(k.shape)} / "
                         f"{tuple(v.shape)} does not match q {tuple(q.shape)}")
    kh = k.shape[2]
    if kh == 0 or h % kh or h // kh > MAX_GROUP:
        raise ValueError(f"decode_attention: {h} query heads over {kh} KV "
                         f"heads; need a multiple, at most {MAX_GROUP} per group")
    if (lengths.dtype != torch.int32 or lengths.shape != (b,)
            or not lengths.is_contiguous()):
        raise ValueError("decode_attention: lengths must be a contiguous "
                         f"(B,) int32 tensor, got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
