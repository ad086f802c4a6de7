"""Chunkwise mLSTM scan -- the Hopper kernel's wrapper.

The kernel is ``csrc/mlstm_scan.cu``, hand-written CUDA C++ for ``sm_90a``.
It replaces the reference package's Pallas TPU kernel ``mlstm_scan_pallas``
(kernels/mlstm_scan.py): the mLSTM/SSD recurrence with a float32 matrix
state ``C`` (dk x dv) and normaliser ``n`` (dk), evaluated a chunk at a
time.  The TPU kernel keeps the whole of ``C`` in VMEM; here each block
keeps a 64-column slice of it in shared memory, so the grid is (BH,
ceil(dv / 64)), and the chunk length is chosen by the kernel from dk.
Unlike the Pallas kernel it takes any sequence length.  What bounds it on
the card is written at the top of the CUDA source.  The plain version is
``ref.mlstm_chunkwise_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 10 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])


def chunk_len(dk: int) -> int:
    """The chunk length the kernel uses at head dim ``dk`` (0: no fit)."""
    return build.function("mlstm_scan", "mlstm_scan_chunk", [ctypes.c_int])(dk)


def mlstm_scan(q, k, v, logf, i, *, scale: float | None = None):
    """q, k: (BH, S, dk); v: (BH, S, dv), CUDA tensors of one type, float32
    or bfloat16, feature dim contiguous; logf, i: (BH, S) gates (cast to
    float32).  Returns h (BH, S, dv) in q's type."""
    _check(q, k, v, logf, i)
    bh, s, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5 if scale is None else scale
    logf = logf.float().contiguous()
    i = i.float().contiguous()
    if chunk_len(dk) == 0:
        raise ValueError(f"mlstm_scan: head dim {dk} leaves no room for a "
                         "chunk beside the state slice in shared memory")
    out = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    fn = build.function("mlstm_scan", "mlstm_scan_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), logf.data_ptr(),
             i.data_ptr(), out.data_ptr(), bh, s, dk, dv,
             q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), logf.stride(0), i.stride(0),
             out.stride(0), out.stride(1), float(scale), DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "mlstm_scan")
    launches.add()
    return out


def _check(q, k, v, logf, i) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("logf", logf), ("i", i)):
        if not t.is_cuda:
            raise ValueError(f"mlstm_scan: {name} is on {t.device}, the "
                             "kernel takes CUDA tensors")
        if t.device != q.device:
            raise ValueError("mlstm_scan: inputs on different devices")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"mlstm_scan: {name} is {t.dtype}; the kernel "
                            "takes float32 or bfloat16, q, k, v alike")
        if t.dim() != 3 or t.stride(-1) != 1:
            raise ValueError(f"mlstm_scan: {name} must be 3-D (BH, S, D) "
                             f"with a contiguous last dim, got {tuple(t.shape)}")
    bh, s, dk = q.shape
    if k.shape != q.shape or v.shape[:2] != (bh, s):
        raise ValueError(f"mlstm_scan: q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f" and v {tuple(v.shape)} do not match")
    if dk % 4:
        raise ValueError(f"mlstm_scan: head dim {dk} is not a multiple of 4")
    for name, t in (("logf", logf), ("i", i)):
        if tuple(t.shape) != (bh, s):
            raise ValueError(f"mlstm_scan: {name} must be (BH, S) = "
                             f"{(bh, s)}, got {tuple(t.shape)}")
