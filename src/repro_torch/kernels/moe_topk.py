"""Fused MoE router (softmax, top-k, renormalise) -- the Hopper kernel's
wrapper.

The kernel is ``csrc/moe_topk.cu``, hand-written CUDA C++ for ``sm_90a``.
It replaces the reference package's Pallas TPU kernel ``moe_topk_pallas``
(kernels/moe_topk.py): per token a softmax over the experts below
``n_valid``, then the top ``k`` by masked-argmax passes (ties to the lowest
index), then the picked weights divided by their sum.  One warp serves one
token; unlike the Pallas kernel it takes any number of tokens.  What bounds
it on the card is written at the top of the CUDA source.  The plain version
is ``ref.moe_topk_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_EXPERTS = 256       # MAXE in the CUDA source
MAX_TOP_K = 8           # MAXK
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def moe_topk(logits, top_k: int, n_valid: int | None = None):
    """logits: (T, E) CUDA tensor, float32 or bfloat16, experts contiguous.
    Returns (weights (T, k) float32, indices (T, k) int32)."""
    _check(logits, top_k)
    t, e = logits.shape
    n_valid = e if n_valid is None else int(n_valid)
    w = torch.empty((t, top_k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((t, top_k), dtype=torch.int32, device=logits.device)
    fn = build.function("moe_topk", "moe_topk_fwd", _ARGTYPES)
    err = fn(logits.data_ptr(), w.data_ptr(), idx.data_ptr(), t, e, top_k,
             n_valid, logits.stride(0), DTYPES[logits.dtype],
             torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(err, "moe_topk")
    launches.add()
    return w, idx


def _check(logits, top_k: int) -> None:
    if not logits.is_cuda:
        raise ValueError(f"moe_topk: logits are on {logits.device}, the "
                         "kernel takes CUDA tensors")
    if logits.dtype not in DTYPES:
        raise TypeError(f"moe_topk: logits are {logits.dtype}; the kernel "
                        "takes float32 or bfloat16")
    if logits.dim() != 2 or (logits.shape[1] > 1 and logits.stride(1) != 1):
        raise ValueError("moe_topk: logits must be 2-D (T, E) with the "
                         f"experts contiguous, got {tuple(logits.shape)}")
    e = logits.shape[1]
    if not 0 < e <= MAX_EXPERTS:
        raise ValueError(f"moe_topk: {e} experts; the kernel takes 1 to "
                         f"{MAX_EXPERTS}")
    if not 0 < top_k <= min(MAX_TOP_K, e):
        raise ValueError(f"moe_topk: top_k {top_k} must be in 1..{MAX_TOP_K} "
                         f"and at most the {e} experts")
