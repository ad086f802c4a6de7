"""Flash attention forward (prefill) -- the Hopper kernel's wrapper.

The kernel is ``csrc/flash_attention.cu``, hand-written CUDA C++ for
``sm_90a``.  It replaces the reference package's Pallas TPU kernel
``flash_attention_pallas`` (kernels/flash_attention.py): an online softmax
over KV tiles with float32 running max, sum and accumulator, causal
(queries at the last Sq key positions), sliding-window or unmasked.

Unlike the Pallas kernel it reads grouped-query K/V directly (query head
``h`` uses KV head ``h // G``), so the caller needs no repeated K/V copy, and
it masks ragged tails instead of asserting block multiples.  It also takes a
value dim other than the query-key dim for the one pair a model needs,
MLA's (192, 128), which the reference runs through its blocked ``xla``
flash because the Pallas kernel takes one D.

The source holds two hand-written kernels, and the C entry point picks one
by the input type: bfloat16 (the serving path) runs on the tensor cores
through ``wgmma``; float32 runs on the CUDA cores, because ``wgmma`` on
float32 is TF32 (about three decimal digits) and the float32 model checks
hold the kernel to 1e-4.  Both are this wrapper's launches, counted alike;
neither is a fallback for the other.  What bounds them on the card and what
the designs do about it is written at the top of the CUDA source.  The
plain version is ``ref.grouped_flash_ref``.

With ``return_lse`` the forward also returns each query row's logsumexp,
(B, H, Sq) float32 in the natural log: the float32 kernel keeps its
running max in natural units, the bf16 kernel in base 2 and converts when
it stores.  ``flash_attention_bwd`` is the gradient, a source of its own
(``csrc/flash_attention_bwd.cu``, three launches a call, counted once a
call in ``bwd_launches``), with ``ref.grouped_flash_bwd_ref`` as its plain
version; ``ops.grouped_flash`` reaches it through autograd.  As in the
forward the input type alone picks the kernels, at every pair of dims:
bfloat16 runs dK/dV and dQ on the tensor cores
(``flash_bwd_dkdv_wgmma_kernel``, ``flash_bwd_dq_wgmma_kernel``; at MLA's
(192, 128) the dK/dV launch sums dV and dK in separate blocks, and dQ takes
32-key tiles), float32 on the CUDA cores (``bwd_dkdv_kernel``,
``bwd_dq_kernel``); both start with ``bwd_delta_kernel``.  A pair of dims
the kernels do not take is refused before a launch.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 80, 128)
# (query-key dim, value dim) pairs taken besides the equal ones: MLA's.
DIM_PAIRS = ((192, 128),)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_ROW_PAD = 128    # ROW_PAD of csrc/flash_attention_bwd.cu

launches = build.LaunchCounter()
bwd_launches = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                 + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, return_lse: bool = False):
    """q: (B, Sq, H, hd); k: (B, Sk, KH, hd); v: (B, Sk, KH, hdv) CUDA
    tensors with H a multiple of KH, and hdv = hd or (hd, hdv) in
    ``DIM_PAIRS``.  Returns (B, Sq, H, hdv) in q's dtype, and with
    ``return_lse`` also the (B, H, Sq) float32 row logsumexp (natural log,
    -inf for a row that sees no key); ``scale`` defaults to hd ** -0.5."""
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk, kh, hdv = k.shape[1], k.shape[2], v.shape[3]
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((b, sq, h, hdv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), b, sq, sk, h, kh,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.stride(0), out.stride(1), out.stride(2),
             float(scale), int(bool(causal)), int(window), DTYPES[q.dtype], hd,
             hdv, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    launches.add()
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, scale: float | None = None):
    """The gradient of ``flash_attention`` on the card.  q: (B, Sq, H, hd);
    k: (B, Sk, KH, hd); v: (B, Sk, KH, hdv); o, do: (B, Sq, H, hdv); one
    dtype, and the dims as the forward takes them (hdv = hd in
    ``HEAD_DIMS``, or a pair of ``DIM_PAIRS``); lse: the forward's (B, H,
    Sq) float32 row logsumexp.  Returns (dq, dk, dv), contiguous, in the
    inputs' dtype.  Inputs that are not contiguous (``do`` from autograd
    may not be) are copied first."""
    _check(q, k, v)
    b, sq, h, hd = q.shape
    sk, kh, hdv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("o", o), ("do", do)):
        if (t.device != q.device or t.dtype != q.dtype
                or tuple(t.shape) != (b, sq, h, hdv)):
            raise ValueError(f"flash_attention_bwd: {name} "
                             f"{tuple(t.shape)} {t.dtype} on {t.device} is "
                             f"not ({b}, {sq}, {h}, {hdv}) {q.dtype}")
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, h, sq)):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} is not ({b}, {h}, {sq}) float32 on "
                         f"{q.device}")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    scale = hd ** -0.5 if scale is None else scale
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # D, and for bfloat16 lse log2(e) beside it, rows padded to BWD_ROW_PAD
    scratch = torch.empty((2, b, h, -(-sq // BWD_ROW_PAD) * BWD_ROW_PAD),
                          dtype=torch.float32, device=q.device)
    fn = build.function("flash_attention_bwd", "flash_attention_bwd",
                        _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, kh, float(scale),
             int(bool(causal)), int(window), DTYPES[q.dtype], hd, hdv,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention_bwd")
    bwd_launches.add()
    return dq, dk, dv


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
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not build.aligned16(t):
                raise ValueError(f"flash_attention: bfloat16 {name} is copied "
                                 "in 16-byte chunks and must be 16-byte "
                                 "aligned, with strides that keep every row so")
    b, _, h, hd = q.shape
    hdv = v.shape[3]
    if not ((hd == hdv and hd in HEAD_DIMS) or (hd, hdv) in DIM_PAIRS):
        raise ValueError(f"flash_attention: head dims ({hd}, {hdv}) are "
                         f"neither equal and in {HEAD_DIMS} nor in "
                         f"{DIM_PAIRS}")
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b
            or k.shape[3] != hd):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {k.shape[2]} KV heads")
