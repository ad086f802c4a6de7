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
by the input type: bfloat16 (the serving and training path) runs
``flash_fwd_tma_kernel`` on the tensor cores -- one producer warp filling
a ring of K/V tiles with TMA, two consumer warpgroups on ``wgmma``, one
persistent block an SM -- and is also counted in ``tma_launches``; float32
runs on the CUDA cores, because ``wgmma`` on float32 is TF32 (about three
decimal digits) and the float32 model checks hold the kernel to 1e-4.
Both are this wrapper's launches, counted alike in ``launches``; neither
is a fallback for the other.  The bf16 kernel reads q, k and v through
tensor maps encoded on the host for each call (``tma_encode_us`` times
that).  A bf16 input no tensor map can describe -- an expanded tensor (a
stride of 0), a view whose rows are not 16-byte aligned or whose head
dim is strided -- is first copied into a fresh contiguous tensor and
the copy counted in ``tma_copies``: the reference's kernel takes any
array (its arrays have no strides), and the model paths pass none such,
so the count there stays 0.  Head dims the kernels do not take, and a
float32 head dim that is not contiguous, still raise; a map the driver
refuses raises too.  What bounds the kernels on the card and what the
designs do about it is written at the top of the CUDA source.  The plain
version is ``ref.grouped_flash_ref``.

``flash_attention_watchdog`` is the same call on a second build of the
source with ``-DREPRO_MBAR_WATCHDOG``, whose ``mbarrier`` waits trap after
a bounded number of tries (``csrc/hopper.cuh``), so a wrong transaction
count ends the launch with an error instead of hanging the process.  The
trap costs the bf16 kernel its ``setmaxnreg`` split, so only the parity
tests run it; its launches count in ``watchdog_launches`` alone.

With ``return_lse`` the forward also returns each query row's logsumexp,
(B, H, Sq) float32 in the natural log: the float32 kernel keeps its
running max in natural units, the bf16 kernel in base 2 and converts when
it stores.  ``flash_attention_bwd`` is the gradient, a source of its own
(``csrc/flash_attention_bwd.cu``, three launches a call, counted once a
call in ``bwd_launches``), with ``ref.grouped_flash_bwd_ref`` as its plain
version; ``ops.grouped_flash`` reaches it through autograd.  As in the
forward the input type alone picks the kernels, at every pair of dims:
bfloat16 runs dK/dV and dQ on the tensor cores, each warp specialised as
the forward (``flash_bwd_dkdv_tma_kernel``, ``flash_bwd_dq_tma_kernel``:
a TMA producer, two ``wgmma`` consumer warpgroups, persistent; at MLA's
(192, 128) the dK/dV walk sums dV and dK in separate work tiles), float32
on the CUDA cores (``bwd_dkdv_kernel``, ``bwd_dq_kernel``); both start
with ``bwd_delta_kernel``.  The bf16 kernels read q, k, v and ``do``
through tensor maps encoded each call, so what no map describes is
copied first and counted in ``tma_copies``, as in the forward (``do``
from autograd may be a strided view a map does describe: it is read as
it is); ``o`` is read through its strides.  A pair of dims the kernels do
not take is refused before a launch, and a map the driver refuses
raises.  ``flash_attention_bwd_watchdog`` is the backward on its watchdog
build, counted in ``bwd_watchdog_launches`` alone.
"""
from __future__ import annotations

import ctypes

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import build

HEAD_DIMS = (16, 32, 64, 80, 128)
# (query-key dim, value dim) pairs taken besides the equal ones: MLA's.
DIM_PAIRS = ((192, 128),)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BWD_ROW_PAD = 128    # ROW_PAD of csrc/flash_attention_bwd.cu

launches = build.LaunchCounter()
tma_launches = build.LaunchCounter()     # the bf16 kernel's, also in launches
tma_copies = build.LaunchCounter()       # bf16 inputs copied for a tensor map
bwd_launches = build.LaunchCounter()
watchdog_launches = build.LaunchCounter()     # the watchdog build's alone
bwd_watchdog_launches = build.LaunchCounter()   # the backward's, alike
WATCHDOG_FLAGS = ("-DREPRO_MBAR_WATCHDOG",)
TMA_REFUSED = 100000     # + the CUresult of a tensor map the driver refused

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 12 + [ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 15 + [ctypes.c_float]
                 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_ENCODE_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                    + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, return_lse: bool = False):
    """q: (B, Sq, H, hd); k: (B, Sk, KH, hd); v: (B, Sk, KH, hdv) CUDA
    tensors with H a multiple of KH, and hdv = hd or (hd, hdv) in
    ``DIM_PAIRS``.  Returns (B, Sq, H, hdv) in q's dtype, and with
    ``return_lse`` also the (B, H, Sq) float32 row logsumexp (natural log,
    -inf for a row that sees no key); ``scale`` defaults to hd ** -0.5."""
    return _forward(q, k, v, causal, window, scale, return_lse, (), (
        launches, tma_launches) if q.dtype == torch.bfloat16 else (launches,))


def flash_attention_watchdog(q, k, v, *, causal: bool = True, window: int = 0,
                             scale: float | None = None,
                             return_lse: bool = False):
    """``flash_attention`` on the watchdog build (``WATCHDOG_FLAGS``; the
    module docstring says what it is for), counted in
    ``watchdog_launches`` alone."""
    return _forward(q, k, v, causal, window, scale, return_lse,
                    WATCHDOG_FLAGS, (watchdog_launches,))


def _forward(q, k, v, causal, window, scale, return_lse, flags: tuple,
             counters: tuple):
    """One launch of the forward kernel of the library built with
    ``flags``, added to each of ``counters`` once the driver took it."""
    _check(q, k, v)
    q, k, v = (_readable(t) for t in (q, k, v))
    b, sq, h, hd = q.shape
    sk, kh, hdv = k.shape[1], k.shape[2], v.shape[3]
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty((b, sq, h, hdv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if isinstance(q, FakeTensor):               # shapes alone: no launch
        return (out, lse) if return_lse else out
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES,
                        flags)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if lse is None else lse.data_ptr(), b, sq, sk, h, kh,
             q.stride(0), q.stride(1), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.stride(0), out.stride(1), out.stride(2),
             float(scale), int(bool(causal)), int(window), DTYPES[q.dtype], hd,
             hdv, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_refused(err)
    build.check(err, "flash_attention")
    for c in counters:
        c.add()
    return (out, lse) if return_lse else out


def tma_encode_us(q, k, v, iters: int = 1000) -> float:
    """Host microseconds a call spends encoding the bf16 kernel's four
    tensor maps (q, k, v and the output) for these bfloat16 CUDA tensors
    (as ``flash_attention`` would take them), the mean over ``iters``
    encodings; nothing is launched."""
    _check(q, k, v)
    q, k, v = (_readable(t) for t in (q, k, v))
    if q.dtype != torch.bfloat16:
        raise TypeError("flash_attention: only the bfloat16 kernel reads "
                        "through tensor maps")
    b, sq, h, hd = q.shape
    sk, kh, hdv = k.shape[1], k.shape[2], v.shape[3]
    fn = build.function("flash_attention", "flash_attention_encode_us",
                        _ENCODE_ARGTYPES)
    fn.restype = ctypes.c_double
    us = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), b, sq, sk, h, kh,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), hd, hdv, iters)
    if us < 0:
        _raise_if_refused(int(-us))
        build.check(int(-us), "flash_attention_encode_us")
    return us


def _tma_ready(t) -> bool:
    """Whether a tensor map describes bf16 ``t`` as it is: its head dim
    contiguous, its first row and every other stride 16-byte aligned
    (a fake tensor's storage offset standing for its address), no stride
    of a dim longer than 1 zero."""
    if t.stride(-1) != 1 or any(st == 0 and n > 1 for st, n in
                                zip(t.stride(), t.shape)):
        return False
    if isinstance(t, FakeTensor) and \
            t.storage_offset() * t.element_size() % 16:
        return False
    return build.aligned16(t)


def _readable(t):
    """``t`` as the bf16 kernels read it: itself, or a fresh contiguous
    copy, counted in ``tma_copies``, where no tensor map describes it
    (``_tma_ready``).  Other types pass as they are."""
    if t.dtype != torch.bfloat16 or _tma_ready(t):
        return t
    tma_copies.add()
    return t.clone(memory_format=torch.contiguous_format)


def _raise_if_refused(err: int, what: str = "flash_attention",
                      inputs: str = "q, k or v") -> None:
    if err >= TMA_REFUSED:
        raise ValueError(f"{what}: the driver refused a tensor map of "
                         f"{inputs} (CUresult {err - TMA_REFUSED})")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, scale: float | None = None):
    """The gradient of ``flash_attention`` on the card.  q: (B, Sq, H, hd);
    k: (B, Sk, KH, hd); v: (B, Sk, KH, hdv); o, do: (B, Sq, H, hdv); one
    dtype, and the dims as the forward takes them (hdv = hd in
    ``HEAD_DIMS``, or a pair of ``DIM_PAIRS``); lse: the forward's (B, H,
    Sq) float32 row logsumexp.  Returns (dq, dk, dv), contiguous, in the
    inputs' dtype.  float32 inputs that are not contiguous are copied
    first; a bf16 q, k, v or do that no tensor map describes is copied and
    counted in ``tma_copies`` (``_readable``), and o is read through its
    strides."""
    return _backward(q, k, v, o, lse, do, causal, window, scale, (),
                     (bwd_launches,))


def flash_attention_bwd_watchdog(q, k, v, o, lse, do, *, causal: bool = True,
                                 window: int = 0, scale: float | None = None):
    """``flash_attention_bwd`` on the watchdog build (``WATCHDOG_FLAGS``),
    counted in ``bwd_watchdog_launches`` alone."""
    return _backward(q, k, v, o, lse, do, causal, window, scale,
                     WATCHDOG_FLAGS, (bwd_watchdog_launches,))


def _backward(q, k, v, o, lse, do, causal, window, scale, flags: tuple,
              counters: tuple):
    """One call of the backward's launches from the library built with
    ``flags``, added to each of ``counters`` once the driver took them."""
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
    if q.dtype == torch.bfloat16:
        q, k, v, do = (_readable(t) for t in (q, k, v, do))
        if o.stride(-1) != 1:       # D's kernel reads a row's elements in turn
            o = o.contiguous()
    else:
        q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    lse = lse.contiguous()
    scale = hd ** -0.5 if scale is None else scale
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                  for t in (q, k, v))
    # D, and for bfloat16 lse log2(e) beside it, rows padded to BWD_ROW_PAD
    scratch = torch.empty((2, b, h, -(-sq // BWD_ROW_PAD) * BWD_ROW_PAD),
                          dtype=torch.float32, device=q.device)
    if isinstance(q, FakeTensor):               # shapes alone: no launch
        return dq, dk, dv
    fn = build.function("flash_attention_bwd", "flash_attention_bwd",
                        _BWD_ARGTYPES, flags)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), b, sq, sk, h, kh,
             *(t.stride(i) for t in (q, k, v, o, do) for i in range(3)),
             float(scale), int(bool(causal)), int(window), DTYPES[q.dtype],
             hd, hdv, torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if_refused(err, "flash_attention_bwd", "q, k, v or do")
    build.check(err, "flash_attention_bwd")
    for c in counters:
        c.add()
    return dq, dk, dv


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda and not isinstance(t, FakeTensor):
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
        if t.stride(-1) != 1 and t.dtype == torch.float32:
            raise ValueError(f"flash_attention: float32 {name}'s head dim "
                             "must be contiguous")
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
