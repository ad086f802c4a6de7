"""Chunkwise mLSTM scan -- the Hopper kernels' wrapper.

The kernels are in ``csrc/mlstm_scan.cu``, hand-written CUDA C++ for
``sm_90a``.  They replace the reference package's Pallas TPU kernel
``mlstm_scan_pallas`` (kernels/mlstm_scan.py): the mLSTM/SSD recurrence with
a float32 matrix state ``C`` (dk x dv) and normaliser ``n`` (dk), evaluated a
chunk at a time.  The TPU kernel keeps the whole of ``C`` in VMEM; here a
block owns 64 of its value columns.

* bfloat16 runs on the tensor cores (``wgmma``) in chunks of 64 steps, by
  the plan ``scan_plan`` draws from the shapes alone: a **single pass**
  (a pre-pass carries the normaliser once a row-head and gives each chunk
  its gates' rows and q . n_prev; then grid (BH, dv / 64), each block walks
  every chunk with its slice of ``C`` in registers, a TMA producer
  warpgroup streaming Q and K in 64-column panels of dk through an
  ``mbarrier`` ring to two consumer warpgroups: one sums the scores and Q
  C_prev over every panel and writes the output, the other holds most of
  ``C`` and carries it), or, where the H100 timed it faster (a few
  row-heads over many chunks; more widely at small dk), **chunk-parallel**
  (each chunk's own state, then one pass in chunk order over those states
  in float32 scratch, then every chunk's output in parallel: three
  launches).  ``ref.mlstm_single_pass_ref`` and
  ``ref.mlstm_chunk_parallel_ref`` are their arithmetic in plain PyTorch.
  ``mlstm_scan_watchdog`` is the single pass on a second build with
  ``-DREPRO_MBAR_WATCHDOG`` (every ``mbarrier`` wait traps after a bounded
  number of tries), counted in ``watchdog_launches`` alone.
* float32 runs the first design, on the CUDA cores: one launch, chunk
  length from dk (``chunk_len``).

Unlike the Pallas kernel it takes any sequence length.  What bounds it on
the card is written at the top of the CUDA source.  The plain version is
``ref.mlstm_chunkwise_ref``.

``mlstm_scan_bwd`` is the gradient, ``csrc/mlstm_scan_bwd.cu``, counted
once a call in ``bwd_launches``, with ``ref.mlstm_chunkwise_bwd_ref`` as its
plain version; ``ops.mlstm_scan`` reaches it through autograd.  The input
type alone picks its kernels: bfloat16 runs six launches with every product
on the tensor cores (``wgmma``: the gates; two walks over the chunks that
carry the state and its gradient in float32 registers, their tiles brought
by TMA; the normaliser; the gradient kernel by 64-column tiles, its tiles
brought by TMA; the gate gradients), bf16
operands and float32 sums; float32 runs seven launches on the CUDA cores,
float32 throughout.  Every bfloat16 shape the forward takes (dk, dv
multiples of 8, dk up to 512) runs the tensor-core route, hymba's dk 16, dv
64 included.  The bf16 kernels read q, k, v and dh through tensor maps of
packed rows: one that is not packed (``dh`` from autograd may not be) is
copied first and counted in ``tma_copies``.  ``mlstm_scan_bwd_watchdog`` is
the same call on a second build with ``-DREPRO_MBAR_WATCHDOG`` (every
``mbarrier`` wait traps after a bounded number of tries, where the
production build would hang), counted in ``bwd_watchdog_launches`` alone.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DESIGNS = {"single": 0, "chunk_parallel": 1}
CHUNK = 64          # steps a chunk of the bfloat16 kernels (one m64 tile)
BWD_CHUNK = 64      # L in csrc/mlstm_scan_bwd.cu: steps a chunk of the backward
COLS = 64           # value columns a block
MAX_DK = 512        # the bfloat16 kernels' largest head dim (8 tiles of 64)
# Where chunk-parallel is the faster design (``scan_study plans`` on the
# H100).  Large states (timed at dk = dv = 512): at most this many
# single-pass blocks and at least this many chunks.  Small states (timed
# at dk = 16, dv = 64, applied up to dk = CP_SMALL_DK): everywhere.
CP_MAX_BLOCKS = 8
CP_MIN_CHUNKS = 8
CP_SMALL_DK = 16
# Either way, at most this much float32 scratch.
CP_MAX_SCRATCH = 64 << 20

launches = build.LaunchCounter()
watchdog_launches = build.LaunchCounter()   # the forward's watchdog build
bwd_launches = build.LaunchCounter()
bwd_watchdog_launches = build.LaunchCounter()   # the watchdog build's alone
tma_copies = build.LaunchCounter()   # bf16 inputs of the backward copied
WATCHDOG_FLAGS = ("-DREPRO_MBAR_WATCHDOG",)
TMA_REFUSED = 100000   # hopper.cuh: + the CUresult of a refused tensor map

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 10
             + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


_BWD_ARGTYPES = ([ctypes.c_void_p] * 26 + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


class ScanPlan(NamedTuple):
    """How the bfloat16 scan runs: ``design`` is ``"single"`` or
    ``"chunk_parallel"``; chunk ``c`` covers steps ``[c * chunk, min(s, (c +
    1) * chunk))`` of ``n_chunks``; a block owns ``cols`` value columns."""
    design: str
    chunk: int
    cols: int
    n_chunks: int


def scan_plan(bh: int, s: int, dk: int, dv: int, *,
              design: str | None = None) -> ScanPlan:
    """The plan for a (BH, S, dk) x (BH, S, dv) bfloat16 scan.  The single
    pass keeps one block for each of the ``bh * ceil(dv / 64)`` column
    slices and walks the chunks in order; the chunk-parallel design writes,
    carries and reads back ``(n_chunks - 1) * bh * dk * dv`` floats of
    chunk states to run the chunks side by side.  Timed on the H100 (the
    single pass of ``mlstm_tma_kernel``) at dk = dv = 512 over BH 1-32 and
    S 128-2048, chunk-parallel was faster at BH 1 (8 blocks) from 8 chunks
    (S 500: 1.49x, S 2048: 1.68x) and at BH 2, S 500 (1.18x), and 1.06-7.6x
    slower everywhere else it was timed, BH 2 from S 1024 and every BH >= 4
    (the bulk prefill's BH 4, S 500 included: 1.66x).  At dk = 16, dv = 64
    (hymba's SSD heads) over BH 25-200 and S 64-2048, where the single
    pass has one 64-column panel and a short chain to a chunk,
    chunk-parallel was faster at 21 of 24 points (1.02-3.0x) and at most
    1.18x slower at the others (BH 100, S 256 and 500).  It is picked
    where it was faster while its scratch is at most ``CP_MAX_SCRATCH``
    bytes.  ``design`` forces one (the tests hold the two against each
    other).  Depends on shapes only."""
    n_chunks = max(1, -(-s // CHUNK))
    if design is None:
        blocks = bh * -(-dv // COLS)
        few = dk <= CP_SMALL_DK or (blocks <= CP_MAX_BLOCKS
                                    and n_chunks >= CP_MIN_CHUNKS)
        scratch = (n_chunks - 1) * bh * dk * dv * 4
        design = ("chunk_parallel" if few and scratch <= CP_MAX_SCRATCH
                  else "single")
    if design not in DESIGNS:
        raise ValueError(f"mlstm_scan: no design {design!r}")
    return ScanPlan(design, CHUNK, COLS, n_chunks)


def single_pass_panels(dk: int) -> int:
    """The 64-column panels of dk the single pass is built for: 1, 2, 4 or
    8 (dk padded up to the next)."""
    return next(n for n in (1, 2, 4, 8) if dk <= 64 * n)


def chunk_len(dk: int) -> int:
    """The chunk length the float32 kernel uses at head dim ``dk`` (0: no
    fit); the bfloat16 kernels use ``CHUNK``."""
    return build.function("mlstm_scan", "mlstm_scan_chunk", [ctypes.c_int])(dk)


def mlstm_scan(q, k, v, logf, i, *, scale: float | None = None,
               design: str | None = None):
    """q, k: (BH, S, dk); v: (BH, S, dv), CUDA tensors of one type, float32
    or bfloat16, feature dim contiguous; logf, i: (BH, S) gates (cast to
    float32).  Returns h (BH, S, dv) in q's type.  bfloat16 runs
    ``scan_plan`` of the shapes, with ``design`` forced if given; float32
    has the single pass only."""
    out = run(q, k, v, logf, i, scale=scale, design=design)
    if not isinstance(q, FakeTensor):
        launches.add()
    return out


def mlstm_scan_watchdog(q, k, v, logf, i, *, scale: float | None = None,
                        design: str | None = None):
    """``mlstm_scan`` on the watchdog build (``WATCHDOG_FLAGS``), counted
    in ``watchdog_launches`` alone."""
    out = run(q, k, v, logf, i, scale=scale, design=design,
              flags=WATCHDOG_FLAGS)
    watchdog_launches.add()
    return out


def run(q, k, v, logf, i, *, scale: float | None = None,
        design: str | None = None, flags: tuple = ()):
    """``mlstm_scan`` on the library built with the extra nvcc ``flags``
    (a diagnostic build), without counting a launch."""
    _check(q, k, v, logf, i)
    bh, s, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5 if scale is None else scale
    logf = logf.float().contiguous()
    i = i.float().contiguous()
    out = torch.empty((bh, s, dv), dtype=q.dtype, device=q.device)
    scratch = [None, None, None]
    fake = isinstance(q, FakeTensor)
    if q.dtype == torch.float32:
        if design not in (None, "single"):
            raise ValueError("mlstm_scan: float32 runs the single-pass "
                             "CUDA-core kernel only")
        if not fake and chunk_len(dk) == 0:
            raise ValueError(f"mlstm_scan: head dim {dk} leaves no room for "
                             "a chunk beside the state slice in shared memory")
        design, chunk = 0, 0
    else:
        plan = scan_plan(bh, s, dk, dv, design=design)
        design, chunk = DESIGNS[plan.design], plan.chunk
        if design and plan.n_chunks > 1:
            slots = (plan.n_chunks - 1) * bh
            scratch = [torch.empty(n, dtype=torch.float32, device=q.device)
                       for n in (slots * dk * dv, slots * dk, slots)]
        elif not design:
            # the pre-pass's rows a chunk: exp(la) and w, q . n_prev of
            # each dk panel, the decay tile (rows of CHUNK + 8)
            per = ((2 + single_pass_panels(dk)) * CHUNK
                   + CHUNK * (CHUNK + 8))
            scratch[0] = torch.empty(bh * plan.n_chunks * per,
                                     dtype=torch.float32, device=q.device)
    if fake:                                    # shapes alone: no launch
        return out
    fn = build.function("mlstm_scan", "mlstm_scan_fwd", _ARGTYPES, flags)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), logf.data_ptr(),
             i.data_ptr(), out.data_ptr(),
             *(0 if t is None else t.data_ptr() for t in scratch),
             bh, s, dk, dv,
             q.stride(0), q.stride(1), k.stride(0), k.stride(1),
             v.stride(0), v.stride(1), logf.stride(0), i.stride(0),
             out.stride(0), out.stride(1), float(scale), DTYPES[q.dtype],
             design, chunk, torch.cuda.current_stream(q.device).cuda_stream)
    if err >= TMA_REFUSED:
        raise ValueError(f"mlstm_scan: the driver refused a tensor map of "
                         f"q, k or v (CUresult {err - TMA_REFUSED})")
    build.check(err, "mlstm_scan")
    return out


def mlstm_scan_bwd(q, k, v, logf, i, dh, *, scale: float | None = None):
    """The gradient of ``mlstm_scan`` on the card.  q, k: (BH, S, dk); v,
    dh: (BH, S, dv), CUDA tensors of one type, float32 or bfloat16; logf,
    i: (BH, S) gates.  Returns (dq, dk, dv) contiguous in the inputs' type
    and (dlogf, di) float32.  Inputs that are not contiguous are copied
    first (bf16 ones counted in ``tma_copies``); ``scale`` defaults to dk
    ** -0.5."""
    return _backward(q, k, v, logf, i, dh, scale, (), (bwd_launches,))


def mlstm_scan_bwd_watchdog(q, k, v, logf, i, dh, *,
                            scale: float | None = None):
    """``mlstm_scan_bwd`` on the watchdog build (``WATCHDOG_FLAGS``),
    counted in ``bwd_watchdog_launches`` alone."""
    return _backward(q, k, v, logf, i, dh, scale, WATCHDOG_FLAGS,
                     (bwd_watchdog_launches,))


def _packed(t):
    """``t`` as the backward reads it: itself, or a fresh packed copy where
    it is not packed and 16-byte aligned; a bf16 copy (the tensor maps read
    packed rows) is counted in ``tma_copies``."""
    if t.is_contiguous() and build.aligned16(t):
        return t
    if t.dtype == torch.bfloat16:
        tma_copies.add()
    return t.clone(memory_format=torch.contiguous_format)


def bwd_scratch(bh: int, s: int, dk: int, dv: int, dtype, device) -> list:
    """The backward's scratch, in the entry point's order (None where the
    route reads nothing): la, the per-step rows, the chunk totals, C, n, dC,
    dn, P, Y, the shares, the bf16 copies of C and dC, the gradient
    kernel's bf16 operands dS o D and S, and the sums of E and F."""
    chunk = BWD_CHUNK
    nc = -(-s // chunk)

    def buf(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)
    nd, ne = -(-dk // 64), -(-dv // 64)
    if dtype == torch.bfloat16:
        # the states before and the gradients after each chunk as bf16
        # operand copies, nothing in float32; the tiles' shares of the
        # normaliser's row dots (ne + 1 rows a dk tile), of dA and dw (2
        # rows) and of <C, dC>
        f32 = (None,) * 4                                   # C, dC, P, Y
        bf = (buf(bh * nc * nd * ((ne + 3) * chunk + 1)),
              *(buf(bh, nc, *shape, dtype=torch.bfloat16)
                for shape in ((dk, dv), (dk, dv), (chunk, chunk),
                              (chunk, chunk))),
              buf(bh, nc, 3, chunk))
    else:
        f32 = (buf(bh, nc, dk, dv), buf(bh, nc, dk, dv),
               buf(bh, nc, chunk, chunk), buf(bh, nc, chunk, chunk))
        bf = (None,) * 6
    return [torch.empty((bh, nc * chunk), dtype=torch.float64, device=device),
            buf(4, bh, nc * chunk), buf(bh, nc),
            f32[0], buf(bh, nc, dk), f32[1], buf(bh, nc, dk),  # C, n, dC, dn
            f32[2], f32[3], *bf]


def _backward(q, k, v, logf, i, dh, scale, flags: tuple, counters: tuple):
    """One call of the backward's launches from the library built with
    ``flags``, added to each of ``counters`` once the driver took them."""
    _check(q, k, v, logf, i)
    if dh.device != q.device or dh.dtype != q.dtype or dh.shape != v.shape:
        raise ValueError(f"mlstm_scan_bwd: dh {tuple(dh.shape)} {dh.dtype} "
                         f"on {dh.device} does not match v {tuple(v.shape)} "
                         f"{q.dtype}")
    bh, s, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5 if scale is None else scale
    q, k, v, dh = (_packed(t) for t in (q, k, v, dh))
    logf = logf.float().contiguous()
    i = i.float().contiguous()
    dev = q.device
    grads = [torch.empty_like(t) for t in (q, k, v)]
    dlogf = torch.empty((bh, s), dtype=torch.float32, device=dev)
    di = torch.empty((bh, s), dtype=torch.float32, device=dev)
    scratch = bwd_scratch(bh, s, dk, dv, q.dtype, dev)
    if isinstance(q, FakeTensor):               # shapes alone: no launch
        return (*grads, dlogf, di)
    fn = build.function("mlstm_scan_bwd", "mlstm_scan_bwd", _BWD_ARGTYPES,
                        flags)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dh.data_ptr(),
             logf.data_ptr(), i.data_ptr(),
             *(t.data_ptr() for t in grads), dlogf.data_ptr(), di.data_ptr(),
             *(0 if t is None else t.data_ptr() for t in scratch), bh, s, dk,
             dv, float(scale),
             DTYPES[q.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if err >= TMA_REFUSED:
        raise ValueError(f"mlstm_scan_bwd: the driver refused a tensor map "
                         f"of q, k, v, dh or the states (CUresult "
                         f"{err - TMA_REFUSED})")
    build.check(err, "mlstm_scan_bwd")
    for c in counters:
        c.add()
    return (*grads, dlogf, di)


def _check(q, k, v, logf, i) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("logf", logf), ("i", i)):
        if not t.is_cuda and not isinstance(t, FakeTensor):
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
    dv = v.shape[-1]
    if k.shape != q.shape or v.shape[:2] != (bh, s):
        raise ValueError(f"mlstm_scan: q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f" and v {tuple(v.shape)} do not match")
    if dk % 4:
        raise ValueError(f"mlstm_scan: head dim {dk} is not a multiple of 4")
    if q.dtype == torch.bfloat16:
        if dk % 8 or dv % 8 or dk > MAX_DK:
            raise ValueError(f"mlstm_scan: bfloat16 takes dk and dv that are "
                             f"multiples of 8 and dk <= {MAX_DK}, got dk {dk}"
                             f" and dv {dv}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not build.aligned16(t):
                raise ValueError(f"mlstm_scan: bfloat16 {name} is read "
                                 "through tensor maps and 16-byte copies and "
                                 "must be 16-byte aligned, with strides that "
                                 "keep every row so")
    for name, t in (("logf", logf), ("i", i)):
        if tuple(t.shape) != (bh, s):
            raise ValueError(f"mlstm_scan: {name} must be (BH, S) = "
                             f"{(bh, s)}, got {tuple(t.shape)}")
