"""Single-token decode attention -- the Hopper kernels' wrapper.

The kernels are ``csrc/decode_attention.cu``, hand-written CUDA C++ for
``sm_90a``.  They replace the reference package's Pallas TPU kernel
``decode_attention_pallas`` (kernels/decode_attention.py): one query token
per row attends to the cache positions below the row's live length, as an
online softmax in float32.

Split-KV in one launch.  bfloat16 runs ``decode_mma_kernel``: the grid is
(split, KV head, batch row), a block serves all G query heads of its (row,
KV head) as the rows of ``mma.sync`` tiles over its share of the row's live
positions, and the splits of a (row, KV head) are one thread-block cluster
that merges their partial softmax states through distributed shared
memory.  ``mma_plan`` chooses the cluster and the number of clusters from
the cache's shape alone; the kernel divides each row's live length among
the splits on the device (``mma_ranges``).  float32 runs
``decode_split_kernel``: fixed ranges of ``chunk`` positions
(``split_plan``), merged by the last block to arrive.
``ref.grouped_decode_split_ref`` is the float32 kernel's split and merge in
plain PyTorch, and ``ref.grouped_decode_mma_ref`` the bf16 kernel's.
What bounds the kernels on the card and what the designs do about it is
written at the top of the CUDA source.  The plain version is
``ref.grouped_decode_ref``.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import build

HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 16          # query heads per KV head (MAXG in the CUDA source)
SPLIT_TILE = 64         # a split's range is a multiple of this many positions
BLOCKS_PER_SM = 4       # the grid the split plan aims at
H100_SMS = 132
MAX_CLUSTER = 8         # blocks of a thread-block cluster (portable)
STAMP_FLAGS = ("-DDECODE_STAMPS",)
# the diagnostic build whose launch bounds make ptxas spill in every
# instantiation of the bf16 kernel (the GPU tests hold it to the plain
# version); its launches are counted in ``spill_launches`` alone
SPILL_FLAGS = ("-DREPRO_DECODE_SPILL",)

launches = build.LaunchCounter()
spill_launches = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 10 + [ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])

_counters: dict = {}
_counters_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def split_plan(s_max: int, b: int, kh: int) -> tuple:
    """``(n_split, chunk)`` of the float32 split kernel: split ``i``
    covers cache positions ``[i * chunk, min(s_max, (i + 1) * chunk))``,
    so the ranges cover ``[0, s_max)`` once.  ``chunk`` is a multiple of
    ``SPLIT_TILE``, and ``n_split`` is chosen so that the grid of ``b * kh
    * n_split`` blocks comes near ``BLOCKS_PER_SM`` blocks on each of the
    H100's SMs.  Depends on the cache's shape only: the live lengths stay
    on the device."""
    tiles = -(-s_max // SPLIT_TILE)
    want = max(1, min(tiles, round(BLOCKS_PER_SM * H100_SMS / (b * kh))))
    chunk = -(-tiles // want) * SPLIT_TILE
    return -(-s_max // chunk), chunk


@functools.lru_cache(maxsize=None)
def mma_plan(s_max: int, b: int, kh: int) -> tuple:
    """``(cluster, groups)`` of the bf16 kernel: each (row, KV head) runs
    on ``cluster * groups`` blocks, ``groups`` thread-block clusters of
    ``cluster`` (1, 2, 4 or 8) blocks.  The blocks are of 8 warps (4 at hd
    80), against the split kernel's 4: a pair takes the largest power of
    two of them that keeps the grid within one block an SM (llama3.2-1b's
    64 pairs 2, hymba-1.5b's 40 pairs 2, 128 pairs and more 1), no more
    than the split plan's count.  Where that count passes a cluster (a long
    cache over few pairs), it is kept, as ``groups`` clusters of
    ``MAX_CLUSTER``.  Depends on the cache's shape only."""
    n, _ = split_plan(s_max, b, kh)
    if n > MAX_CLUSTER:
        return MAX_CLUSTER, -(-n // MAX_CLUSTER)
    fit = min(n, max(1, H100_SMS // (b * kh)))
    return 1 << (fit.bit_length() - 1), 1


def mma_ranges(length: int, n_split: int) -> list:
    """The positions ``[lo, hi)`` of each of the bf16 kernel's ``n_split``
    splits of a row ``length`` long (clamped to the cache): equal shares,
    computed on the device from the row's live length."""
    return [(i * length // n_split, (i + 1) * length // n_split)
            for i in range(n_split)]


def _counter_buffer(device, stream, n: int):
    """The kernels' per-(row, KV head) arrival counters for this device and
    stream, at least ``n`` of them.  Zeroed when made; every launch leaves
    them zero.  Calls on one stream run in order, so they can share it."""
    key = (device.index, stream)
    with _counters_lock:
        buf = _counters.get(key)
        if buf is None or buf.numel() < n:
            buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
            _counters[key] = buf
        return buf


def decode_attention(q, k, v, lengths, *, scale: float | None = None):
    """q: (B, 1, H, hd); k, v: (B, S, KH, hd) caches; lengths: (B,) int32
    live lengths, all CUDA tensors.  Returns (B, 1, H, hd) in q's dtype."""
    return _decode(q, k, v, lengths, scale, ())


def decode_attention_spill(q, k, v, lengths, *, scale: float | None = None):
    """``decode_attention`` on the build made to spill (``SPILL_FLAGS``),
    counted in ``spill_launches`` alone."""
    return _decode(q, k, v, lengths, scale, SPILL_FLAGS, spill_launches)


def _decode(q, k, v, lengths, scale, flags: tuple, counter=launches):
    """``decode_attention`` on the build of the source with the extra nvcc
    ``flags`` (``STAMP_FLAGS`` for the study's stamps), counted in
    ``counter``."""
    _check(q, k, v, lengths)
    b, _, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    mma = q.dtype == torch.bfloat16
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    if mma:
        cluster, groups = mma_plan(s, b, kh)
        n_split, chunk, parts = cluster * groups, 0, groups
    else:
        (n_split, chunk), cluster = split_plan(s, b, kh), 0
        parts = n_split
    part = (torch.empty(b * kh * parts * (h // kh) * (hd + 2),
                        dtype=torch.float32, device=q.device)
            if parts > 1 or not mma else None)
    if isinstance(q, FakeTensor):               # shapes alone: no launch
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = (None if part is None
                else _counter_buffer(q.device, stream, b * kh).data_ptr())
    fn = build.function("decode_attention", "decode_attention_fwd", _ARGTYPES,
                        flags)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), None if part is None else part.data_ptr(),
             counters, b, s, h, kh, n_split, chunk,
             q.stride(0), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.stride(0), out.stride(2),
             float(scale), DTYPES[q.dtype], hd, cluster, stream)
    build.check(err, "decode_attention")
    counter.add()
    return out


def _check(q, k, v, lengths) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_cuda and not isinstance(t, FakeTensor):
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
    for name, t in (("k", k), ("v", v)):
        if not build.aligned16(t):
            raise ValueError(f"decode_attention: {name} is read in 16-byte "
                             "rows and must be 16-byte aligned, with strides "
                             "that keep every row so")
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
