"""Single-token decode attention -- the Hopper kernel's wrapper.

The kernel is ``csrc/decode_attention.cu``, hand-written CUDA C++ for
``sm_90a``.  It replaces the reference package's Pallas TPU kernel
``decode_attention_pallas`` (kernels/decode_attention.py): one query token per
row attends to the cache positions below the row's live length, as an
online softmax in float32.

Split-KV in one launch: the grid is (KV head, batch row, split), a block
serves all G query heads of its (row, KV head) over one range of cache
positions, and the last block of each (row, KV head) to finish merges the
ranges' partial softmax states.  ``split_plan`` cuts the cache into ranges
from its shape alone; ``ref.grouped_decode_split_ref`` is the same split and
merge in plain PyTorch.  What bounds the kernel on the card and what the
design does about it is written at the top of the CUDA source.  The plain
version is ``ref.grouped_decode_ref``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 80, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 16          # query heads per KV head (MAXG in the CUDA source)
SPLIT_TILE = 64         # a split's range is a multiple of this many positions
BLOCKS_PER_SM = 4       # the grid the split plan aims at
H100_SMS = 132

launches = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 10 + [ctypes.c_float]
             + [ctypes.c_int] * 2 + [ctypes.c_void_p])

_counters: dict = {}
_counters_lock = threading.Lock()


def split_plan(s_max: int, b: int, kh: int) -> tuple:
    """``(n_split, chunk)``: split ``i`` covers cache positions ``[i * chunk,
    min(s_max, (i + 1) * chunk))``, so the ranges cover ``[0, s_max)`` once.
    ``chunk`` is a multiple of ``SPLIT_TILE``, and ``n_split`` is chosen so
    that the grid of ``b * kh * n_split`` blocks comes near ``BLOCKS_PER_SM``
    blocks on each of the H100's SMs.  Depends on the cache's shape only:
    the live lengths stay on the device."""
    tiles = -(-s_max // SPLIT_TILE)
    want = max(1, min(tiles, round(BLOCKS_PER_SM * H100_SMS / (b * kh))))
    chunk = -(-tiles // want) * SPLIT_TILE
    return -(-s_max // chunk), chunk


def _counter_buffer(device, stream, n: int):
    """The kernel's per-(row, KV head) arrival counters for this device and
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
    _check(q, k, v, lengths)
    b, _, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    n_split, chunk = split_plan(s, b, kh)
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    part = torch.empty(b * kh * n_split * (h // kh) * (hd + 2),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _counter_buffer(q.device, stream, b * kh)
    fn = build.function("decode_attention", "decode_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             out.data_ptr(), part.data_ptr(), counters.data_ptr(),
             b, s, h, kh, n_split, chunk,
             q.stride(0), q.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             out.stride(0), out.stride(2),
             float(scale), DTYPES[q.dtype], hd, stream)
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
