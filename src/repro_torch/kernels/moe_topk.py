"""The MoE router of one layer (K4) -- the Hopper kernel's wrapper.

The kernel is ``csrc/moe_topk.cu``, hand-written CUDA C++ for ``sm_90a``.
It replaces the reference package's Pallas TPU kernel ``moe_topk_pallas``
(kernels/moe_topk.py) and the capacity dispatch that follows it in the
reference's models/moe.py.  ``moe_route`` takes the router's logits to the
whole dispatch plan in one launch: per token a softmax over the experts
below ``n_valid``, the top ``k`` by masked-argmax passes (ties to the lowest
index), the picked weights divided by their sum and multiplied by the
router's scale; then each (token, choice) pair's slot in the (E, C) grid,
the token in each slot, the probabilities summed over tokens and the pairs
routed to each expert.  ``moe_topk`` runs the same kernel with the plan
switched off.  One launch a call, counted in ``launches`` for both.  What
bounds it and why it is one cluster of blocks is written at the top of the
CUDA source.  The plain versions are ``ref.moe_route_ref`` and
``ref.moe_topk_ref``.

``moe_route_bwd`` is the gradient of the weights and probability sums
with respect to the logits, ``router_bwd_kernel`` in the same source: one
warp a token, no atomics.  One launch a call, counted in
``bwd_launches``.  Its plain version is ``ref.moe_route_bwd_ref``;
``ops.moe_route`` and ``ops.moe_topk`` reach it through autograd.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .ref import Route

MAX_EXPERTS = 256       # MAXE in the CUDA source
MAX_TOP_K = 8           # MAXK
MAX_BLOCKS = 16         # MAXCL: the blocks of one cluster
THREADS = 512           # THREADS
MIN_TOKENS_PER_BLOCK = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = build.LaunchCounter()
bwd_launches = build.LaunchCounter()

_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_longlong] + [ctypes.c_int] * 4
             + [ctypes.c_void_p])


_BWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                 + [ctypes.c_float] + [ctypes.c_longlong] * 2 + [ctypes.c_int]
                 + [ctypes.c_void_p])


class Plan(NamedTuple):
    blocks: int             # one cluster when there is a capacity
    tokens_per_block: int
    values_per_lane: int    # experts a lane holds; a token takes G lanes


def group_lanes(n_experts: int, values_per_lane: int) -> int:
    """Lanes serving one token: the least power of two that holds them."""
    g = 1
    while g * values_per_lane < n_experts:
        g *= 2
    return g


def route_plan(t: int, n_experts: int) -> Plan:
    """Blocks of at least 128 tokens, at most 16 (one cluster); then the
    fewest experts a lane -- the most lanes a token, the shortest chains --
    that still serve all of a block's tokens in one round, else 16."""
    blocks = max(1, min(MAX_BLOCKS, -(-t // MIN_TOKENS_PER_BLOCK)))
    tpb = max(1, -(-t // blocks))
    for vpl in (2, 4, 8):
        g = group_lanes(n_experts, vpl)
        if g <= 32 and tpb * g <= THREADS:
            return Plan(blocks, tpb, vpl)
    return Plan(blocks, tpb, 16)


def moe_route(logits, top_k: int, *, capacity: int, n_valid: int | None = None,
              router_scale: float = 1.0) -> Route:
    """logits: (T, E) CUDA tensor, float32 or bfloat16, experts contiguous.
    Returns ``ref.Route``: weights (T, k) float32 (times ``router_scale``),
    idx (T, k) int32, slot (T, k) int32 (``E * capacity`` if dropped),
    slot_tok (E, capacity) int32 (T if empty), prob_sum (E,) float32,
    counts (E,) int32."""
    _check(logits, top_k)
    if capacity < 1:
        raise ValueError(f"moe_route: capacity {capacity}; the kernel takes "
                         "1 slot an expert or more")
    t, e = logits.shape
    if e * capacity >= 2 ** 31 or t * top_k >= 2 ** 31:
        raise ValueError(f"moe_route: {e} x {capacity} slots or {t} x "
                         f"{top_k} pairs do not fit int32")
    dev = logits.device
    out = Route(
        weights=torch.empty((t, top_k), dtype=torch.float32, device=dev),
        idx=torch.empty((t, top_k), dtype=torch.int32, device=dev),
        slot=torch.empty((t, top_k), dtype=torch.int32, device=dev),
        slot_tok=torch.empty((e, capacity), dtype=torch.int32, device=dev),
        prob_sum=torch.empty((e,), dtype=torch.float32, device=dev),
        counts=torch.empty((e,), dtype=torch.int32, device=dev))
    _launch(logits, top_k, n_valid, capacity, router_scale,
            [o.data_ptr() for o in out])
    return out


def moe_topk(logits, top_k: int, n_valid: int | None = None):
    """logits: (T, E) CUDA tensor, float32 or bfloat16, experts contiguous.
    Returns (weights (T, k) float32, indices (T, k) int32)."""
    _check(logits, top_k)
    t = logits.shape[0]
    w = torch.empty((t, top_k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((t, top_k), dtype=torch.int32, device=logits.device)
    _launch(logits, top_k, n_valid, 0, 1.0,
            [w.data_ptr(), idx.data_ptr(), None, None, None, None])
    return w, idx


def moe_route_bwd(logits, idx, weights, dweights, dprob_sum=None, *,
                  n_valid: int | None = None, router_scale: float = 1.0):
    """The gradient with respect to ``logits`` (T, E) CUDA float32 or
    bfloat16, experts contiguous, of the router's ``weights`` (T, k)
    float32 (times ``router_scale``) at the picks ``idx`` (T, k) int32,
    given their gradient ``dweights`` (T, k) and the probability sums'
    ``dprob_sum`` (E,) (None: ``moe_topk``'s gradient).  Returns dlogits
    (T, E) in logits' type."""
    _check(logits, idx.shape[1] if idx.dim() == 2 else 0)
    t, e = logits.shape
    k = idx.shape[1]
    if router_scale == 0:
        raise ValueError("moe_route_bwd: router_scale 0 leaves no weights "
                         "to differentiate")
    for name, x, dt in (("idx", idx, torch.int32), ("weights", weights,
                                                     torch.float32),
                        ("dweights", dweights, torch.float32)):
        if x.device != logits.device or tuple(x.shape) != (t, k):
            raise ValueError(f"moe_route_bwd: {name} {tuple(x.shape)} on "
                             f"{x.device} is not ({t}, {k}) on "
                             f"{logits.device}")
        if x.dtype != dt:
            raise TypeError(f"moe_route_bwd: {name} is {x.dtype}, not {dt}")
    idx, weights, dweights = (x.contiguous() for x in (idx, weights, dweights))
    if dprob_sum is not None:
        if dprob_sum.device != logits.device or tuple(dprob_sum.shape) != (e,):
            raise ValueError(f"moe_route_bwd: dprob_sum {tuple(dprob_sum.shape)}"
                             f" is not ({e},) on {logits.device}")
        dprob_sum = dprob_sum.float().contiguous()
    out = torch.empty((t, e), dtype=logits.dtype, device=logits.device)
    fn = build.function("moe_topk", "moe_route_bwd", _BWD_ARGTYPES)
    err = fn(logits.data_ptr(), idx.data_ptr(), weights.data_ptr(),
             dweights.data_ptr(),
             None if dprob_sum is None else dprob_sum.data_ptr(),
             out.data_ptr(), t, e, k, e if n_valid is None else int(n_valid),
             float(router_scale), logits.stride(0), out.stride(0),
             DTYPES[logits.dtype],
             torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(err, "moe_route_bwd")
    bwd_launches.add()
    return out


def _launch(logits, top_k, n_valid, capacity, scale, ptrs) -> None:
    t, e = logits.shape
    n_valid = e if n_valid is None else int(n_valid)
    plan = route_plan(t, e)
    fn = build.function("moe_topk", "moe_route_fwd", _ARGTYPES)
    err = fn(logits.data_ptr(), *ptrs, t, e, top_k, n_valid, capacity,
             float(scale), logits.stride(0), DTYPES[logits.dtype], plan.blocks,
             plan.tokens_per_block, plan.values_per_lane,
             torch.cuda.current_stream(logits.device).cuda_stream)
    build.check(err, "moe_route" if capacity else "moe_topk")
    launches.add()


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
