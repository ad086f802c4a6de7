"""Kernel entry points, dispatched by the device of the tensors they get.

A CUDA tensor goes to the hand-written Hopper kernel, which launches or
raises; a CPU tensor goes to the plain version in ``ref``.  There is no
backend switch that could pick the plain path on the card, and no fallback
from a failed build or launch.

* ``grouped_flash`` / ``flash_attention``   -- prefill attention (K1)
* ``grouped_decode`` / ``decode_attention`` -- decode attention (K2)
* ``mlstm_scan``                            -- chunkwise mLSTM scan (K3)
* ``moe_route``                             -- MoE router and dispatch plan (K4)
* ``moe_topk``                              -- the router's top k alone (K4)

The ``grouped_*`` forms take the model's layout (``(B, S, H, hd)`` queries,
``(B, S, KH, hd)`` keys and values); the others the reference package's
``(BH, S, D)`` signatures.

Gradients.  On the CPU the plain versions are differentiated by autograd.
On the card each kernel that a training path runs goes through a
``torch.autograd.Function`` when a gradient is wanted, whose backward is
that kernel's backward kernel and nothing else: ``FlashAttention`` (K1, its
forward keeping the row logsumexp; MLA's 192 / 128 too), ``MlstmScan``
(K3) and ``MoeRoute`` / ``MoeTopk`` (K4: the gradient of the weights and
of the probability sums; the integer outputs have none).  K2 runs only in
decode, which records no gradient.
"""
from __future__ import annotations

import torch

from . import ref
from .decode_attention import decode_attention as _decode_cuda
from .flash_attention import flash_attention as _flash_cuda
from .flash_attention import flash_attention_bwd as _flash_bwd_cuda
from .mlstm_scan import mlstm_scan as _mlstm_cuda
from .mlstm_scan import mlstm_scan_bwd as _mlstm_bwd_cuda
from .moe_topk import moe_route as _moe_route_cuda
from .moe_topk import moe_route_bwd as _moe_route_bwd_cuda
from .moe_topk import moe_topk as _moe_topk_cuda


def _on_cuda(t, op: str) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no path for tensors on {t.device}")


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class FlashAttention(torch.autograd.Function):
    """K1 with a gradient: the forward kernel, keeping its output and row
    logsumexp, and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = _flash_cuda(q, k, v, causal=causal, window=window,
                               scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = _flash_bwd_cuda(q, k, v, out, lse, dout, causal=causal,
                                     window=window, scale=scale)
        return dq, dk, dv, None, None, None


class MlstmScan(torch.autograd.Function):
    """K3 with a gradient: the forward kernel, then the backward kernel,
    which recomputes the chunk states from the inputs."""

    @staticmethod
    def forward(ctx, q, k, v, logf, i, scale):
        ctx.save_for_backward(q, k, v, logf, i)
        ctx.scale = scale
        return _mlstm_cuda(q, k, v, logf, i, scale=scale)

    @staticmethod
    def backward(ctx, dh):
        q, k, v, logf, i = ctx.saved_tensors
        dq, dk, dv, dlogf, di = _mlstm_bwd_cuda(q, k, v, logf, i, dh,
                                                scale=ctx.scale)
        return dq, dk, dv, dlogf.to(logf.dtype), di.to(i.dtype), None


class MoeRoute(torch.autograd.Function):
    """K4 with a gradient: the router and its plan, and the backward
    kernel from the weights' and probability sums' gradients to the
    logits'."""

    @staticmethod
    def forward(ctx, logits, top_k, capacity, n_valid, router_scale):
        r = _moe_route_cuda(logits, top_k, capacity=capacity, n_valid=n_valid,
                            router_scale=router_scale)
        ctx.save_for_backward(logits, r.idx, r.weights)
        ctx.args = (n_valid, router_scale)
        ctx.mark_non_differentiable(r.idx, r.slot, r.slot_tok, r.counts)
        return tuple(r)

    @staticmethod
    def backward(ctx, dweights, _idx, _slot, _slot_tok, dprob_sum, _counts):
        logits, idx, weights = ctx.saved_tensors
        n_valid, router_scale = ctx.args
        return (_moe_route_bwd_cuda(logits, idx, weights, dweights, dprob_sum,
                                    n_valid=n_valid, router_scale=router_scale),
                None, None, None, None)


class MoeTopk(torch.autograd.Function):
    """K4's top k alone with a gradient: the backward kernel with no
    probability sums."""

    @staticmethod
    def forward(ctx, logits, top_k, n_valid):
        w, idx = _moe_topk_cuda(logits, top_k, n_valid=n_valid)
        ctx.save_for_backward(logits, idx, w)
        ctx.n_valid = n_valid
        ctx.mark_non_differentiable(idx)
        return w, idx

    @staticmethod
    def backward(ctx, dweights, _idx):
        logits, idx, w = ctx.saved_tensors
        return (_moe_route_bwd_cuda(logits, idx, w, dweights,
                                    n_valid=ctx.n_valid), None, None)


def grouped_flash(q, k, v, *, causal: bool = True, window: int = 0,
                  scale: float | None = None):
    """q: (B, Sq, H, hd); k: (B, Sk, KH, hd); v: (B, Sk, KH, hdv) ->
    (B, Sq, H, hdv); hdv differs from hd only for MLA (192, 128)."""
    if _on_cuda(q, "grouped_flash"):
        if _wants_grad(q, k, v):
            return FlashAttention.apply(q, k, v, causal, window, scale)
        return _flash_cuda(q, k, v, causal=causal, window=window, scale=scale)
    return ref.grouped_flash_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)


def grouped_decode(q, k, v, lengths, *, scale: float | None = None):
    """q: (B, 1, H, hd); k, v: (B, S, KH, hd); lengths: (B,) int32."""
    if _on_cuda(q, "grouped_decode"):
        return _decode_cuda(q, k, v, lengths, scale=scale)
    return ref.grouped_decode_ref(q, k, v, lengths, scale=scale)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """q: (BH, Sq, D); k: (BH, Sk, D); v: (BH, Sk, Dv) -> (BH, Sq, Dv)."""
    return grouped_flash(q[:, :, None], k[:, :, None], v[:, :, None],
                         causal=causal, window=window, scale=scale)[:, :, 0]


def decode_attention(q, k, v, lengths, *, scale: float | None = None):
    """q: (BH, 1, D); k, v: (BH, S, D); lengths: (BH,) int32."""
    return grouped_decode(q[:, :, None], k[:, :, None], v[:, :, None],
                          lengths, scale=scale)[:, :, 0]


def mlstm_scan(q, k, v, logf, i, *, scale: float | None = None):
    """q, k: (BH, S, dk); v: (BH, S, dv); logf, i: (BH, S) -> h (BH, S, dv).
    ``scale`` defaults to dk ** -0.5."""
    if _on_cuda(q, "mlstm_scan"):
        if _wants_grad(q, k, v, logf, i):
            return MlstmScan.apply(q, k, v, logf, i, scale)
        return _mlstm_cuda(q, k, v, logf, i, scale=scale)
    return ref.mlstm_chunkwise_ref(q, k, v, logf, i, scale=scale)


def moe_topk(logits, top_k: int, n_valid: int | None = None):
    """logits: (T, E) -> (weights (T, k) float32, indices (T, k) int32)."""
    if _on_cuda(logits, "moe_topk"):
        if _wants_grad(logits):
            return MoeTopk.apply(logits, top_k, n_valid)
        return _moe_topk_cuda(logits, top_k, n_valid=n_valid)
    return ref.moe_topk_ref(logits, top_k, n_valid=n_valid)


def moe_route(logits, top_k: int, *, capacity: int, n_valid: int | None = None,
              router_scale: float = 1.0):
    """logits: (T, E) -> ``ref.Route``: weights, idx, slot (T, k), slot_tok
    (E, capacity), prob_sum and counts (E,)."""
    if _on_cuda(logits, "moe_route"):
        if _wants_grad(logits):
            return ref.Route(*MoeRoute.apply(logits, top_k, capacity, n_valid,
                                             router_scale))
        return _moe_route_cuda(logits, top_k, capacity=capacity,
                               n_valid=n_valid, router_scale=router_scale)
    return ref.moe_route_ref(logits, top_k, capacity=capacity, n_valid=n_valid,
                             router_scale=router_scale)
