"""Each kernel's work -- operations and bytes -- and the hook that counts it.

The kernels are bound with ``ctypes``, so a counter of dispatched PyTorch
operations (``torch.utils.flop_counter.FlopCounterMode``) never sees them
on the card, and on the CPU it would see their plain versions, which do
dense work (``grouped_flash_ref`` also computes the pairs the mask drops).
So each call of K1-K4, or of their backward kernels, reports its own work,
computed from its inputs' shapes by one formula on both devices:

* ``flash`` / ``flash_bwd``  -- K1 and its backward
* ``decode``                 -- K2 (the live positions of this call)
* ``scan`` / ``scan_bwd``    -- K3 and its backward
* ``route`` / ``topk`` / ``route_bwd`` -- K4 with and without its plan,
  and its backward

Bytes count each input read once and each output written once; operations
are those the algorithm needs, at the peak rate of ``dtype``.  These are
the counts behind each kernel's bound in ``chip_smoke.py``
(``roofline.analysis.bound_ms``).

``counted(fwd, bwd)`` wraps an entry point of ``ops``.  Outside
``recording()`` it calls the entry point and does nothing else.  Inside,
it records the call's ``Work`` and runs the call ``hidden()``, so that the
roofline's counter counts no operation inside a kernel's wrapper or plain
version a second time; where a gradient is wanted, the backward's ``Work``
is recorded when the backward runs, again with its own operations hidden.
Hidden operations still run under every dispatch mode (a ``FakeTensorMode``
keeps them fake), and the counter still sees what they allocate.  Counting changes no result and picks no path: the
entry point runs as it would, on the device of its tensors.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch


class Work(NamedTuple):
    name: str
    ops: float
    bytes: float
    dtype: torch.dtype      # the type whose peak rate bounds the operations


def flash_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask keeps, per batch row and head; queries
    are the last ``sq`` of the ``sk`` positions."""
    i = np.arange(sq, dtype=np.int64)
    offs = sk - sq if causal else 0
    hi = np.minimum(sk, i + offs + 1) if causal else np.full(sq, sk)
    lo = np.maximum(0, i + offs - window + 1) if window > 0 else 0
    return int(np.maximum(0, hi - lo).sum())


def flash(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """K1, q (B, Sq, H, dk), k (B, Sk, KH, dk), v (B, Sk, KH, dv): q, k
    and v read once and the output written once, each at its own head dim;
    2 dk operations a kept pair for Q K^T and 2 dv for P V."""
    b, sq, h, dk = q.shape
    sk, dv = k.shape[1], v.shape[3]
    nbytes = (q.numel() + k.numel() + v.numel() + b * sq * h * dv) \
        * q.element_size()
    ops = 2 * b * h * (dk + dv) * flash_pairs(sq, sk, causal, window)
    return Work("flash_attention", ops, nbytes, q.dtype)


def flash_bwd(q, k, v, *, causal: bool = True, window: int = 0, scale=None):
    """K1's backward: q, k, v, o, dO and the row logsumexp read once, dq,
    dk and dv written once; 6 dk + 4 dv operations a kept pair (S and dP
    recomputed, dV, dQ and dK)."""
    b, sq, h, dk = q.shape
    sk, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    rows, cols = 2 * b * sq * h, 2 * b * sk * kh
    nbytes = ((rows + cols) * dk + (rows + cols) * dv) * q.element_size() \
        + b * h * sq * 4
    ops = b * h * (6 * dk + 4 * dv) * flash_pairs(sq, sk, causal, window)
    return Work("flash_attention_bwd", ops, nbytes, q.dtype)


def decode(q, k, v, lengths, *, scale=None):
    """K2, q (B, 1, H, hd), k, v (B, S, KH, hd): q read and the output
    written once, the live positions' K and V read once; 4 hd operations a
    (head, live position).  ``lengths`` is one int for every row (the
    model's decode step), or a (B,) tensor, which is read (a device sync on
    the card; a fake tensor cannot be read)."""
    b, _, h, hd = q.shape
    kh = k.shape[2]
    es = q.element_size()
    if isinstance(lengths, int):
        live = b * min(lengths, k.shape[1])
    else:
        live = int(lengths.clamp(max=k.shape[1]).sum())
    nbytes = 2 * q.numel() * es + 2 * live * kh * hd * es + b * 4
    return Work("decode_attention", 4 * h * hd * live, nbytes, q.dtype)


def scan(q, k, v, logf, i, *, scale=None):
    """K3, q, k (BH, S, dk), v (BH, S, dv): q, k, v read once, out written
    once, the two float32 gates read once; 4 dk dv operations a step."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    nbytes = (2 * q.numel() + 2 * v.numel()) * q.element_size() + 2 * bh * s * 4
    return Work("mlstm_scan", 4 * bh * s * dk * dv, nbytes, q.dtype)


def scan_bwd(q, k, v, logf, i, *, scale=None):
    """K3's backward: q, k, v, dh and the two gates read once, dq, dk, dv
    and the two gate gradients written once; 8 dk dv operations a step."""
    bh, s, dk = q.shape
    dv = v.shape[-1]
    nbytes = (4 * q.numel() + 3 * v.numel()) * q.element_size() + 4 * bh * s * 4
    return Work("mlstm_scan_bwd", 8 * bh * s * dk * dv, nbytes, q.dtype)


def route(logits, top_k: int, *, capacity: int, n_valid=None,
          router_scale: float = 1.0):
    """K4 with its plan: each logit read once; weights, indices and slots
    (T, k), the slot tokens (E, C), the probability sums and counts (E,)
    written once; (5 + 2k) float32 operations a logit (mask, max, exp,
    sum, divide; a compare and a select per argmax pass)."""
    t, e = logits.shape
    nbytes = (logits.numel() * logits.element_size() + 12 * t * top_k
              + 4 * e * capacity + 8 * e)
    return Work("moe_topk", t * e * (5 + 2 * top_k), nbytes, torch.float32)


def topk(logits, top_k: int, n_valid=None):
    """K4's top k alone: the logits read once, weights and indices (T, k)
    written once; the operations of ``route``."""
    t, e = logits.shape
    nbytes = logits.numel() * logits.element_size() + 8 * t * top_k
    return Work("moe_topk", t * e * (5 + 2 * top_k), nbytes, torch.float32)


def route_bwd(logits, top_k: int, **_):
    """K4's backward: the logits read and their gradient written once, the
    picks, weights and their gradient (T, k) and the probability sums'
    gradient (E,) read once; about 10 float32 operations a logit."""
    t, e = logits.shape
    nbytes = (2 * logits.numel() * logits.element_size() + 12 * t * top_k
              + 4 * e)
    return Work("moe_route_bwd", 10 * t * e, nbytes, torch.float32)


# ------------------------------------------------------------- the hook
_local = threading.local()


@contextlib.contextmanager
def recording():
    """Collect the ``Work`` of every counted call made in this thread
    inside the block (backward passes included) into the list it yields."""
    prev = getattr(_local, "sink", None)
    _local.sink = sink = []
    try:
        yield sink
    finally:
        _local.sink = prev


def hidden() -> bool:
    """Whether this thread runs inside a counted call: its operations are
    the kernel's, whose ``Work`` stands for them."""
    return getattr(_local, "depth", 0) > 0


@contextlib.contextmanager
def _hidden():
    """No counter counts the block's operations, and no counted call
    inside it records."""
    depth = getattr(_local, "depth", 0)
    _local.depth = depth + 1
    try:
        yield
    finally:
        _local.depth = depth


def counted(fwd, bwd=None):
    """Decorate an entry point: ``fwd(*args, **kw)`` gives its call's
    ``Work``, ``bwd`` (if it has a gradient) its backward's."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            sink = getattr(_local, "sink", None)
            if sink is None or getattr(_local, "depth", 0):
                return fn(*args, **kw)
            sink.append(fwd(*args, **kw))
            spots = [n for n, a in enumerate(args)
                     if isinstance(a, torch.Tensor)]
            if (bwd is None or not torch.is_grad_enabled()
                    or not any(args[n].requires_grad for n in spots)):
                with _hidden():
                    return fn(*args, **kw)

            kind = []

            def call(*tensors):
                full = list(args)
                for n, t in zip(spots, tensors):
                    full[n] = t
                out = fn(*full, **kw)
                kind.append(type(out))
                return out
            out = _Counted.apply(call, (sink, bwd(*args, **kw)),
                                 *(args[n] for n in spots))
            if issubclass(kind[0], torch.Tensor):
                return out[0]
            return kind[0](*out) if hasattr(kind[0], "_fields") else out
        return run
    return deco


class _Counted(torch.autograd.Function):
    """The entry point recorded under its own autograd graph: the
    backward records its ``Work`` and differentiates that graph with the
    dispatch modes off."""

    @staticmethod
    def forward(ctx, call, record, *tensors):
        ctx.set_materialize_grads(False)
        with _hidden(), torch.enable_grad():
            ins = [t.detach().requires_grad_(t.requires_grad) for t in tensors]
            out = call(*ins)
        outs = tuple(out) if isinstance(out, tuple) else (out,)
        ctx.ins, ctx.outs, ctx.record = ins, outs, record
        ret = tuple(o.detach() for o in outs)
        ctx.mark_non_differentiable(*[o for o in ret
                                      if not o.is_floating_point()])
        return ret

    @staticmethod
    def backward(ctx, *grads):
        sink, w = ctx.record
        sink.append(w)
        pairs = [(o, g) for o, g in zip(ctx.outs, grads)
                 if g is not None and o.requires_grad]
        wants = [x for x in ctx.ins if x.requires_grad]
        got = iter(())
        if pairs and wants:
            with _hidden():
                got = iter(torch.autograd.grad(
                    [o for o, _ in pairs], wants, [g for _, g in pairs],
                    allow_unused=True))
        return (None, None) + tuple(next(got, None) if x.requires_grad
                                    else None for x in ctx.ins)
