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

Counting.  Each entry point that reaches a kernel reports its call's
operations and bytes (and its backward's) to ``work.recording()``, which
``roofline.analysis.analyze`` opens; outside it the decorator only calls
the entry point.

DTensors.  An entry point given DTensors (a program sharded over a
``DeviceMesh``, as the dry-run traces it) runs the kernel on each rank's
shard under ``torch.distributed.tensor.experimental.local_map``, the
counterpart of the reference's kernel inside ``shard_map``: K1 and K2 on
batch rows over the data axes and heads over the model axis (``_heads``
says when the heads shard), K3 on its BH rows and K4 on its tokens, each as
the rows arrive.  ``local_map`` moves each input to those placements
first, so a shard of another layout is redistributed there, as GSPMD
would; each shard is made contiguous there (``_local``), so a shard that
arrives as a view reaches the kernel, never the plain version.  The
autograd functions work through it unchanged (each input's gradient the
whole of it: every rank's computation covers what its placements say),
and the count is of the rank's shapes.  K4's plan is then each rank's own,
over its tokens, with the capacity the caller gives for them; its slot
tokens are sharded on the slot dim and its sums are partial over the ranks
of the tokens (the MoE layer gives it every token, ``models/moe.py``).

Fake tensors.  A fake CUDA tensor (``FakeTensorMode``, which the dry-run
traces under) reaches the kernel's wrapper, which checks it as it checks a
real one, allocates the same outputs and buffers, and returns before the
launch: shapes and dtypes alone, no launch counted, the work recorded as
the real call's.  A fake CPU tensor runs the plain version, as a CPU
tensor does.  A meta tensor still raises.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from . import ref, work
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
    if isinstance(q, DTensor):
        return _by_heads(_grouped_flash, q, k, v,
                         causal=causal, window=window, scale=scale)
    return _grouped_flash(q, k, v, causal=causal, window=window, scale=scale)


@work.counted(work.flash, work.flash_bwd)
def _grouped_flash(q, k, v, *, causal: bool = True, window: int = 0,
                   scale: float | None = None):
    if _on_cuda(q, "grouped_flash"):
        if _wants_grad(q, k, v):
            return FlashAttention.apply(q, k, v, causal, window, scale)
        return _flash_cuda(q, k, v, causal=causal, window=window, scale=scale)
    return ref.grouped_flash_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)


def grouped_decode(q, k, v, lengths, *, scale: float | None = None):
    """q: (B, 1, H, hd); k, v: (B, S, KH, hd); lengths: (B,) int32, or one
    int, every row's live length."""
    if isinstance(q, DTensor):
        return _by_heads(_grouped_decode, q, k, v, lengths, scale=scale)
    return _grouped_decode(q, k, v, lengths, scale=scale)


@work.counted(work.decode)
def _grouped_decode(q, k, v, lengths, *, scale: float | None = None):
    if isinstance(lengths, int):
        lengths = torch.full((q.shape[0],), lengths, dtype=torch.int32,
                             device=q.device)
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
    if isinstance(q, DTensor):
        rows = row_placements(q)
        return on_shards(_mlstm_scan, (rows,) * 5, rows, q, k, v, logf, i,
                      scale=scale)
    return _mlstm_scan(q, k, v, logf, i, scale=scale)


@work.counted(work.scan, work.scan_bwd)
def _mlstm_scan(q, k, v, logf, i, *, scale: float | None = None):
    if _on_cuda(q, "mlstm_scan"):
        if _wants_grad(q, k, v, logf, i):
            return MlstmScan.apply(q, k, v, logf, i, scale)
        return _mlstm_cuda(q, k, v, logf, i, scale=scale)
    return ref.mlstm_chunkwise_ref(q, k, v, logf, i, scale=scale)


def moe_topk(logits, top_k: int, n_valid: int | None = None):
    """logits: (T, E) -> (weights (T, k) float32, indices (T, k) int32)."""
    if isinstance(logits, DTensor):
        rows = row_placements(logits)
        return on_shards(_moe_topk, (rows, None, None), (rows, rows), logits,
                      top_k, n_valid)
    return _moe_topk(logits, top_k, n_valid)


@work.counted(work.topk, work.route_bwd)
def _moe_topk(logits, top_k: int, n_valid: int | None = None):
    if _on_cuda(logits, "moe_topk"):
        if _wants_grad(logits):
            return MoeTopk.apply(logits, top_k, n_valid)
        return _moe_topk_cuda(logits, top_k, n_valid=n_valid)
    return ref.moe_topk_ref(logits, top_k, n_valid=n_valid)


def moe_route(logits, top_k: int, *, capacity: int, n_valid: int | None = None,
              router_scale: float = 1.0):
    """logits: (T, E) -> ``ref.Route``: weights, idx, slot (T, k), slot_tok
    (E, capacity), prob_sum and counts (E,).  On DTensors each rank plans
    its own tokens with ``capacity`` slots an expert (the module docstring
    says how the outputs are placed)."""
    if isinstance(logits, DTensor):
        rows = row_placements(logits)
        slots = [_moved(p, 1) for p in rows]
        sums = [Partial() if p != Replicate() else p for p in rows]
        return ref.Route(*on_shards(
            _moe_route, (rows, None), (rows, rows, rows, slots, sums, sums),
            logits, top_k, capacity=capacity, n_valid=n_valid,
            router_scale=router_scale))
    return _moe_route(logits, top_k, capacity=capacity, n_valid=n_valid,
                      router_scale=router_scale)


@work.counted(work.route, work.route_bwd)
def _moe_route(logits, top_k: int, *, capacity: int, n_valid: int | None = None,
               router_scale: float = 1.0):
    if _on_cuda(logits, "moe_route"):
        if _wants_grad(logits):
            return ref.Route(*MoeRoute.apply(logits, top_k, capacity, n_valid,
                                             router_scale))
        return _moe_route_cuda(logits, top_k, capacity=capacity,
                               n_valid=n_valid, router_scale=router_scale)
    return ref.moe_route_ref(logits, top_k, capacity=capacity, n_valid=n_valid,
                             router_scale=router_scale)


# ------------------------------------------------------------- DTensors
def on_shards(fn, in_placements, out_placements, *args,
              grad_placements=None, **kwargs):
    """``fn(*args, **kwargs)`` on each rank's shards of the DTensors in
    ``args`` under ``local_map``: each input moved to its placements (a
    list a tensor, None for another argument) first, the output placed by
    ``out_placements`` (a list, or a tuple of lists for a tuple of
    outputs).  ``grad_placements`` (as ``in_placements``) says how each
    input's local gradient is placed where it is not as the input is (a
    partial sum, when each rank computes with a part of it); by default
    each is taken whole."""
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh

    def run(*a):
        return fn(*(_local(t) for t in a), **kwargs)
    return local_map(run, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def _local(t):
    """A rank's shard as a kernel takes it: contiguous (a strided shard,
    or a ``redistribute``'s output, can arrive as a view), its gradient
    made contiguous too (``_ContiguousGrad``); another argument as it
    is."""
    if not isinstance(t, torch.Tensor):
        return t
    if t.requires_grad:
        t = _ContiguousGrad.apply(t)
    return t.contiguous()


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous.  DTensor takes a
    shard's layout to be its global tensor's, and the autograd of a plain
    version returns some gradients permuted (an einsum's), which a later
    view of the DTensor could not take."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def row_placements(x) -> list:
    """``x``'s placements on the rows of its dim 0 alone, as plain shards
    (a strided one, of rows flattened from two sharded dims, included):
    a shard of any other dim, and a partial sum, replicated."""
    return [Shard(0) if getattr(p, "dim", None) == 0 else Replicate()
            for p in x.placements]


def _moved(p, dim: int):
    """A placement that shards dim 0 as the same shard of ``dim``."""
    return Shard(dim) if getattr(p, "dim", None) == 0 else p


def _heads(mesh, b: int, h: int, kh: int) -> tuple:
    """The layout of K1 and K2 on ``mesh``: placements of q (B, S, H, d)
    and of k, v (B, S, KH, d), and whether a rank takes its query heads'
    one KV head from the whole set.  Batch rows shard over the data axes
    (pod and data) when B divides by their product; query heads over the
    model axis when H divides by its size, KV heads too when KH does; else
    each rank's H / tp query heads must share one KV head (tp > KH), which
    it reads from k, v replicated on the model axis."""
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    dp = 1
    for a in ("pod", "data"):
        dp *= sizes.get(a, 1)
    tp = sizes.get("model", 1)
    g = h // kh
    q_heads = tp > 1 and h % tp == 0
    kv_heads = q_heads and kh % tp == 0
    if q_heads and not kv_heads and g % (h // tp):
        q_heads = False
    batch = dp > 1 and b % dp == 0

    def placements(heads: bool) -> list:
        return [Shard(0) if a in ("pod", "data") and batch
                else Shard(2) if a == "model" and heads
                else Replicate() for a in names]
    return (placements(q_heads), placements(kv_heads),
            q_heads and not kv_heads)


def _by_heads(fn, q, k, v, *rest, **kwargs):
    """K1 or K2 (``fn``) on each rank's batch rows and heads (``_heads``);
    ``rest`` is K2's lengths, a tensor of the batch rows or an int.

    Where each rank's query heads share one KV head (``pick``) and a
    gradient is wanted, the KV heads are repeated to one a model rank
    (tp / KH copies each) and sharded as the query heads are, so each
    rank's K1 gets its own KV head and the copies' gradients sum back
    over the ranks.  A rank's pick of its head from k, v replicated on the
    model axis would leave it a part of their gradient, which ``local_map``
    would take for the whole.  Without a gradient (prefill, K2's decode)
    the rank picks its head from the replicated k, v: no copy of a
    cache."""
    mesh = q.device_mesh
    h, kh = q.shape[2], k.shape[2]
    qp, kvp, pick = _heads(mesh, q.shape[0], h, kh)
    rows = [p if p.is_shard(0) else Replicate() for p in qp]
    g = h // kh
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
    h_local = h // tp
    if pick and _wants_grad(q, k, v):
        k, v = (_repeat_heads(t.redistribute(mesh, kvp), tp // kh)
                for t in (k, v))
        kvp, pick = qp, False

    def local(q, k, v, *rest):
        if pick:
            j = mesh.get_local_rank("model") * h_local // g
            k, v = k[:, :, j:j + 1], v[:, :, j:j + 1]
        return fn(q, k, v, *rest, **kwargs)
    extra = tuple(rows if isinstance(r, torch.Tensor) else None for r in rest)
    return on_shards(local, (qp, kvp, kvp) + extra, qp, q, k, v, *rest)


def _repeat_heads(x, r: int):
    """(B, S, KH, d) -> (B, S, KH r, d): each head ``r`` times in a row."""
    b, s, kh, d = x.shape
    return x.unsqueeze(3).expand(b, s, kh, r, d).reshape(b, s, kh * r, d)
