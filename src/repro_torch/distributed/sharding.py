"""Sharding rules: FSDP + TP (+ EP) specs for every tree in the system
(params, optimizer state, batches, caches), as DTensor placements.

The rules are the reference package's, name-driven over tree paths:

* **data axis (+pod)**: batch dimension of activations; FSDP shard of every
  weight's non-TP dimension (ZeRO-3-style);
* **model axis**: tensor parallelism on head/FF/vocab dims; expert-TP on the
  per-expert FF dim by default, or true EP (expert axis) when selected;
* dims that do not divide evenly fall back to replication.

A spec is a tuple with one entry a tensor dim: an axis name, a tuple of
names (the dim sharded over both, major first), or None; it equals the
reference's ``PartitionSpec`` entry for entry.  ``placements`` turns a
spec into the ``Shard`` / ``Replicate`` list of a ``DeviceMesh``, one a
mesh dimension.  The rules read a mesh only through ``axis_sizes`` (its
axis names and sizes), as the reference's read ``mesh.shape`` and
``mesh.axis_names``.  Paths are tuples of dict keys and list indices, and
count dims from the end, so a stacked layer axis is transparent.
"""
from __future__ import annotations

import inspect
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..launch.mesh import axis_sizes, dp_axes


def _axis_size(mesh, name) -> int:
    return axis_sizes(mesh).get(name, 1)


def _fits(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def _pick(dim: int, mesh, axis: Optional[str]):
    """axis name if the dim divides evenly, else None (replicate)."""
    if axis is None:
        return None
    if isinstance(axis, tuple):
        total = 1
        for a in axis:
            total *= _axis_size(mesh, a)
        return axis if _fits(dim, total) else None
    return axis if _fits(dim, _axis_size(mesh, axis)) else None


# (tp_dim, fsdp_dim) conventions per parameter name; dims counted from the
# END of the shape so stacked leading layer dims are transparent.
# tp on the output dim for column-parallel, input dim for row-parallel.
_RULES = {
    # attention & generic projections: (d_in, d_out)
    "wq": (-1, -2), "wk": (-1, -2), "wv": (-1, -2),
    "wo": (-2, -1), "wout": (-1, -2),
    "gate": (-1, -2), "up": (-1, -2), "down": (-2, -1),
    "wz": (-1, -2), "wi": (-1, -2), "wf": (-1, -2), "proj": (-2, -1),
    "wb": (-1, -2), "wc": (-1, -2), "wdt": (-1, -2),
    # MLA
    "wq_a": (-1, -2), "wq_b": (-1, -2), "wkv_a": (-1, -2), "wkv_b": (-1, -2),
    # router
    "router": (-1, -2),
}


def param_spec(path, leaf, mesh, ep: bool = False) -> tuple:
    """The spec of one parameter leaf at ``path`` (its dict keys and list
    indices)."""
    keys = list(path)
    name = None
    for k in reversed(keys):
        if isinstance(k, str) and k not in ("w", "b", "g", "table"):
            name = k
            break
    last = keys[-1]
    ndim = leaf.ndim
    tp = "model"
    # FSDP extends across the pod axis on multi-pod meshes (512-way shards).
    fsdp = ("pod", "data") if "pod" in axis_sizes(mesh) else "data"

    def build(tp_dim=None, fsdp_dim=None):
        spec = [None] * ndim
        if tp_dim is not None:
            ax = _pick(leaf.shape[tp_dim], mesh, tp)
            if ax is not None:
                spec[tp_dim % ndim] = ax
        if fsdp_dim is not None and spec[fsdp_dim % ndim] is None:
            ax = _pick(leaf.shape[fsdp_dim], mesh, fsdp)
            if ax is not None:
                spec[fsdp_dim % ndim] = ax
        return tuple(spec)

    if last == "table":
        # embedding (vocab, d): feature-dim TP, vocab replicated -- a
        # vocab-sharded table turns the token gather into a full gather of
        # the table every step.
        return build(-1, None)
    if last == "b":                          # bias (out,)
        return build(-1, None)
    if last == "g":                          # norm scale
        return (None,) * ndim
    if name == "experts" or (ndim >= 3 and name in ("gate", "up", "down")
                             and last in ("gate", "up", "down")):
        # expert weights (E, d, f) / (E, f, d)
        if ep:
            spec = [None] * ndim
            e_dim = ndim - 3
            ax = _pick(leaf.shape[e_dim], mesh, tp)
            if ax is not None:
                spec[e_dim] = ax
            # FSDP on d_model dim
            d_dim = ndim - 2 if last in ("gate", "up") else ndim - 1
            ax = _pick(leaf.shape[d_dim], mesh, fsdp)
            if ax is not None:
                spec[d_dim] = ax
            return tuple(spec)
        # expert-TP: shard the per-expert FF dim
        ff_dim = -1 if last in ("gate", "up") else -2
        d_dim = -2 if last in ("gate", "up") else -1
        return build(ff_dim, d_dim)
    if name in _RULES or last in _RULES:
        tp_dim, fsdp_dim = _RULES.get(last, _RULES.get(name))
        return build(tp_dim, fsdp_dim)
    if ndim >= 2:
        return build(-1, -2)
    return (None,) * ndim


def _canon(spec) -> tuple:
    """A one-axis tuple entry as its axis name, as ``PartitionSpec`` keeps
    it."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension,
    ``Shard(d)`` where the spec puts that axis on tensor dim d, else
    ``Replicate()``."""
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)) if ax else ():
            out[names.index(a)] = Shard(d)
    return tuple(out)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def params_shardings(params, mesh, ep: bool = False):
    """DTensor placements of every leaf of a parameter (or optimizer-state)
    tree."""
    return tree_map_with_path(
        lambda path, leaf: placements(param_spec(path, leaf, mesh, ep=ep),
                                      mesh), params)


def batch_spec(leaf, mesh) -> tuple:
    """A batch leaf: leading dim over the (pod+)data axes."""
    b = leaf.shape[0] if leaf.ndim else 1
    ax = _pick(b, mesh, dp_axes(mesh))
    return _canon((ax,) + (None,) * (leaf.ndim - 1))


def batch_shardings(batch, mesh):
    """Batch dict: leading dim over (pod+)data axes."""
    return tree_map_with_path(
        lambda _, leaf: placements(batch_spec(leaf, mesh), mesh), batch)


def cache_spec(leaf, mesh) -> tuple:
    """KV caches / recurrent state: batch dim over data axes when it
    divides; otherwise the longest other dim (sequence, for long-context
    batch-1 decode) over data.  Head-count dims over model when
    divisible."""
    if leaf.ndim == 0:
        return ()
    dp = dp_axes(mesh)
    dims = list(leaf.shape)
    spec_list = [None] * leaf.ndim
    # batch dim: first dim of size>1 that divides dp; stacked caches carry a
    # leading layer dim -- detect via heuristic: try dim 0 then 1.
    placed_dp = False
    for d in range(min(2, leaf.ndim)):
        if _pick(dims[d], mesh, dp) is not None and dims[d] >= 2:
            spec_list[d] = _pick(dims[d], mesh, dp)
            placed_dp = True
            break
    if not placed_dp:
        # shard the longest dim (sequence) over data
        longest = max(range(leaf.ndim), key=lambda d: dims[d])
        ax = _pick(dims[longest], mesh, dp)
        if ax is not None and dims[longest] >= 1024:
            spec_list[longest] = ax
    # heads/hidden over model: last-but-one or last dim
    for d in range(leaf.ndim - 1, max(leaf.ndim - 3, 0) - 1, -1):
        if spec_list[d] is None and _fits(dims[d], _axis_size(mesh, "model")) \
                and dims[d] >= _axis_size(mesh, "model") and d >= 2:
            spec_list[d] = "model"
            break
    return _canon(spec_list)


def cache_leaf_spec(shape: tuple, mesh, scanned: bool) -> tuple:
    """The spec of one cache leaf of ``Model.cache_pspecs``, the
    reference's ``_cache_leaf_pspec``: the batch dim (after a scanned
    segment's layer dim) over the data axes when it divides and is above
    1, else the sequence dim when it is at least 4096 and divides; then
    the last heads-like dim (from the next-to-last down, past the batch)
    over model where it divides."""
    sizes = axis_sizes(mesh)
    dp = dp_axes(mesh)
    dp_size = 1
    for a in dp:
        dp_size *= sizes[a]
    tp = sizes.get("model", 1)
    off = 1 if scanned else 0
    spec = [None] * len(shape)
    dp_spec = dp if len(dp) > 1 else dp[0]
    b = shape[off]
    if b >= dp_size and b % dp_size == 0 and b > 1:
        spec[off] = dp_spec
    elif len(shape) > off + 1:
        s_dim = off + 1
        if shape[s_dim] >= 4096 and shape[s_dim] % dp_size == 0:
            spec[s_dim] = dp_spec
    for d in range(len(shape) - 2, off, -1):
        if spec[d] is None and tp > 1 and shape[d] % tp == 0 and shape[d] >= tp:
            spec[d] = "model"
            break
    return tuple(spec)


def cache_shardings(caches, mesh):
    return tree_map_with_path(
        lambda _, leaf: placements(cache_spec(leaf, mesh), mesh), caches)


def replicated(mesh) -> tuple:
    return placements((), mesh)


def state_shardings(state, mesh, ep: bool = False):
    """Placements of a train state ``{"params", "opt"[, "ef"]}``: every
    part by ``params_shardings`` (the optimizer's ``m`` and ``v`` as their
    parameters, the 0-d ``step`` replicated), as the reference's test
    places it."""
    return {k: params_shardings(v, mesh, ep=ep) for k, v in state.items()}


def device_put(tree, placements_tree, mesh):
    """The counterpart of the reference's ``device_put(tree, shardings)``:
    each leaf of ``tree`` as a DTensor on ``mesh``, placed by the leaf at
    its path in ``placements_tree`` (``params_shardings``,
    ``batch_shardings``, ``cache_shardings``, ``state_shardings``).

    A leaf with data is cut by ``distribute_tensor`` from the whole tensor
    that every rank holds (made from one seed, or read from one file), each
    rank keeping its own shard without a collective (``src_data_rank=None``
    where torch has it).  A leaf without data (meta or fake: the dry-run's
    trace) becomes a new empty shard of its local shape on the mesh's
    device, made under the fake mode that is active.  Both place a leaf
    alike, so a trace and a real run share one layout.  A leaf that is a
    DTensor already (a step's output, as the reference's ``out_shardings``
    places it) is redistributed to its placements."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import distribute_tensor
    from ..models.weights import tree_map
    kw = ({"src_data_rank": None} if "src_data_rank" in
          inspect.signature(distribute_tensor).parameters else {})

    def put(t, plc):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, tuple(plc))
        if t.is_meta or isinstance(t, FakeTensor):
            return _empty_shard(t, tuple(plc), mesh)
        return distribute_tensor(t.to(mesh.device_type), mesh, tuple(plc),
                                 **kw)
    return tree_map(put, tree, placements_tree)


def _empty_shard(t, plc: tuple, mesh):
    """A DTensor of ``t``'s global shape and dtype placed by ``plc``,
    whose local shard is a new tensor on the mesh's device (the rules
    shard only dims that divide evenly)."""
    local = list(t.shape)
    for md, p in enumerate(plc):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(md)
    loc = torch.empty(local, dtype=t.dtype, device=mesh.device_type)
    stride, n = [], 1
    for d in reversed(t.shape):
        stride.insert(0, n)
        n *= d
    return DTensor.from_local(loc, mesh, plc, run_check=False,
                              shape=t.shape, stride=tuple(stride))


# ------------------------------------------------------- DTensor programs
def constrain(x, spec):
    """``x`` redistributed to the placements of ``spec`` on its mesh when
    it is a DTensor -- an axis kept only where its dim divides, as the
    rules keep one -- the counterpart of the reference's
    ``with_sharding_constraint``; a plain tensor, or no spec, passes as it
    is."""
    if spec is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    fitted = _canon(tuple(_pick(x.shape[d], mesh, a) for d, a in enumerate(spec)))
    return x.redistribute(mesh, placements(fitted, mesh))


def whole(x, dim: int, parts: int | None = None):
    """A DTensor ``x`` with ``dim`` on every rank whole (its shards
    gathered, partial sums reduced), the other dims placed as they were;
    a plain tensor as it is.  For an operation whose result on a shard of
    ``dim`` is not a shard of its result (a softmax over a sharded
    vocabulary, a linear map over a sequence split two ways).  With
    ``parts``, only when ``dim``'s shards do not split it into a multiple
    of ``parts`` pieces (heads that a reshape makes of it)."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    if parts is not None:
        n = 1
        for md, p in enumerate(x.placements):
            if getattr(p, "dim", None) == dim:
                n *= x.device_mesh.size(md)
        if parts % n == 0:
            return x
    keep = tuple(p if getattr(p, "dim", dim) != dim else Replicate()
                 for p in x.placements)
    return x.redistribute(x.device_mesh, keep)


class _WholeGrad(torch.autograd.Function):
    """The identity, whose gradient is made whole on ``dim``."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return whole(grad, ctx.dim), None


def whole_grad(x, dim: int):
    """``x`` itself, whose gradient, when it is a DTensor, arrives whole on
    ``dim`` (``whole``): what ``whole`` does for a value, for the gradient
    that flows back into it (a product's output, whose gradient the
    product's backward flattens as its input)."""
    if not isinstance(x, DTensor):
        return x
    return _WholeGrad.apply(x, dim)


def shardwise(fn, x, dims: tuple = ()):
    """``fn`` of one tensor on each rank's shard of a DTensor ``x`` under
    ``local_map``, for an ``fn`` that maps a shard to the same shard of its
    result once ``x``'s ``dims`` are whole (made so first): an elementwise
    operation DTensor has no rule for (``logsigmoid``), a pad or roll of
    the sequence into a cache (DTensor's rule for padding cannot place
    some layouts).  Other shards stay where they are; a partial sum is
    reduced first.  On a plain tensor, ``fn(x)``."""
    if not isinstance(x, DTensor):
        return fn(x)
    from ..kernels.ops import on_shards
    dims = {d % x.ndim for d in dims}
    keep = [Replicate() if p.is_partial() or getattr(p, "dim", None) in dims
            else p for p in x.placements]
    return on_shards(fn, (keep,), keep, x)


def settle(y, like):
    """A DTensor ``y`` that is a partial sum, reduced to the layout of the
    tensor it is about to be added to (``like``, broadcast from the right:
    a bias, a residual stream): scattered over ``like``'s shards where
    ``like`` is sharded on that mesh dim, else reduced whole.  DTensor's
    rule for the sum would otherwise move ``like`` to a partial sum, which
    torch 2.11 cannot do.  Anything else as it is."""
    if not isinstance(y, DTensor) or not any(p.is_partial()
                                             for p in y.placements):
        return y
    lp = like.placements if isinstance(like, DTensor) else \
        (Replicate(),) * len(y.placements)
    off = y.ndim - like.ndim
    out = [(Shard(lp[i].dim + off) if isinstance(lp[i], Shard) else Replicate())
           if p.is_partial() else p for i, p in enumerate(y.placements)]
    return y.redistribute(y.device_mesh, out)


def head_layout(x):
    """A DTensor (B, S, heads, d) placed as the attention kernels take it:
    batch rows over the data axes and heads over the model axis, each where
    it divides, the sequence and head dim whole (``constrain``).  DTensor
    leaves the layout of the projected heads to its rules, and some of
    those layouts it cannot pad or roll into a cache; a plain tensor
    passes as it is."""
    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    dp = tuple(a for a in ("pod", "data") if a in names)
    return constrain(x, (dp if len(dp) > 1 else (dp[0] if dp else None),
                         None, "model" if "model" in names else None, None))
