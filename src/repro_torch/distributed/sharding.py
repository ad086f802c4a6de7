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

from typing import Optional

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
    from torch.distributed.tensor import Replicate, Shard
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


def cache_shardings(caches, mesh):
    return tree_map_with_path(
        lambda _, leaf: placements(cache_spec(leaf, mesh), mesh), caches)


def replicated(mesh) -> tuple:
    return placements((), mesh)
