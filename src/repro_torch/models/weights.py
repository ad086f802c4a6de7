"""Parameter and cache trees: nested dicts and lists of tensors.

``params_from_numpy`` turns a parameter tree of numpy arrays -- the
reference package's tree after mapping ``np.asarray`` over it, or any tree of
the same layout -- into the port's tree, key for key.  The layout is the same in both
packages (a linear weight is ``(d_in, d_out)``), so no leaf is transposed.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import dtype_of


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in a fixed order: list order, and dict entries by sorted key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves``, given in
    ``tree_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes bfloat16
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


# Leaves the models keep in float32 whatever ``cfg.dtype`` is: the SSD
# heads' decay rates, as the reference's ``ssd_init`` makes them.
FLOAT32_LEAVES = frozenset({"a_log"})


def params_from_numpy(tree, device="cuda", dtype=None):
    """numpy tree -> torch tree on ``device``; floating leaves are cast to
    ``dtype`` when one is given, except those named in ``FLOAT32_LEAVES``,
    which stay float32; other leaves keep their type."""
    dt = dtype_of(dtype) if dtype is not None else None

    def one(a, name):
        t = _to_tensor(a)
        if dt is not None and t.is_floating_point():
            t = t.to(torch.float32 if name in FLOAT32_LEAVES else dt)
        return t.to(device)

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return one(node, name)

    return walk(tree)
