"""Random weights made by the benchmark from the seed, on the device, in
the type they are served in and in the port's parameter-tree layout.

The tree's shapes come from the port's model on the ``meta`` device (no
memory).  Every leaf is a view of one flat buffer filled by a few large
``normal_`` calls of a ``torch.Generator`` on the device, then scaled in
place by its leaf's rule: norm gains 1, biases 0, the embedding table and
the router 0.02, every other matrix 1 / sqrt(its input width), the
second-to-last dim of the port's (..., d_in, d_out) layout.  The same seed
gives the same bits.  The plain reference reads these same tensors.
"""
from __future__ import annotations

import torch

CHUNK = 1 << 30          # elements per normal_ call


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, made, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, made, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, made, path + (i,)) for i, v in enumerate(tree)]
    return made[path]


def scale_of(path: tuple, shape) -> float | None:
    """The leaf's standard deviation, or None for a constant leaf."""
    name = path[-1]
    if name in ("g", "b"):
        return None
    if "embed" in path or "router" in path:
        return 0.02
    return float(shape[-2]) ** -0.5


def make(meta_tree, seed: int, device) -> tuple:
    """(tree, nbytes): the weights of ``meta_tree``'s shapes and types."""
    leaves = list(_leaves(meta_tree))
    dtypes = {t.dtype for _, t in leaves}
    if len(dtypes) != 1:
        raise ValueError(f"one served type expected, got {dtypes}")
    dtype = dtypes.pop()
    total = sum(t.numel() for _, t in leaves)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    for s in range(0, total, CHUNK):
        flat[s:s + CHUNK].normal_(generator=gen)
    made, off = {}, 0
    for path, t in leaves:
        view = flat[off:off + t.numel()].view(t.shape)
        off += t.numel()
        sd = scale_of(path, t.shape)
        if sd is None:
            view.fill_(1.0 if path[-1] == "g" else 0.0)
        else:
            view.mul_(sd)
        made[path] = view
    return _rebuild(meta_tree, made), total * flat.element_size()


def per_layer(model, params) -> list:
    """The tree's layers in order, each a dict of views (a scanned
    segment's stacked leaves sliced on their layer axis)."""
    out = []
    for seg, sp in zip(model.plan, params["segments"]):
        n = seg.n if seg.kind == "scan" else 1
        for i in range(n):
            out.append(_slice(sp, i) if seg.kind == "scan" else sp)
    return out


def _slice(tree, i):
    if isinstance(tree, dict):
        return {k: _slice(v, i) for k, v in tree.items()}
    return tree[i]
