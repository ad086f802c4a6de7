"""Pipeline parallelism over a stage axis (GPipe-style) on
``torch.distributed``.

For multi-pod meshes the default maps the ``pod`` axis to data
parallelism; this module provides the alternative, as the reference
package does: layer stages spread over the ranks of an axis, microbatches
streamed through a ring.  Each rank of the stage group runs its stage's
slice of the stacked parameters; the reference's ``ppermute`` ring becomes
``dist.batch_isend_irecv`` (each rank sends its output to the next stage
and receives the previous stage's), and its final ``psum`` of the last
stage's outputs an ``all_reduce``, so every rank returns them.

Schedule: classic GPipe fill-drain over ``n_micro`` microbatches with
``n_stages`` stages; bubble fraction (n_stages-1)/(n_micro+n_stages-1).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.weights import tree_map


def _rotate(y, stage: int, n_stages: int, group):
    """Send ``y`` to the next stage and return the previous stage's."""
    if n_stages == 1:
        return y
    y = y.contiguous()
    carry = torch.empty_like(y)
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, y, nxt, group),
                                   dist.P2POp(dist.irecv, carry, prv, group)])
    for r in reqs:
        r.wait()
    return carry


def pipeline_forward(stage_fn, n_stages: int, group=None):
    """Returns f(stage_params, x_micro) running the fill-drain schedule on
    this rank, whose stage is its rank in ``group`` (default: the world).

    stage_params: tree with a leading stage axis of ``n_stages``; this rank
    applies its own slice.  x_micro: (n_micro, mb, ...) microbatched
    activations, the same on every rank.  stage_fn(params_for_stage, x) ->
    y, of x's shape, applied at every stage.  Every rank returns the last
    stage's outputs (n_micro, mb, ...).
    """
    group = group if group is not None else dist.group.WORLD

    def run(stage_params, x_micro):
        if dist.get_world_size(group) != n_stages:
            raise ValueError(f"{n_stages} stages on a group of "
                             f"{dist.get_world_size(group)} ranks")
        stage = dist.get_rank(group)
        n_micro = x_micro.shape[0]
        my_params = tree_map(lambda a: a[stage], stage_params)
        carry = torch.zeros_like(x_micro[0])
        outs = torch.zeros_like(x_micro)
        for t in range(n_micro + n_stages - 1):
            # stage 0 injects microbatch t; others use the received carry
            x_in = x_micro[t if t < n_micro else 0] if stage == 0 else carry
            y = stage_fn(my_params, x_in)
            # the last stage emits microbatch (t - n_stages + 1)
            out_idx = t - (n_stages - 1)
            if stage == n_stages - 1 and out_idx >= 0:
                outs[out_idx] = y
            carry = _rotate(y, stage, n_stages, group)
        # only the last stage holds real outputs; replicate across stages
        dist.all_reduce(outs, group=group)
        return outs

    return run


def make_pipelined_fn(stage_fn, mesh, n_stages: int, axis: str = "pod"):
    """``pipeline_forward`` over ``mesh``'s ``axis`` (a ``DeviceMesh``)."""
    return pipeline_forward(stage_fn, n_stages, mesh.get_group(axis))
