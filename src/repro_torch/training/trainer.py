"""Training step construction: gradient accumulation, optional gradient
compression (error feedback), the model's remat-aware loss, metrics -- the
reference package's ``training/trainer.py`` in PyTorch.

``make_train_step(model, cfg)`` returns ``train_step(state, batch) ->
(state, metrics)``.  The state is a tree ``{"params", "opt"[, "ef"]}`` in
the reference's layout.  Gradients come from ``torch.autograd.grad`` over
the parameter tree's leaves, which stays explicit as everywhere in the
port; on the card attention's gradient is K1's backward kernel.  A step
never writes the state it was given (every update is out of place), so a
snapshot of step N -- a checkpoint saved later in the slack -- stays step
N's state.

A state of DTensors (``sharding.device_put``) runs the same step as a
sharded program: the parameters and optimizer state keep their placements
(``optimizer.apply_updates``), micro-batches are each rank's own rows
(``_micro``), and the metrics are plain 0-d tensors, the same on every
rank, so every caller reads them as it reads an unsharded step's.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..distributed.sharding import shardwise
from ..models.weights import tree_leaves, tree_unflatten
from . import grad_compress, optimizer as opt


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    grad_accum: int = 1
    compress_grads: bool = False
    opt: opt.OptimizerConfig = dataclasses.field(default_factory=opt.OptimizerConfig)


def init_state(model, train_cfg: TrainConfig, generator):
    """Random parameters from ``generator`` (a ``torch.Generator`` on the
    model's device) and a fresh optimizer state."""
    params = model.init_params(generator)
    state = {"params": params, "opt": opt.init_state(train_cfg.opt, params)}
    if train_cfg.compress_grads:
        state["ef"] = grad_compress.init_error_state(params)
    return state


def value_and_grad(model, params, batch):
    """(loss, grads): the model's training loss on ``batch`` and its
    gradient with respect to every leaf of ``params``, in the leaves'
    types, as a tree of ``params``' layout.  An empty leaf (the MoE
    segment of a config whose layers are all dense) gets its empty zeros,
    as the reference's gradient gives it; any other leaf the loss does not
    read is a fault, and autograd raises for it."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    live = [p for p in leaves if p.numel()]
    with torch.enable_grad():
        loss, _ = model.train_loss(tree_unflatten(params, leaves), batch)
        got = iter(torch.autograd.grad(loss, live))
    grads = [next(got) if p.numel() else torch.zeros_like(p) for p in leaves]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model, train_cfg: TrainConfig):
    accum = train_cfg.grad_accum

    def train_step(state, batch):
        if not isinstance(tree_leaves(state["params"])[0], DTensor):
            return step(state, batch)
        # A sharded state: the model's plain tensors (positions, masks)
        # join its DTensors as replicated, and the metrics come back as
        # plain 0-d tensors, the same on every rank.
        with implicit_replication():
            new_state, metrics = step(state, batch)
        return new_state, {k: v.full_tensor() if isinstance(v, DTensor)
                           else v for k, v in metrics.items()}

    def step(state, batch):
        params = state["params"]
        if accum > 1:
            # Micro-batch gradients summed in float32, then divided, as the
            # reference's scan over micro-batches does.  The sum starts from
            # zeros laid out as the first gradients (a DTensor gradient's
            # placements included).
            gsum = None
            lsum = 0.0
            for i in range(accum):
                mb = {k: _micro(v, i, accum) for k, v in batch.items()}
                loss, grads = value_and_grad(model, params, mb)
                leaves = tree_leaves(grads)
                if gsum is None:
                    gsum = [torch.zeros_like(g, dtype=torch.float32)
                            for g in leaves]
                gsum = [s + g for s, g in zip(gsum, leaves)]
                lsum = lsum + loss
            grads = tree_unflatten(params, [g / accum for g in gsum])
            loss = lsum / accum
        else:
            loss, grads = value_and_grad(model, params, batch)
        new_state = dict(state)
        if train_cfg.compress_grads:
            grads, new_state["ef"] = grad_compress.compress_decompress(
                grads, state["ef"])
        new_state["params"], new_state["opt"], om = opt.apply_updates(
            train_cfg.opt, params, grads, state["opt"])
        return new_state, {"loss": loss, **om}

    return train_step


def _micro(x, i: int, accum: int):
    """Micro-batch ``i`` of ``accum`` along the leading axis; of a DTensor
    batch (a sharded program), the ``i``-th slice of each rank's own rows,
    as data parallelism accumulates (the micro-batches still cover the
    batch once, so the summed gradient is the same)."""
    def part(t):
        n = t.shape[0] // accum
        return t[i * n:(i + 1) * n]
    return shardwise(part, x)
