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
"""
from __future__ import annotations

import dataclasses

import torch

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
        params = state["params"]
        if accum > 1:
            # Micro-batch gradients summed in float32, then divided, as the
            # reference's scan over micro-batches does.
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in tree_leaves(params)]
            lsum = 0.0
            for i in range(accum):
                mb = {k: _micro(v, i, accum) for k, v in batch.items()}
                loss, grads = value_and_grad(model, params, mb)
                gsum = [s + g for s, g in zip(gsum, tree_leaves(grads))]
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
    """Micro-batch ``i`` of ``accum`` along the leading axis."""
    n = x.shape[0] // accum
    return x[i * n:(i + 1) * n]
