"""AdamW optimizer over a parameter tree, cosine schedule, global-norm
clipping -- the reference package's ``training/optimizer.py`` in PyTorch.

The math runs in float32 whatever the parameters' type; ``state_dtype=
"bfloat16"`` stores ``m`` and ``v`` in bf16 (fp32 math per step).  Weight
decay applies to every leaf with ``ndim >= 2``: a scanned segment's norm
scales are stacked ``(n_layers, d)``, so they are decayed, as in the
reference, while the final norm ``(d,)`` is not.

Updates are out of place: ``apply_updates`` returns new tensors and never
writes the ones it was given, so a state handed to a background checkpoint
save stays the state of its step while training goes on.

A sharded state (DTensor leaves, ``sharding.device_put``): the global norm
and the clip scale are replicated scalars over every rank's shard; each
gradient is placed as its parameter before the update (a partial sum over
the data axes reduced, or reduce-scattered onto FSDP shards), and the new
parameters, ``m``, ``v`` and ``step`` keep the placements they came in
with, as the reference's ``out_shardings`` keeps them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate

from ..models.layers import dtype_of
from ..models.weights import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: Optional[str] = None     # None -> fp32 m/v


def lr_at(cfg: OptimizerConfig, step):
    """The learning rate at ``step`` (a number, or a tensor on any
    device), float32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init_state(cfg: OptimizerConfig, params):
    dt = dtype_of(cfg.state_dtype) if cfg.state_dtype else torch.float32

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
    }


def global_norm(tree):
    """The norm over every leaf; of DTensor leaves, over every rank's
    shard: each leaf's sum of squares made a replicated scalar (partial
    sums reduced) before the leaves are summed."""
    return torch.stack([_replicated(x.float().square().sum())
                        for x in tree_leaves(tree)]).sum().sqrt()


def _replicated(x):
    """A DTensor replicated on every mesh dim (shards gathered, partial
    sums reduced); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def _placed_as(x, like):
    """A DTensor ``x`` redistributed to ``like``'s placements (a gradient
    that arrives as a partial sum over the data axes is reduced, or
    reduce-scattered onto its parameter's shards); anything else as it
    is."""
    if not isinstance(x, DTensor) or x.placements == like.placements:
        return x
    return x.redistribute(like.device_mesh, like.placements)


def apply_updates(cfg: OptimizerConfig, params, grads, state):
    """One AdamW step; returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.clip_norm else 1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = _placed_as(g, p).float() * scale
        m32 = m.float() * cfg.b1 + g * (1 - cfg.b1)
        v32 = v.float() * cfg.b2 + g.square() * (1 - cfg.b2)
        delta = (m32 / b1c) / ((v32 / b2c).sqrt() + cfg.eps)
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * p.float()
        newp = p.float() - lr * delta
        return (_placed_as(newp.to(p.dtype), p),
                _placed_as(m32.to(m.dtype), m), _placed_as(v32.to(v.dtype), v))

    out = [upd(*t) for t in zip(*(tree_leaves(x) for x in (
        params, grads, state["m"], state["v"])))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[j] for o in out])
                           for j in range(3))
    return new_p, {"step": _placed_as(step, state["step"]), "m": new_m,
                   "v": new_v}, {"grad_norm": gnorm, "lr": lr}
