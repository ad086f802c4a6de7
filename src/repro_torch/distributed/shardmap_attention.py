"""Tensor-parallel GQA attention over the ``model`` axis, with K1 on each
rank's own heads -- the reference package's explicit shard_map mixer.

Each rank of the model group

  1. projects q/k/v for *its* heads only (KV weights are pre-expanded to
     per-q-head layout, so grouped heads stay rank-local; the duplicated
     KV projection costs about one extra q-projection),
  2. runs flash attention (K1, ``ops.flash_attention``) on its local
     tensors,
  3. applies its rows of the output projection and sums the partial
     outputs with ``all_reduce`` over the model group -- the only
     collective in the mixer.

DTensor cannot carry a kernel bound with ``ctypes``, so the mixer works on
plain local tensors: every rank holds the full weights and the same input
(the rank's data-parallel batch), and takes its heads' columns itself.
The sum is an autograd function (``all_reduce`` forward, the gradient
passed through), and the input enters through its mirror (identity
forward, the gradient summed over the group), so a backward pass through
the mixer gives every rank the input's full gradient and its own heads'
rows and columns of the weights' gradients.  The ``all_reduce`` runs at
any group size, one rank included.

On DTensors (a sharded program, the dry-run's) the mixer runs on each
rank's shards under ``local_map``, as the reference's ``shard_map`` does:
the input's batch rows over the data axes, q's columns and wo's rows over
the model axis (the reference's in_specs), the K/V weights whole (each rank
expands them and takes its heads' columns, as on plain tensors); the
output, summed over the model group, is placed on the batch rows alone.

Restrictions (checked): n_heads divisible by the model-axis size, no QKV
bias.  ``Model.shardmap_attn`` applies it in place of the GQA mixer.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels import ops
from ..launch.mesh import axis_sizes
from ..models import layers as L


def expand_kv_weight(w, kh: int, g: int):
    """(d, KH*hd) -> (d, KH*G*hd): repeat each kv head's columns G times so
    every q head owns a local copy of its kv projection."""
    d, _ = w.shape
    hd = w.shape[1] // kh
    return w.reshape(d, kh, 1, hd).expand(d, kh, g, hd).reshape(d, kh * g * hd)


class _SumOverGroup(torch.autograd.Function):
    """``all_reduce`` (sum) over ``group``; the gradient passes through,
    since every rank's output is the same sum."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _EnterGroup(torch.autograd.Function):
    """The identity; the gradient is summed over ``group``, since each
    rank's heads contribute their part of the input's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def make_shardmap_gqa(mesh, cfg):
    """Returns fwd(p, x, positions, window) -> y for full-sequence GQA on
    this rank's heads of ``mesh``'s model axis."""
    tp = axis_sizes(mesh)["model"]
    if cfg.n_heads % tp:
        raise ValueError(f"n_heads {cfg.n_heads} must divide model axis {tp}")
    if cfg.qkv_bias:
        raise ValueError("tensor-parallel GQA does not support qkv bias")
    group, rank = mesh.get_group("model"), mesh.get_local_rank("model")
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kh
    h_l = h // tp
    cols = slice(rank * h_l * hd, (rank + 1) * h_l * hd)

    def fwd(p, x, positions, window: int = 0):
        dt = x.dtype
        if isinstance(x, DTensor):
            return _on_shards(p, x, positions, window)
        return local(p["wq"]["w"].to(dt)[:, cols], p["wk"]["w"].to(dt),
                     p["wv"]["w"].to(dt), p["wo"]["w"].to(dt)[cols], x,
                     positions, window)

    def _on_shards(p, x, positions, window):
        names = mesh.mesh_dim_names
        rows = [Shard(0) if a in ("pod", "data") else Replicate()
                for a in names]
        whole = [Replicate()] * len(names)
        q_cols = [Shard(1) if a == "model" else Replicate() for a in names]
        o_rows = [Shard(0) if a == "model" else Replicate() for a in names]
        dt = x.dtype
        return ops.on_shards(
            lambda wq, wk, wv, wo, x: local(wq, wk, wv, wo, x, positions,
                                            window),
            (q_cols, whole, whole, o_rows, rows), rows,
            p["wq"]["w"].to(dt), p["wk"]["w"].to(dt), p["wv"]["w"].to(dt),
            p["wo"]["w"].to(dt), x)

    def local(wq, wk, wv, wo, x, positions, window):
        """The mixer on this rank's q columns ``wq`` and wo rows ``wo``
        and the whole K/V weights."""
        wk = expand_kv_weight(wk, kh, g)[:, cols]
        wv = expand_kv_weight(wv, kh, g)[:, cols]
        positions = torch.broadcast_to(positions, x.shape[:2])
        x = _EnterGroup.apply(x, group)
        b, s, _ = x.shape
        q = L.apply_rope((x @ wq).reshape(b, s, h_l, hd), positions,
                         cfg.rope_theta)
        k = L.apply_rope((x @ wk).reshape(b, s, h_l, hd), positions,
                         cfg.rope_theta)
        v = (x @ wv).reshape(b, s, h_l, hd)

        def heads(t):
            return t.transpose(1, 2).reshape(b * h_l, s, hd)
        of = ops.flash_attention(heads(q), heads(k), heads(v), causal=True,
                                 window=window)
        out = of.reshape(b, h_l, s, hd).transpose(1, 2).reshape(b, s, h_l * hd)
        return _SumOverGroup.apply(out @ wo, group)

    return fwd
