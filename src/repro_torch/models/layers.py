"""Foundational functional layers (PyTorch, params as nested dicts).

Conventions, as in the reference package's layers:

* every ``*_init(generator, ...)`` returns a dict of tensors made on the
  generator's device; ``lead`` prepends axes (a stacked layer axis);
* every forward fn is ``f(params, x, ...) -> y``;
* compute dtype follows the input; params are stored in ``cfg.dtype``;
* a linear weight is stored ``(d_in, d_out)`` and applied as ``x @ w``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..distributed.sharding import settle, whole, whole_grad


def dtype_of(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[str(name)]


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the ``meta`` device, which
    torch does not have: an init given it makes shapes without memory."""
    device = torch.device("meta")


def _normal(gen, shape, scale: float, dtype):
    """Normal(0, scale) values drawn in float32 and stored in ``dtype``.  A
    tensor of more than two dims is drawn one leading slice at a time, so
    the float32 draw never holds more than a slice (a stacked expert
    tensor of qwen2-moe is 17.7 GB in float32).  On the ``meta`` device
    only the shape is made."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype_of(dtype), device="meta")
    if len(shape) > 2:
        out = torch.empty(shape, dtype=dtype_of(dtype), device=gen.device)
        for i in range(shape[0]):
            out[i] = _normal(gen, shape[1:], scale, dtype)
        return out
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype_of(dtype))


# ---------------------------------------------------------------- linear
def linear_init(gen, d_in: int, d_out: int, dtype="float32", bias: bool = False,
                scale: float | None = None, lead: tuple = ()):
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    p = {"w": _normal(gen, (*lead, d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype_of(dtype),
                             device=gen.device)
    return p


def linear(p, x):
    """x @ w (+ b).  A DTensor (B, S, d) input sharded on its sequence is
    made whole on it first: the product flattens (B, S), and a flattening
    of two sharded dims is a strided shard, which DTensor's rules for the
    product cannot take; so is the gradient that flows back into the
    product (``sharding.whole_grad``).  A DTensor product that is a partial
    sum is settled before its bias is added (``sharding.settle``)."""
    if isinstance(x, DTensor) and x.ndim == 3:
        y = whole_grad(whole(x, 1) @ p["w"].to(x.dtype), 1)
    else:
        y = x @ p["w"].to(x.dtype)
    if "b" in p:
        b = p["b"].to(x.dtype)
        y = settle(y, b) + b
    return y


# ---------------------------------------------------------------- norms
def rmsnorm_init(dim: int, dtype="float32", device="cuda", lead: tuple = ()):
    return {"g": torch.ones((*lead, dim), dtype=dtype_of(dtype), device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["g"].float()).to(x.dtype)


# ---------------------------------------------------------------- embedding
def embedding_init(gen, vocab: int, dim: int, dtype="float32"):
    return {"table": _normal(gen, (vocab, dim), 0.02, dtype)}


def embed(p, tokens):
    return F.embedding(tokens, p["table"])


def unembed(p, x):
    """Tied or untied output head: logits in float32 for stable loss.  The
    table is cast to float32 on every call, as in the reference."""
    return x.float() @ p["table"].float().T


# ---------------------------------------------------------------- MLPs
def swiglu_init(gen, d_model: int, d_ff: int, dtype="float32", lead: tuple = ()):
    return {
        "gate": linear_init(gen, d_model, d_ff, dtype, lead=lead),
        "up": linear_init(gen, d_model, d_ff, dtype, lead=lead),
        "down": linear_init(gen, d_ff, d_model, dtype, lead=lead),
    }


def swiglu(p, x):
    return linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x))


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x, positions, theta: float = 10_000.0):
    """Half-split rotation.  x: (..., seq, n_heads, head_dim);
    positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)   # (hd/2,)
    angles = positions[..., :, None].float() * freqs               # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                       # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits, labels, ignore_id: int = -1):
    """Mean token cross-entropy with ignore mask; logits float32.  Sharded
    logits (a DTensor) are made whole over the vocabulary first: the
    log-sum-exp and the label's gather need every logit of a row."""
    logits = whole(logits.float(), -1)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())[..., 0]
    nll = logz - gold
    mask = (labels != ignore_id).float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)
