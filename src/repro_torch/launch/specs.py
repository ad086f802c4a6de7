"""Example inputs for every (arch x shape) dry-run cell, as fake tensors:
the reference's shapes and dtypes, nothing allocated.

``input_specs(cfg, shape, model)`` returns (step_kind, example_inputs) where
the inputs are fake tensors (``FakeTensorMode``) on the model's device,
matching what the corresponding step consumes:

* train   : ({"tokens", "labels" [, "frames" | "vision_embeds"]},)
* prefill : ({"tokens" [, frontend embeddings]},)
* decode  : (caches, token) -- the caches from the model's ``init_cache``

The tensors are made in the fake mode that is active (the dry-run's), or in
a new one.
"""
from __future__ import annotations

import contextlib

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models.layers import dtype_of


@contextlib.contextmanager
def fake_mode():
    """The active ``FakeTensorMode``, entered again, or a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    with detect_fake_mode() or FakeTensorMode():
        yield


def sds(shape, dtype, device):
    """A fake tensor of ``shape`` and ``dtype`` (a torch dtype or its
    name) on ``device``."""
    with fake_mode():
        return torch.empty(tuple(shape), dtype=dtype_of(dtype), device=device)


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, with_labels: bool,
                device):
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": sds((b, s), torch.int32, device)}
    if with_labels:
        batch["labels"] = sds((b, s), torch.int32, device)
    if cfg.encoder_layers:
        batch["frames"] = sds((b, cfg.encoder_len, cfg.d_model), cfg.dtype,
                              device)
    if cfg.vision_tokens:
        batch["vision_embeds"] = sds((b, cfg.vision_tokens, cfg.d_model),
                                     cfg.dtype, device)
    return batch


def cache_specs(model, batch_size: int, smax: int):
    with fake_mode():
        return model.init_cache(batch_size, smax)


def input_specs(cfg: ArchConfig, shape: ShapeConfig, model):
    dev = model.device
    if shape.kind == "train":
        return "train", (batch_specs(cfg, shape, True, dev),)
    if shape.kind == "prefill":
        return "prefill", (batch_specs(cfg, shape, False, dev),)
    if shape.kind == "decode":
        caches = cache_specs(model, shape.global_batch, shape.seq_len)
        token = sds((shape.global_batch, 1), torch.int32, dev)
        return "decode", (caches, token)
    raise ValueError(shape.kind)
