"""Deterministic stub model for serving-path tests and benchmarks.

A tiny recurrent model with the engine's full contract (``init_cache`` /
``prefill`` / ``prefill_batch`` / ``decode_step``): real tensor compute, but
microseconds per step, so the engine's *scheduler and engine* overhead
(lock hold, wakeup latency, admission batching) shows instead of device
FLOPs.

Unlike a KV-cache transformer, the recurrent state makes batched
right-padded prefill *exactly* equivalent to per-request prefill: the
padded tail would corrupt a naive final state, so ``prefill_batch`` keeps
the per-step states and gathers each row's state at ``lengths-1``.  Engine
greedy decode through this stub is therefore comparable token for token
against a direct (unscheduled) prefill+decode loop.
"""
from __future__ import annotations

import numpy as np
import torch


class TinyStubModel:
    """h' = tanh(h @ Wh + embed[token]); logits = h' @ Wout."""

    def __init__(self, d_model: int = 32, vocab: int = 32, depth: int = 1,
                 device="cuda"):
        self.d_model = d_model
        self.vocab = vocab
        self.depth = depth            # extra tanh-matmul rounds per step
        self.device = torch.device(device)

    def init_params(self, seed: int = 0):
        gen = torch.Generator(device=self.device).manual_seed(seed)
        s = 1.0 / np.sqrt(self.d_model)

        def normal(shape):
            return torch.randn(shape, generator=gen, device=self.device) * s

        return {"emb": normal((self.vocab, self.d_model)),
                "wh": normal((self.d_model, self.d_model)),
                "wout": normal((self.d_model, self.vocab))}

    def params_from_numpy(self, tree):
        """The same weights as a numpy tree (for example the reference
        stub's ``init_params`` mapped through ``np.asarray``)."""
        return {k: torch.from_numpy(np.array(v, dtype=np.float32))
                .to(self.device) for k, v in tree.items()}

    # ------------------------------------------------------------- contract
    def init_cache(self, batch_size: int, smax: int, dtype=None, device=None):
        del smax
        dev = torch.device(device) if device is not None else self.device
        return {"h": torch.zeros((batch_size, self.d_model),
                                 dtype=dtype or torch.float32, device=dev)}

    def _tokens(self, t):
        return torch.as_tensor(t, device=self.device).long()

    def _step(self, params, h, tok):
        """One recurrent update; tok: (B,) int, h: (B, D)."""
        h = torch.tanh(h @ params["wh"] + params["emb"][tok])
        for _ in range(self.depth - 1):
            h = torch.tanh(h @ params["wh"])
        return h

    def prefill(self, params, batch, smax: int):
        """tokens (1, S) -> logits (1, 1, V), cache {"h": (1, D)}."""
        del smax
        toks = self._tokens(batch["tokens"])
        h = torch.zeros((toks.shape[0], self.d_model), device=self.device)
        for t in range(toks.shape[1]):
            h = self._step(params, h, toks[:, t])
        return (h @ params["wout"])[:, None, :], {"h": h}

    def prefill_batch(self, params, batch, smax: int):
        """tokens (B, S) right-padded + lengths (B,) -> logits (B, 1, V),
        cache {"h": (B, D)} taken at each row's last *real* token, so
        padding is exact (see module docstring)."""
        del smax
        toks = self._tokens(batch["tokens"])
        lengths = self._tokens(batch["lengths"])
        h = torch.zeros((toks.shape[0], self.d_model), device=self.device)
        hs = []
        for t in range(toks.shape[1]):
            h = self._step(params, h, toks[:, t])
            hs.append(h)
        hs = torch.stack(hs)                                  # (S, B, D)
        h = hs[lengths - 1, torch.arange(toks.shape[0], device=self.device)]
        return (h @ params["wout"])[:, None, :], {"h": h}

    def decode_step(self, params, caches, token, pos):
        """token (B, 1); returns logits (B, 1, V) and new cache."""
        del pos
        h = self._step(params, caches["h"], self._tokens(token)[:, 0])
        return (h @ params["wout"])[:, None, :], {"h": h}
