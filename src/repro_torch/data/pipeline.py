"""Token data pipeline: deterministic synthetic streams and memory-mapped
binary token files, sharded by data-parallel rank, with background prefetch.

Determinism contract: ``(seed, step, dp_rank)`` fully determines a batch, so
a restarted (or re-scaled) job resumes mid-stream without data skew -- the
fault-tolerance story depends on this (DESIGN.md section 6).
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


class SyntheticTokens:
    """Zipf-ish synthetic token stream (shape-true stand-in for a tokenized
    corpus; e.g. the train_100m example)."""

    def __init__(self, vocab_size: int, seed: int = 0):
        self.vocab = vocab_size
        self.seed = seed

    def batch(self, step: int, dp_rank: int, batch: int, seq: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, dp_rank]))
        # Zipf tail clipped into the vocab; cheap and distribution-plausible.
        toks = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
        toks = (toks - 1) % self.vocab
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class TokenFile:
    """Memory-mapped flat int32 token file, chunked into sequences and
    sharded deterministically across data-parallel ranks."""

    def __init__(self, path: str, seed: int = 0):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.seed = seed

    def batch(self, step: int, dp_rank: int, dp_size: int, batch: int, seq: int):
        n_chunks = (len(self.tokens) - 1) // seq
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        order = rng.permutation(n_chunks)
        base = (step * dp_size + dp_rank) * batch
        idx = order[(base + np.arange(batch)) % n_chunks]
        rows = np.stack([self.tokens[i * seq:(i + 1) * seq + 1] for i in idx])
        return {"tokens": rows[:, :-1].copy(), "labels": rows[:, 1:].copy()}


class Prefetcher:
    """Background-thread prefetch of an iterator (depth-bounded)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None

        def run():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001
                self._err = e
            finally:
                self._q.put(self._done)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def batches(source, *, steps: int, dp_rank: int = 0, dp_size: int = 1,
            batch: int = 8, seq: int = 128, prefetch: int = 2):
    def gen():
        for step in range(steps):
            if isinstance(source, TokenFile):
                yield source.batch(step, dp_rank, dp_size, batch, seq)
            else:
                yield source.batch(step, dp_rank, batch, seq)
    return Prefetcher(gen(), depth=prefetch)
