"""The one traffic generator: a mix file's parameters and a seed in, the
requests of a run out.

A mix has tiers.  An ``open`` tier arrives on a schedule at the cell's
rate (Poisson); a ``closed`` tier keeps a fixed number of requests
outstanding and sends the next as one completes.  Sizes are drawn by
stratified quantiles of their distribution and only their order comes
from the seed, so every seed offers the same work in another order: the
same multiset of prompt and output lengths and of inter-arrival gaps
(a closed tier's lengths repeat their strata every ``block`` requests, so
any prefix a run consumes is as heavy as any other seed's).  Token ids
are drawn from the seed.  The same seed gives the same requests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


@dataclass(frozen=True)
class Item:
    """One request the generator offers."""
    tier: str
    weight: float
    prompt: np.ndarray        # int32 token ids
    new_tokens: int
    due: float = 0.0          # seconds after the window opens (open tiers)


def quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` integer sizes at the stratified quantiles (i + 0.5) / n of a
    size distribution: ``fixed`` (value), ``uniform`` (min..max) or
    ``lognormal`` (median, sigma), clipped to [min, max]."""
    u = (np.arange(n) + 0.5) / n
    kind = spec["dist"]
    if kind == "fixed":
        x = np.full(n, float(spec["value"]))
    elif kind == "uniform":
        x = spec["min"] + u * (spec["max"] + 1 - spec["min"])
    elif kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(p) for p in u])
        x = spec["median"] * np.exp(spec["sigma"] * z)
    else:
        raise ValueError(f"unknown size distribution {kind!r}")
    lo = spec.get("min", -math.inf)
    hi = spec.get("max", math.inf)
    return np.clip(np.floor(x), lo, hi).astype(np.int64)


def _rng(seed: int, *path: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), *path])


def arrival_offsets(rate: float, seconds: float, seed: int,
                    k: int = 0) -> np.ndarray:
    """Due times of open tier ``k``: round(rate x seconds) gaps at the
    exponential distribution's stratified quantiles, in the seed's order;
    the first request is due when the window opens and each next one a gap
    later.  Those due inside the window are the tier's requests."""
    n = max(1, int(round(rate * seconds)))
    u = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-u) / rate
    gaps = gaps[_rng(seed, 1, k).permutation(n)]
    t = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    return t[t < seconds]


class Traffic:
    """A mix's requests for one run: ``open_items()`` (due times set) and,
    for each closed tier, ``closed(tier_index, i)``."""

    def __init__(self, mix: dict, seed: int, vocab: int, seconds: float,
                 rates: dict):
        self.mix, self.seed, self.vocab = mix, int(seed), vocab
        self.seconds, self.rates = seconds, rates
        self._closed_sizes = {}

    def _tokens(self, k: int, i: int, n: int) -> np.ndarray:
        return _rng(self.seed, 2, k, i).integers(
            0, self.vocab, n).astype(np.int32)

    def open_items(self) -> list:
        out = []
        for k, tier in enumerate(self.mix["tiers"]):
            if tier["loop"] != "open":
                continue
            rate = self.rates[tier["tier"]]
            due = arrival_offsets(rate, self.seconds, self.seed, k)
            n = len(due)
            full = max(1, int(round(rate * self.seconds)))
            order = _rng(self.seed, 3, k)
            prompts = quantiles(tier["prompt"], full)[order.permutation(full)]
            outputs = quantiles(tier["output"], full)[order.permutation(full)]
            for i in range(n):
                out.append(Item(tier["tier"], float(tier["weight"]),
                                self._tokens(k, i, int(prompts[i])),
                                int(outputs[i]), float(due[i])))
        out.sort(key=lambda it: it.due)
        return out

    def closed_tiers(self) -> list:
        return [(k, t) for k, t in enumerate(self.mix["tiers"])
                if t["loop"] == "closed"]

    def closed(self, k: int, i: int) -> Item:
        """The ``i``-th request of closed tier ``k``."""
        tier = self.mix["tiers"][k]
        block = int(tier.get("block", 8))
        b, j = divmod(i, block)
        key = (k, b)
        if key not in self._closed_sizes:
            order = _rng(self.seed, 4, k, b)
            self._closed_sizes[key] = (
                quantiles(tier["prompt"], block)[order.permutation(block)],
                quantiles(tier["output"], block)[order.permutation(block)])
        prompts, outputs = self._closed_sizes[key]
        return Item(tier["tier"], float(tier["weight"]),
                    self._tokens(k, 100_000 + i, int(prompts[j])),
                    int(outputs[j]))

    def warmup(self) -> list:
        """The mix's warm-up requests: the shapes its traffic hits."""
        rng_i = 0
        out = []
        for w in self.mix.get("warmup", []):
            tier = next(t for t in self.mix["tiers"] if t["tier"] == w["tier"])
            for n in w["prompts"]:
                out.append(Item(w["tier"], float(tier["weight"]),
                                self._tokens(99, rng_i, int(n)),
                                int(w["output"])))
                rng_i += 1
        return out
