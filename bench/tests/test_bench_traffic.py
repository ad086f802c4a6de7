"""The traffic generator: the same seed gives the same requests, another
seed another order of the same work."""
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchlib import discover  # noqa: E402
from benchlib.traffic import Traffic, arrival_offsets, quantiles  # noqa: E402

MIX = discover.traffic("azure-chat-batch")
RATES = {"time-sensitive": 0.8}
BIG = 2 ** 31 + 977


def _open(seed):
    return Traffic(MIX, seed, 49152, 51, RATES).open_items()


def _closed(seed, n=24):
    t = Traffic(MIX, seed, 49152, 51, RATES)
    (k, _), = t.closed_tiers()
    return [t.closed(k, i) for i in range(n)]


def test_same_seed_same_requests():
    a, b = _open(BIG), _open(BIG)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.due == y.due and x.new_tokens == y.new_tokens
        assert np.array_equal(x.prompt, y.prompt)
    for x, y in zip(_closed(BIG), _closed(BIG)):
        assert np.array_equal(x.prompt, y.prompt)


def test_another_seed_other_order_same_work():
    a, b = _open(BIG), _open(BIG + 1)
    assert [x.due for x in a] != [x.due for x in b]
    assert not all(np.array_equal(x.prompt[:8], y.prompt[:8])
                   for x, y in zip(a, b))
    full = int(round(0.8 * 51))
    sizes = quantiles(MIX["tiers"][0]["prompt"], full)
    for items in (a, b):
        # every request due in the window comes from the same strata
        got = sorted(len(x.prompt) for x in items)
        assert set(got) <= set(sizes.tolist())
    # a closed tier's every block of 8 holds the same 8 lengths
    ca, cb = _closed(BIG), _closed(BIG + 1)
    for blk in range(3):
        sa = sorted(len(x.prompt) for x in ca[8 * blk:8 * blk + 8])
        sb = sorted(len(x.prompt) for x in cb[8 * blk:8 * blk + 8])
        assert sa == sb
    assert [len(x.prompt) for x in ca] != [len(x.prompt) for x in cb]


def _within(n, spec):
    return spec["min"] <= n <= spec["max"]


def test_sizes_within_the_mix_bounds():
    ts, bg = MIX["tiers"]
    for x in _open(7):
        assert _within(len(x.prompt), ts["prompt"])
        assert _within(x.new_tokens, ts["output"])
        assert x.prompt.dtype == np.int32 and x.prompt.max() < 49152
    for x in _closed(7):
        assert _within(len(x.prompt), bg["prompt"])
        assert _within(x.new_tokens, bg["output"])


def test_arrivals_are_stratified_exponential_gaps():
    t = arrival_offsets(2.0, 100.0, 11)
    assert t[0] == 0.0 and np.all(np.diff(t) > 0)
    gaps = np.sort(np.diff(t))
    n = 200
    u = (np.arange(n) + 0.5) / n
    want = np.sort(-np.log1p(-u) / 2.0)
    # the gaps are the stratified quantiles, one of them left out (the
    # last, which would fall after the window)
    assert len(t) == n or len(t) == n - 1
    assert np.all(np.isin(np.round(gaps, 9), np.round(want, 9)))
    assert abs(np.mean(want) - 0.5) < 0.02


def test_lognormal_quantiles_median_and_clip():
    q = quantiles({"dist": "lognormal", "median": 768, "sigma": 0.6,
                   "min": 128, "max": 2048}, 101)
    assert q[50] == 768 and q.min() >= 128 and q.max() <= 2048
    u = quantiles({"dist": "uniform", "min": 2048, "max": 3072}, 8)
    assert u.min() >= 2048 and u.max() <= 3072 and len(set(u)) == 8


def _bucket(n):
    """The engine's admission bucket: a power of two, at least 8."""
    return 1 << max(3, (n - 1).bit_length())


def test_warmup_covers_every_bucket():
    """Every admission bucket the time-sensitive tier's sizes reach is
    warmed, and the background tier's extremes."""
    ts, bg = MIX["tiers"]
    w = Traffic(MIX, 3, 49152, 51, RATES).warmup()
    warm = {_bucket(len(x.prompt)) for x in w if x.tier == "time-sensitive"}
    sizes = quantiles(ts["prompt"], 10000)
    assert {_bucket(int(n)) for n in sizes} <= warm
    assert {_bucket(ts["prompt"]["min"]), _bucket(ts["prompt"]["max"])} <= warm
    warm_bg = sorted(len(x.prompt) for x in w if x.tier == "background")
    assert warm_bg == [bg["prompt"]["min"], bg["prompt"]["max"]]
