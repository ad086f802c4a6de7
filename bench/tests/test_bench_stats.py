"""Statistics over all samples, gaps over the whole window, TTFT from
when a request was due."""
import math
import sys
from pathlib import Path
from types import SimpleNamespace as NS

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchlib import stats  # noqa: E402


@pytest.mark.parametrize("p", [0, 5, 50, 95, 99, 100])
def test_percentile_matches_numpy_over_all_samples(p):
    xs = np.random.default_rng(3).lognormal(size=997).tolist()
    assert stats.percentile(xs, p) == pytest.approx(np.percentile(xs, p))


def test_missing_request_sorts_last():
    xs = [1.0, 2.0, 3.0, math.inf]
    assert stats.percentile(xs, 100) == math.inf
    assert stats.percentile(xs, 50) == pytest.approx(2.5)


def rec(due, first, times, ok=True, prompt=10):
    return NS(due=due, first_token=first, token_times=times, ok=ok,
              prompt=np.zeros(prompt, np.int32))


def test_ttft_is_timed_from_the_due_time():
    r = [rec(10.0, 10.5, [10.5]), rec(11.0, 13.0, [13.0]),
         rec(12.0, None, [], ok=False)]
    t = stats.ttfts(r)
    assert t[0] == pytest.approx(0.5) and t[1] == pytest.approx(2.0)
    assert t[2] == math.inf


def test_itl_counts_every_gap_that_ends_in_the_window():
    r = [rec(0, 1.0, [1.0, 1.5, 2.5, 4.0]), rec(0, 3.0, [3.0, 3.1])]
    assert sorted(stats.itls(r, 1.2, 3.5)) == pytest.approx([0.1, 0.5, 1.0])
