"""End-to-end statistics of a served window, each over all the requests
or tokens of the window (never medians of chunks).

Times are host monotonic seconds.  A request record carries ``due`` (when
the generator was to send it; open-loop requests are timed from it),
``first_token``, ``token_times`` and ``ok``.
"""
from __future__ import annotations

import math


def percentile(values, p: float) -> float:
    """The ``p``-th percentile (0-100) of all ``values``, linearly
    interpolated between the two nearest ranks (numpy's default); an
    infinite value (a request that never answered) sorts last."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def ttfts(requests) -> list:
    """Time to first token of each request, from when it was due; a
    request that failed or never answered counts as infinitely late."""
    out = []
    for r in requests:
        if r.ok and r.first_token is not None:
            out.append(r.first_token - r.due)
        else:
            out.append(math.inf)
    return out


def itls(requests, t0: float, t1: float) -> list:
    """Every gap between consecutive output tokens of ``requests`` whose
    later token came inside the window [t0, t1)."""
    out = []
    for r in requests:
        tt = r.token_times
        for a, b in zip(tt, tt[1:]):
            if t0 <= b < t1:
                out.append(b - a)
    return out
