"""Median gap between consecutive output tokens, over every token of a
time-sensitive request that came inside the traced window (ms): the
steady speed of interactive decode, as the engine stamped each token."""
from benchlib import stats


def read(run):
    gaps = stats.itls(run.tier("time-sensitive"), run.window.t_open,
                      run.window.t_close)
    return stats.percentile(gaps, 50) * 1e3 if gaps else None
