"""95th percentile of the gaps between consecutive output tokens, over
every token of a time-sensitive request that came inside the window (ms):
what a stall behind other work does to a reader."""
from benchlib import stats


def read(run):
    gaps = stats.itls(run.tier("time-sensitive"), run.window.t_open,
                      run.window.t_close)
    return stats.percentile(gaps, 95) * 1e3 if gaps else None
