"""Launch calls (``profiling.LAUNCHES``: kernels, async copies and sets)
the decode thread made inside ``engine.decode`` spans, over the number of
those spans: a count, steady whatever the host's speed."""
from benchlib import spans


def read(run):
    return spans.launches_per_step(run)
