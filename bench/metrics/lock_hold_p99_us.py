"""99th percentile of the engine lock's hold times sampled in the window
(``EngineStats.lock_hold_s``), in microseconds."""
from benchlib import stats


def read(run):
    holds = run.window.lock_holds
    return stats.percentile(holds, 99) * 1e6 if holds else None
