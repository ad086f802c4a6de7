"""95th percentile of how long the engine's decode job (the
time-sensitive group's job) waited between becoming runnable (woken or
requeued after a chunk: the scheduler's ``enqueue`` event) and starting on
a slot (``start_job``), from the UFS live kernel's tracer (ms)."""
from benchlib import stats


def read(run):
    if not run.sched_events:
        return None
    waits, queued = [], {}
    for e in run.sched_events:
        if e.group != run.engine.get("ts_group", "serve"):
            continue
        if e.kind == "enqueue":
            queued[e.jid] = e.t
        elif e.kind == "start_job" and e.jid in queued:
            waits.append(e.t - queued.pop(e.jid))
    return stats.percentile(waits, 95) * 1e3 if waits else None
