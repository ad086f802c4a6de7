"""The least time the window's decode steps could take, their needed
bytes at 3.35 TB/s, over the device time of the operations they launched
(profiler, attributed by the proxy's call log), in percent.  Needed
bytes: every weight but the routed experts, the experts the step's tokens
route to, the embedding rows, and the live cache (``work.decode_step_bytes``).
Which experts a step of several rows routes to is not reported, so the
metric is read only where a step holds one row (its k experts)."""
from benchlib import work


def read(run):
    tl = run.timeline
    steps = [c for c in run.calls if c.kind == "decode_step"]
    busy = tl.kind_s.get("decode_step", 0.0) if tl else 0.0
    if not steps or busy <= 0 or any(c.rows != 1 for c in steps):
        return None
    k = run.model.get("num_experts_per_tok", 0)
    need = sum(work.decode_step_bytes(run.model, 1, c.pos + 1, k)
               for c in steps)
    return need / work.PEAK_BYTES_PER_S / busy * 100.0
