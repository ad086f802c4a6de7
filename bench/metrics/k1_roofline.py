"""K1 (prefill attention, the port's ``flash_fwd`` kernels): the least
time of every K1 call inside the traced window (``work.flash`` from each
prefill call's shape, one call an attention layer) over K1's device time
by kernel name, in percent."""
from benchlib import work


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    t = sum(s for n, s in tl.kernel_s.items() if "flash_fwd" in n)
    m = run.model
    h, dk, dv = work.attention_dims(m)
    kh = m.get("num_key_value_heads", h) if not m.get("kv_lora_rank") else h
    bound = 0.0
    for c in run.calls:
        if c.kind in ("prefill", "prefill_batch"):
            ops, nbytes = work.flash(c.rows, c.tokens, c.tokens, h, kh, dk, dv)
            bound += m["num_hidden_layers"] * work.time_bound(ops, nbytes)
    if t <= 0 or bound <= 0:
        return None
    return bound / t * 100.0
