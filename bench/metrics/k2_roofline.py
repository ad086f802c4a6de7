"""K2 (decode attention, the port's ``decode_mma`` / ``decode_split``
kernels): the least time of every K2 call inside the traced window
(``work.decode`` over each step's rows and live positions, one call an
attention layer) over K2's device time by kernel name, in percent."""
from benchlib import work


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    t = sum(s for n, s in tl.kernel_s.items()
            if "decode_mma" in n or "decode_split" in n)
    m = run.model
    h, hd, _ = work.attention_dims(m)
    kh = m["num_key_value_heads"]
    bound = 0.0
    for c in run.calls:
        if c.kind == "decode_step":
            ops, nbytes = work.decode(c.rows, c.pos + 1, h, kh, hd)
            bound += m["num_hidden_layers"] * work.time_bound(ops, nbytes)
    if t <= 0 or bound <= 0:
        return None
    return bound / t * 100.0
