"""Share of the traced window in which no operation ran on the device
(profiler timeline), in percent."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return (1.0 - tl.busy_s / tl.window_s) * 100.0
