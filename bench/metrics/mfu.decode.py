"""Model FLOPs of the tokens decoded inside the traced window, over the
window times the card's bf16 peak, in percent: the decode steps' share of
the peak, the whole step's bound beside K2's roofline."""
from benchlib import flops, work


def read(run):
    if run.timeline is None:
        return None
    return flops.decode(run) / (run.timeline.window_s
                                * work.PEAK_FLOPS_BF16) * 100.0
