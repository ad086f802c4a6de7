"""Model FLOPs of every prompt prefilled and every token decoded inside
the traced window (each request at its own positions, the frozen
formulas of ``benchlib.work``), over the window times the card's bf16
peak, in percent."""
from benchlib import flops, work


def read(run):
    if run.timeline is None:
        return None
    total = flops.prefill(run) + flops.decode(run)
    return total / (run.timeline.window_s * work.PEAK_FLOPS_BF16) * 100.0
