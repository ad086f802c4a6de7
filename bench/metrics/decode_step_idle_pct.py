"""Share of the summed ``engine.decode`` span time (the model's decode
step and the host's wait for its argmax) in which no operation ran on the
device, in percent: how far the host paces the step."""
from benchlib import spans


def read(run):
    return spans.idle_pct(run)
