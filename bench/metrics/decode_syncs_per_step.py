"""Runtime calls that wait for the device (any ``*Synchronize``, and the
blocking ``cudaMemcpy``) the decode thread made inside ``engine.decode``
spans, over the number of those spans."""
from benchlib import spans


def read(run):
    return spans.syncs_per_step(run)
