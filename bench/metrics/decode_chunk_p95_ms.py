"""95th percentile of the program's ``engine.decode_chunk`` spans that
merged a step, in the traced window (ms): the part of a token gap the
engine and the model spend, beside the scheduler's dispatch wait."""
from benchlib import spans


def read(run):
    return spans.chunk_p95_ms(run)
