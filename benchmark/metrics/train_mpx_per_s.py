"""Input pixels trained over the whole window, in Mpx/s (WSSS: both pairs of a step)."""

from benchmark.readers import rate_mpx


def read(record):
    return rate_mpx(record, "train")
