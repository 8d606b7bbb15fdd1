"""Scene pixels served over the whole window, in Mpx/s."""

from benchmark.readers import rate_mpx


def read(record):
    return rate_mpx(record, "serve")
