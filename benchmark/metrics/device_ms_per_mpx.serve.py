"""Device busy ms over the Mpx served in the profiled scenes."""

from benchmark.readers import busy_ms_per_mpx


def read(record):
    return busy_ms_per_mpx(record, "serve")
