"""channel_sums's least time over its device time in the profiled slice sets, %."""

from benchmark.readers import roofline


def read(record):
    return roofline(record, "serve", ("channel_sums",))
