"""phase_pool's least time over its device time in the profiled scenes, %."""

from benchmark.readers import roofline


def read(record):
    return roofline(record, "serve", ("phase_pool",))
