"""The serving kernels' least time over their device time in the profiled scenes, %."""

from benchmark.readers import KERNELS, roofline


def read(record):
    return roofline(record, "serve", KERNELS["serve"])
