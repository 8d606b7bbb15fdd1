"""The six kernels' least time over their device time in the profiled steps, %."""

from benchmark.readers import KERNELS, roofline


def read(record):
    return roofline(record, "train", KERNELS["train"])
