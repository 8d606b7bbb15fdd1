"""fused_ssim's least time over its device time in the profiled steps, %."""

from benchmark.readers import roofline


def read(record):
    return roofline(record, "train", ("fused_ssim",))
