"""Device ms a profiled step in the elementwise/BN/reduce kernel group."""

from benchmark.readers import group_ms_per_unit


def read(record):
    return group_ms_per_unit(record, "train", "elementwise_bn")
