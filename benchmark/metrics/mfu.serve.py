"""Model FLOPs of the window over its seconds, % of 989 TFLOP/s."""

from benchmark.readers import mfu


def read(record):
    return mfu(record, "serve")
