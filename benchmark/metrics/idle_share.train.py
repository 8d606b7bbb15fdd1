"""Share of the profiled steps in which no kernel or copy ran, %."""

from benchmark.readers import idle_share


def read(record):
    return idle_share(record, "train")
