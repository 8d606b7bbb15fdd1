"""Host ms a step in the call into the train step (its enqueue)."""

from benchmark.readers import span_ms_per


def read(record):
    return span_ms_per(record, "train", ("dispatch",), "steps")
