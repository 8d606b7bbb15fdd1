"""Host ms a step waiting on the loader and placing the batch on the device."""

from benchmark.readers import span_ms_per


def read(record):
    return span_ms_per(record, "train", ("feed", "put"), "steps")
