"""Host ms a profiled WSSS step in D's update (its two forwards, backward and RMSprop)."""

from benchmark.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "train", "adv.d_update")
