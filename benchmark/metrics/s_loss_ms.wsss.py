"""Host ms a profiled WSSS step in S's loss (the frozen G, D again, the cgenerator loss)."""

from benchmark.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "train", "adv.s_loss")
