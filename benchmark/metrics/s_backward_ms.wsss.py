"""Host ms a profiled WSSS step in S's backward (autograd.grad through D into S)."""

from benchmark.program_spans import ms_per_unit


def read(record):
    return ms_per_unit(record, "train", "adv.s_backward")
