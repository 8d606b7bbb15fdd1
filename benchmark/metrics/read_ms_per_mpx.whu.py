"""Host ms waiting on the slice reads over the Mpx of the profiled slice sets."""

from benchmark.program_spans import ms_per_mpx


def read(record):
    return ms_per_mpx(record, "serve", "serve.slices.read")
