"""Seconds from the start of the process to the first timed unit."""


def read(record):
    return record["setup_s"]
