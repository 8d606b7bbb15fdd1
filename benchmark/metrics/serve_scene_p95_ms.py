"""The 95th percentile (nearest rank) of every scene latency of the window, in ms."""

from benchmark.readers import nearest_rank


def read(record):
    return None if record.get("kind") != "serve" else 1e3 * nearest_rank(record["latencies_s"], 0.95)
