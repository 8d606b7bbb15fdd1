"""Share of the profiled WSSS steps that replayed a CUDA graph, %: the
program's counter ``step.graph_replays`` over the profiled steps."""


def read(record):
    if record.get("kind") != "train" or record.get("trace") is None:
        return None
    replays = record.get("counters", {}).get("step.graph_replays", 0)
    return 100.0 * replays / record["trace"]["units"]
