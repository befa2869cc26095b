"""The host's milliseconds a step in the order between the shards' streams:
the time inside the program's ``order.sync`` spans (``ShardOrder``'s marks,
waits, holds, fetches and its outermost scope's entry and exit) in stretch 3
of a traced run (``portbench/spans.py``)."""

from portbench.spans import measure


def read(run):
    spans = measure(run)
    if spans is None or run.frames or not spans.host_s:
        return None
    return spans.host_ms().get("order")
