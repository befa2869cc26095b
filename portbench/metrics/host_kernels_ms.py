"""The host's milliseconds a step inside the kernels' wrappers: the time in
the outermost ``kernel.*`` spans, less the ``order.*`` spans inside them, in
stretch 3 of a traced run (``portbench/spans.py``): the wrappers' checks,
descriptors, scratch allocations and launch calls."""

from portbench.spans import measure


def read(run):
    spans = measure(run)
    if spans is None or run.frames or not spans.host_s:
        return None
    return spans.host_ms().get("kernels")
