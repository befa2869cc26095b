"""The host's milliseconds a step in the model step's own code: the self time
of the program's ``phase.*`` and ``halo.exchange`` spans (their duration
less their child ``kernel.*``, ``order.*`` and ``halo.*`` spans) in stretch
3 of a traced run (``portbench/spans.py``), calls made each after a
synchronisation with the spans on and no profiler."""

from portbench.spans import measure


def read(run):
    spans = measure(run)
    if spans is None or run.frames or not spans.host_s:
        return None
    return spans.host_ms().get("model")
