"""The milliseconds a step in which the sharded step's exchanges ran on the
card, by the program's spans: the union, over the shards' streams, of the
intervals of the device operations launched inside a ``halo.exchange`` span
(its ``kernel.K13`` children included) in stretch 4 of a traced run
(``portbench/spans.py``)."""

from portbench.spans import measure


def read(run):
    spans = measure(run)
    if spans is None:
        return None
    busy = spans.joined.busy_us(lambda name, stack: "halo.exchange" in stack)
    if busy <= 0:
        return None
    return busy / 1e3 / (spans.units * spans.steps)
