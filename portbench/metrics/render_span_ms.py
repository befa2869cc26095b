"""The device's milliseconds a frame in the render, by the program's spans:
the union of the intervals of the device operations launched inside the
``render.frame`` span in stretch 4 of a traced run (``portbench/spans.py``),
over its frames."""

from portbench.spans import measure


def read(run):
    spans = measure(run)
    if spans is None or not run.frames:
        return None
    busy = spans.joined.busy_us(lambda name, stack: "render.frame" in stack)
    if busy <= 0:
        return None
    return busy / 1e3 / spans.units
