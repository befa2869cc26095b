"""The plain PyTorch launches a step: the device operations of stretch 4 of a
traced run (``portbench/spans.py``) whose launch call was made with a
``phase.*``, ``engine.*`` or ``halo.*`` span innermost, and so outside
every kernel wrapper's ``kernel.*`` span."""

from portbench.spans import PLAIN, measure


def read(run):
    spans = measure(run)
    if spans is None or not spans.joined.ops:
        return None
    plain = sum(1 for *_, stack in spans.joined.ops if stack and stack[-1].startswith(PLAIN))
    return plain / (spans.units * spans.steps)
