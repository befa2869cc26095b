"""The reduction of a ``torch.profiler`` trace to intervals: the device's
operations, the benchmark's own host spans (``record_function``) and the
traced window, on the profiler's one clock in microseconds.

The metrics' readers take their numbers from a ``Trace``: the union of the
intervals of the operations whose names match, the time the device was busy
and the gaps in which it was idle, named by the host span the benchmark was
in.
"""

from __future__ import annotations

import bisect
import re
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

WINDOW = "window"
SPANS = ("step", "render", "read")

Interval = Tuple[float, float]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The disjoint, sorted union of ``intervals``."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def short_name(name: str) -> str:
    """A kernel's name without its arguments and its namespace noise."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0][:90]


class Trace:
    """``ops``: ``(name, start, end)`` of each device operation (kernels,
    copies, sets) inside the window; ``spans``: ``(name, start, end)`` of
    the host spans; ``window``: ``(start, end)``.  Times in microseconds."""

    def __init__(self, ops: Sequence[tuple], spans: Sequence[tuple], window: Interval):
        self.window = window
        lo, hi = window
        self.ops = [(n, max(a, lo), min(b, hi)) for n, a, b in ops if b > lo and a < hi]
        self.spans = list(spans)

    @classmethod
    def from_profile(cls, prof) -> "Trace":
        """Read a finished ``torch.profiler.profile``: the window is its
        ``record_function(WINDOW)`` span.  Reads the profiler's raw events
        where it has them (``prof.events()`` builds an object tree that
        takes tens of microseconds an event)."""
        from torch.autograd import DeviceType

        raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
        if raw is not None:
            events = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3, e.device_type())
                      for e in raw.events()]
        else:
            events = [(e.name, float(e.time_range.start), float(e.time_range.end),
                       e.device_type) for e in prof.events()]
        ops, spans, window = [], [], None
        for name, a, b, kind in events:
            if name in SPANS or name == WINDOW:
                # record_function ranges are also mirrored onto the device's
                # timeline as annotations: they are not device work.
                if kind == DeviceType.CPU:
                    if name == WINDOW:
                        window = (a, b)
                    else:
                        spans.append((name, a, b))
                continue
            if kind == DeviceType.CUDA and b > a:
                ops.append((name, a, b))
        if window is None:
            raise RuntimeError("the profile holds no window span")
        return cls(ops, spans, window)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def select(self, match: Callable[[str], bool]) -> List[tuple]:
        return [op for op in self.ops if match(op[0])]

    def busy_us(self, match: Optional[Callable[[str], bool]] = None) -> float:
        """Microseconds of the window in which an operation (matching
        ``match``) ran on the device, on any stream."""
        ops = self.ops if match is None else self.select(match)
        return length(union((a, b) for _, a, b in ops))

    def device_ops(self, top: int = 10) -> List[list]:
        """The operations that took the most device time: ``[name, seconds]``
        summed over their launches."""
        by: dict = {}
        for n, a, b in self.ops:
            key = short_name(n)
            by[key] = by.get(key, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle time in the window by what the host was doing:
        ``[span, seconds]``, ``"between"`` where it was in no span."""
        lo, hi = self.window
        idle, t = [], lo
        for a, b in union((a, b) for _, a, b in self.ops):
            if a > t:
                idle.append((t, a))
            t = max(t, b)
        if t < hi:
            idle.append((t, hi))
        starts = [a for a, _ in idle]
        by: dict = {}
        for name, a, b in self.spans:
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            got = 0.0
            while i < len(idle) and idle[i][0] < b:
                got += max(0.0, min(idle[i][1], b) - max(idle[i][0], a))
                i += 1
            by[name] = by.get(name, 0.0) + got / 1e6
        by["between"] = max(length(idle) / 1e6 - sum(by.values()), 0.0)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top] if v > 0]


def matcher(*patterns: str) -> Callable[[str], bool]:
    """A test of an operation's name against regular expressions."""
    res = [re.compile(p) for p in patterns]
    return lambda name: any(r.search(name) for r in res)
