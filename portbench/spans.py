"""The program's own spans (``fluidsim_tpu_torch.utils.profiling.tracing``),
read by the per-layer metrics that name them: two more stretches of a
``--trace 1`` run, made once a run by the first of those metrics' readers
(``measure``), after the run's own stretches, its comparison and the
readings of the metrics before them, which they leave as they were.

* Stretch 3: ``trace.span_units`` calls inside ``tracing()``, each after a
  synchronisation and followed by one with the spans off, with no profiler:
  the host's time a call on and off (the tracing's cost, from calls in
  turns) and the recording of the program's spans, whose self times give
  the host's time by layer.
* Stretch 4: ``trace.units`` calls inside ``tracing()`` under
  ``torch.profiler``, where each span is also a ``record_function``: every
  device operation is joined to the innermost program span open when its
  launch call (the profiler's runtime event of the same correlation id) was
  made.

Both run on a driver of the cell built anew from the run's configuration,
with inputs made from the run's ``--seed``, and warmed up as the run was.
Where the program has no ``tracing`` (a checkout before it), or the run was
not traced, ``measure`` returns None and the metrics read nothing.  It
prints to standard error the share of the device's busy time joined to a
span, the host's time by layer, the device's idle time by innermost span
and the span at the memory peak.
"""

from __future__ import annotations

import bisect
import importlib
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .trace import Interval, length, union

# The benchmark's own annotation around stretch 4.
WINDOW = "window"
# The host layers, by the prefix of a span's name.
LAYERS = (("order.", "order"), ("kernel.", "kernels"), ("phase.", "model"),
          ("halo.", "model"), ("engine.", "driver"), ("shard.", "driver"),
          ("render.", "render"), ("trace.", "tracing"))
# The host events that are calls into the CUDA runtime or driver (a launch,
# a copy, a set): their correlation id is that of the device operation they
# started.  Operators (``aten::``) and annotations have ids of their own.
RUNTIME = "cu"
# The spans whose launches are the plain PyTorch operations of a step.
PLAIN = ("phase.", "engine.", "halo.")


def layer(name: str) -> str:
    return next((lay for prefix, lay in LAYERS if name.startswith(prefix)), "other")


def self_times(spans: Sequence[tuple]) -> List[int]:
    """Each span's self time: its duration less its children's, in the order
    of ``spans`` (``(id, parent, name, t0_ns, t1_ns, ...)``)."""
    own = {s[0]: s[4] - s[3] for s in spans}
    for s in spans:
        if s[1] in own:
            own[s[1]] -= s[4] - s[3]
    return [own[s[0]] for s in spans]


def host_layers(spans: Sequence[tuple]) -> Dict[str, float]:
    """Nanoseconds of host time by layer over ``spans``, the recording's
    ``(id, parent, name, t0_ns, t1_ns, ...)``: each span's self time (its
    duration less its children's) goes to its layer, except that inside a
    ``kernel.*`` span everything but ``order.*`` spans is the kernels'; the
    tracing's own reads of the allocator (``trace.memory``) are a layer of
    their own.  The layers add up to the top-level spans' durations."""
    by_id = {s[0]: s for s in spans}
    self_ns = dict(zip(by_id, self_times(spans)))

    def in_kernel(s) -> bool:
        while s is not None:
            if s[2].startswith("kernel."):
                return True
            s = by_id.get(s[1])
        return False

    out: Dict[str, float] = {}
    for s in spans:
        lay = layer(s[2])
        if lay not in ("order", "tracing") and in_kernel(s):
            lay = "kernels"
        out[lay] = out.get(lay, 0.0) + self_ns[s[0]]
    return out


class Joined:
    """The profile of stretch 4 reduced to intervals in microseconds:
    ``ops``, ``(name, start, end, stack)`` of each device operation in the
    window, ``stack`` the names of the program spans open at its launch
    call, outermost first (empty where none was or its launch call was not
    found); ``spans``, ``(name, start, end)`` of the program's spans;
    ``window``."""

    def __init__(self, ops: Sequence[tuple], spans: Sequence[tuple], window: Interval):
        self.window = window
        lo, hi = window
        self.ops = [(n, max(a, lo), min(b, hi), st) for n, a, b, st in ops if b > lo and a < hi]
        self.spans = list(spans)

    @classmethod
    def from_events(cls, events: Sequence[tuple]) -> "Joined":
        """``events``: ``(name, start_us, end_us, kind, correlation,
        annotation)``, ``kind`` one of ``"cpu"`` (a host operation),
        ``"runtime"`` (a launch call), ``"device"``; ``annotation`` for a
        ``record_function`` range (on the device's timeline a mirror, which
        is no device work)."""
        spans, launches, ops, window = [], {}, [], None
        for name, a, b, kind, corr, annotation in events:
            if kind == "device":
                if not annotation and b > a:
                    ops.append((name, a, b, corr))
            elif kind == "runtime":
                launches[corr] = a
            elif annotation:
                if name == WINDOW:
                    window = (a, b)
                else:
                    spans.append((name, a, b))
        if window is None:
            raise RuntimeError("the profile holds no window span")
        stacks = stacks_at(spans, [launches.get(c) for *_, c in ops])
        return cls([(n, a, b, st) for (n, a, b, _), st in zip(ops, stacks)], spans, window)

    @classmethod
    def from_profile(cls, prof) -> "Joined":
        from torch.autograd import DeviceType

        events = []
        for e in prof.profiler.kineto_results.events():
            name, annotation = e.name(), e.is_user_annotation()
            if e.device_type() == DeviceType.CUDA:
                kind = "device"
            elif not annotation and name.startswith(RUNTIME):
                kind = "runtime"
            else:
                kind = "cpu"
            events.append((name, e.start_ns() / 1e3, e.end_ns() / 1e3, kind,
                           e.correlation_id(), annotation))
        return cls.from_events(events)

    def busy_us(self, match=None) -> float:
        return length(union((a, b) for n, a, b, st in self.ops
                            if match is None or match(n, st)))

    def joined_share(self) -> Optional[float]:
        """The share of the busy time whose operations are joined to a span."""
        busy = self.busy_us()
        return self.busy_us(lambda n, st: bool(st)) / busy if busy > 0 else None

    def idle_by_span(self) -> Dict[str, float]:
        """The device's idle seconds in the window by the innermost program
        span open on the host at the time (``"none"`` outside every span)."""
        lo, hi = self.window
        idle, t = [], lo
        for a, b in union((a, b) for _, a, b, _ in self.ops):
            if a > t:
                idle.append((t, a))
            t = max(t, b)
        if t < hi:
            idle.append((t, hi))
        starts = [g[0] for g in idle]
        out: Dict[str, float] = {}
        for (a, b), name in innermost_segments(self.spans, lo, hi):
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            while i < len(idle) and idle[i][0] < b:
                got = min(idle[i][1], b) - max(idle[i][0], a)
                if got > 0:
                    out[name] = out.get(name, 0.0) + got / 1e6
                i += 1
        return out


def stacks_at(spans: Sequence[tuple], times: Sequence[Optional[float]]) -> List[Tuple[str, ...]]:
    """For each of ``times``, the names of the ``spans`` (``(name, start,
    end)``, nested) open at it, outermost first; () for None."""
    # At one time: ends (the inner first), starts (the outer first), then the
    # times asked about: a span holds its start and not its end.
    events = []
    for i, (_, a, b) in enumerate(spans):
        if b > a:
            events += [(a, 1, -b, i), (b, 0, -a, i)]
    for j, t in enumerate(times):
        if t is not None:
            events.append((t, 2, 0, j))
    out: List[Tuple[str, ...]] = [()] * len(times)
    stack: List[int] = []
    for _, what, _, i in sorted(events):
        if what == 1:
            stack.append(i)
        elif what == 0:
            stack.remove(i)
        else:
            out[i] = tuple(spans[s][0] for s in stack)
    return out


def innermost_segments(spans: Sequence[tuple], lo: float, hi: float):
    """``((start, end), name)`` of the stretches of ``[lo, hi]`` by the
    innermost of the nested ``spans`` open in each (``"none"`` where none)."""
    cuts = sorted({lo, hi} | {t for _, a, b in spans for t in (a, b) if lo < t < hi})
    mids = [(a + b) / 2 for a, b in zip(cuts, cuts[1:])]
    stacks = stacks_at(spans, mids)
    return [((a, b), st[-1] if st else "none") for (a, b), st in zip(zip(cuts, cuts[1:]), stacks)]


class Spans:
    """What the two stretches measured: ``spans`` (stretch 3's, the
    recording's ``(id, parent, name, t0_ns, t1_ns, call)``), ``host_s`` and
    ``off_s`` (the host seconds of its calls with the spans on, and of the
    calls with them off between them), ``joined`` (stretch 4), ``peak`` (the
    allocator's high-water mark in stretch 3 and the span it was first read
    at), ``steps`` a call and ``units`` (stretch 4's calls)."""

    def __init__(self, spans, host_s, off_s, joined, peak, steps: int, units: int):
        self.spans, self.host_s, self.off_s, self.joined = spans, host_s, off_s, joined
        self.peak, self.steps, self.units = peak, steps, units

    def host_ms(self) -> Dict[str, float]:
        """Stretch 3's host milliseconds a step by layer."""
        n = len(self.host_s) * self.steps
        return {k: v / 1e6 / n for k, v in host_layers(self.spans).items()}


def program_tracing():
    """The program's ``tracing``, or None where the program has none."""
    try:
        mod = importlib.import_module("fluidsim_tpu_torch.utils.profiling")
    except ImportError:
        return None
    return getattr(mod, "tracing", None)


def run_seed(default: int = 0) -> int:
    """The ``--seed`` of the command line of ``portbench/run.py``."""
    argv = sys.argv
    for i, a in enumerate(argv[:-1]):
        if a == "--seed":
            return int(argv[i + 1])
    return default


def measure(run) -> Optional[Spans]:
    """The program's spans over stretches 3 and 4 of a traced run, made once
    a run (kept on it); None where the program has no spans or the run was
    not traced."""
    if "program_spans" in vars(run):
        return run.program_spans
    run.program_spans = None
    tracing = program_tracing()
    if tracing is None or run.trace is None:
        return None
    run.program_spans = _stretches(run, tracing)
    return run.program_spans


def _stretches(run, tracing) -> Spans:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import fields as fields_mod
    from .harness import load_module, sync
    from .program import sim_config

    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    cell = run.cell
    device = torch.device("cuda" if run.trace.ops else "cpu")
    # What the run still holds beside this driver (its last states, kept for
    # the comparison).
    held = (sum(torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count()))
            if device.type == "cuda" else 0)
    inputs = fields_mod.make_inputs(run.sim, cell["inputs"], run_seed(), device)
    driver = load_module("drivers", cell["driver"]).Driver(sim_config(run.sim), cell, inputs,
                                                           device)
    del inputs
    devices = driver.devices
    cards = [d for d in devices if torch.device(d).type == "cuda"]

    def unit():
        driver.dispatch()
        if run.frames:
            driver.render().cpu()

    for _ in range(int(cell["warmup_units"]) + 1):
        unit()
    sync(devices)
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)

    def timed() -> float:
        sync(devices)
        t = time.perf_counter()
        driver.dispatch()
        t = time.perf_counter() - t
        if run.frames:
            driver.render().cpu()
        return t

    # Stretch 3: a call with the spans on, then one with them off, in turns,
    # each its own recording, the ids of each after the last's.
    spans3, host_s, off_s, peaks = [], [], [], []
    for _ in range(int(cell["trace"]["span_units"])):
        with tracing() as rec:
            host_s.append(timed())
        base = max((sp[0] for sp in spans3), default=0)
        spans3 += [(i + base, parent and parent + base, name, t0, t1, call + base)
                   for i, parent, name, t0, t1, call in rec.spans]
        peaks += [rec.high_water] if rec.high_water else []
        off_s.append(timed())
    sync(devices)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cards else [])
    units = int(cell["trace"]["units"])
    host4 = 0.0
    with tracing(), profile(activities=acts) as prof:
        with record_function(WINDOW):
            for _ in range(units):
                t = time.perf_counter()
                driver.dispatch()
                host4 += time.perf_counter() - t
                if run.frames:
                    driver.render().cpu()
            sync(devices)
    joined = Joined.from_profile(prof)
    del driver
    spans = Spans(spans3, host_s, off_s, joined, max(peaks) if peaks else None,
                  run.steps_per_unit, units)
    _report(run, spans, host4, held, log)
    return spans


def _report(run, spans: Spans, host4_s: float, held: int, log) -> None:
    steps = run.steps_per_unit
    share = spans.joined.joined_share()
    log(f"# joined to a program span: "
        f"{'none' if share is None else f'{100 * share:.2f}%'} of the device's busy time "
        f"(stretch 4, {spans.units} calls)")
    if share is not None and share < 1:
        lost: Dict[str, float] = {}
        for name, a, b, stack in spans.joined.ops:
            if not stack:
                lost[name[:60]] = lost.get(name[:60], 0.0) + (b - a) / 1e6
        log("# not joined (s): " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(lost.items(), key=lambda kv: -kv[1])[:5]))
    by = {k: v for k, v in spans.host_ms().items() if k != "render"}
    roots = [s for s in spans.spans if s[1] == 0 and layer(s[2]) != "render"]
    n = len(spans.host_s) * steps
    root_ms = sum(s[4] - s[3] for s in roots) / 1e6 / n
    on_ms, off_ms = (statistics.median(x) * 1e3 / steps for x in (spans.host_s, spans.off_s))
    log("# host ms a step by layer (stretch 3): "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
        + f"; layers {sum(by.values()):.4f}, top-level spans {root_ms:.4f}, "
        f"the calls {sum(spans.host_s) * 1e3 / n:.4f}")
    self_by: Dict[str, float] = {}
    for sp, ns in zip(spans.spans, self_times(spans.spans)):
        self_by[sp[2]] = self_by.get(sp[2], 0.0) + ns / 1e6 / n
    log("# host ms a step by span, self time (stretch 3): " + ", ".join(
        f"{k} {v:.4f}" for k, v in sorted(self_by.items(), key=lambda kv: -kv[1])[:10]))
    log(f"# tracing on (stretch 3, medians of calls in turns): {on_ms:.4f} ms a step on, "
        f"{off_ms:.4f} off, {on_ms - off_ms:+.4f} ms ({100 * (on_ms / off_ms - 1):+.1f}%)")
    if run.dispatch_s:
        base = sum(run.dispatch_s) * 1e3 / (len(run.dispatch_s) * steps)
        log(f"# against stretch 2 (untraced, its mean): {base:.4f} ms a step")
    prof_steps = [b - a for name, a, b in run.trace.spans if name == "step"]
    if prof_steps:
        log(f"# profiled with spans: {host4_s * 1e3 / (spans.units * steps):.4f} ms a step "
            f"(stretch 4) against {sum(prof_steps) / 1e3 / (len(prof_steps) * steps):.4f} "
            f"in the benchmark's profiled stretch (its calls' host time)")
    launched: Dict[str, float] = {}
    for *_, stack in spans.joined.ops:
        key = stack[-1] if stack else "none"
        launched[key] = launched.get(key, 0.0) + 1 / (spans.units * steps)
    log("# launches a step by innermost span (stretch 4): " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(launched.items(), key=lambda kv: -kv[1])))
    idle = sorted(spans.joined.idle_by_span().items(), key=lambda kv: -kv[1])[:6]
    log("# idle by span (stretch 4, s): " + ", ".join(f"{k} {v:.6f}" for k, v in idle))
    if spans.peak is not None:
        log(f"# peak by span: {spans.peak[0] / 2 ** 30:.3f} GiB high-water, reached in "
            f"{spans.peak[1]} (stretch 3); {held / 2 ** 30:.3f} GiB of it held by the run "
            f"before this driver was built")
