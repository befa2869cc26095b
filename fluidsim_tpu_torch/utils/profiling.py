"""Step timing and tracing (counterpart of ``fluidsim_tpu/utils/profiling.py``).

* ``StepTimer``: per-sample step times with percentile summaries, the JAX
  package's ``summary()`` keys.  On a CUDA device each sample is the time
  between two CUDA events recorded on the current stream around the block
  (the device's time for the work issued there, host gaps included); on the
  CPU it is the wall clock.
* ``trace_profile``: a context manager around ``torch.profiler`` (CPU and,
  where a card is present, CUDA activity) that writes a Chrome trace.
* ``sharded_step_part``: the part of the sharded step that a kernel's device
  time belongs to (``SHARDED_STEP_PARTS``), which ``chip_smoke.py`` and
  ``tools/torch_steps_ab.py`` report the step's time by.
* ``span``, ``spanned`` and ``tracing``: the program's spans at its layer
  boundaries (the engine's step, a phase of the model step, a halo exchange,
  the shards' order, a kernel wrapper, a frame's render).  Off (outside
  ``tracing()``) a span is one flag test and a shared no-op object; on, each
  appends a ``SpanRecord`` to the ``Recording`` that ``tracing()`` yields and,
  under an active ``torch.profiler``, opens a ``record_function`` of its name,
  so that the device operations it launches can be joined to it on the
  profiler's clock.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


class StepTimer:
    """Accumulates per-dispatch times; reports p50/p90/mean.  ``device``
    picks the clock: CUDA events on a CUDA device, else the wall clock."""

    def __init__(self, device="cpu"):
        self._cuda = torch.device(device).type == "cuda"
        self._samples: List[float] = []
        self._events: List[tuple] = []
        self._t0: Optional[object] = None

    def __enter__(self):
        if self._cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._events.append((self._t0, end))
        else:
            self._samples.append(time.perf_counter() - self._t0)
        self._t0 = None

    def _seconds(self) -> List[float]:
        if self._events:
            self._events[-1][1].synchronize()
            self._samples.extend(s.elapsed_time(e) / 1e3 for s, e in self._events)
            self._events.clear()
        return self._samples

    def summary(self, steps_per_sample=1) -> dict:
        """``steps_per_sample`` may be a scalar or a per-sample sequence
        (for a trailing partial dispatch chunk)."""
        samples = self._seconds()
        if not samples:
            return {"count": 0}
        t = np.asarray(samples)
        per = np.broadcast_to(np.asarray(steps_per_sample, float), t.shape)
        s = t / per
        return {
            "count": len(s),
            "mean_ms": float(s.mean() * 1e3),
            "p50_ms": float(np.percentile(s, 50) * 1e3),
            "p90_ms": float(np.percentile(s, 90) * 1e3),
            "steps_per_sec": float(per.sum() / t.sum()),
        }


@contextlib.contextmanager
def trace_profile(logdir: str):
    """``with trace_profile("trace_dir"):`` captures a ``torch.profiler``
    trace (CUDA activity too where a card is present) and writes it to
    ``logdir/trace.json`` for chrome://tracing or Perfetto, the program's
    spans (``tracing()`` is on inside) beside the operations they launch."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tracing(), profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# Parts of the sharded step's device time by kernel name: the first part one
# of whose keys the name holds (in any case); every other kernel is a plain op.
SHARDED_STEP_PARTS = (("K10/K12", ("jacobi_round",)), ("K11", ("advect",)),
                      ("K13", ("exchange_kernel",)),
                      ("K7e", ("divergence_ext", "gradient_ext")),
                      ("cat", ("CatArrayBatchedCopy",)), ("copies", ("copy", "Memcpy")))


def sharded_step_part(kernel: str) -> str:
    """The part of ``SHARDED_STEP_PARTS`` that the kernel named ``kernel``
    (as ``torch.profiler`` names it) belongs to, else ``"plain ops"``."""
    name = kernel.lower()
    return next((part for part, keys in SHARDED_STEP_PARTS
                 if any(k.lower() in name for k in keys)), "plain ops")


# -- the program's spans ---------------------------------------------------------


class SpanRecord(NamedTuple):
    """One closed span: its ``id`` (from 1, in the order spans opened), the id
    of the span it opened inside (``parent``, 0 for none), its ``name``, its
    start and end on ``time.perf_counter_ns``, and ``call``, the id of the
    top-level span it ran under (its own for a top-level span)."""

    id: int
    parent: int
    name: str
    t0_ns: int
    t1_ns: int
    call: int


class Recording:
    """What ``tracing()`` recorded, in memory: ``spans`` in the order they
    closed; ``peak``, the highest ``torch.cuda.memory_allocated`` read at the
    end of a span given a card (the ``phase.*`` spans; see ``span``) and that
    span's name; ``high_water``, the highest the allocator's high-water mark
    (``max_memory_allocated``) rose to since tracing began, and the name of
    the span at whose end it was first read so high (the mark rose between
    that span's reading and the one before).  Both are host reads of the
    allocator's statistics, with no synchronisation.  Spans are opened from
    one thread."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.peak: Optional[Tuple[int, str]] = None
        self.high_water: Optional[Tuple[int, str]] = None
        self._open: List[Tuple[int, int]] = []  # (id, call) of the open spans
        self._next = 1
        self._read: set = set()  # (call, name) of the spans that read the allocator
        self._marks: Dict[int, int] = {}  # card -> high-water mark last read
        if torch.cuda.is_initialized():
            for d in range(torch.cuda.device_count()):
                self._marks[d] = torch.cuda.max_memory_allocated(d)

    def self_ns(self) -> Dict[int, int]:
        """Each span's self time, ``{id: ns}``: its duration less its
        children's (which open and close inside it, one after another)."""
        out = {s.id: s.t1_ns - s.t0_ns for s in self.spans}
        for s in self.spans:
            if s.parent in out:
                out[s.parent] -= s.t1_ns - s.t0_ns
        return out

    def _memory(self, name: str, cards) -> None:
        for d in cards:
            index = d.index if d.index is not None else torch.cuda.current_device()
            # One call for both numbers, not flattened in Python as
            # ``memory_allocated`` and ``max_memory_allocated`` each do.
            stats = torch.cuda.memory_stats_as_nested_dict(index)["allocated_bytes"]["all"]
            allocated, mark = stats["current"], stats["peak"]
            if self.peak is None or allocated > self.peak[0]:
                self.peak = (allocated, name)
            if mark > self._marks.get(index, 0):
                self._marks[index] = mark
                if self.high_water is None or mark > self.high_water[0]:
                    self.high_water = (mark, name)


class _Off:
    """The span while tracing is off: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_recording: Optional[Recording] = None  # the active recording; None: tracing is off
_profiler_enabled = torch.autograd._profiler_enabled
_new_record = functools.partial(tuple.__new__, SpanRecord)  # a SpanRecord, built in C


class _Span:
    __slots__ = ("rec", "name", "cards", "id", "parent", "call", "t0", "annotation")

    def __init__(self, rec: Recording, name: str, cards: tuple):
        self.rec, self.name, self.cards = rec, name, cards

    def __enter__(self):
        rec = self.rec
        self.id = i = rec._next
        rec._next = i + 1
        self.parent, self.call = rec._open[-1] if rec._open else (0, i)
        rec._open.append((i, self.call))
        self.annotation = None
        if _profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self.cards and (self.call, self.name) not in rec._read:
            # The allocator's reading is the tracing's own cost: a child span
            # of its own, so that no layer's time holds it.
            rec._read.add((self.call, self.name))
            with _Span(rec, "trace.memory", ()):
                rec._memory(self.name, self.cards)
        t1 = time.perf_counter_ns()
        rec._open.pop()
        rec.spans.append(_new_record((self.id, self.parent, self.name, self.t0, t1, self.call)))
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, device=None):
    """``with span("phase.project", device):`` records the block as a span of
    ``name`` while ``tracing()`` is on, and does nothing otherwise.  Given a
    ``torch.device`` or a tuple of cards (CUDA devices), the span reads the
    allocator's memory of each card at its end, inside a child span
    ``trace.memory``: the first time a span of its name ends in a top-level
    call (the later steps of a call repeat its allocations)."""
    if _recording is None:
        return _OFF
    if device is None:
        cards = ()
    elif isinstance(device, torch.device):
        cards = (device,) if device.type == "cuda" else ()
    else:
        cards = device
    return _Span(_recording, name, cards)


def spanned(name: str):
    """Decorates a function: each call runs inside a span of ``name`` while
    tracing is on (``@spanned("kernel.K1")`` on a kernel's wrapper)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _recording is None:
                return fn(*args, **kwargs)
            with _Span(_recording, name, ()):
                return fn(*args, **kwargs)

        return call

    return wrap


@contextlib.contextmanager
def tracing():
    """``with tracing() as rec:`` turns the program's spans on and yields the
    ``Recording`` they append to; inside another ``tracing()`` it yields the
    active one.  Spans record nothing outside it."""
    global _recording
    if _recording is not None:
        yield _recording
        return
    rec = _recording = Recording()
    try:
        yield rec
    finally:
        _recording = None
