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
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List, Optional

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
    ``logdir/trace.json`` for chrome://tracing or Perfetto."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
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
