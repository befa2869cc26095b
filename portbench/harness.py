"""One run of one cell: set-up, the measured window, the traced stretches of
a ``--trace 1`` run, the comparison with the plain reference, and the result
line.

A run goes so:

1. Set-up: the program's kernel library loaded (built on a checkout's first
   run), the inputs made from the seed on the device, the cell's driver
   built, its first call (whose output the reference later checks from the
   same inputs) and the cell's warm-up calls.  ``setup_s`` runs from the
   process's start to the first timed call.
2. The window: calls into the program for ``--seconds``: in a ``steps`` cell
   dispatched back to back and ended by a synchronisation, in a ``frames``
   cell each a frame, the image read to host memory.  The state before each
   call is kept, so the window's last call can be checked.
3. With ``--trace 1``: ``trace.units`` more calls under ``torch.profiler``
   (spans ``step``, ``render``, ``read`` around them), then
   ``trace.span_units`` calls each after a synchronisation, their host time
   (``dispatch_s``) and, in a ``frames`` cell, the render's device time by
   CUDA events.
4. The peak device memory is read; the program is freed; the reference
   follows the first call from the seed's inputs and the last call from the
   state the program held before it, and every compared number is set
   beside its limit.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import List, Optional

import torch

from . import fields as fields_mod
from .program import Counters, sim_config
from .trace import Trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FIELDS = ("density", "velocity", "pressure")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(kind: str, name: str, catalog: Path = HERE):
    """``<catalog>/<kind>/<name>.py``, loaded by its path (a name may hold
    dots)."""
    path = catalog / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(bench: dict, cell: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"BENCHMARK.json has no workload named {cell!r}")


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or with
    ``trace`` its per-layer ones (those that list the cell, or that list no
    cells and move one of its end-to-end metrics)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


@dataclasses.dataclass
class Run:
    """What a run measured, for the metrics' readers."""

    cell: dict
    sim: dict
    steps_per_unit: int
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0                      # calls (steps cells) or frames in the window
    frame_s: List[float] = dataclasses.field(default_factory=list)
    trace: Optional[Trace] = None
    trace_units: int = 0
    dispatch_s: List[float] = dataclasses.field(default_factory=list)
    render_ms: List[float] = dataclasses.field(default_factory=list)

    @property
    def frames(self) -> bool:
        return self.cell["mode"] == "frames"

    @property
    def steps(self) -> int:
        return self.units * self.steps_per_unit

    @property
    def trace_steps(self) -> int:
        return self.trace_units * self.steps_per_unit


def sync(devices) -> None:
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


def host_fields(f: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in f.items()}


def gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest gap between ``got`` and ``ref`` as a share of ``ref``'s
    largest magnitude (NaN where ``got`` is not finite)."""
    got, ref = got.to(ref.device, torch.float32), ref.float()
    if not bool(torch.isfinite(got).all()):
        return math.nan
    scale = float(ref.abs().max())
    return float((got - ref).abs().max()) / max(scale, 1e-30)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, bench: Optional[dict] = None,
             sim_overrides: Optional[dict] = None,
             program_overrides: Optional[dict] = None, log=None,
             catalog: Path = HERE) -> dict:
    """Run ``cell_name`` once and return its result: ``line`` (the result
    line's object; on the CPU its device reads ``"cpu"``), ``checks``
    (``{name: (value, limit)}``) and ``counters``.
    ``sim_overrides`` change the configuration for the program and the
    reference alike (the tests' sizes); ``program_overrides`` the program's
    alone (the control's precision).  ``catalog`` is the directory whose
    ``cells/``, ``configs/``, ``drivers/``, ``reference/`` and ``metrics/``
    hold what the names lead to."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    bench = bench if bench is not None else load_benchmark()
    entry = workload(bench, cell_name)
    cell = load_json(catalog / "cells" / f"{cell_name}.json")
    if cell["config"] != entry["config"]:
        raise ValueError(f"cell {cell_name}: config {cell['config']!r} in its file, "
                         f"{entry['config']!r} in BENCHMARK.json")
    config = load_json(catalog / "configs" / f"{cell['config']}.json")
    sim = dict(config["sim"], **(sim_overrides or {}))
    device = torch.device(device)

    if device.type == "cuda":
        from fluidsim_tpu_torch.kernels import _build

        _build.load_library()
    t_lib = time.perf_counter()
    cfg = sim_config(sim, program_overrides)
    driver_mod = load_module("drivers", cell["driver"], catalog)
    inputs = fields_mod.make_inputs(sim, cell["inputs"], seed, device)
    driver = driver_mod.Driver(cfg, cell, inputs, device)
    del inputs
    devices = driver.devices
    run = Run(cell=cell, sim=sim, steps_per_unit=driver.steps)

    def unit():
        """One call (and, in a frames cell, its frame read to the host)."""
        driver.dispatch()
        if run.frames:
            return driver.render().cpu()
        return None

    first_img = unit()
    first = host_fields(driver.fields(driver.state))
    for _ in range(int(cell["warmup_units"])):
        unit()
    sync(devices)
    counters = Counters()
    counters.start()
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    prev = driver.state
    img = None
    while True:
        f0 = time.perf_counter()
        prev = driver.state
        img = unit()
        run.units += 1
        now = time.perf_counter()
        if run.frames:
            run.frame_s.append(now - f0)
        if now - t0 >= seconds:
            break
    sync(devices)
    run.window_s = time.perf_counter() - t0
    counted = counters.stop()
    log(f"# setup {run.setup_s:.3f} s (library {t_lib - t_start:.3f} s); window "
        f"{run.window_s:.3f} s, {run.units} {'frames' if run.frames else 'calls'}, "
        f"{run.steps} steps")

    if trace:
        prev, img = traced(run, driver, devices, cell["trace"])
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if torch.device(d).type == "cuda"), default=0)

    # The program's state is freed before the reference runs.
    last, before = driver.fields(driver.state), driver.fields(prev)
    del driver, prev
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, failed = compare(load_module("reference", config["reference"], catalog), sim,
                             cell, seed, device, run.steps_per_unit, first, first_img,
                             before, last, img)
    log(f"# reference {time.perf_counter() - t_ref:.3f} s")
    correct = failed == 0

    metrics = {}
    for m in cell_metrics(bench, cell_name, trace):
        value = load_module("metrics", m["name"], catalog).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(devices[0]) if device.type == "cuda" else "cpu",
           "count": len(devices), "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = run.trace.busy_us() / 1e6
        dev["window_s"] = run.trace.window_us / 1e6
    line = {"correct": correct, "attempted": run.units, "failed": failed,
            "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = {"device_ops": run.trace.device_ops(),
                             "idle_gaps": run.trace.idle_gaps()}
    return {"line": line, "checks": checks, "counters": counted}


def traced(run: Run, driver, devices, spec: dict):
    """The profiled stretch and the stretch of host spans of a ``--trace 1``
    run; returns the state before the last call and the last frame."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if any(torch.device(d).type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    img = prev = None
    sync(devices)
    with profile(activities=acts) as prof:
        with record_function("window"):
            for _ in range(int(spec["units"])):
                prev = driver.state
                with record_function("step"):
                    driver.dispatch()
                if run.frames:
                    with record_function("render"):
                        frame = driver.render()
                    with record_function("read"):
                        img = frame.cpu()
            sync(devices)
    run.trace = Trace.from_profile(prof)
    run.trace_units = int(spec["units"])
    cuda = devices[0].type == "cuda"
    for _ in range(int(spec["span_units"])):
        sync(devices)
        prev = driver.state
        t = time.perf_counter()
        driver.dispatch()
        run.dispatch_s.append(time.perf_counter() - t)
        if run.frames:
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            frame = driver.render()
            if cuda:
                ev[1].record()
            img = frame.cpu()
            if cuda:
                run.render_ms.append(ev[0].elapsed_time(ev[1]))
    sync(devices)
    return prev, img


def compare(ref_mod, sim, cell, seed, device, steps, first, first_img, before, last,
            img) -> dict:
    """The reference's two checks: ``steps`` steps from the seed's inputs
    against the program's first call, and ``steps`` steps from the state
    before the program's last call against its output; the frames of both
    where the cell renders.  Returns ``({name: (value, limit)}, failed)``,
    each value the worse of the two checks, ``failed`` the checked calls
    with a number off its limit (or not finite)."""
    ref = ref_mod.Reference(sim, device)
    limits = {k: float(v) for k, v in cell["limits"].items()}
    worst = {k: 0.0 for k in limits}

    def judge(got: dict, start: dict, got_img) -> bool:
        d, v, p = ref.steps(start["density"].to(device), start["velocity"].to(device), steps)
        gaps = {f"{name}_gap": gap(got[name], r) for name, r in zip(FIELDS, (d, v, p))}
        if got_img is not None:
            gaps["frame_gap"] = gap(got_img, ref.render(d))
        for k, g in gaps.items():
            w = worst[k]
            worst[k] = math.nan if math.isnan(g) or math.isnan(w) else max(w, g)
        return all(g <= limits[k] for k, g in gaps.items())  # False for NaN

    inputs = fields_mod.make_inputs(sim, cell["inputs"], seed, device)
    failed = int(not judge(first, inputs, first_img))
    del inputs
    failed += int(not judge(last, before, img))
    return {k: (worst[k], limits[k]) for k in limits}, failed
