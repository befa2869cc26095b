"""Runs of the harness on the CPU at 32³: the port's kernel route on the CPU
(its kernels' plain twins, taken by treating the CPU as the card) against the
reference; a cell, a metric and a configuration added as files and found by
name; the result line's keys; the control, the program in bfloat16, and the
faults a cell can have, each of which the comparison must call not correct;
and the run's refusal without a card."""

import copy
import json
from pathlib import Path

import pytest
import torch

from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.kernels import halo as khalo
from fluidsim_tpu_torch.kernels import resident as kresident
from fluidsim_tpu_torch.models import stable3d
from portbench import harness

HERE = Path(__file__).resolve().parent.parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
# The test size: 32³; sharded512 also with its emitter's radius and its
# solve cut, as the program's own tests cut it.
CUT = {"bench128": dict(size=32),
       "sharded512": dict(size=32, source_radius=2.0, jacobi_iters=4)}
KEYS = {"correct", "attempted", "failed", "metrics", "device"}

torch.set_num_threads(2)


@pytest.fixture
def kernel_route(monkeypatch):
    """The kernel path's route on the CPU: every kernel's wrapper then runs
    its plain twin, the arithmetic the card's kernels reproduce bitwise."""
    monkeypatch.setattr(stable3d, "_kernels_usable",
                        lambda cfg, device: cfg.kernel_backend != "xla" and cfg.advect_window > 0)


def catalog(tmp_path, cells=None, metrics=None):
    """A catalog whose configurations, drivers, reference and metrics are the
    benchmark's, its cells the benchmark's with short traced stretches, plus
    ``cells`` and ``metrics`` (``{name: source}``) as new files."""
    root = tmp_path / "catalog"
    root.mkdir()
    for kind in ("configs", "drivers", "reference"):
        (root / kind).symlink_to(HERE / kind)
    (root / "metrics").mkdir()
    for f in (HERE / "metrics").glob("*.py"):
        (root / "metrics" / f.name).symlink_to(f)
    for name, src in (metrics or {}).items():
        (root / "metrics" / f"{name}.py").write_text(src)
    (root / "cells").mkdir()
    for f in (HERE / "cells").glob("*.json"):
        cell = json.loads(f.read_text())
        cell["trace"] = {"units": 1, "span_units": 1}
        cell["warmup_units"] = 1
        (root / "cells" / f.name).write_text(json.dumps(cell))
    for name, cell in (cells or {}).items():
        (root / "cells" / f"{name}.json").write_text(json.dumps(cell))
    return root


def run(tmp_path, cell, trace=False, bench=BENCH, root=None, **kw):
    root = root or catalog(tmp_path)
    config = harness.workload(bench, cell)["config"]
    return harness.run_cell(cell, 2 ** 31 + 12345, 0.05, trace, "cpu", bench=bench,
                            sim_overrides=CUT[config], log=lambda *a: None, catalog=root,
                            **kw)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_kernel_route_is_the_reference_bitwise(tmp_path, kernel_route, cell):
    """Every cell's first call and last call on the kernel route's twins
    equal the reference's steps exactly."""
    out = run(tmp_path, cell)
    assert out["line"]["correct"]
    assert all(v == 0.0 for v, _ in out["checks"].values()), out["checks"]


@pytest.mark.parametrize("cell,solve", [("bench128.steps", "float32"),
                                        ("sharded512.whole", "float32")])
def test_reference_is_within_rounding_of_the_cpu_path(tmp_path, cell, solve):
    """The port's own CPU path (``Engine(cfg, "cpu")``: the plain ops, its
    solve in float32) against the reference with a float32 solve: within
    1e-5 of each field's largest magnitude after 5 or 10 steps (they differ
    in the order of a few float32 operations, not in what they compute)."""
    config = harness.workload(BENCH, cell)["config"]
    out = harness.run_cell(cell, 99, 0.05, False, "cpu", bench=BENCH,
                           sim_overrides=dict(CUT[config], solve_dtype=solve),
                           log=lambda *a: None, catalog=catalog(tmp_path))
    assert all(v <= 1e-5 for v, _ in out["checks"].values()), out["checks"]


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_step_on_a_cpu_mesh_is_the_reference(tmp_path, shards):
    cell = dict(json.loads((HERE / "cells" / "sharded512.mesh8.json").read_text()),
                shards=shards)
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append(dict(harness.workload(BENCH, "sharded512.mesh8"),
                                   name="sharded512.meshk"))
    root = catalog(tmp_path, cells={"sharded512.meshk": cell})
    out = run(tmp_path, "sharded512.meshk", bench=bench, root=root)
    assert out["line"]["correct"]
    assert all(v == 0.0 for v, _ in out["checks"].values()), out["checks"]


def test_a_cell_and_a_metric_added_as_files_are_found_by_name(tmp_path, kernel_route):
    """A new cell (a file in ``cells/`` and a workload in BENCHMARK.json) and
    a new per-layer metric (a reader in ``metrics/`` and an entry) run with
    no other change."""
    cell = dict(json.loads((HERE / "cells" / "bench128.steps.json").read_text()),
                steps_per_dispatch=3, warmup_units=0, trace={"units": 2, "span_units": 1})
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append({"name": "bench128.three", "config": "bench128",
                               "traffic": "three", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "steps_per_s":
            m["workloads"].append("bench128.three")
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "driver",
                               "moves": "steps_per_s", "workloads": ["bench128.three"]})
    root = catalog(tmp_path, cells={"bench128.three": cell},
                   metrics={"calls_traced": "def read(run):\n    return run.trace_units\n"})
    timed = run(tmp_path, "bench128.three", bench=bench, root=root)
    assert set(timed["line"]["metrics"]) == {"steps_per_s", "setup_s"}
    traced = run(tmp_path, "bench128.three", trace=True, bench=bench, root=root)
    assert traced["line"]["metrics"]["calls_traced"] == {"value": 2, "unit": "calls"}
    assert traced["line"]["correct"] and timed["line"]["correct"]
    assert timed["line"]["attempted"] >= 1


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_exactly_the_contracts_keys(tmp_path, kernel_route, trace):
    line = run(tmp_path, "bench128.live", trace=trace)["line"]
    assert set(line) == KEYS | ({"breakdown"} if trace else set())
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {"frame_ms_p95", "setup_s"}
    json.dumps(line)


@pytest.mark.parametrize("cell", ["bench128.steps", "sharded512.mesh8", "bench128.live",
                                  "sharded512.whole"])
def test_the_control_in_bfloat16_is_not_correct(tmp_path, kernel_route, cell):
    """The program with its bfloat16 fields, the precision below the
    configuration's float32, in the program's place."""
    out = run(tmp_path, cell, program_overrides={"dtype": "bfloat16"})
    assert not out["line"]["correct"], out["checks"]


def test_fault_a_step_that_returns_its_state_unchanged(tmp_path, kernel_route, monkeypatch):
    monkeypatch.setattr(Engine, "_one_step", lambda self, state: state)
    assert not run(tmp_path, "bench128.steps")["line"]["correct"]


def test_fault_an_answer_altered_where_it_is_produced(tmp_path, kernel_route, monkeypatch):
    """K2's density carries one cell off by a thousandth of its largest
    value."""
    plain = kresident.project_advect_density_3d_plain

    def altered(*a, **kw):
        vel, p, dens = plain(*a, **kw)
        dens = dens.clone()
        dens[5, 6, 7] += 1e-3 * float(dens.abs().max())
        return vel, p, dens

    monkeypatch.setattr(kresident, "project_advect_density_3d_plain", altered)
    assert not run(tmp_path, "bench128.steps")["line"]["correct"]


def test_fault_the_exchange_between_shards_left_out(tmp_path, monkeypatch):
    """K13 builds each shard's extended arrays from its own planes alone,
    zeros where the neighbours' planes belong."""
    def no_exchange(arrays_by_shard, depth):
        out = []
        for arrays in arrays_by_shard:
            exts = []
            for x in arrays:
                e = x.new_zeros((x.shape[0], x.shape[1] + 2 * depth) + tuple(x.shape[2:]))
                e[:, depth:depth + x.shape[1]] = x
                exts.append(e)
            out.append(exts)
        return out

    monkeypatch.setattr(khalo, "halo_exchange_rdma_plain", no_exchange)
    assert not run(tmp_path, "sharded512.mesh8")["line"]["correct"]


def test_the_run_refuses_without_a_card(capsys, monkeypatch):
    import importlib.util

    spec = importlib.util.spec_from_file_location("portbench_run", HERE / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main(["--workload", "bench128.steps", "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 1
    assert capsys.readouterr().out == ""


def test_same_seed_same_inputs_and_a_large_seed_works():
    from portbench import fields

    sim = json.loads((HERE / "configs" / "bench128.json").read_text())["sim"]
    sim = dict(sim, size=32)
    a = fields.make_inputs(sim, {"cells": 0.5}, 2 ** 33 + 1, "cpu")
    b = fields.make_inputs(sim, {"cells": 0.5}, 2 ** 33 + 1, "cpu")
    c = fields.make_inputs(sim, {"cells": 0.5}, 2 ** 33 + 2, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["velocity"], c["velocity"])
    # The largest displacement of a substep stays inside the window of one cell.
    n_sub, dt = sim["advect_substeps"], sim["time_step"]
    assert float(a["velocity"].abs().max()) * dt * (32 - 2) / n_sub <= 0.5 + 1e-6
