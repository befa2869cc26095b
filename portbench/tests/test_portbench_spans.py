"""The readers of the program's spans (``portbench/spans.py``) on made-up span
lists and profiles whose numbers are known: host time by layer adding up to
the top-level spans, the join of each device operation to the span open at
its launch call, the mirrored annotations dropped, and each of the six
metrics; with a program that has no spans, every one reads nothing."""

import json
from pathlib import Path

import pytest

from portbench import harness, spans as spans_mod
from portbench.spans import Joined, Spans, host_layers, stacks_at
from portbench.trace import Trace

HERE = Path(__file__).resolve().parent.parent
NEW = ("host_model_ms", "host_kernels_ms", "host_order_ms", "plain_launches",
       "exchange_span_ms", "render_span_ms")


class Rec:
    """A recording's spans: ``(id, parent, name, t0_ns, t1_ns, call)``."""

    def __init__(self, spans):
        self.spans = [tuple(s) + (1,) for s in spans]


def reader(name):
    return harness.load_module("metrics", name)


def make_run(config, cell, joined_events=None, recorded=(), host_s=(), units=2):
    sim = json.loads((HERE / "configs" / f"{config}.json").read_text())["sim"]
    cell = json.loads((HERE / "cells" / f"{cell}.json").read_text())
    run = harness.Run(cell=cell, sim=sim, steps_per_unit=int(cell["steps_per_dispatch"]))
    run.trace = Trace([], [], (0.0, 1.0))
    joined = Joined.from_events(joined_events or [("window", 0, 1000, "cpu", 0, True)])
    run.program_spans = Spans(Rec(recorded).spans, list(host_s), list(host_s), joined, None,
                              run.steps_per_unit, units)
    return run


# One step of the mesh by the host (ns): shard.step 0-1000 holding phase.forces
# 0-100, phase.project 100-900 (a halo.exchange 150-350 with kernel.K13
# 200-300 and order.sync 300-340 in it; kernel.K12 400-700 with an order.sync
# 450-500 in it; order.sync 700-720), and an order.sync root 1000-1050.
MESH_SPANS = [(1, 0, "shard.step", 0, 1000), (2, 1, "phase.forces", 0, 100),
              (3, 1, "phase.project", 100, 900), (4, 3, "halo.exchange", 150, 350),
              (5, 4, "kernel.K13", 200, 300), (6, 4, "order.sync", 300, 340),
              (7, 3, "kernel.K12", 400, 700), (8, 7, "order.sync", 450, 500),
              (9, 3, "order.sync", 700, 720), (10, 0, "order.sync", 1000, 1050)]


def test_host_layers_add_up_to_the_top_level_spans():
    by = host_layers(Rec(MESH_SPANS).spans)
    assert by == {"driver": 1000 - 100 - 800, "model": 100 + (800 - 200 - 300 - 20)
                  + (200 - 100 - 40), "kernels": 100 + (300 - 50), "order": 40 + 50 + 20 + 50}
    assert sum(by.values()) == 1000 + 50


def test_stretch_3_readers_give_ms_a_step():
    run = make_run("sharded512", "sharded512.mesh8", recorded=MESH_SPANS, host_s=[1e-6])
    steps = run.steps_per_unit  # one call of 5 steps
    assert reader("host_model_ms").read(run) == pytest.approx((100 + 280 + 60) / 1e6 / steps)
    assert reader("host_kernels_ms").read(run) == pytest.approx(350 / 1e6 / steps)
    assert reader("host_order_ms").read(run) == pytest.approx(160 / 1e6 / steps)


def test_stacks_are_the_nested_spans_open_at_each_time():
    spans = [("engine.step", 0, 100), ("phase.project", 10, 60), ("kernel.K2", 20, 50),
             ("phase.sinks", 60, 70)]
    assert stacks_at(spans, [5, 20, 55, 60, 65, 100, 150, None]) == [
        ("engine.step",), ("engine.step", "phase.project", "kernel.K2"),
        ("engine.step", "phase.project"), ("engine.step", "phase.sinks"),
        ("engine.step", "phase.sinks"), (), (), ()]


# A made-up profile of two steps of a mesh on one card (us): each device
# operation launched by a runtime event of its correlation id; the spans'
# mirrors on the device's timeline are annotations, no device work.
def mesh_events():
    ev = [("window", 0, 1000, "cpu", 0, True)]
    for i, t in enumerate((0, 500)):
        ev += [("shard.step", t, t + 400, "cpu", 0, True),
               ("phase.forces", t, t + 50, "cpu", 0, True),
               ("phase.project", t + 50, t + 400, "cpu", 0, True),
               ("halo.exchange", t + 60, t + 120, "cpu", 0, True),
               ("kernel.K13", t + 70, t + 90, "cpu", 0, True),
               ("kernel.K12", t + 130, t + 150, "cpu", 0, True),
               ("phase.project", t + 100, t + 450, "device", 0, True)]  # a mirror
        c = 10 * (i + 1)
        ev += [("cudaLaunchKernel", t + 10, t + 12, "runtime", c, False),       # plain add
               ("cudaLaunchKernel", t + 100, t + 102, "runtime", c + 1, False),  # _ext_faces
               ("cudaLaunchKernel", t + 75, t + 77, "runtime", c + 2, False),    # K13
               ("cudaLaunchKernel", t + 80, t + 82, "runtime", c + 3, False),    # K13, 2nd shard
               ("cudaLaunchKernel", t + 135, t + 137, "runtime", c + 4, False),  # K12
               ("aten::add", t + 9, t + 13, "cpu", c + 2, False)]               # not a launch
        ev += [("vectorized_elementwise_kernel", t + 20, t + 40, "device", c, False),
               ("fill_kernel", t + 110, t + 115, "device", c + 1, False),
               ("exchange_kernel", t + 120, t + 180, "device", c + 2, False),
               ("exchange_kernel", t + 150, t + 200, "device", c + 3, False),
               ("jacobi_round_kernel", t + 200, t + 400, "device", c + 4, False),
               ("Memcpy HtoD", t + 401, t + 402, "device", 99 + i, False)]  # no launch found
    return ev


def test_the_join_drops_mirrors_and_finds_each_launching_span():
    j = Joined.from_events(mesh_events())
    assert len(j.ops) == 12 and "phase.project" not in [n for n, *_ in j.ops]
    stacks = {n: st for n, a, b, st in j.ops if a < 500}
    assert stacks["vectorized_elementwise_kernel"] == ("shard.step", "phase.forces")
    assert stacks["fill_kernel"] == ("shard.step", "phase.project", "halo.exchange")
    assert stacks["jacobi_round_kernel"] == ("shard.step", "phase.project", "kernel.K12")
    assert stacks["Memcpy HtoD"] == ()
    busy = 2 * (20 + 5 + 80 + 200 + 1)
    assert j.busy_us() == busy
    assert j.joined_share() == pytest.approx(1 - 2 / busy)
    idle = j.idle_by_span()
    # A step's idle: 0-20 and 40-50 under phase.forces, 50-60 under
    # phase.project, 60-70, 90-110 and 115-120 under halo.exchange, 70-90
    # under kernel.K13, 400-401 and 402-500 in no span.
    assert idle == pytest.approx({"phase.forces": 2 * 30 / 1e6, "phase.project": 2 * 10 / 1e6,
                                  "halo.exchange": 2 * 35 / 1e6, "kernel.K13": 2 * 20 / 1e6,
                                  "none": 2 * 99 / 1e6})


def test_stretch_4_readers_on_the_made_up_mesh():
    run = make_run("sharded512", "sharded512.mesh8", mesh_events())
    steps = 2 * run.steps_per_unit
    # Plain: the add under phase.forces and the faces under halo.exchange.
    assert reader("plain_launches").read(run) == pytest.approx(4 / steps)
    # Exchange: the faces and both K13 shares, their union on the streams.
    assert reader("exchange_span_ms").read(run) == pytest.approx(2 * (5 + 80) / 1e3 / steps)
    assert reader("render_span_ms").read(run) is None


def test_render_span_is_the_union_under_render_frame_a_frame():
    ev = [("window", 0, 1000, "cpu", 0, True), ("render.frame", 100, 200, "cpu", 0, True),
          ("engine.step", 0, 100, "cpu", 0, True),
          ("cudaLaunchKernel", 110, 111, "runtime", 1, False),
          ("cudaLaunchKernel", 120, 121, "runtime", 2, False),
          ("cudaLaunchKernel", 50, 51, "runtime", 3, False),
          ("cumsum_kernel", 300, 340, "device", 1, False),
          ("reduce_kernel", 330, 360, "device", 2, False),
          ("advect_kernel", 200, 300, "device", 3, False)]
    run = make_run("bench128", "bench128.live", ev, units=1)
    assert reader("render_span_ms").read(run) == pytest.approx(60 / 1e3)
    # The advection's launch under engine.step is the frame's one plain launch.
    assert reader("plain_launches").read(run) == pytest.approx(1 / run.steps_per_unit)
    assert reader("host_model_ms").read(run) is None  # a frames cell


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_gives_nothing(name, monkeypatch):
    sim = json.loads((HERE / "configs" / "bench128.json").read_text())["sim"]
    cell = json.loads((HERE / "cells" / "bench128.steps.json").read_text())
    run = harness.Run(cell=cell, sim=sim, steps_per_unit=10)
    run.trace = Trace([], [], (0.0, 1.0))
    monkeypatch.setattr(spans_mod, "program_tracing", lambda: None)
    assert reader(name).read(run) is None
    # Nor does an untraced run.
    untraced = harness.Run(cell=cell, sim=sim, steps_per_unit=10)
    assert reader(name).read(untraced) is None


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_is_in_the_benchmark_with_its_cells(name):
    bench = harness.load_benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["workloads"]
    assert (HERE / "metrics" / f"{name}.py").is_file()
