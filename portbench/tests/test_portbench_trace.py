"""The trace's reduction and the per-layer readers on a made-up trace whose
numbers are known: unions over streams, idle time by host span, and each
roofline and union metric."""

import json
from pathlib import Path

import pytest

from portbench import harness, roofline
from portbench.trace import Trace, union

HERE = Path(__file__).resolve().parent.parent


def reader(name):
    return harness.load_module("metrics", name)


def make_run(config, cell, ops, spans=(), window=(0.0, 1000.0), trace_units=2):
    sim = json.loads((HERE / "configs" / f"{config}.json").read_text())["sim"]
    cell = json.loads((HERE / "cells" / f"{cell}.json").read_text())
    run = harness.Run(cell=cell, sim=sim, steps_per_unit=int(cell["steps_per_dispatch"]))
    run.trace = Trace(ops, spans, window)
    run.trace_units = trace_units
    return run


def test_union_merges_overlaps_across_streams():
    assert union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]


def test_ops_are_clipped_to_the_window_and_idle_goes_to_the_host_span():
    t = Trace([("a", -10, 10), ("b", 50, 60), ("c", 55, 80), ("d", 990, 1200)],
              [("step", 0, 500), ("read", 500, 900)], (0, 1000))
    assert t.busy_us() == 10 + 30 + 10
    gaps = dict(t.idle_gaps())
    assert gaps["step"] == pytest.approx((40 + 420) / 1e6)
    assert gaps["read"] == pytest.approx(400 / 1e6)
    assert gaps["between"] == pytest.approx(90 / 1e6)
    ops = dict(t.device_ops())
    assert ops["c"] == pytest.approx(25 / 1e6)


def test_device_idle_is_the_share_outside_the_union():
    run = make_run("bench128", "bench128.steps", [("k", 0, 300), ("k", 200, 500)])
    assert reader("device_idle_pct").read(run) == pytest.approx(50.0)


def test_k2_roofline_counts_its_calls_by_the_gradient():
    bound = roofline.k2_ms(128, 60)
    ops = []
    for i in range(4):  # four calls of K2, each 0.1 ms of solve, gradient and density
        t0 = i * 200.0
        ops += [("void solve_tiled_kernel<a>(x)", t0, t0 + 60),
                ("void (anonymous namespace)::gradient_kernel<float, float, false>(x)",
                 t0 + 60, t0 + 80),
                ("void (anonymous namespace)::advect_tiled_kernel<1, false>(x)", t0 + 80, t0 + 100),
                ("void (anonymous namespace)::advect_tiled_kernel<3, true>(x)", t0 + 100, t0 + 150)]
    run = make_run("bench128", "bench128.steps", ops)
    assert reader("k2_roofline_pct").read(run) == pytest.approx(100 * bound / 0.1)


def test_k12_roofline_is_over_the_union_of_the_rounds():
    bound = roofline.k12_round_ms(512, 64, 4)
    ops = [("void jacobi_round_kernel<4, false>(x)", 0, 400) for _ in range(8)]
    run = make_run("sharded512", "sharded512.mesh8", ops)
    assert reader("k12_roofline_pct").read(run) == pytest.approx(100 * 8 * bound / 0.4)


def test_k6_roofline_counts_five_rounds_a_call():
    ops = [("void jacobi_round_kernel<4, false>(x)", i * 100, i * 100 + 96) for i in range(10)]
    run = make_run("sharded512", "sharded512.whole", ops)
    assert reader("k6_roofline_pct").read(run) == pytest.approx(
        100 * 2 * roofline.k6_ms(512, 20) / 0.96)


def test_exchange_is_the_union_of_k13_cats_and_copies_a_step():
    ops = [("exchange_kernel", 0, 100), ("CatArrayBatchedCopy", 50, 150),
           ("Memcpy DtoD (Device -> Device)", 300, 320), ("jacobi_round_kernel", 400, 900)]
    run = make_run("sharded512", "sharded512.mesh8", ops, trace_units=2)
    assert reader("exchange_ms").read(run) == pytest.approx(0.17 / 10)


@pytest.mark.parametrize("name", ["k2_roofline_pct", "k12_roofline_pct", "k6_roofline_pct",
                                  "exchange_ms", "device_idle_pct"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    run = make_run("sharded512", "sharded512.mesh8", [])
    assert reader(name).read(run) is None
