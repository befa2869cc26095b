"""The program's spans (``fluidsim_tpu_torch/utils/profiling.py``) on the
CPU: off, ``span`` is one shared no-op object and nothing is recorded; on,
spans nest under their parent and share their top-level call's id, a span's
self time is its duration less its children's, and under a CPU
``torch.profiler`` each span is a user annotation of its name.  An ``Engine``
at smoke32 records its step's layers in the step's order, and a 2-shard CPU
mesh of sharded512 records the sharded step's, its halo exchanges and the
shards' order.  The kernel spans' counts against the launch counters are
card tests (``tests/test_torch_cuda.py``)."""

import collections

import torch
from torch.profiler import ProfilerActivity, profile

from fluidsim_tpu_torch.config import preset_sharded_512, preset_smoke_box_32
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.kernels import halo as khalo
from fluidsim_tpu_torch.kernels import project as kproject
from fluidsim_tpu_torch.parallel import make_mesh, shard_state, sharded_step_fn
from fluidsim_tpu_torch.state import zeros_state
from fluidsim_tpu_torch.utils import profiling
from fluidsim_tpu_torch.utils.profiling import Recording, SpanRecord, span, spanned, tracing


def by_open(rec):
    """The recording's spans in the order they opened."""
    return sorted(rec.spans, key=lambda s: s.id)


def test_off_a_span_is_one_shared_object_and_records_nothing():
    assert profiling._recording is None
    first, second = span("engine.step"), span("phase.project", torch.device("cpu"))
    assert first is second
    with first:
        with second:
            pass
    with tracing() as rec:
        pass
    assert rec.spans == [] and rec.peak is None and rec.high_water is None
    with span("engine.step"):
        pass
    assert rec.spans == [] and profiling._recording is None


def test_a_span_nests_under_its_parent_and_shares_its_calls_id():
    with tracing() as rec:
        with span("engine.step"):
            with span("phase.project"):
                with span("kernel.K2"):
                    pass
            with span("phase.sinks"):
                pass
        with span("engine.step"):
            pass
    names = [(s.name, s.parent, s.call) for s in by_open(rec)]
    assert names == [("engine.step", 0, 1), ("phase.project", 1, 1), ("kernel.K2", 2, 1),
                     ("phase.sinks", 1, 1), ("engine.step", 0, 5)]
    for s in rec.spans:
        assert s.t1_ns >= s.t0_ns
        if s.parent:
            parent = next(p for p in rec.spans if p.id == s.parent)
            assert parent.t0_ns <= s.t0_ns and s.t1_ns <= parent.t1_ns
    # Closed spans are appended as they close: children first.
    assert [s.name for s in rec.spans][:2] == ["kernel.K2", "phase.project"]


def test_tracing_inside_tracing_yields_the_active_recording():
    with tracing() as outer:
        with tracing() as inner:
            with span("render.frame"):
                pass
        assert inner is outer and profiling._recording is outer
    assert [s.name for s in outer.spans] == ["render.frame"]
    assert profiling._recording is None


def test_a_span_closes_when_its_block_raises():
    with tracing() as rec:
        try:
            with span("engine.step"):
                with span("phase.forces"):
                    raise ValueError("x")
        except ValueError:
            pass
        with span("engine.after"):
            pass
    assert [(s.name, s.parent) for s in by_open(rec)] == [
        ("engine.step", 0), ("phase.forces", 1), ("engine.after", 0)]


def test_self_time_is_the_duration_less_the_children():
    rec = Recording()
    rec.spans = [SpanRecord(3, 2, "kernel.K2", 30, 50, 1), SpanRecord(2, 1, "phase.project", 20, 60, 1),
                 SpanRecord(4, 1, "phase.sinks", 60, 70, 1), SpanRecord(1, 0, "engine.step", 0, 100, 1),
                 SpanRecord(5, 0, "engine.step", 100, 110, 5)]
    assert rec.self_ns() == {1: 100 - 40 - 10, 2: 40 - 20, 3: 20, 4: 10, 5: 10}
    assert sum(rec.self_ns().values()) == 100 + 10


def test_spanned_calls_straight_through_and_keeps_the_wrappers_attributes():
    calls = []

    @spanned("kernel.Kx")
    def wrapper(a, b=2):
        calls.append((a, b))
        return a + b

    wrapper.launches = 0
    assert wrapper(1) == 3 and wrapper.__name__ == "wrapper"
    with tracing() as rec:
        assert wrapper(1, b=5) == 6
    assert calls == [(1, 2), (1, 5)] and [s.name for s in rec.spans] == ["kernel.Kx"]
    # The kernel wrappers keep the counters and flags the callers read.
    assert kproject.divergence_ext_kernel.reads_peers and kproject.gradient_ext_kernel.reads_peers
    assert isinstance(khalo.advect_ext_kernel.launches, int)
    assert kproject.divergence_ext_kernel.__wrapped__.__name__ == "divergence_ext_kernel"


def test_under_a_cpu_profiler_the_spans_are_user_annotations_of_their_names():
    with tracing() as rec, profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("engine.step"):
            with span("phase.project"):
                torch.ones(8).add_(1)
    annotations = [(e.name(), e.start_ns(), e.end_ns())
                   for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]
    assert sorted(n for n, _, _ in annotations) == ["engine.step", "phase.project"]
    outer = next(a for a in annotations if a[0] == "engine.step")
    inner = next(a for a in annotations if a[0] == "phase.project")
    assert outer[1] <= inner[1] and inner[2] <= outer[2]
    assert [s.name for s in by_open(rec)] == ["engine.step", "phase.project"]
    # Without the profiler no annotation is opened.
    with tracing():
        with span("engine.step"):
            assert not torch.autograd._profiler_enabled()


def test_an_engine_records_its_steps_layers_in_order():
    eng = Engine(preset_smoke_box_32(), "cpu")
    eng.step(1)
    with tracing() as rec:
        eng.step(2, substeps_per_dispatch=2)
    spans = by_open(rec)
    assert spans[0].name == "engine.step" and spans[0].parent == 0
    assert all(s.call == spans[0].id for s in spans)
    one_step = ["engine.source", "phase.forces", "phase.advect_velocity", "phase.project",
                "phase.advect_density"]
    assert [s.name for s in spans[1:]] == one_step * 2 + ["engine.after"]
    assert all(s.parent == spans[0].id for s in spans[1:])
    # The CPU has no allocator statistics to read.
    assert rec.peak is None and rec.high_water is None


def test_a_two_shard_mesh_records_the_sharded_steps_layers():
    cfg = preset_sharded_512().replace(size=16)
    mesh = make_mesh(["cpu"] * 2)
    step = sharded_step_fn(cfg, mesh, halo="explicit", halo_block_iters=2,
                           halo_backend="rdma")
    state = step(shard_state(zeros_state(cfg, "cpu"), mesh))
    with tracing() as rec:
        step(state)
    spans = by_open(rec)
    ids = {s.id: s for s in spans}
    names = collections.Counter(s.name for s in spans)
    assert names["shard.step"] == 1
    for name in ("phase.source", "phase.forces", "phase.advect_velocity", "phase.project",
                 "phase.advect_density", "halo.exchange", "order.sync"):
        assert names[name] >= 1, name
    step_span = next(s for s in spans if s.name == "shard.step")
    phases = [s.name for s in spans if s.parent == step_span.id and s.name.startswith("phase.")]
    assert phases == ["phase.source", "phase.forces", "phase.advect_velocity", "phase.project",
                      "phase.advect_density"]
    # Every halo exchange runs inside a phase, and the kernels' wrappers (their
    # twins on the CPU) inside the phases too.
    for s in spans:
        if s.name in ("halo.exchange", "kernel.K11", "kernel.K7e"):
            p = s
            while p.parent:
                p = ids[p.parent]
                if p.name.startswith("phase."):
                    break
            assert p.name.startswith("phase."), s
    assert names["kernel.K11"] == 2 * 2 and names["kernel.K7e"] == 2 * 2
