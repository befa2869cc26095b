"""The explicit halo-exchange sharded step of fluidsim_tpu_torch
(``parallel.sharding.sharded_step_fn``) as a whole, against the JAX
package's ``sharded_step_fn``, and its gates.

sharded512 cut to 32³ (``size=32, source_radius=2.0, jacobi_iters=4``; every
other field is the preset's: buoyancy, the emitter, two K = 1 substeps) on 4
shards of 8 planes, 2 steps from one state made from a seed (smooth fields,
tests/test_torch_multi256.py's ``start_arrays``); vortex128 (its sphere,
three substeps) and plume64 (K = 3) cut to 32³ the same way.  The JAX side
runs its Pallas kernels in interpret mode on 4 host devices; the port runs
K10's to K13's twins on ``make_mesh(["cpu"] * 4)``.  The port's ``"rdma"``
step is bitwise its ``"pallas"`` step, as the JAX package's is
(tests/test_rdma.py).

Tolerance: rtol 1e-5, atol 1e-6·max|ref| per field (tests/test_torch_step.
py's class).  The density reaches about 260, where a float32 ulp is 3e-5:
an absolute 1e-6 is below the density's resolution.  Observed max abs diff
over max|ref| after 2 steps: 1.8e-7 (density), 6.2e-7 (velocity), 3.3e-7
(pressure) with K10/K11, 1.8e-7, 5.2e-7, 3.3e-7 on the plain backend, from
XLA-CPU's FMAs in the JAX step (the buoyancy, the emitter, the interpreted
kernels); 1.8e-7, 6.2e-7, 3.3e-7 on ``"rdma"`` against the JAX ``"rdma"``
step; vortex128 4.9e-7, 5.3e-7, 2.0e-7 and plume64 6.4e-7, 5.0e-7, 1.9e-7
against the JAX ``"pallas"`` step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import fluidsim_tpu.config as j_config
from fluidsim_tpu.parallel.sharding import make_mesh as j_make_mesh
from fluidsim_tpu.parallel.sharding import shard_state as j_shard_state
from fluidsim_tpu.parallel.sharding import sharded_step_fn as j_sharded_step_fn
from fluidsim_tpu.state import FluidState as JState

import fluidsim_tpu_torch.config as t_config
import fluidsim_tpu_torch.models.stable3d as t_s3
from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy
from fluidsim_tpu_torch.models.stable3d import simulate_step_3d
from fluidsim_tpu_torch.models.step_kernels import PLAIN_TWINS, StepKernels
from fluidsim_tpu_torch.parallel import (
    make_mesh,
    shard_state,
    sharded_step_fn,
    state_sharding,
    unshard_state,
)
from fluidsim_tpu_torch.scene.sources import apply_custom_source

from test_torch_multi256 import start_arrays

torch.set_num_threads(1)

N = 32
SHARDS = 4
CUT = dict(size=N, source_radius=2.0, jacobi_iters=4)


def configs(**change):
    return (j_config.preset_sharded_512().replace(**CUT, **change),
            t_config.preset_sharded_512().replace(**CUT, **change))


class Recorder:
    """PLAIN_TWINS whose calls are recorded by slot name."""

    def __init__(self):
        self.calls = []
        self.kernels = StepKernels(*(self._wrap(name, fn)
                                     for name, fn in PLAIN_TWINS._asdict().items()))

    def _wrap(self, name, fn):
        def call(*a, **k):
            self.calls.append(name)
            return fn(*a, **k)
        return call


def start(cfg):
    """``start_arrays`` with the config's obstacle mask."""
    arrays = start_arrays()
    if cfg.enable_obstacle:
        arrays["obstacles"] = np.asarray(build_obstacle_mask(cfg))
    return arrays


def run_jax(cfg, steps, **kw):
    mesh = j_make_mesh(jax.devices()[:SHARDS])
    state = j_shard_state(JState(**{k: jnp.asarray(v) for k, v in start(cfg).items()}), mesh)
    step = j_sharded_step_fn(cfg, mesh, **kw)
    for _ in range(steps):
        state = step(state)
    return {k: np.asarray(getattr(state, k)) for k in ("density", "velocity", "pressure")}


def run_port(cfg, steps, shards=SHARDS, **kw):
    """``steps`` sharded steps from ``start(cfg)``; the global state
    (``unshard_state``)."""
    mesh = make_mesh(["cpu"] * shards)
    state = shard_state(state_from_numpy(start(cfg), "cpu"), mesh)
    step = sharded_step_fn(cfg, mesh, **kw)
    for _ in range(steps):
        state = step(state)
    return unshard_state(state)


def assert_close(got, ref, what=""):
    for field, r in ref.items():
        np.testing.assert_allclose(got[field], r, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(r).max()), err_msg=f"{what} {field}")


@pytest.mark.parametrize("backend,t", [("pallas", 2), ("xla", 1)])
def test_explicit_step_matches_jax(backend, t):
    """``halo_backend="pallas"`` (K10 and K11 per shard, T = 2) and ``"xla"``
    (the plain sweeps at T = 1, the plain advection) for 2 steps."""
    j_cfg, t_cfg = configs()
    ref = run_jax(j_cfg, 2, halo="explicit", halo_block_iters=t, halo_backend=backend,
                  pallas_interpret=True)
    got = state_to_numpy(run_port(t_cfg, 2, halo="explicit", halo_block_iters=t,
                                  halo_backend=backend))
    assert_close(got, ref)


@pytest.mark.parametrize("name,t,window", [("vortex_128", 2, None), ("plume_64", 4, None),
                                           ("plume_64", 4, 4)],
                         ids=["vortex_128-2", "plume_64-4", "plume_64-4-K4"])
def test_explicit_step_with_obstacle_and_window3_matches_jax(name, t, window):
    """vortex128 (its sphere, three substeps: the mask rides every exchange
    and K11's halo is 6 planes) at T = 2 and plume64 (K = 3, viscous
    diffusion; and at K = 4, a K11 halo of 4 planes) at T = 4, cut to 32³,
    2 steps: the port's ``"pallas"`` and ``"rdma"`` steps against the JAX
    ``"pallas"`` step (which the JAX package holds bitwise to its
    ``"rdma"`` step), and the port's two bitwise each other."""
    change = dict(size=N) if window is None else dict(size=N, advect_window=window)
    j_cfg = getattr(j_config, f"preset_{name}")().replace(**change)
    t_cfg = getattr(t_config, f"preset_{name}")().replace(**change)
    kw = dict(halo="explicit", halo_block_iters=t)
    ref = run_jax(j_cfg, 2, halo_backend="pallas", pallas_interpret=True, **kw)
    got = {backend: state_to_numpy(run_port(t_cfg, 2, halo_backend=backend, **kw))
           for backend in ("pallas", "rdma")}
    for backend, g in got.items():
        assert_close(g, ref, backend)
    for field in ("density", "velocity", "pressure"):
        np.testing.assert_array_equal(got["rdma"][field], got["pallas"][field], err_msg=field)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_substeps_match_jax(backend):
    """``sharded_step_fn(..., n_substeps=2)``: two steps a call (the JAX
    package's ``lax.scan``, the port's loop), one call against the JAX
    one's, and bitwise two calls of one step on the port."""
    j_cfg, t_cfg = configs()
    kw = dict(halo="explicit", halo_block_iters=2 if backend == "pallas" else 1,
              halo_backend=backend)
    ref = run_jax(j_cfg, 1, n_substeps=2, pallas_interpret=True, **kw)
    got = run_port(t_cfg, 1, n_substeps=2, **kw)
    assert_close(state_to_numpy(got), ref)
    steps = run_port(t_cfg, 2, **kw)
    for field in ("density", "velocity", "pressure", "time", "step"):
        assert torch.equal(getattr(got, field), getattr(steps, field)), field


def test_rdma_step_matches_jax():
    """sharded512 cut to 32³ with ``halo_backend="rdma"`` (K12 rounds, K13
    exchanges) against the JAX ``"rdma"`` step in interpret mode, and
    bitwise the port's ``"pallas"`` step."""
    j_cfg, t_cfg = configs()
    kw = dict(halo="explicit", halo_block_iters=2)
    ref = run_jax(j_cfg, 2, halo_backend="rdma", pallas_interpret=True, **kw)
    got = run_port(t_cfg, 2, halo_backend="rdma", **kw)
    assert_close(state_to_numpy(got), ref)
    pallas = run_port(t_cfg, 2, halo_backend="pallas", **kw)
    for field in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(got, field), getattr(pallas, field)), field


def test_auto_halo_is_the_unsharded_step():
    """``halo="auto"`` on 4 shards (the plain path, as on the JAX package's
    multi-shard mesh) equals the unsharded ``simulate_step_3d`` bitwise."""
    _, cfg = configs()
    got = run_port(cfg, 2, halo="auto")
    state = state_from_numpy(start_arrays(), "cpu")
    dt = cfg.effective_params()[0]
    for _ in range(2):
        d, v = apply_custom_source(state.density, state.velocity, cfg, state.time + dt)
        state = simulate_step_3d(state.replace(density=d, velocity=v), cfg)
    for field in ("density", "velocity", "pressure", "step", "time"):
        assert torch.equal(getattr(got, field), getattr(state, field)), field


def test_per_shard_calls(monkeypatch):
    """With K10 and K11 per shard, a step makes iters/T K10 calls, two K11
    calls (self-advection and density) and one K7e divergence and gradient
    per shard, and no single-card kernel call; ``halo_backend="xla"`` makes
    none of them."""
    _, cfg = configs()
    rec = Recorder()
    run_port(cfg, 1, halo="explicit", halo_block_iters=2, halo_backend="pallas",
             kernels=rec.kernels)
    assert sorted(rec.calls) == sorted(["jacobi_ext"] * SHARDS * 2 + ["advect_ext"] * SHARDS * 2
                                       + ["divergence_ext", "gradient_ext"] * SHARDS)
    rec.calls.clear()
    run_port(cfg, 1, halo="explicit", halo_backend="xla", kernels=rec.kernels)
    assert rec.calls == []


def test_per_shard_calls_on_the_rdma_backend():
    """``halo_backend="rdma"`` makes one K13 call (every shard's priming of
    the solve) and iters/T K12 calls (every shard's round) a solve, one K13
    call (every shard's slabs) before each of the two K11 calls a shard,
    one K7e divergence and gradient a shard (which read their neighbours'
    halo planes in place, with no K13 call), and no K10 call."""
    _, cfg = configs()
    rec = Recorder()
    run_port(cfg, 1, halo="explicit", halo_block_iters=2, halo_backend="rdma",
             kernels=rec.kernels)
    assert sorted(rec.calls) == sorted(["halo_exchange_rdma"] * 3 + ["jacobi_ext_rdma"] * 2
                                       + ["advect_ext"] * SHARDS * 2
                                       + ["divergence_ext", "gradient_ext"] * SHARDS)


@pytest.mark.parametrize("change", [dict(advection_scheme="maccormack", advect_window=2),
                                    dict(advect_window=0),
                                    dict(advect_window=3, advect_substeps=2)])
def test_advection_hook_only_where_it_applies(change):
    """The per-shard advection (K11) takes every scheme at a window of 1 to
    3 whose halo fits a shard, MacCormack for its forward and backward
    advections (two K11 calls a shard for each of the step's two
    advections); the exact gather (window 0) and a 6-plane halo on 8-plane
    shards keep the plain advection, while the solve still runs K10 per
    shard."""
    _, cfg = configs(**change)
    rec = Recorder()
    run_port(cfg, 1, shards=SHARDS if change.get("advect_window") != 3 else 8,
             halo="explicit", halo_block_iters=2, halo_backend="pallas", kernels=rec.kernels)
    if cfg.advection_scheme == "maccormack":
        assert rec.calls.count("advect_ext") == 2 * 2 * SHARDS
    else:
        assert "advect_ext" not in rec.calls
    assert "jacobi_ext" in rec.calls


def test_one_shard_mesh_keeps_the_single_card_kernels(monkeypatch):
    """On a one-shard mesh ``halo="auto"`` is the unsharded step with the
    single-card kernels (here their twins): Engine's step, bitwise, and the
    same kernel calls."""
    monkeypatch.setattr(t_s3, "_kernels_usable", lambda cfg, device: cfg.kernel_backend != "xla")
    _, cfg = configs()
    a, b = Recorder(), Recorder()
    eng = Engine(cfg, "cpu", kernels=a.kernels)
    eng.state = state_from_numpy(start_arrays(), "cpu")
    eng.step(2)
    got = run_port(cfg, 2, shards=1, halo="auto", kernels=b.kernels)
    assert a.calls == b.calls and "advect" in a.calls
    for field in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(got, field), getattr(eng.state, field)), field


def test_hooks_turn_the_fusions_off(monkeypatch):
    """Without hooks the kernel path of bench128 (at 32³) fuses the
    projection and the density advection (K2) and folds the buoyancy into
    K1; passing ``advect_fn`` or ``jacobi_fn`` turns both off, as in the JAX
    step; passing ``None`` for both is the step without hooks, bitwise."""
    monkeypatch.setattr(t_s3, "_kernels_usable", lambda cfg, device: cfg.kernel_backend != "xla")
    cfg = t_config.preset_bench_128().replace(size=N)
    assert t_s3.fuses_projection(cfg, True, True)
    assert t_s3.fold_buoyancy(cfg, True)
    hook = object()
    assert not t_s3.fuses_projection(cfg, True, True, jacobi_fn=hook)
    assert not t_s3.fuses_projection(cfg, True, True, advect_fn=hook)
    assert not t_s3.fold_buoyancy(cfg, True, advect_fn=hook)

    state = state_from_numpy(start_arrays(), "cpu")
    a, b = Recorder(), Recorder()
    plain = simulate_step_3d(state, cfg, a.kernels)
    hooked = simulate_step_3d(state, cfg, b.kernels, jacobi_fn=None, advect_fn=None)
    assert a.calls == b.calls == ["advect", "project_advect"]
    for field in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(plain, field), getattr(hooked, field)), field

    seen = []

    def advect_fn(bs, fields, vel, dt, obst=None):
        seen.append(bs)
        return PLAIN_TWINS.advect(bs, fields, vel, dt, obst=obst, window=cfg.advect_window,
                                  n_sub=cfg.advect_substeps)

    c = Recorder()
    simulate_step_3d(state, cfg, c.kernels, advect_fn=advect_fn)
    assert seen == [(1, 2, 3), (0,)]
    assert "project_advect" not in c.calls and "advect" not in c.calls
    with pytest.raises(ValueError, match="hooks"):
        simulate_step_3d(state, cfg, src=torch.zeros(5), advect_fn=advect_fn)


def test_gates_and_errors():
    _, cfg = configs()
    mesh = make_mesh(["cpu"] * SHARDS)
    with pytest.raises(ValueError, match="fft"):
        sharded_step_fn(cfg.replace(pressure_solver="fft"), mesh, halo="explicit")
    with pytest.raises(ValueError, match="halo_block_iters only applies"):
        sharded_step_fn(cfg, mesh, halo="auto", halo_block_iters=2)
    with pytest.raises(ValueError, match="multi-shard mesh"):
        sharded_step_fn(cfg.replace(kernel_backend="pallas"), mesh)
    with pytest.raises(ValueError, match="halo must be"):
        sharded_step_fn(cfg, mesh, halo="ppermute")
    with pytest.raises(ValueError, match="halo_backend must be"):
        sharded_step_fn(cfg, mesh, halo="explicit", halo_backend="nccl")
    # halo_backend="rdma" and bfloat16 fields step (they raised before K12,
    # K13 and bfloat16 K11 were ported).
    for change in (dict(), dict(dtype="bfloat16")):
        sharded_step_fn(cfg.replace(**change), mesh, halo="explicit", halo_block_iters=2,
                        halo_backend="rdma")
    with pytest.raises(ValueError, match="3D"):
        sharded_step_fn(t_config.preset_scene_b(), mesh)
    with pytest.raises(ValueError, match="not divisible"):
        shard_state(state_from_numpy(start_arrays(), "cpu"), make_mesh(["cpu"] * 3))


def test_mesh_layout():
    """Entries may repeat one device; a mesh that mixes device types is
    refused; a leaf's split axis is z."""
    mesh = make_mesh(["cpu"] * 8)
    assert mesh.shape["z"] == 8 and mesh.devices == (torch.device("cpu"),) * 8
    assert mesh.streams == (None,) * 8
    with pytest.raises(ValueError, match="mixes device types"):
        make_mesh(["cpu", "meta"])
    sh = state_sharding(mesh)
    assert (sh.density, sh.velocity, sh.pressure, sh.obstacles) == (0, 1, 0, 0)
    assert sh.step is None and sh.time is None
