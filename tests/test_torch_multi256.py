"""The multi256 slice of fluidsim_tpu_torch against the JAX package:

* multi256 and sharded512 cut to 32³ (only the size: sweeps, substeps,
  emitters and forces stay as the presets have them) stepped by the port's
  ``Engine`` against the JAX ``Engine`` from one start state, on the kernel
  path and on the plain path.  On the kernel path both sides take the slab
  route, as they do at full size: the JAX side runs its Pallas kernels in
  interpret mode with ``resident_fits`` and ``project_advect_fits`` forced
  to decline, the port its kernels' twins with its L2 gate
  (``kernels/project.resident_fits``) forced shut.  multi256 runs K1 with
  two substeps, the slab projection and K1 for the density; sharded512
  runs K1 with the buoyancy folded in and two substeps;
* multi256's three emitters (one emits velocity, one pulses) against the
  JAX package's ``apply_custom_source``;
* the projection route at full size for bench128, vortex128, multi256
  and sharded512, and the slab route's float32 solve whatever
  ``solve_dtype`` asks for.

Tolerances, with what was observed.  After 3 steps, on both paths, rtol
1e-5, atol 1e-6·max|ref| (tests/test_torch_step.py's class).  Observed max
abs diff over max|ref|: kernel path multi256 3.5e-7 (density), 3.7e-7
(velocity), 2.0e-7 (pressure), sharded512 2.1e-7, 2.4e-7, 1.7e-7; plain path
multi256 5.5e-7, 5.2e-7, 3.4e-7, sharded512 4.2e-7, 3.8e-7, 5.2e-7.  The
differences come from XLA-CPU contracting multiply-adds into FMAs (inside
the interpreted K1 on the kernel path, in the XLA composition on the plain
path); the slab projection itself is bitwise (tests/test_torch_slab.py).
Emitters: rtol 1e-6, atol 1e-6·max|ref|; observed 1.9e-5 in density (max
150) and 9.5e-7 in velocity, a float32 ulp of the values.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fluidsim_tpu.config as j_config
import fluidsim_tpu.models.stable3d as j_s3
import fluidsim_tpu.pallas.advect as j_pa
import fluidsim_tpu.pallas.project as j_pp
import fluidsim_tpu.pallas.resident as j_res
from fluidsim_tpu.engine import Engine as JEngine
from fluidsim_tpu.scene.sources import apply_custom_source as j_apply_source
from fluidsim_tpu.state import FluidState as JState

import fluidsim_tpu_torch.config as t_config
import fluidsim_tpu_torch.models.stable3d as t_s3
from fluidsim_tpu_torch.models.step_kernels import PLAIN_TWINS
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy
from fluidsim_tpu_torch.kernels import project as t_kp
from fluidsim_tpu_torch.kernels.project import project_3d_kernel, project_3d_slab_plain
from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask
from fluidsim_tpu_torch.scene.sources import apply_custom_source

torch.set_num_threads(1)

N = 32
STEPS = 3
PRESETS = {"multi256": "preset_multi_emitter_256", "sharded512": "preset_sharded_512"}


def presets(name, **change):
    fn = PRESETS[name]
    return (getattr(j_config, fn)().replace(size=N, **change),
            getattr(t_config, fn)().replace(size=N, **change))


def smooth(n, rng, modes=6):
    """A sum of random low-wavenumber plane waves, unit amplitude."""
    z, y, x = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    out = np.zeros((n, n, n))
    for _ in range(modes):
        k = rng.integers(-3, 4, size=3)
        phase = rng.uniform(0, 2 * np.pi)
        out += np.sin(2 * np.pi * (k[0] * z + k[1] * y + k[2] * x) / n + phase)
    return out / np.sqrt(modes)


def start_arrays(seed=256):
    rng = np.random.default_rng(seed)
    vel = np.stack([smooth(N, rng) for _ in range(3)]) * 0.5
    dens = np.maximum(5.0 * (1.0 + smooth(N, rng)), 0.0)
    return {
        "density": dens.astype(np.float32),
        "velocity": vel.astype(np.float32),
        "pressure": np.zeros((N, N, N), np.float32),
        "obstacles": np.zeros((N, N, N), bool),
        "step": np.zeros((), np.int32),
        "time": np.zeros((), np.float32),
    }


def max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b))))


def rollout_jax(cfg):
    eng = JEngine(cfg)
    eng.state = JState(**{k: jnp.asarray(v) for k, v in start_arrays().items()})
    eng.step(STEPS)
    return {k: np.asarray(getattr(eng.state, k))
            for k in ("density", "velocity", "pressure", "step", "time")}


def rollout_port(cfg):
    eng = Engine(cfg, "cpu")
    eng.state = state_from_numpy(start_arrays(), "cpu")
    eng.step(STEPS)
    return state_to_numpy(eng.state)


@pytest.fixture(scope="module", params=sorted(PRESETS))
def rollouts(request):
    name = request.param
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # Both kernel paths on the CPU and on the slab route: interpret-mode
        # Pallas on the JAX side, the kernels' twins on the port's.
        mp.setattr(j_s3, "_pallas_usable", lambda cfg: cfg.kernel_backend != "xla")
        mp.setattr(j_res, "resident_fits", lambda *a, **k: False)
        mp.setattr(j_res, "project_advect_fits", lambda *a, **k: None)
        for mod, fn in ((j_pa, "advect_multi_3d_pallas"),
                        (j_pp, "project_3d_pallas"),
                        (j_pp, "project_advect_density_3d_pallas")):
            mp.setattr(mod, fn, functools.partial(getattr(mod, fn), interpret=True))
        mp.setattr(t_s3, "_kernels_usable",
                   lambda cfg, device: cfg.kernel_backend != "xla")
        mp.setattr(t_kp, "resident_fits", lambda *a: False)
        for backend in ("auto", "xla"):
            j_cfg, t_cfg = presets(name, kernel_backend=backend)
            out[("jax", backend)] = rollout_jax(j_cfg)
            out[("port", backend)] = rollout_port(t_cfg)
    return name, out


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_3_steps_match_jax(rollouts, backend):
    """``auto`` is the kernel path, ``xla`` the plain path."""
    name, out = rollouts
    ref, got = out[("jax", backend)], out[("port", backend)]
    assert float(ref["density"].sum()) > float(start_arrays()["density"].sum())
    for field in ("density", "velocity", "pressure"):
        r = ref[field]
        np.testing.assert_allclose(
            got[field], r, rtol=1e-5, atol=1e-6 * float(np.abs(r).max()),
            err_msg=f"{name} {backend} {field}: max abs diff "
                    f"{max_diff(got[field], r):.3e}, max |ref| {float(np.abs(r).max()):.3e}")
    assert got["step"] == ref["step"] == STEPS and got["time"] == ref["time"]


@pytest.mark.parametrize("t", [0.02, 0.25, 0.77])
def test_multi256_emitters_match_jax(t):
    """Three emitters: the main one, one emitting velocity along +y, one
    pulsing at 2 Hz; ``t`` moves the pulse."""
    j_cfg, t_cfg = presets("multi256")
    assert len(t_cfg.extra_sources) == 2
    arrays = start_arrays(7)
    ref_d, ref_v = j_apply_source(jnp.asarray(arrays["density"]),
                                  jnp.asarray(arrays["velocity"]), j_cfg,
                                  jnp.float32(t))
    got_d, got_v = apply_custom_source(torch.from_numpy(arrays["density"]),
                                       torch.from_numpy(arrays["velocity"]), t_cfg,
                                       torch.tensor(t, dtype=torch.float32))
    for got, ref in ((got_d, ref_d), (got_v, ref_v)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(ref).max()))
    # The velocity emitter moved the y velocity only.
    moved = got_v.numpy() != arrays["velocity"]
    assert moved[1].any() and not moved[0].any() and not moved[2].any()


# -- the route ------------------------------------------------------------------


@pytest.mark.parametrize("preset,resident,fused", [
    ("preset_bench_128", True, True),
    ("preset_vortex_128", True, False),
    ("preset_multi_emitter_256", False, False),
    ("preset_sharded_512", False, False),
])
def test_route_at_full_size_on_an_h100(preset, resident, fused):
    """The gate at the H100's 50 MB L2: bench128 and vortex128 keep their
    resident kernels (K2, K3), multi256 and sharded512 take the slab
    route, and none of the four raises on the kernel path."""
    cfg = getattr(t_config, preset)()
    n = cfg.current_size
    assert t_kp.resident_route(n, cfg.solve_dtype, None) == resident
    assert t_kp.resident_route(n, cfg.solve_dtype, "cpu") == resident
    assert t_kp.resident_fits(n, 2 if cfg.solve_dtype == "bfloat16" else 4,
                              50 * 1024 * 1024) == resident
    assert t_s3.fuses_projection(cfg, True, resident) == fused
    assert not t_s3.fuses_projection(cfg, False, resident)
    t_s3.check_supported(cfg, True)


def test_k2_errors_fire_only_where_the_gate_picks_k2(monkeypatch):
    """multi256 asks for the fused kernel with two substeps: at 32³ the gate
    picks K2, which takes the substeps (and, with an obstacle, the mask:
    K2o), so nothing raises; with the gate shut it declines and the step
    projects on the slab route.  The twins' calls are counted."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append((name, k.get("n_sub"), k.get("obst") is not None))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(t_s3, "_kernels_usable", lambda cfg, device: True)
    kernels = PLAIN_TWINS._replace(
        project_advect=spy("K2", PLAIN_TWINS.project_advect),
        project=spy("project", PLAIN_TWINS.project))
    _, cfg = presets("multi256")
    arrays = start_arrays()
    for change in ({}, {"enable_obstacle": True}):
        t_s3.check_supported(cfg.replace(**change), True)
        arrays["obstacles"] = build_obstacle_mask(cfg.replace(**change))
        t_s3.simulate_step_3d(state_from_numpy(arrays, "cpu"),
                              cfg.replace(**change), kernels)
    assert calls == [("K2", 2, False), ("K2", 2, True)]
    monkeypatch.setattr(t_kp, "resident_fits", lambda *a: False)
    calls.clear()
    t_s3.simulate_step_3d(state_from_numpy(arrays, "cpu"), cfg, kernels)
    assert calls == [("project", None, False)]


def test_slab_route_solves_in_float32(monkeypatch):
    """A bfloat16 solve on the slab route runs in float32, as the JAX
    package's ``project_3d_pallas`` does (its slab kernels ignore
    ``solve_dtype``); observed bitwise."""
    monkeypatch.setattr(t_kp, "resident_fits", lambda *a: False)
    monkeypatch.setattr(j_res, "resident_fits", lambda *a, **k: False)
    vel = start_arrays(11)["velocity"]
    tv = torch.from_numpy(vel)
    ref_vel, ref_p = j_pp.project_3d_pallas(jnp.asarray(vel), 20, interpret=True,
                                            solve_dtype="bfloat16")
    f32 = project_3d_slab_plain(tv, 20)
    for solve_dtype in ("bfloat16", "float32", None):
        got_vel, got_p = project_3d_kernel(tv, 20, solve_dtype=solve_dtype)
        assert got_vel.dtype == got_p.dtype == torch.float32
        assert torch.equal(got_vel, f32[0]) and torch.equal(got_p, f32[1])
    np.testing.assert_array_equal(f32[0].numpy(), np.asarray(ref_vel))
    np.testing.assert_array_equal(f32[1].numpy(), np.asarray(ref_p))


def test_step_takes_the_slab_route_when_the_gate_shuts(monkeypatch):
    """The step's projection call goes to the slab route, and K2 is not
    called, once the solve does not fit: the twins' calls are counted."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(t_s3, "_kernels_usable", lambda cfg, device: True)
    monkeypatch.setattr(t_kp, "resident_fits", lambda *a: False)
    monkeypatch.setattr(t_kp, "project_3d_slab_plain",
                        spy("slab", t_kp.project_3d_slab_plain))
    kernels = PLAIN_TWINS._replace(
        project_advect=spy("K2", PLAIN_TWINS.project_advect))
    _, cfg = presets("multi256")
    state = state_from_numpy(start_arrays(), "cpu")
    t_s3.simulate_step_3d(state, cfg, kernels)
    assert calls == ["slab"]


def test_engine_decides_the_route_once(monkeypatch):
    """``Engine`` decides the projection route when it takes a config, not
    at every step, and its steps project on the route it decided."""
    calls, seen = [], []
    monkeypatch.setattr(t_kp, "resident_fits", lambda *a: calls.append(a) or False)
    monkeypatch.setattr(t_s3, "_kernels_usable", lambda cfg, device: True)

    def project(vel, iters, resident=None, **kw):
        seen.append(resident)
        return PLAIN_TWINS.project(vel, iters, resident=resident, **kw)

    _, cfg = presets("multi256")
    eng = Engine(cfg, "cpu", kernels=PLAIN_TWINS._replace(project=project))
    eng.step(2)
    assert len(calls) == 1 and seen == [False, False]
    eng.set_config(cfg.replace(size=48))
    assert len(calls) == 2
