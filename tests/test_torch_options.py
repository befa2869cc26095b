"""The remaining 3D options of fluidsim_tpu_torch against the JAX package:
3D turbulent noise, the FFT pressure projection, and the fused kernels with
a window of K = 2 and 3 (K2, K2s, K2o, K8, and K1 with the folded emitter).

Tolerances, each with its reason:

* Perlin noise and ``apply_turbulent_noise_3d`` (float32): the per-op class
  of the 2D noise (tests/test_torch_forces.py), rtol 2e-6, atol 1e-6: XLA
  on the CPU may contract the gradient dot products into FMAs.
* ``project_3d_fft``: within 1e-5·max|ref| (float32 FFTs in both, with
  their own reduction orders), and the projected field's central-difference
  divergence removed to machine precision, as tests/test_solver3d.py checks.
* The windowed fused kernels' twins against the interpret-mode Pallas
  kernels: the classes the K = 1 tests hold (tests/test_torch_fused.py):
  rtol 3e-5, atol 3e-6·max|ref| for a float32 solve; what remains is
  XLA-CPU's FMA contraction in the interpreted backtrace.  Against the
  port's own unfused composition they are bitwise.
* The steps with noise or the FFT projection, 2 steps against the JAX
  package: rtol 1e-5, atol 1e-5·max|ref| (a few float32 ulps through the
  sensitive plume: the per-op differences above, carried through a step).
* The fused paths at K = 2, 3 through ``Engine`` against their unfused runs
  on the port after 10 steps: bitwise (fusion is bitwise in the JAX package,
  and the twins are K1 and K3 in sequence); the folded emitter at K = 2
  against the composed run within rtol 1e-5, atol 1e-6·max|ref| (the JAX
  package's bound for its fold).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fluidsim_tpu.models.stable3d as j_s3
import fluidsim_tpu.pallas.advect as j_pa
import fluidsim_tpu.pallas.project as j_pp
from fluidsim_tpu import config as j_config
from fluidsim_tpu.engine import Engine as JEngine
from fluidsim_tpu.ops import fft_poisson as j_fft
from fluidsim_tpu.ops import forces as j_forces
from fluidsim_tpu.pallas.resident import (
    full_step_3d_resident,
    project_advect_density_3d_resident,
)
from fluidsim_tpu.state import FluidState as JState

from fluidsim_tpu_torch import config as t_config
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.convert import state_from_numpy
from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_kernel
from fluidsim_tpu_torch.kernels.resident import (
    full_step_3d,
    project_3d_resident_plain,
    project_advect_density_3d,
)
from fluidsim_tpu_torch.models import stable3d as t_s3
from fluidsim_tpu_torch.ops import fft_poisson as t_fft
from fluidsim_tpu_torch.ops import forces as t_forces
from fluidsim_tpu_torch.scene.sources import emitter_fold_operand, src_field_add

torch.set_num_threads(1)

N = 16
DT = 0.05
DAMP = float(1.0 / (1.0 + np.float32(DT) * np.float32(2.0)))
DDAMP = float(1.0 / (1.0 + np.float32(DT) * np.float32(0.5)))


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def assert_close(got, ref, rtol, atol_rel, what):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    r = np.asarray(ref)
    atol = atol_rel * max(float(np.abs(r).max()), 1e-30)
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                               err_msg=f"{what}: max abs diff {float(np.abs(g - r).max()):.3e}")


# -- 3D turbulent noise ----------------------------------------------------------


def test_perlin_3d_like_jax():
    coords = [rand(1 + i, (N, N, N), 7.0) for i in range(3)]
    got = t_forces.perlin_3d(*(torch.from_numpy(c) for c in coords))
    ref = j_forces.perlin_3d(*(jnp.asarray(c) for c in coords))
    assert got.dtype == torch.float32
    assert_close(got, ref, 2e-6, 1e-6, "perlin_3d")


def test_turbulent_noise_3d_like_jax():
    vel = rand(4, (3, 32, 32, 32), 2.0)
    got = t_forces.apply_turbulent_noise_3d(torch.from_numpy(vel))
    ref = j_forces.apply_turbulent_noise_3d(jnp.asarray(vel))
    assert_close(got, ref, 2e-6, 1e-6, "apply_turbulent_noise_3d")
    # The walls are left alone, and the interior moves.
    assert torch.equal(got[:, 0], torch.from_numpy(vel)[:, 0])
    assert not torch.equal(got, torch.from_numpy(vel))


# -- the FFT projection ----------------------------------------------------------


def smoothed(seed):
    vel = torch.from_numpy(rand(seed, (3, N, N, N)))
    for _ in range(4):
        vel = sum(torch.roll(vel, s, ax) for ax in (1, 2, 3) for s in (-1, 1)) / 6.0
    return vel


def div_norm(v):
    d = 0.5 * ((torch.roll(v[0], -1, 2) - torch.roll(v[0], 1, 2))
               + (torch.roll(v[1], -1, 1) - torch.roll(v[1], 1, 1))
               + (torch.roll(v[2], -1, 0) - torch.roll(v[2], 1, 0)))
    return float(d[2:-2, 2:-2, 2:-2].abs().mean())


def test_fft_projection_like_jax():
    vel = smoothed(11)
    got_v, got_p = t_fft.project_3d_fft(vel)
    ref_v, ref_p = j_fft.project_3d_fft(jnp.asarray(vel.numpy()))
    assert got_p.shape == (N, N, N)
    assert_close(got_v, ref_v, 0.0, 1e-5, "project_3d_fft velocity")
    assert_close(got_p, ref_p, 0.0, 1e-5, "project_3d_fft pressure")
    assert div_norm(got_v) < div_norm(vel) * 1e-4
    np.testing.assert_array_equal(
        t_fft._wide_inv_eigenvalues((2 * N,) * 3, N + 1),
        np.asarray(j_fft._wide_inv_eigenvalues((2 * N,) * 3, N + 1)))
    got16, p16 = t_fft.project_3d_fft(vel.to(torch.bfloat16))
    assert got16.dtype == torch.bfloat16 and p16.dtype == torch.bfloat16


# -- the fused kernels at K = 2, 3 against interpret-mode Pallas ------------------


def inputs(seed, n=N, reach=2.5):
    """Seeded velocity with a backtrace of up to about ``reach`` cells at DT,
    and a positive density (torch, float32)."""
    vel = rand(seed, (3, n, n, n), reach / (DT * (n - 2) * 3.0))
    dens = np.abs(rand(seed + 1, (n, n, n), 4.0)) + 1.0
    return torch.from_numpy(vel), torch.from_numpy(dens)


def box_mask(n=N):
    obst = np.zeros((n, n, n), bool)
    obst[6:10, 5:11, 6:9] = True
    return torch.from_numpy(obst)


def descriptor(n=N):
    return emitter_fold_operand(t_config.preset_bench_128().replace(size=32),
                                torch.full((), DT)) * torch.tensor(
        [n / 32, n / 32, n / 32, 1.0, n / 32])


def j(t):
    return None if t is None else jnp.asarray(t.numpy())


@pytest.mark.parametrize("variant", ["K2", "K2s", "K2o"])
@pytest.mark.parametrize("window", [2, 3])
def test_k2_window_twins_match_pallas(window, variant):
    vel, dens = inputs(20 + window)
    kw = {"K2": {}, "K2s": {"src": descriptor()}, "K2o": {"obst": box_mask()}}[variant]
    got = project_advect_density_3d(vel, dens, 8, DT, window=window, damp=DAMP,
                                    dens_damp=DDAMP, **kw)
    ref = project_advect_density_3d_resident(
        j(vel), j(dens), 8, DT, window=window, damp=DAMP, dens_damp=DDAMP,
        interpret=True, **{k: j(v) for k, v in kw.items()})
    for name, g, r in zip(("velocity", "pressure", "density"), got, ref):
        assert_close(g, r, 3e-5, 3e-6, f"{variant} window={window} {name}")
    # Bitwise the port's own composition: K3 then K1 on the density.
    v3, p3 = project_3d_resident_plain(vel, 8, obst=kw.get("obst"), damp=DAMP)
    d = src_field_add(dens, kw["src"]) if variant == "K2s" else dens
    d3 = advect_multi_3d_kernel((0,), d[None], v3, DT, obst=kw.get("obst"), window=window)[0]
    for g, r in zip(got, (v3, p3, d3 * DDAMP)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("window", [2, 3])
def test_k8_window_twin_matches_pallas(window):
    vel, dens = inputs(30 + window)
    got = full_step_3d(vel, dens, 8, DT, window=window, damp=DAMP, dens_damp=DDAMP)
    ref = full_step_3d_resident(j(vel), j(dens), 8, DT, window=window, damp=DAMP,
                                dens_damp=DDAMP, interpret=True)
    for name, g, r in zip(("velocity", "pressure", "density"), got, ref):
        assert_close(g, r, 3e-5, 3e-6, f"K8 window={window} {name}")
    adv = advect_multi_3d_kernel((1, 2, 3), vel, vel, DT, window=window)
    for g, r in zip(got, project_advect_density_3d(adv, dens, 8, DT, window=window,
                                                   damp=DAMP, dens_damp=DDAMP)):
        assert torch.equal(g, r)


# -- the steps --------------------------------------------------------------------


def start_arrays(cfg, seed=2026):
    n = cfg.current_size
    vel = rand(seed, (3, n, n, n), 0.3)
    dens = np.abs(rand(seed + 1, (n, n, n), 3.0))
    return {"density": dens, "velocity": vel, "pressure": np.zeros((n, n, n), np.float32),
            "obstacles": np.zeros((n, n, n), bool), "step": np.zeros((), np.int32),
            "time": np.zeros((), np.float32)}


def kernel_paths(mp):
    """The JAX kernel path with interpret-mode Pallas, the port's on the
    twins, both on the CPU."""
    mp.setattr(j_s3, "_pallas_usable",
               lambda cfg: cfg.kernel_backend != "xla" and cfg.advect_window > 0)
    for mod, fn in ((j_pa, "advect_multi_3d_pallas"), (j_pp, "project_3d_pallas"),
                    (j_pp, "project_advect_density_3d_pallas"),
                    (j_pp, "full_step_3d_pallas")):
        mp.setattr(mod, fn, functools.partial(getattr(mod, fn), interpret=True))
    mp.setattr(t_s3, "_kernels_usable",
               lambda cfg, device: cfg.kernel_backend != "xla" and cfg.advect_window > 0)


def port_run(cfg, steps, arrays=None):
    eng = Engine(cfg, "cpu")
    eng.state = state_from_numpy(arrays or start_arrays(cfg), "cpu")
    eng.step(steps)
    return eng.state


@pytest.mark.parametrize("name,change", [
    ("preset_smoke_box_32", dict(pressure_solver="fft")),
    ("preset_plume_64", dict(size=32, pressure_solver="fft")),
    ("preset_plume_64", dict(size=32, apply_turbulent_noise=True)),
], ids=["smoke32-fft", "plume64-fft", "plume64-noise"])
def test_option_steps_like_jax(name, change):
    jcfg = getattr(j_config, name)().replace(**change)
    tcfg = getattr(t_config, name)().replace(**change)
    arrays = start_arrays(tcfg)
    with pytest.MonkeyPatch.context() as mp:
        kernel_paths(mp)
        jeng = JEngine(jcfg)
        jeng.state = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
        jeng.step(2)
        got = port_run(tcfg, 2, arrays)
    for field in ("density", "velocity", "pressure"):
        assert_close(getattr(got, field), getattr(jeng.state, field), 1e-5, 1e-5,
                     f"{name} {change} {field}")


def test_fft_with_obstacles_raises():
    cfg = t_config.preset_smoke_box_32().replace(pressure_solver="fft", enable_obstacle=True)
    with pytest.raises(ValueError, match="no obstacles"):
        Engine(cfg, "cpu").step(1)


def gate_cfg():
    """The BASELINE 64³ density gate's config (tests/test_oracle3d_parity.py),
    cut to 32³: K = 2."""
    return t_config.SimConfig(
        size=32, ndim=3, time_step=0.02, diffusion=1e-4, viscosity=1e-4, jacobi_iters=20,
        buoyancy=1.0, ambient_density=0.0, vorticity_confinement=0.0, advect_window=2,
        enable_custom_source=True, source_strength=60.0, source_radius=3.0,
        source_position=(0.5, 0.15, 0.5), obstacle_position=(0.5, 0.5, 0.5),
        enable_obstacle=False, double_project=False, advection_scheme="substep",
        advect_substeps=1)


def spied(calls):
    """The kernel table with each slot's calls recorded by name."""
    def spy(name, fn):
        def call(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return call

    return t_s3.HAND_KERNELS._make(spy(name, fn) for name, fn in
                                   zip(t_s3.HAND_KERNELS._fields, t_s3.HAND_KERNELS))


# The fused kernels run with the substep scheme (the JAX ``fuse_ok``); with
# one substep its advections are the semi-Lagrangian scheme's, so each fused
# config equals the preset as it is.
FUSED = dict(advection_scheme="substep", advect_substeps=1, fuse_project_advect=True)


@pytest.mark.parametrize("base,extra,slot", [
    (lambda: t_config.preset_plume_64().replace(size=32), {}, "project_advect"),
    (lambda: t_config.preset_plume_64().replace(size=32), {"fuse_self_advect": True},
     "full_step"),
    (gate_cfg, {}, "project_advect"),
], ids=["plume64-K2-K3", "plume64-K8-K3", "gate-K2-K2"])
def test_windowed_fused_paths_equal_unfused(base, extra, slot):
    """plume64 with ``fuse_project_advect`` (K2 with a K = 3 density phase),
    with ``fuse_self_advect`` too (K8 at K = 3 in both phases), and the 64³
    gate's config with ``fuse_project_advect`` (K2 at K = 2): each runs its
    fused kernel and never K3, and equals the unfused preset bitwise after
    10 steps."""
    cfg = base().replace(**FUSED, **extra)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        kernel_paths(mp)
        eng = Engine(cfg, "cpu", kernels=spied(calls))
        eng.state = state_from_numpy(start_arrays(cfg), "cpu")
        eng.step(10)
        unfused = port_run(base(), 10)
    assert calls.count(slot) == 10 and "project" not in calls
    for field in ("density", "velocity", "pressure"):
        assert torch.equal(getattr(eng.state, field), getattr(unfused, field)), field


def test_plume64_fused_like_jax():
    """plume64 fused (K2 with K = 3), 2 steps against the JAX package's fused
    step (its interpret-mode ``project_advect_density_3d_resident``)."""
    change = dict(size=32, **FUSED)
    jcfg = j_config.preset_plume_64().replace(**change)
    tcfg = t_config.preset_plume_64().replace(**change)
    arrays = start_arrays(tcfg)
    with pytest.MonkeyPatch.context() as mp:
        kernel_paths(mp)
        jeng = JEngine(jcfg)
        jeng.state = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
        jeng.step(2)
        got = port_run(tcfg, 2, arrays)
    for field in ("density", "velocity", "pressure"):
        assert_close(getattr(got, field), getattr(jeng.state, field), 1e-5, 1e-5,
                     f"plume64 fused {field}")


def test_emitter_fold_at_window_2_tracks_the_composed_run():
    """bench128 with ``advect_window=2`` and ``fuse_emitter``: K1 with the
    buoyancy and the emitter folded at K = 2, then K2s at K = 2, no emitter
    pass; after 10 steps within the composed run's bound."""
    cfg = t_config.preset_bench_128().replace(size=32, advect_window=2)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        kernel_paths(mp)
        folded = Engine(cfg.replace(fuse_emitter=True), "cpu", kernels=spied(calls))
        assert folded._folds
        folded.step(10)
        comp = Engine(cfg, "cpu")
        comp.step(10)
    assert calls == ["advect", "project_advect"] * 10
    for field in ("density", "velocity", "pressure"):
        assert_close(getattr(folded.state, field), getattr(comp.state, field), 1e-5, 1e-6,
                     f"folded vs composed {field}")
