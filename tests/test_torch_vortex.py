"""The vortex128 slice of fluidsim_tpu_torch against the JAX package:

* the K1 twin with substeps and the obstacle contract, and the K3 twin with
  and without its mask, against the Pallas kernels run in interpret mode
  (as tests/test_pallas_interpret.py runs them);
* vortex128 cut to 32³ (only the size: depth, sweeps, substeps and the
  mask's shape stay as the preset has them) stepped by the port's
  ``Engine`` against the JAX ``Engine`` from one start state, on the kernel
  path (port twins against interpret-mode Pallas) and on the plain path;
* the buoyancy-fold gate against the JAX step's own gate;
* the K1 and K3 wrappers' CPU behaviour.

Tolerances: K1 rtol 2e-4, atol 5e-5 (the JAX package's own class for its
in-kernel substep and obstacle contract, tests/test_pallas_interpret.py);
the only source of difference is XLA-CPU contracting multiply-adds into
FMAs in the interpreted kernel, which three substeps carry forward.  K3 is
bitwise in velocity and pressure, as K2's projection is: it does no
multiply-add XLA could contract.

The step, with tests/test_torch_step.py's classes where they hold: after 3
plain-path steps rtol 1e-5, atol 1e-6·max|ref|; after 3 kernel-path steps
density within 1e-5·max|ρ| and velocity within 1e-3·max|v| (the bf16-solve
class: a last-bit difference from an FMA in the JAX vorticity pass moves a
bfloat16 pressure iterate by one bf16 ulp; observed 5.4e-6 and 5.7e-5).
After 20 steps neither path stays in its class, and neither does the JAX
package against itself: vorticity confinement normalises ∇|ω| (N̂ =
∇|ω| / (|∇|ω|| + 1e-5)), whose direction turns by O(1) for a last-bit
change where |ω| is near an extremum, and the cut scene is strongly forced.
Observed after 20 steps, port against JAX: kernel path 1.75e2 in density
(max 3.8e2) and 3.5e1 in velocity (max 3.0e1); plain path 2.9 and 0.45.
The JAX package from a start velocity moved by one ulp diverges from itself
by 1.95e2 and 2.8e1 (kernel path), 2.2 and 0.34 (plain path).  So after 20
steps each field of the port is held to 4× the JAX package's own divergence
from that one-ulp perturbation, and the mass and the plume's height to the
same share.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fluidsim_tpu.models.stable3d as j_s3
import fluidsim_tpu.pallas.advect as j_pa
import fluidsim_tpu.pallas.project as j_pp
from fluidsim_tpu.config import preset_bench_128 as j_bench128
from fluidsim_tpu.config import preset_vortex_128 as j_vortex128
from fluidsim_tpu.engine import Engine as JEngine
from fluidsim_tpu.pallas.resident import project_3d_resident as j_project
from fluidsim_tpu.scene.obstacles import build_obstacle_mask as j_build_mask
from fluidsim_tpu.state import FluidState as JState

import fluidsim_tpu_torch.models.stable3d as t_s3
from fluidsim_tpu_torch.models.step_kernels import PLAIN_TWINS
from fluidsim_tpu_torch.config import preset_bench_128 as t_bench128
from fluidsim_tpu_torch.config import preset_vortex_128 as t_vortex128
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy
from fluidsim_tpu_torch.kernels.advect import (
    advect_multi_3d_kernel,
    advect_multi_3d_plain,
)
from fluidsim_tpu_torch.kernels.resident import (
    project_3d_resident,
    project_3d_resident_plain,
)

torch.set_num_threads(1)

N = 32
STEPS = (3, 20)
DT = 0.03  # vortex128's time step


def smooth(n, rng, modes=6):
    """A sum of random low-wavenumber plane waves, unit amplitude."""
    z, y, x = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    out = np.zeros((n, n, n))
    for _ in range(modes):
        k = rng.integers(-3, 4, size=3)
        phase = rng.uniform(0, 2 * np.pi)
        out += np.sin(2 * np.pi * (k[0] * z + k[1] * y + k[2] * x) / n + phase)
    return out / np.sqrt(modes)


def fields(n, seed, scale):
    """A velocity of up to about ``scale`` cells per unit time and a
    positive density."""
    rng = np.random.default_rng(seed)
    vel = np.stack([smooth(n, rng) for _ in range(3)]) * scale
    dens = np.maximum(10.0 * (1.2 + smooth(n, rng)), 0.0)
    return vel.astype(np.float32), dens.astype(np.float32)


def box_mask(n):
    """tests/test_pallas_interpret.py's ``_box_obst`` pattern."""
    obst = np.zeros((n, n, n), bool)
    obst[6:10, 5:9, 7:11] = True
    return obst


def vortex_mask(n):
    obst = np.asarray(j_build_mask(j_vortex128().replace(size=n)))
    assert obst.any()
    return obst


def max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b))))


# -- K1: substeps and the obstacle contract -----------------------------


@pytest.mark.parametrize("mode", ["self", "scalar"])
@pytest.mark.parametrize("n,n_sub,mask", [(16, 2, "box"), (16, 3, "box"),
                                          (32, 3, "vortex128")])
def test_k1_substep_obstacle_twin_matches_pallas_interpret(n, n_sub, mask, mode):
    # The scale makes the backtraces reach past one cell per substep, so
    # the window clamp is exercised.
    vel, dens = fields(n, 40 + n + n_sub, scale=0.5 * n_sub)
    obst = box_mask(n) if mask == "box" else vortex_mask(n)
    n_fields = 3 if mode == "self" else 1
    # advect_multi_3d_pallas takes its XLA fallback when no slab fits: make
    # sure the JAX side really runs the interpret-mode Pallas kernel.
    assert j_pa._pick_slab(n, n_fields, n_sub * 2, True, mode == "self") is not None
    jv, tv, jo, to = (jnp.asarray(vel), torch.from_numpy(vel), jnp.asarray(obst),
                      torch.from_numpy(obst))
    if mode == "self":
        ref = j_pa.advect_multi_3d_pallas((1, 2, 3), jv, jv, DT, jo, window=1,
                                          n_sub=n_sub, interpret=True)
        got = advect_multi_3d_plain((1, 2, 3), tv, tv, DT, obst=to, n_sub=n_sub)
    else:
        ref = j_pa.advect_multi_3d_pallas((0,), jnp.asarray(dens)[None], jv, DT,
                                          jo, window=1, n_sub=n_sub,
                                          interpret=True)
        got = advect_multi_3d_plain((0,), torch.from_numpy(dens)[None], tv, DT,
                                    obst=to, n_sub=n_sub)
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        got.numpy(), ref, rtol=2e-4, atol=5e-5,
        err_msg=f"K1 {mode} n={n} n_sub={n_sub}: max abs diff "
                f"{max_diff(got.numpy(), ref):.3e}, max |ref| {np.abs(ref).max():.3e}")
    # The density's interior solid cells come out zero.
    solid = obst.copy()
    solid[[0, -1]] = solid[:, [0, -1]] = solid[:, :, [0, -1]] = False
    if mode == "scalar":
        assert np.all(got.numpy()[0][solid] == 0.0)


# -- K3: the projection with and without its mask -------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("solve_dtype", [None, "bfloat16"])
def test_k3_twin_matches_pallas_interpret_bitwise(solve_dtype, masked):
    vel, _ = fields(N, 70, scale=4.0)
    obst = vortex_mask(N) if masked else None
    ref = j_project(jnp.asarray(vel), 20,
                    obst=None if obst is None else jnp.asarray(obst),
                    interpret=True, solve_dtype=solve_dtype)
    got = project_3d_resident_plain(
        torch.from_numpy(vel), 20,
        obst=None if obst is None else torch.from_numpy(obst),
        solve_dtype=solve_dtype)
    for name, g, r in zip(("velocity", "pressure"), got, ref):
        r = np.asarray(r)
        np.testing.assert_array_equal(
            g.numpy(), r, err_msg=f"K3 {name}: max abs diff {max_diff(g.numpy(), r):.3e}")
    if masked:
        # Solid interior cells hold the mirror, not the input.
        solid = obst.copy()
        solid[[0, -1]] = solid[:, [0, -1]] = solid[:, :, [0, -1]] = False
        assert not np.array_equal(got[0].numpy()[:, solid], vel[:, solid])


# -- vortex128 at 32³, the port's Engine against the JAX Engine --------------


def start_arrays(seed=2026):
    vel, dens = fields(N, seed, scale=0.3)
    return {
        "density": dens,
        "velocity": vel,
        "pressure": np.zeros((N, N, N), np.float32),
        "obstacles": vortex_mask(N),
        "step": np.zeros((), np.int32),
        "time": np.zeros((), np.float32),
    }


def perturbed_start():
    """The start state with every velocity value moved by one ulp."""
    arrays = start_arrays()
    arrays["velocity"] = np.nextafter(arrays["velocity"], np.float32(np.inf))
    return arrays


def rollout_jax(backend, arrays):
    eng = JEngine(j_vortex128().replace(size=N, kernel_backend=backend))
    eng.state = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    out, done = {}, 0
    for n in STEPS:
        eng.step(n - done)
        done = n
        out[n] = {k: np.asarray(getattr(eng.state, k))
                  for k in ("density", "velocity", "pressure", "step", "time")}
    return out


def rollout_port(backend):
    eng = Engine(t_vortex128().replace(size=N, kernel_backend=backend), "cpu")
    eng.state = state_from_numpy(start_arrays(), "cpu")
    out, done = {}, 0
    for n in STEPS:
        eng.step(n - done)
        done = n
        out[n] = state_to_numpy(eng.state)
    return out


@pytest.fixture(scope="module")
def rollouts():
    with pytest.MonkeyPatch.context() as mp:
        # The JAX kernel path with interpret-mode Pallas kernels, and the
        # port's kernel path with its kernels' twins, both on the CPU.
        mp.setattr(j_s3, "_pallas_usable", lambda cfg: cfg.kernel_backend != "xla")
        for mod, name in ((j_pa, "advect_multi_3d_pallas"),
                          (j_pp, "project_3d_pallas")):
            mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                    interpret=True))
        mp.setattr(t_s3, "_kernels_usable",
                   lambda cfg, device: cfg.kernel_backend != "xla")
        out = {}
        for backend in ("auto", "xla"):
            out[("jax", backend)] = rollout_jax(backend, start_arrays())
            out[("jax-ulp", backend)] = rollout_jax(backend, perturbed_start())
            out[("port", backend)] = rollout_port(backend)
        return out


def assert_state_close(got, ref, what):
    for field in ("density", "velocity", "pressure"):
        r = ref[field]
        atol = 1e-6 * float(np.abs(r).max())
        np.testing.assert_allclose(
            got[field], r, rtol=1e-5, atol=atol,
            err_msg=f"{what} {field}: max abs diff {max_diff(got[field], r):.3e}, "
                    f"max |ref| {float(np.abs(r).max()):.3e}")
    assert got["step"] == ref["step"]
    assert got["time"] == ref["time"]


def mass_and_height(state):
    d = state["density"].astype(np.float64)
    mass = d.sum()
    return mass, float((d * np.arange(N)[None, :, None]).sum() / mass)


def test_vortex128_kernel_path_3_steps(rollouts):
    ref, got = rollouts[("jax", "auto")][3], rollouts[("port", "auto")][3]
    assert float(ref["density"].sum()) > float(start_arrays()["density"].sum())
    for field, bound in (("density", 1e-5), ("velocity", 1e-3)):
        scale = float(np.abs(ref[field]).max())
        diff = max_diff(got[field], ref[field])
        assert diff <= bound * scale, (
            f"{field}: max abs diff {diff:.3e} > {bound} x max {scale:.3e}")
    assert got["step"] == ref["step"] and got["time"] == ref["time"]


def test_vortex128_plain_path_3_steps(rollouts):
    assert_state_close(rollouts[("port", "xla")][3], rollouts[("jax", "xla")][3],
                       "plain path, 3 steps")


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_vortex128_20_steps_within_jax_own_sensitivity(rollouts, backend):
    ref = rollouts[("jax", backend)][20]
    got = rollouts[("port", backend)][20]
    ulp = rollouts[("jax-ulp", backend)][20]
    for field in ("density", "velocity", "pressure"):
        diff, own = max_diff(got[field], ref[field]), max_diff(ulp[field], ref[field])
        assert 0.0 < own and diff <= 4.0 * own, (
            f"{backend} {field}: max abs diff {diff:.3e} > 4 x the JAX package's "
            f"own one-ulp divergence {own:.3e}")
    (m_ref, h_ref), (m_got, h_got), (m_ulp, h_ulp) = map(mass_and_height,
                                                         (ref, got, ulp))
    assert abs(m_got - m_ref) <= 4.0 * abs(m_ulp - m_ref) + 1e-6 * m_ref
    assert abs(h_got - h_ref) <= 4.0 * abs(h_ulp - h_ref) + 1e-6 * h_ref
    assert got["step"] == ref["step"] == 20 and got["time"] == ref["time"]


def test_vortex128_obstacle_cells_end_at_zero(rollouts):
    solid = start_arrays()["obstacles"].copy()
    solid[[0, -1]] = solid[:, [0, -1]] = solid[:, :, [0, -1]] = False
    for key in (("port", "auto"), ("port", "xla")):
        for steps in STEPS:
            assert np.all(rollouts[key][steps]["velocity"][:, solid] == 0.0), key


# -- the buoyancy-fold gate -------------------------------------------------


class _GateSeen(Exception):
    pass


@pytest.mark.parametrize("change", [
    {}, {"enable_obstacle": False},
    {"enable_obstacle": False, "vorticity_confinement": 0.0},
    {"enable_obstacle": False, "vorticity_confinement": 0.0,
     "fuse_buoyancy": False},
], ids=["as-shipped", "no-obstacle", "no-obstacle-no-vorticity", "no-fuse"])
@pytest.mark.parametrize("preset", ["bench128", "vortex128"])
def test_fold_buoyancy_gate_matches_jax(monkeypatch, preset, change):
    """The JAX step decides the fold inline: record the ``buoy`` argument
    its self-advection call receives (the call ends the step early)."""
    j_pre, t_pre = {"bench128": (j_bench128, t_bench128),
                    "vortex128": (j_vortex128, t_vortex128)}[preset]
    j_cfg = j_pre().replace(size=N, **change)
    t_cfg = t_pre().replace(size=N, **change)
    seen = {}

    def record(bs, fields, vel, dt, obst=None, window=2, n_sub=1, buoy=None,
               **kw):
        seen["fold"] = buoy is not None
        raise _GateSeen

    monkeypatch.setattr(j_s3, "_pallas_usable", lambda cfg: True)
    monkeypatch.setattr(j_pa, "advect_multi_3d_pallas", record)
    arrays = start_arrays()
    arrays["obstacles"] = np.asarray(j_build_mask(j_cfg))
    with pytest.raises(_GateSeen):
        j_s3.simulate_step_3d(
            JState(**{k: jnp.asarray(v) for k, v in arrays.items()}), j_cfg)
    assert t_s3.fold_buoyancy(t_cfg, use_kernels=True) == seen["fold"]
    assert not t_s3.fold_buoyancy(t_cfg, use_kernels=False)

    # The port's step passes the same decision to its advection call.
    def t_record(bs, fields, vel, dt, obst=None, window=1, n_sub=1, buoy=None,
                 src=None):
        seen["port"] = buoy is not None
        raise _GateSeen

    monkeypatch.setattr(t_s3, "_kernels_usable", lambda cfg, device: True)
    kernels = PLAIN_TWINS._replace(advect=t_record)
    if t_cfg.enable_obstacle and t_cfg.fuse_project_advect:
        t_cfg = t_cfg.replace(fuse_project_advect=False)
    with pytest.raises(_GateSeen):
        t_s3.simulate_step_3d(state_from_numpy(arrays, "cpu"), t_cfg, kernels)
    assert seen["port"] == seen["fold"]


# -- the wrappers on the CPU ---------------------------------------------------


def test_wrappers_on_cpu_run_the_twins():
    vel, dens = fields(16, 3, scale=1.0)
    tv, td = torch.from_numpy(vel), torch.from_numpy(dens)
    to = torch.from_numpy(box_mask(16))
    advect_multi_3d_kernel.launches = 0
    project_3d_resident.launches = 0
    for bs, f in (((1, 2, 3), tv), ((0,), td[None])):
        np.testing.assert_array_equal(
            advect_multi_3d_kernel(bs, f, tv, DT, obst=to, n_sub=3).numpy(),
            advect_multi_3d_plain(bs, f, tv, DT, obst=to, n_sub=3).numpy())
    for obst in (None, to):
        got = project_3d_resident(tv, 5, obst=obst, solve_dtype="bfloat16")
        ref = project_3d_resident_plain(tv, 5, obst=obst, solve_dtype="bfloat16")
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r.numpy())
    assert advect_multi_3d_kernel.launches == 0
    assert project_3d_resident.launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    vel, dens = fields(16, 4, scale=1.0)
    tv, td = torch.from_numpy(vel), torch.from_numpy(dens)
    to = torch.from_numpy(box_mask(16))
    with pytest.raises(NotImplementedError, match="buoyancy fold"):
        advect_multi_3d_kernel((1, 2, 3), tv, tv, DT, obst=to,
                               buoy=(td, 1.0, 0.0, 0.0))
    with pytest.raises(TypeError, match="obst"):
        advect_multi_3d_kernel((1, 2, 3), tv, tv, DT, obst=to.to(torch.uint8))
    with pytest.raises(ValueError, match="n_sub"):
        advect_multi_3d_kernel((1, 2, 3), tv, tv, DT, n_sub=0)
    with pytest.raises(ValueError, match="obst"):
        project_3d_resident(tv, 5, obst=to[:8])
    with pytest.raises(ValueError, match="iters"):
        project_3d_resident(tv, 0)


def test_engine_rasterises_the_mask_on_its_device():
    cfg = t_vortex128().replace(size=N)
    eng = Engine(cfg, "cpu")
    for change in ({}, {"obstacle_radius": 0.2}, {"obstacle_position": (0.3, 0.5, 0.5)}):
        if change:
            eng.set_config(cfg.replace(**change))
        ref = np.asarray(j_build_mask(j_vortex128().replace(size=N, **change)))
        got = eng.state.obstacles
        assert got.dtype == torch.bool and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), ref)
    eng.reset()
    np.testing.assert_array_equal(eng.state.obstacles.numpy(), ref)
