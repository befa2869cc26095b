"""plume64, smoke32, the BASELINE 64³ density gate and ``double_project``
through fluidsim_tpu_torch, against the JAX package and tests/oracle3d.py:

* plume64 cut to 32³ (only the size: viscosity, the K = 3 window, the
  sweeps and the emitter stay) stepped by the port's ``Engine`` against the
  JAX ``Engine`` from one start state for 3 and 20 steps, on the plain path
  and on the kernel path (port twins against interpret-mode Pallas, with
  the JAX ``_pallas_usable`` opened to the 32³ grid);
* smoke32 at its own 32³ for 3 and 8 steps on the plain path, which is
  also its route on a card: no kernel takes its exact-gather advection
  (window 0);
* the BASELINE row "density-field parity with reference solver at 64³,
  float32 tolerance" (BASELINE.md): tests/test_oracle3d_parity.py's
  ``plume_cfg`` stepped by the port, re-synced to the NumPy oracle every
  step, on the plain path and on the kernel path's twins;
* ``double_project`` (plume64, and vortex128 with its obstacle: K4 without
  and with the mask) on the kernel path's twins against the JAX kernel
  path with interpret-mode K4;
* the fused-kernel gate's scheme term: bench128 with the semi-Lagrangian
  scheme asks for the fused projection, which the JAX step declines.

Tolerances.  After 3 steps, plume64: rtol 1e-5, atol 5e-6·max|ref| on
both paths (observed up to 1.95e-6·max|ref|: XLA on the CPU contracts the
diffusion's and the advection's multiply-adds into FMAs, and 60 viscous
sweeps a step carry them); smoke32: rtol 1e-5, atol 1e-5·max|ref|.  Both
scenes are sensitive: the JAX package from a start density or velocity
moved by one ulp diverges from itself by about 1e-6 of each field after 3
steps, by 2e-3 to 2e-2 (plume64) after 20, and (smoke32, whose emitter
blows at 30 cells a step into a 32³ box) by at most 2.4e-4 of each field
after 8 steps, 2.7e-3 after 10 and O(1) after 20, as the port does from it.
So plume64 after 20 steps and smoke32 after 8 are held, field by field, to
4× the larger of the JAX package's two one-ulp divergences
(tests/test_torch_vortex.py's rule), and that divergence must itself stay
below 5e-2 (plume64) and 1e-3 (smoke32) of the field, so that the bound
stays well under the field's scale.  The gate: rtol
1e-4, atol 2e-5·scale, as tests/test_oracle3d_parity.py holds the JAX
step.  ``double_project`` and the semi-Lagrangian bench128 after one step:
density within 1e-5·max|ρ|, velocity within 1e-3·max|v|, pressure within
one bf16 ulp of its largest value where the solve is bfloat16
(tests/test_torch_step.py's kernel-path class), else rtol 1e-5,
atol 2e-6·max|ref|.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import fluidsim_tpu.models.stable3d as j_s3
import fluidsim_tpu.pallas.advect as j_pa
import fluidsim_tpu.pallas.jacobi as j_pj
import fluidsim_tpu.pallas.project as j_pp
import fluidsim_tpu.pallas.resident as j_pr
from fluidsim_tpu import config as j_config
from fluidsim_tpu.engine import Engine as JEngine
from fluidsim_tpu.scene.obstacles import build_obstacle_mask as j_build_mask
from fluidsim_tpu.state import FluidState as JState

import fluidsim_tpu_torch.models.stable3d as t_s3
from fluidsim_tpu_torch.models.step_kernels import PLAIN_TWINS, StepKernels
from fluidsim_tpu_torch import config as t_config
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy
from fluidsim_tpu_torch.scene.sources import apply_custom_source
from fluidsim_tpu_torch.state import zeros_state

import oracle3d
from test_oracle3d_parity import plume_cfg as j_gate_cfg

torch.set_num_threads(1)

N = 32
FIELDS = ("density", "velocity", "pressure")


def smooth(n, rng, modes=6):
    z, y, x = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    out = np.zeros((n, n, n))
    for _ in range(modes):
        k = rng.integers(-3, 4, size=3)
        phase = rng.uniform(0, 2 * np.pi)
        out += np.sin(2 * np.pi * (k[0] * z + k[1] * y + k[2] * x) / n + phase)
    return out / np.sqrt(modes)


def start_arrays(obstacles=None, seed=64):
    rng = np.random.default_rng(seed)
    vel = np.stack([smooth(N, rng) for _ in range(3)]) * 0.3
    dens = np.maximum(5.0 * (1.0 + smooth(N, rng)), 0.0)
    return {
        "density": dens.astype(np.float32),
        "velocity": vel.astype(np.float32),
        "pressure": np.zeros((N, N, N), np.float32),
        "obstacles": (np.zeros((N, N, N), bool) if obstacles is None
                      else np.asarray(obstacles)),
        "step": np.zeros((), np.int32),
        "time": np.zeros((), np.float32),
    }


def one_ulp(arrays, field):
    """``arrays`` with every value of ``field`` moved by one ulp."""
    return dict(arrays, **{field: np.nextafter(arrays[field], np.float32(np.inf))})


def kernel_class(mp):
    """The JAX kernel path with interpret-mode Pallas kernels at any grid
    size, and the port's kernel path with its kernels' twins, on the CPU."""
    mp.setattr(j_s3, "_pallas_usable",
               lambda cfg: cfg.kernel_backend != "xla" and cfg.advect_window > 0)
    for mod, name in ((j_pa, "advect_multi_3d_pallas"), (j_pp, "project_3d_pallas"),
                      (j_pp, "project_advect_density_3d_pallas"),
                      (j_pj, "jacobi_3d_pallas"), (j_pr, "jacobi_3d_resident")):
        mp.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
    mp.setattr(t_s3, "_kernels_usable",
               lambda cfg, device: cfg.kernel_backend != "xla" and cfg.advect_window > 0)


class Spy:
    """The twins as a ``StepKernels`` that records the calls a step made."""

    def __init__(self):
        self.calls = []

        def wrap(name, fn):
            def call(*a, **k):
                self.calls.append(name)
                return fn(*a, **k)
            return call

        self.kernels = StepKernels(*(wrap(name, fn) for name, fn in
                                          PLAIN_TWINS._asdict().items()))


def rollout_jax(cfg, arrays, steps, eng=None):
    """The JAX ``Engine``'s states after each count in ``steps`` from
    ``arrays`` (``eng``: an engine of ``cfg`` to reuse, compiled)."""
    eng = eng or JEngine(cfg)
    eng.state = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    out, done = {}, 0
    for n in steps:
        eng.step(n - done)
        done = n
        out[n] = {k: np.asarray(getattr(eng.state, k)) for k in FIELDS + ("step",)}
    return out


def rollout_port(cfg, arrays, steps, kernels=PLAIN_TWINS):
    eng = Engine(cfg, "cpu", kernels=kernels)
    eng.state = state_from_numpy(arrays, "cpu")
    out, done = {}, 0
    for n in steps:
        eng.step(n - done)
        done = n
        out[n] = state_to_numpy(eng.state)
    return out


def max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)))


def assert_close(got, ref, rtol, atol_scale, what):
    for field in FIELDS:
        r = ref[field]
        np.testing.assert_allclose(
            got[field], r, rtol=rtol, atol=atol_scale * float(np.abs(r).max()),
            err_msg=f"{what} {field}: max abs diff {max_diff(got[field], r):.3e}, "
                    f"max |ref| {float(np.abs(r).max()):.3e}")


def assert_kernel_class(got, ref, bf16_solve, what):
    if not bf16_solve:
        assert_close(got, ref, 1e-5, 2e-6, what)
        return
    for field, bound in (("density", 1e-5), ("velocity", 1e-3), ("pressure", 2.0 ** -8)):
        scale = float(np.abs(ref[field]).max())
        diff = max_diff(got[field], ref[field])
        assert diff <= bound * scale, (
            f"{what} {field}: max abs diff {diff:.3e} > {bound} x max {scale:.3e}")


# -- plume64 and smoke32 through Engine -----------------------------------------


# Each preset's config function and the step counts it is compared at.
PRESETS = {"plume64": ("preset_plume_64", (3, 20)),
           "smoke32": ("preset_smoke_box_32", (3, 8))}


@pytest.fixture(scope="module")
def rollouts():
    """For each preset and path: the port's and the JAX package's states
    after each of the preset's step counts from one start, and the JAX
    package's from that start with the density or the velocity moved by
    one ulp."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        kernel_class(mp)
        for name, (preset, steps) in PRESETS.items():
            for backend in ("auto", "xla"):
                if name == "smoke32" and backend == "auto":
                    continue  # window 0: the same plain path as "xla"
                j_cfg = getattr(j_config, preset)().replace(size=N, kernel_backend=backend)
                t_cfg = getattr(t_config, preset)().replace(size=N, kernel_backend=backend)
                spy = Spy()
                out[(name, "port", backend)] = rollout_port(t_cfg, start_arrays(),
                                                            steps, spy.kernels)
                out[(name, "calls", backend)] = spy.calls
                eng = JEngine(j_cfg)
                out[(name, "jax", backend)] = rollout_jax(j_cfg, start_arrays(), steps, eng)
                out[(name, "jax-ulp", backend)] = [
                    rollout_jax(j_cfg, one_ulp(start_arrays(), field), steps, eng)
                    for field in ("density", "velocity")]
    return out


def assert_within_own_sensitivity(out, name, backend, steps, factor, own_below):
    """Each field of the port within ``factor`` × the larger of the JAX
    package's own divergences from a one-ulp change of its start, which
    must stay below ``own_below`` × the field's largest value."""
    got, ref = out[(name, "port", backend)][steps], out[(name, "jax", backend)][steps]
    assert got["step"] == ref["step"] == steps
    for field in FIELDS:
        diff = max_diff(got[field], ref[field])
        own = max(max_diff(ulp[steps][field], ref[field])
                  for ulp in out[(name, "jax-ulp", backend)])
        scale = float(np.abs(ref[field]).max())
        assert own <= own_below * scale, (
            f"{name} {backend}, {steps} steps, {field}: the JAX package's own "
            f"one-ulp divergence {own:.3e} is not below {own_below} x {scale:.3e}")
        assert diff <= factor * own, (
            f"{name} {backend}, {steps} steps, {field}: max abs diff {diff:.3e} "
            f"against the JAX package's own one-ulp divergence {own:.3e}")


@pytest.mark.parametrize("backend", ["auto", "xla"], ids=["kernel", "plain"])
def test_plume64_3_steps_like_jax(rollouts, backend):
    got, ref = rollouts[("plume64", "port", backend)][3], rollouts[("plume64", "jax", backend)][3]
    assert got["step"] == ref["step"] == 3
    assert_close(got, ref, 1e-5, 5e-6, f"plume64 {backend}, 3 steps")
    # The kernel path: K1 (K = 3) for the velocity and the density, K3.
    calls = rollouts[("plume64", "calls", backend)]
    assert calls == (["advect", "project", "advect"] * 20 if backend == "auto" else [])


@pytest.mark.parametrize("backend", ["auto", "xla"], ids=["kernel", "plain"])
def test_plume64_20_steps_within_jax_own_sensitivity(rollouts, backend):
    assert_within_own_sensitivity(rollouts, "plume64", backend, 20, 4.0, 5e-2)


def test_smoke32_3_steps_like_jax(rollouts):
    got, ref = rollouts[("smoke32", "port", "xla")][3], rollouts[("smoke32", "jax", "xla")][3]
    assert_close(got, ref, 1e-5, 1e-5, "smoke32, 3 steps")
    assert float(got["density"].sum()) > float(start_arrays()["density"].sum())


def test_smoke32_8_steps_within_jax_own_sensitivity(rollouts):
    assert_within_own_sensitivity(rollouts, "smoke32", "xla", 8, 4.0, 1e-3)


def test_smoke32_takes_no_kernel_on_a_card():
    """Window 0: the gate sends smoke32 down the plain path on a card, as
    the JAX package sends it to XLA, so a step makes no kernel call."""
    cfg = t_config.preset_smoke_box_32()
    assert not t_s3._kernels_usable(cfg, torch.device("cuda"))
    spy = Spy()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_s3, "_kernels_usable",
                   lambda c, device: c.kernel_backend != "xla" and c.advect_window > 0)
        eng = Engine(cfg, "cpu", kernels=spy.kernels)
        eng.step(2)
    assert spy.calls == [] and int(eng.state.step) == 2


# -- the BASELINE 64³ density gate -----------------------------------------------


def gate_cfg():
    """tests/test_oracle3d_parity.py's ``plume_cfg``, as the port's config."""
    j_cfg = j_gate_cfg()
    fields = {f: getattr(j_cfg, f) for f in t_config.SimConfig.__dataclass_fields__
              if f not in ("obstacle_shape", "color_mode", "extra_sources")}
    return t_config.SimConfig(**fields).validate()


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_baseline_gate_64_against_oracle(monkeypatch, path):
    """Every step starts the port and the oracle from the same state, so
    agreement is at float32 reordering level (the JAX step's gate)."""
    cfg = gate_cfg()
    assert cfg.current_size == 64 and cfg.advect_window == 2
    if path == "kernel":
        monkeypatch.setattr(t_s3, "_kernels_usable", lambda c, device: True)
    spy = Spy()
    dt, diff, visc = cfg.effective_params()
    n = cfg.current_size

    def rand(seed, scale):
        return (np.random.default_rng(seed).standard_normal((n, n, n)) * scale
                ).astype(np.float32)

    d = np.abs(rand(70, 1.0))
    v = np.stack([oracle3d.set_bnd_3d(b, rand(80 + b, 0.2), None) for b in (1, 2, 3)])
    t = np.float32(0.0)
    for k in range(3):
        t = t + np.float32(dt)
        sd, sv = apply_custom_source(torch.from_numpy(d), torch.from_numpy(v), cfg,
                                     torch.tensor(t))
        state = zeros_state(cfg, "cpu").replace(
            density=sd, velocity=sv, time=torch.tensor(t - np.float32(dt)))
        state = t_s3.simulate_step_3d(state, cfg, spy.kernels)
        od, ov, op = oracle3d.simulate_step_3d(
            sd.numpy(), sv.numpy(), dt, diff, visc, cfg.jacobi_iters,
            buoy=cfg.buoyancy, ambient=cfg.ambient_density,
            advect_window=cfg.advect_window)
        for name, got, exp in (("density", state.density, od),
                               ("velocity", state.velocity, ov),
                               ("pressure", state.pressure, op)):
            scale = max(1.0, float(np.abs(exp).max()))
            np.testing.assert_allclose(
                got.numpy(), exp, rtol=1e-4, atol=2e-5 * scale,
                err_msg=f"{path} path, step {k}: {name} diverged from the 3D oracle")
        d, v = od, ov
    assert spy.calls == (["advect", "project", "advect"] * 3 if path == "kernel" else [])


# -- double_project and the fused gate's scheme term ----------------------------


def one_step_both(j_cfg, t_cfg, arrays):
    spy = Spy()
    with pytest.MonkeyPatch.context() as mp:
        kernel_class(mp)
        ref = rollout_jax(j_cfg, arrays, (1,))[1]
        got = rollout_port(t_cfg, arrays, (1,), spy.kernels)[1]
    return got, ref, spy.calls


@pytest.mark.parametrize("preset", ["preset_plume_64", "preset_vortex_128"],
                         ids=["plume64-K4", "vortex128-K4-mask"])
def test_double_project_like_jax(preset):
    j_cfg = getattr(j_config, preset)().replace(size=N, double_project=True)
    t_cfg = getattr(t_config, preset)().replace(size=N, double_project=True)
    mask = j_build_mask(j_cfg) if j_cfg.enable_obstacle else None
    got, ref, calls = one_step_both(j_cfg, t_cfg, start_arrays(mask))
    assert calls[0] == "jacobi" and calls.count("jacobi") == 1
    assert_kernel_class(got, ref, t_cfg.solve_dtype == "bfloat16",
                        f"{preset} double_project")


def test_semi_lagrangian_does_not_fuse():
    """bench128 asks for the fused projection; with the semi-Lagrangian
    scheme the JAX step declines it (``fuse_ok``), and so does the port: K1,
    K3 and K1, no K2 or K8."""
    change = dict(size=N, advection_scheme="semi_lagrangian")
    t_cfg = t_config.preset_bench_128().replace(**change)
    assert t_cfg.fuse_project_advect
    assert not t_s3.fuses_projection(t_cfg, True, True)
    assert t_s3.fuses_projection(t_cfg.replace(advection_scheme="substep"), True, True)
    assert not t_s3.fuses_projection(
        t_cfg.replace(advection_scheme="substep", pressure_solver="fft"), True, True)
    for extra in ({}, {"fuse_self_advect": True}):
        got, ref, calls = one_step_both(j_config.preset_bench_128().replace(**change, **extra),
                                        t_cfg.replace(**extra), start_arrays())
        assert calls == ["advect", "project", "advect"]
        assert_kernel_class(got, ref, True, f"semi-Lagrangian bench128 {extra}")


@pytest.mark.parametrize("preset", ["preset_plume_64", "preset_smoke_box_32"])
def test_presets_are_supported_at_full_size(preset):
    """Neither preset raises on either path at its published size."""
    cfg = getattr(t_config, preset)()
    t_s3.check_supported(cfg, False)
    t_s3.check_supported(cfg, t_s3._kernels_usable(cfg, torch.device("cuda")))
    eng = Engine(cfg, "cpu")
    assert eng.state.density.shape == (cfg.current_size,) * 3
