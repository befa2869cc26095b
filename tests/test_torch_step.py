"""The fluidsim_tpu_torch slice end to end: bench128 (cut to 32³) stepped by
the port's ``Engine`` against the JAX package's ``Engine`` from the same
start state, on the kernel path and on the plain path, plus the raymarch
render and the engine's host behaviour.

The JAX kernel path runs its Pallas kernels in interpret mode, as
tests/test_pallas_interpret.py does; the port's kernel path runs the CUDA
kernels' plain twins (the wrappers' behaviour for CPU tensors).

Tolerances: after 3 steps rtol 1e-5, atol 1e-6·max|ref|.  After 20 kernel-
path steps density within 1e-5·max|ρ| and velocity within 1e-3·max|v| —
the bf16-solve class: a last-bit difference before a bfloat16 rounding of
the pressure iterate moves it by one bf16 ulp.  The plain path solves in
float32: rtol 1e-5, atol 1e-6·max|ref| after 20 steps.
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
from fluidsim_tpu.engine import Engine as JEngine
from fluidsim_tpu.render.raymarch import render_frame_3d as j_render
from fluidsim_tpu.scene.obstacles import build_obstacle_mask as j_build_mask
from fluidsim_tpu.state import FluidState as JState

import fluidsim_tpu_torch.models.stable3d as t_s3
from fluidsim_tpu_torch.models.step_kernels import PLAIN_TWINS, StepKernels
from fluidsim_tpu_torch.config import preset_bench_128 as t_bench128
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy
from fluidsim_tpu_torch.kernels.jacobi import composite_block
from fluidsim_tpu_torch.render.raymarch import render_frame_3d

torch.set_num_threads(1)

N = 32
STEPS = (3, 20)


def smooth(n, rng, modes=6):
    z, y, x = np.meshgrid(*(np.arange(n),) * 3, indexing="ij")
    out = np.zeros((n, n, n))
    for _ in range(modes):
        k = rng.integers(-3, 4, size=3)
        phase = rng.uniform(0, 2 * np.pi)
        out += np.sin(2 * np.pi * (k[0] * z + k[1] * y + k[2] * x) / n + phase)
    return out / np.sqrt(modes)


def start_arrays(seed=2024):
    rng = np.random.default_rng(seed)
    vel = np.stack([smooth(N, rng) for _ in range(3)]) * 0.3
    dens = np.maximum(5.0 * (1.0 + smooth(N, rng)), 0.0)
    return {
        "density": dens.astype(np.float32),
        "velocity": vel.astype(np.float32),
        "pressure": np.zeros((N, N, N), np.float32),
        "obstacles": np.zeros((N, N, N), bool),
        "step": np.zeros((), np.int32),
        "time": np.zeros((), np.float32),
    }


def rollout_jax(backend):
    eng = JEngine(j_bench128().replace(size=N, kernel_backend=backend))
    eng.state = JState(**{k: jnp.asarray(v) for k, v in start_arrays().items()})
    out, done = {}, 0
    for n in STEPS:
        eng.step(n - done)
        done = n
        out[n] = {k: np.asarray(getattr(eng.state, k))
                  for k in ("density", "velocity", "pressure", "step", "time")}
    return out


def rollout_port(backend):
    eng = Engine(t_bench128().replace(size=N, kernel_backend=backend), "cpu")
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
                          (j_pp, "project_3d_pallas"),
                          (j_pp, "project_advect_density_3d_pallas")):
            mp.setattr(mod, name, functools.partial(getattr(mod, name),
                                                    interpret=True))
        mp.setattr(t_s3, "_kernels_usable",
                   lambda cfg, device: cfg.kernel_backend != "xla")
        return {
            ("jax", "auto"): rollout_jax("auto"),
            ("port", "auto"): rollout_port("auto"),
            ("jax", "xla"): rollout_jax("xla"),
            ("port", "xla"): rollout_port("xla"),
        }


def max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - b)))


def assert_state_close(got, ref, rtol, what):
    for field in ("density", "velocity", "pressure"):
        r = ref[field]
        atol = 1e-6 * float(np.abs(r).max())
        np.testing.assert_allclose(
            got[field], r, rtol=rtol, atol=atol,
            err_msg=f"{what} {field}: max abs diff {max_diff(got[field], r):.3e}, "
                    f"max |ref| {float(np.abs(r).max()):.3e}")
    assert got["step"] == ref["step"]
    assert got["time"] == ref["time"]


def test_slice_kernel_path_3_steps(rollouts):
    ref, got = rollouts[("jax", "auto")][3], rollouts[("port", "auto")][3]
    assert float(ref["density"].sum()) > float(start_arrays()["density"].sum())
    assert_state_close(got, ref, 1e-5, "kernel path, 3 steps")


def test_slice_kernel_path_20_steps(rollouts):
    ref, got = rollouts[("jax", "auto")][20], rollouts[("port", "auto")][20]
    for field, bound in (("density", 1e-5), ("velocity", 1e-3)):
        scale = float(np.abs(ref[field]).max())
        diff = max_diff(got[field], ref[field])
        assert diff <= bound * scale, (
            f"{field}: max abs diff {diff:.3e} > {bound} x max {scale:.3e}")
    assert got["step"] == ref["step"] == 20


def test_slice_plain_path_20_steps(rollouts):
    for steps in STEPS:
        assert_state_close(rollouts[("port", "xla")][steps],
                           rollouts[("jax", "xla")][steps], 1e-5,
                           f"plain path, {steps} steps")


def test_render_frame_3d(rollouts):
    arrays = dict(start_arrays(), **{
        k: v for k, v in rollouts[("jax", "auto")][20].items()})
    cfg = t_bench128().replace(size=N)
    ref = np.asarray(j_render(JState(**{k: jnp.asarray(v)
                                         for k, v in arrays.items()}),
                              j_bench128().replace(size=N)))
    got = render_frame_3d(state_from_numpy(arrays, "cpu"), cfg).numpy()
    assert got.shape == ref.shape == (N, N, 3)
    np.testing.assert_allclose(
        got, ref, rtol=1e-5, atol=1e-6,
        err_msg=f"render: max abs diff {max_diff(got, ref):.3e}")


def test_engine_host_behaviour():
    cfg = t_bench128().replace(size=N)
    eng = Engine(cfg, "cpu", nan_guard=True)
    eng.step(2, substeps_per_dispatch=2)
    assert int(eng.state.step) == 2
    eng.set_paused(True)
    before = eng.state
    assert eng.step(3) is before
    eng.set_paused(False)
    eng.set_source_position(8.0, 4.0, 16.0)
    assert eng.get_source_position() == (8.0, 4.0, 16.0)
    eng.step(1)
    assert int(eng.state.step) == 3
    assert eng.state.density.device.type == "cpu"
    eng.state = eng.state.replace(
        density=torch.full_like(eng.state.density, float("nan")))
    with pytest.raises(FloatingPointError, match="NaN"):
        eng.step(1)
    eng.reset()
    assert int(eng.state.step) == 0 and float(eng.state.density.sum()) == 0.0


def test_make_step_3d_is_a_loop_of_steps():
    cfg = t_bench128().replace(size=N, kernel_backend="xla")
    state = state_from_numpy(start_arrays(), "cpu")
    looped = t_s3.make_step_3d(cfg, 3)(state)
    for _ in range(3):
        state = t_s3.simulate_step_3d(state, cfg)
    assert int(looped.step) == 3
    for name in ("density", "velocity", "pressure", "time"):
        assert torch.equal(getattr(looped, name), getattr(state, name)), name


@pytest.mark.parametrize("change,what", [
    (dict(ndim=2, size=64, source_position=(0.5, 0.5),
          obstacle_position=(0.5, 0.5), dtype="bfloat16"), "2D"),
    (dict(apply_turbulent_noise=True), "turbulent noise"),
    (dict(pressure_solver="fft"), "FFT"),
    (dict(dtype="bfloat16"), "dtype"),
])
def test_unported_configs_raise(change, what):
    """The configs that raised before the port took them (2D bf16, 3D noise,
    the FFT solver, bf16 fields) now step like the JAX package: 2 steps on
    the plain path from the same start, float32 within rtol 1e-5, atol
    1e-5·max|ref|, bf16 at storage precision (rtol and atol 3e-2·max|ref|,
    tests/test_bf16.py)."""
    jcfg = j_bench128().replace(**{"size": N, **change})
    cfg = t_bench128().replace(**{"size": N, **change})
    jeng, eng = JEngine(jcfg), Engine(cfg, "cpu")
    jeng.step(2)
    eng.step(2)
    tol = 3e-2 if cfg.dtype == "bfloat16" else 1e-5
    for field in ("density", "velocity", "pressure"):
        got = getattr(eng.state, field)
        assert got.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
        got = got.float().numpy()
        ref = np.asarray(getattr(jeng.state, field), np.float32)
        scale = max(float(np.abs(ref).max()), 1e-6)
        assert float(np.abs(ref).max()) > 0.0 or field != "density", what
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * scale,
                                   err_msg=f"{what} {field}")


@pytest.mark.parametrize("change,calls", [
    (dict(diffusion=1e-4), ["advect", "project_advect"]),
    (dict(viscosity=1e-4), ["advect", "project_advect"]),
    (dict(advection_scheme="maccormack"), ["advect"] * 2 + ["project"] + ["advect"] * 2),
    (dict(advect_window=2, fuse_project_advect=False), ["advect", "project", "advect"]),
], ids=["density diffusion", "viscous", "MacCormack", "advect_window=2"])
def test_formerly_unported_configs_step_like_jax(monkeypatch, change, calls):
    """bench128 (cut to 32³) with density diffusion (before the fused K2),
    viscous diffusion, MacCormack advection (K1 with one substep as its
    base step, then K3) and a K1 window of 2 cells (with the buoyancy
    folded) steps on the kernel path's twins and equals the JAX step with
    its interpret-mode Pallas kernels after one step, within the bf16-solve
    class of the 20-step test."""
    one_kernel_step_like_jax(monkeypatch, change, calls)


def one_kernel_step_like_jax(monkeypatch, change, calls):
    """One step of bench128 at 32³ with ``change`` on the kernel path's
    twins, which make ``calls``, against the JAX step with its
    interpret-mode Pallas kernels."""
    monkeypatch.setattr(j_s3, "_pallas_usable", lambda cfg: True)
    for mod, name in ((j_pa, "advect_multi_3d_pallas"), (j_pp, "project_3d_pallas"),
                      (j_pp, "project_advect_density_3d_pallas")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))
    monkeypatch.setattr(t_s3, "_kernels_usable", lambda cfg, device: True)
    eng = JEngine(j_bench128().replace(size=N, **change))
    eng.state = JState(**{k: jnp.asarray(v) for k, v in start_arrays().items()})
    eng.step(1)
    made = []
    kernels = StepKernels(*(
        (lambda name, fn: lambda *a, **k: made.append(name) or fn(*a, **k))(name, fn)
        for name, fn in PLAIN_TWINS._asdict().items()))
    port = Engine(t_bench128().replace(size=N, **change), "cpu", kernels=kernels)
    port.state = state_from_numpy(start_arrays(), "cpu")
    port.step(1)
    assert made == calls
    got = state_to_numpy(port.state)
    for field, bound in (("density", 1e-5), ("velocity", 1e-3), ("pressure", 2.0 ** -8)):
        ref = np.asarray(getattr(eng.state, field))
        scale = float(np.abs(ref).max())
        diff = max_diff(got[field], ref)
        assert diff <= bound * scale, (
            f"{field}: max abs diff {diff:.3e} > {bound} x max {scale:.3e}")


@pytest.mark.parametrize("change,missing", [
    (dict(jacobi_sweep_block=2), "K5"),
    (dict(advect_window=2, jacobi_sweep_block=4), "K5"),
    (dict(advect_window=2, fuse_self_advect=True, jacobi_sweep_block=2), "K5"),
    (dict(advect_window=4, fuse_project_advect=False), "K1 K=4"),
], ids=["K5", "K2 advect_window=2", "K8 advect_window=2", "K1 advect_window=4"])
def test_unported_kernel_variants_raise(monkeypatch, change, missing):
    """The kernel variants that raised before they were ported now step.
    K1 at a window of 4 cells (then K3, then K1 on the density) is the JAX
    step with its interpret-mode Pallas kernels after one step, as in
    test_formerly_unported_configs_step_like_jax.  The sweep-blocked solve
    (K5) steps, in K3 and in the fused kernels at window 2 (K2, K8): with a
    float32 solve, one step is within 1e-5 relative of the
    ``jacobi_sweep_block = 1`` step (the JAX package's bound for its
    composite, tests/test_pallas_interpret.py)."""
    if missing != "K5":
        one_kernel_step_like_jax(monkeypatch, change, ["advect", "project", "advect"])
        return
    monkeypatch.setattr(t_s3, "_kernels_usable", lambda cfg, device: True)
    cfg = t_bench128().replace(size=N, **change)
    cfg = cfg.replace(solve_dtype="float32")
    block = cfg.jacobi_sweep_block
    assert composite_block(N, cfg.jacobi_iters, block) == block
    runs = []
    for sweep_block in (block, 1):
        eng = Engine(cfg.replace(jacobi_sweep_block=sweep_block), "cpu")
        eng.state = state_from_numpy(start_arrays(), "cpu")
        eng.step(1)
        runs.append(state_to_numpy(eng.state))
    for field in ("density", "velocity", "pressure"):
        ref = runs[1][field]
        bound = 1e-5 * max(float(np.abs(ref).max()), 1e-6)
        assert max_diff(runs[0][field], ref) <= bound, field


@pytest.mark.parametrize("change,kernel", [
    (dict(fuse_self_advect=True), "full_step"),
    (dict(fuse_emitter=True), "project_advect"),
    (dict(advect_substeps=2), "project_advect"),
    (dict(enable_obstacle=True), "project_advect"),
], ids=["K8", "K2s", "advect_substeps", "K2o"])
def test_fused_kernel_variants_step_like_jax(monkeypatch, change, kernel):
    """These variants of bench128 step on the kernel path's twins (K8, K2s,
    K2 with two substeps, K2o) and equal the JAX step with its interpret-mode
    Pallas kernels after one step, within the bf16-solve class of the
    20-step test (the pressure within one bf16 ulp of its largest value)."""
    monkeypatch.setattr(j_s3, "_pallas_usable", lambda cfg: True)
    for mod, name in ((j_pa, "advect_multi_3d_pallas"),
                      (j_pp, "project_advect_density_3d_pallas"),
                      (j_pp, "full_step_3d_pallas")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name),
                                                         interpret=True))
    monkeypatch.setattr(t_s3, "_kernels_usable", lambda cfg, device: True)
    j_cfg = j_bench128().replace(size=N, **change)
    arrays = start_arrays()
    arrays["obstacles"] = np.asarray(j_build_mask(j_cfg))
    eng = JEngine(j_cfg)
    eng.state = JState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    eng.step(1)
    calls = []
    kernels = PLAIN_TWINS._replace(**{
        kernel: lambda *a, **k: calls.append(kernel) or getattr(
            PLAIN_TWINS, kernel)(*a, **k)})
    port = Engine(t_bench128().replace(size=N, **change), "cpu", kernels=kernels)
    port.state = state_from_numpy(arrays, "cpu")
    port.step(1)
    assert calls == [kernel]
    got = state_to_numpy(port.state)
    for field, bound in (("density", 1e-5), ("velocity", 1e-3), ("pressure", 2.0 ** -8)):
        ref = np.asarray(getattr(eng.state, field))
        scale = float(np.abs(ref).max())
        diff = max_diff(got[field], ref)
        assert diff <= bound * scale, (
            f"{field}: max abs diff {diff:.3e} > {bound} x max {scale:.3e}")
    assert got["step"] == 1


def test_pallas_backend_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(t_bench128().replace(size=N, kernel_backend="pallas"), "cpu")


def test_engine_runs_on_the_card_unless_asked_for_the_cpu():
    """``Engine(cfg)`` without a device takes the card; without one it
    raises rather than stepping on the CPU."""
    cfg = t_bench128().replace(size=N)
    if torch.cuda.is_available():
        assert Engine(cfg).state.density.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(cfg)
    assert Engine(cfg, "cpu").state.density.device.type == "cpu"
