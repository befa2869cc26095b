"""The 2D reference-parity mode of fluidsim_tpu_torch against the JAX
package and the NumPy oracle (tests/oracle2d.py), on the CPU, at 64² (the
emitter at scene_a's 192²).

Inputs are made with NumPy from a seed and handed to both sides.  The JAX
side runs its XLA path, and K9 (``lin_solve_2d_resident``) in interpret
mode, as tests/test_pallas_interpret.py does; the port runs K9's plain twin
(the wrapper's route for CPU tensors).

Tolerance classes, each no looser than the JAX package's own against the
oracle (tests/test_parity_ops.py, tests/test_parity_step.py):
- per op: rtol 2e-6, atol 1e-6 (the pressure rtol 2e-5, atol 1e-6, the
  projected velocity rtol 2e-5, atol 5e-5).  The port does the oracle's
  float32 operations in its order and is bitwise the oracle on set_bnd, the
  solves, advection and projection (asserted).  XLA on the CPU contracts
  ``x0 + a·nbr`` into one FMA and multiplies by ``1/c`` (observed), so the
  JAX package sits about an ulp from both: 1.2e-7 at a field scale of 2;
- a step re-synced to the reference every step: rtol 1e-5, atol
  2e-6·scale; a 5-step rollout: rtol 1e-3, atol 5e-4·scale.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsim_tpu import config as jcfg
from fluidsim_tpu.engine import Engine as JEngine
from fluidsim_tpu.models.stable2d import simulate_step_2d as j_step_2d
from fluidsim_tpu.ops import advect as j_adv
from fluidsim_tpu.ops import boundary as j_bnd
from fluidsim_tpu.ops import forces as j_forces
from fluidsim_tpu.ops import linsolve as j_lin
from fluidsim_tpu.ops import project as j_proj
from fluidsim_tpu.pallas.resident2d import lin_solve_2d_resident as j_k9
from fluidsim_tpu.scene.sources import apply_custom_source as j_source
from fluidsim_tpu.state import FluidState as JState

from fluidsim_tpu_torch import config as tcfg
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.convert import state_from_numpy, state_to_numpy
from fluidsim_tpu_torch.kernels.resident2d import (
    lin_solve_2d_resident,
    lin_solve_2d_resident_plain,
)
from fluidsim_tpu_torch.models import stable2d as t_s2
from fluidsim_tpu_torch.models.step_kernels import PLAIN_TWINS
from fluidsim_tpu_torch.ops import advect as t_adv
from fluidsim_tpu_torch.ops import boundary as t_bnd
from fluidsim_tpu_torch.ops import forces as t_forces
from fluidsim_tpu_torch.ops import linsolve as t_lin
from fluidsim_tpu_torch.ops import project as t_proj
from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask
from fluidsim_tpu_torch.scene.sources import apply_custom_source as t_source

sys.path.insert(0, str(Path(__file__).resolve().parent))
import oracle2d  # noqa: E402

torch.set_num_threads(1)

F32 = np.float32
N = 64
FIELDS = ("density", "velocity", "pressure")


def airfoil(n=N):
    """scene_a's airfoil rasterized at ``n``² (61 solid cells at 64²)."""
    return build_obstacle_mask(tcfg.preset_scene_a().replace(size=n, resolution_multiplier=1.0))


def rand(seed, n=N, scale=1.0):
    return (np.random.default_rng(seed).standard_normal((n, n)) * scale).astype(F32)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def J(a):
    return jnp.asarray(a)


def close(got, ref, rtol, atol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol,
                               err_msg=f"{what}: max abs diff {np.abs(got - ref).max():.3e}")


def bitwise(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.array_equal(got, ref), f"{what}: max abs diff {np.abs(got - ref).max():.3e}"


@pytest.mark.parametrize("b", [0, 1, 2])
def test_set_bnd_2d_matches_jax_and_oracle(b):
    """Bitwise both (observed): edges, corners from the edges, the mirror."""
    x, obst = rand(b), airfoil()
    ref = x.copy()
    oracle2d.set_bnd(b, ref, obst)
    got = t_bnd.set_bnd_2d(b, T(x), T(obst)).numpy()
    bitwise(got, ref, "against the oracle")
    bitwise(got, j_bnd.set_bnd_2d(b, J(x), J(obst)), "against JAX")


@pytest.mark.parametrize("iters", [20, 21])
@pytest.mark.parametrize("masked", [False, True], ids=["no-obstacle", "airfoil"])
@pytest.mark.parametrize("smooth", [False, True], ids=["fixed-rhs", "smooth"])
@pytest.mark.parametrize("b", [0, 1, 2])
def test_k9_twin_matches_jax_and_oracle(b, smooth, masked, iters):
    """K9's twin against the interpret-mode TPU kernel and the XLA solves in
    the per-op class (observed: at most 1.2e-7 at a scale of 2, one ulp from
    XLA's FMA and 1/c multiply), and bitwise the oracle's solves."""
    n = N
    obst = airfoil(n) if masked else np.zeros((n, n), bool)
    x0 = t_bnd.set_bnd_2d(b, T(rand(99 + b)), T(obst)).numpy()
    x = x0 if smooth else t_bnd.set_bnd_2d(b, T(rand(5 * b + iters)), T(obst)).numpy()
    a = float(F32(0.21))
    c = float(F32(1.0) + F32(6.0) * F32(a))
    got = lin_solve_2d_resident(b, T(x), T(x0), a, c, T(obst) if masked else None,
                                iters, smooth=smooth).numpy()
    interp = j_k9(b, J(x), J(x0), a, c, J(obst) if masked else None, iters,
                  smooth=smooth, interpret=True)
    close(got, interp, 2e-6, 1e-6, "against the interpret-mode TPU kernel")
    if smooth:
        xla = j_lin.diffuse_smooth_2d(b, J(x0), a, c, J(obst), iters)
        ref = oracle2d.diffuse_with_jobs(b, x0, F32(a), F32(c), obst, iters)
    else:
        xla = j_lin.lin_solve_2d(b, J(x), J(x0), a, c, J(obst), iters)
        ref = oracle2d.lin_solve_with_jobs(b, x, x0, F32(a), F32(c), obst, iters)
    close(got, xla, 2e-6, 1e-6, "against XLA")
    bitwise(got, ref, "against the oracle")


@pytest.mark.parametrize("double", [True, False])
@pytest.mark.parametrize("b", [0, 1, 2])
def test_diffuse_2d_matches_jax_and_oracle(b, double):
    """scene_a's viscosity, 40 sweeps (20 with ``double_diffuse=False``):
    bitwise the oracle; the per-op class against JAX (observed 8.6e-6 at a
    value of 11.6, inside its rtol)."""
    cfg = tcfg.preset_scene_a().replace(resolution_multiplier=1.0, double_diffuse=double)
    jc = jcfg.preset_scene_a().replace(resolution_multiplier=1.0, double_diffuse=double)
    dt, _, visc = cfg.effective_params()
    x0, obst = rand(200 + b, scale=3.0), airfoil()
    got = t_lin.diffuse_2d(b, T(x0), visc, dt, T(obst), cfg).numpy()
    close(got, j_lin.diffuse_2d(b, J(x0), visc, dt, J(obst), jc), 2e-6, 1e-6, "against JAX")
    bitwise(got, oracle2d.diffuse(b, x0, F32(visc), F32(dt), obst, cfg.jacobi_iters, double),
            "against the oracle")


@pytest.mark.parametrize("b", [0, 1, 2])
def test_advect_2d_matches_jax_and_oracle(b):
    """Bitwise the oracle and JAX (observed): the bilinear sample in the
    reference's term order, a fresh zero buffer, set_bnd."""
    d0, vx, vy, obst = rand(300 + b, scale=3.0), rand(310, scale=0.8), rand(311, scale=0.8), airfoil()
    got = t_adv.advect_2d(b, T(d0), T(vx), T(vy), 0.1, T(obst)).numpy()
    bitwise(got, oracle2d.advect(b, d0, vx, vy, F32(0.1), obst), "against the oracle")
    bitwise(got, j_adv.advect_2d(b, J(d0), J(vx), J(vy), 0.1, J(obst)), "against JAX")


def test_advect_2d_pair_is_two_advections():
    """Bitwise two ``advect_2d`` calls, and bitwise the JAX pair (observed)."""
    vx, vy, obst = rand(320, scale=0.8), rand(321, scale=0.8), airfoil()
    gx, gy = t_adv.advect_2d_pair(T(vx), T(vy), T(vx), T(vy), 0.1, T(obst))
    bitwise(gx, t_adv.advect_2d(1, T(vx), T(vx), T(vy), 0.1, T(obst)), "x")
    bitwise(gy, t_adv.advect_2d(2, T(vy), T(vx), T(vy), 0.1, T(obst)), "y")
    jx, jy = j_adv.advect_2d_pair(J(vx), J(vy), J(vx), J(vy), 0.1, J(obst))
    bitwise(gx, jx, "x against JAX")
    bitwise(gy, jy, "y against JAX")


@pytest.mark.parametrize("route", ["plain", "K9 twin"])
def test_project_2d_matches_jax_and_oracle(route):
    """The divergence over ``N`` (a tensor divisor), 20 pressure sweeps and
    the gradient: bitwise the oracle on both routes, JAX in its own class
    against the oracle (test_parity_ops.test_project; observed 4.8e-7 at a
    velocity of 5.4, 1.9e-9 in the pressure)."""
    vx, vy, obst = rand(400, scale=1.5), rand(401, scale=1.5), airfoil()
    solve = lin_solve_2d_resident if route == "K9 twin" else None
    got = t_proj.project_2d(T(vx), T(vy), T(obst), 20, solve)
    ref = oracle2d.project(vx, vy, obst, iters=20)
    jgot = j_proj.project_2d(J(vx), J(vy), J(obst), 20)
    for name, g, r, jr, (rtol, atol) in zip(
            ("vel_x", "vel_y", "pressure"), got, ref, jgot,
            ((2e-5, 5e-5), (2e-5, 5e-5), (2e-5, 1e-6))):
        bitwise(g, r, f"{name} against the oracle")
        close(g, jr, rtol, atol, f"{name} against JAX")


def test_enforce_obstacle_boundaries_2d_matches_jax():
    """Bitwise JAX (observed); the oracle in the per-op class, as NumPy's
    exp may differ from PyTorch's by an ulp (observed bitwise on this
    input)."""
    vx, vy, obst = rand(500, scale=2.0), rand(501, scale=2.0), airfoil()
    gx, gy = t_forces.enforce_obstacle_boundaries_2d(T(vx), T(vy), T(obst), 1.0 / N, 1e-4)
    jx, jy = j_forces.enforce_obstacle_boundaries_2d(J(vx), J(vy), J(obst), 1.0 / N, 1e-4)
    bitwise(gx, jx, "vel_x")
    bitwise(gy, jy, "vel_y")
    ex, ey = vx.copy(), vy.copy()
    oracle2d.enforce_obstacle_boundaries(ex, ey, obst, F32(1.0 / N), F32(1e-4))
    close(gx, ex, 2e-6, 1e-6, "vel_x against the oracle")
    close(gy, ey, 2e-6, 1e-6, "vel_y against the oracle")
    inside = obst.copy()
    inside[[0, -1], :] = inside[:, [0, -1]] = False
    assert not gx.numpy()[inside].any() and not gy.numpy()[inside].any()


def test_turbulent_noise_2d_matches_jax():
    """The JAX package's Perlin table and noise in the per-op class
    (observed: ``perlin_2d`` bitwise, the update 1.9e-9 at a scale of 8.9,
    where XLA contracts a multiply-add)."""
    vx, vy = rand(600, scale=2.0), rand(601, scale=2.0)
    gx, gy = t_forces.apply_turbulent_noise_2d(T(vx), T(vy))
    jx, jy = j_forces.apply_turbulent_noise_2d(J(vx), J(vy))
    close(gx, jx, 2e-6, 1e-6, "vel_x")
    close(gy, jy, 2e-6, 1e-6, "vel_y")
    xs = np.linspace(-3.0, 40.0, 301, dtype=F32)
    close(t_forces.perlin_2d(T(xs), T(xs[::-1].copy())),
          j_forces.perlin_2d(J(xs), J(xs[::-1].copy())), 2e-6, 1e-6, "perlin_2d")


@pytest.mark.parametrize("t", [0.0025, 0.05, 0.1375])
@pytest.mark.parametrize("pulsing", [False, True], ids=["as-shipped", "pulsing"])
def test_scene_a_emitter_matches_jax(pulsing, t):
    """scene_a's directional source (velocity along its 2D direction angle)
    at 192², as shipped (the preset sets a pulse rate but leaves
    ``source_pulsing`` off, as the JAX preset does) and pulsing, at three
    times, in the re-synced step's class (rtol 1e-5, atol 2e-6·scale): XLA
    divides by the constant radius as a reciprocal multiply, and
    ``1 − dist/r`` cancels near the rim (observed at most 1.2e-7·scale, in
    4 of 36864 cells)."""
    cfg = tcfg.preset_scene_a().replace(source_pulsing=pulsing)
    jc = jcfg.preset_scene_a().replace(source_pulsing=pulsing)
    n = cfg.current_size
    d, v = rand(700, n), np.stack([rand(701, n), rand(702, n)])
    gd, gv = t_source(T(d), T(v), cfg, torch.tensor(t, dtype=torch.float32))
    jd, jv = j_source(J(d), J(v), jc, jnp.float32(t))
    for what, g, r in (("density", gd, jd), ("velocity", gv, jv)):
        close(g, r, 1e-5, 2e-6 * float(np.abs(np.asarray(r)).max()), what)
    assert float((gd - T(d)).abs().max()) > 0 and float((gv - T(v)).abs().max()) > 0


def scene(name):
    """scene_a cut to 64² (``resolution_multiplier=1``), scene_b (the stock
    defaults) cut to 64²: the port's and the JAX package's configs."""
    change = (dict(resolution_multiplier=1.0) if name == "scene_a" else dict(size=64))
    return (getattr(tcfg, "preset_" + name)().replace(**change),
            getattr(jcfg, "preset_" + name)().replace(**change))


# The seeded states' largest velocity: scene_a's emitter drives ~3 at 64²;
# scene_b has no emitter, and 0.5 keeps its dt = 0.2 backtraces within ~6
# cells.  (With |v| = 1 at 64² the JAX package itself is 5e-6·scale from the
# oracle, outside the re-synced class; the port is within 3e-8·scale.)
VMAX = {"scene_a": 3.0, "scene_b": 0.5}


def seeded_state(cfg, seed, vmax):
    """A non-trivial start: smooth velocity of largest magnitude ``vmax``
    and density (scene_b has no emitter, so from zeros it stays zero)."""
    n = cfg.current_size
    rng = np.random.default_rng(seed)
    ax = np.arange(n, dtype=F32)
    yy, xx = np.meshgrid(ax, ax, indexing="ij")

    def wave():
        k = rng.integers(1, 4, size=2)
        ph = rng.uniform(0, 2 * np.pi)
        return np.sin(2 * np.pi * (k[0] * xx + k[1] * yy) / n + ph).astype(F32)

    return {
        "density": (20.0 * (1.0 + wave())).astype(F32),
        "velocity": (np.stack([wave(), wave()]) * vmax).astype(F32),
        "pressure": np.zeros((n, n), F32),
        "obstacles": build_obstacle_mask(cfg),
        "step": np.zeros((), np.int32),
        "time": np.zeros((), F32),
    }


def j_state(arrays):
    return JState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def oracle_step(arrays, cfg):
    """The oracle's emitter at the engine's time, then its step."""
    d, vx, vy = (a.copy() for a in (arrays["density"], *arrays["velocity"]))
    oracle2d.custom_source(d, vx, vy, cfg, F32(arrays["time"] + F32(cfg.effective_params()[0])))
    d, vx, vy, p = oracle2d.simulate_step(d, vx, vy, arrays["obstacles"], cfg)
    return {"density": d, "velocity": np.stack([vx, vy]), "pressure": p}


@pytest.mark.parametrize("name", ["scene_a", "scene_b"])
def test_engine_step_resync_matches_jax_and_oracle(name):
    """Both ``Engine``s (emitter, then the step) and the oracle from the
    same state every step for 4 steps, in test_step_parity_resync_64's class
    (rtol 1e-5, atol 2e-6·scale).  Observed: the port within 3e-8·scale of
    the oracle (scene_a bitwise), the JAX package 8.6e-7·scale (scene_a) and
    2.5e-6·scale (scene_b, inside the class by its rtol) from both."""
    cfg, jc = scene(name)
    port, jeng = Engine(cfg, "cpu"), JEngine(jc)
    arrays = seeded_state(cfg, 7, VMAX[name])
    for k in range(4):
        port.state, jeng.state = state_from_numpy(arrays, "cpu"), j_state(arrays)
        port.step(1)
        jeng.step(1)
        got, ora = state_to_numpy(port.state), oracle_step(arrays, cfg)
        for f in FIELDS:
            for what, ref in (("JAX", np.asarray(getattr(jeng.state, f))), ("oracle", ora[f])):
                scale = max(1.0, float(np.abs(ref).max()))
                close(got[f], ref, 1e-5, 2e-6 * scale, f"step {k}: {f} against {what}")
        assert got["step"] == k + 1
        arrays = {**got, "obstacles": arrays["obstacles"]}


@pytest.mark.parametrize("name", ["scene_a", "scene_b"])
def test_engine_rollout_matches_jax(name):
    """5 steps without re-sync in test_step_parity_obstacle_emitter's class
    (rtol 1e-3, atol 5e-4·scale; observed 1.4e-6·scale)."""
    cfg, jc = scene(name)
    port, jeng = Engine(cfg, "cpu"), JEngine(jc)
    arrays = seeded_state(cfg, 11, VMAX[name])
    port.state, jeng.state = state_from_numpy(arrays, "cpu"), j_state(arrays)
    port.step(5)
    jeng.step(5)
    got = state_to_numpy(port.state)
    for f in FIELDS:
        ref = np.asarray(getattr(jeng.state, f))
        scale = max(1.0, float(np.abs(ref).max()))
        close(got[f], ref, 1e-3, 5e-4 * scale, f)


def test_step_resync_matches_oracle():
    """test_parity_step.test_step_parity_resync_64's config and gate for the
    port's step (K9's twin): 4 steps, each from the oracle's state after the
    oracle's emitter; rtol 1e-5, atol 2e-6·scale."""
    cfg = tcfg.SimConfig(
        size=64, resolution_multiplier=1.0, time_step=0.05, diffusion=1e-4,
        viscosity=1e-4, enable_custom_source=True, source_strength=80.0,
        source_emits_velocity=True, source_direction=0.0, source_velocity=12.0,
        source_radius=2.5, source_position=(0.2, 0.5), enable_obstacle=True,
        obstacle_shape=tcfg.ObstacleShape.CIRCLE, obstacle_position=(0.6, 0.5),
        obstacle_radius=0.12).validate()
    obst = build_obstacle_mask(cfg)
    n = cfg.current_size
    od, ovx, ovy = (np.zeros((n, n), F32) for _ in range(3))
    t, frame_dt = F32(0.0), F32(cfg.effective_params()[0])
    for k in range(4):
        t = t + frame_dt
        oracle2d.custom_source(od, ovx, ovy, cfg, t)
        state = state_from_numpy({
            "density": od, "velocity": np.stack([ovx, ovy]),
            "pressure": np.zeros((n, n), F32), "obstacles": obst,
            "step": np.zeros((), np.int32), "time": np.zeros((), F32)}, "cpu")
        od, ovx, ovy, op = oracle2d.simulate_step(od, ovx, ovy, obst, cfg)
        state = t_s2.simulate_step_2d(state, cfg)
        for name, got, exp in (("density", state.density, od), ("vel_x", state.velocity[0], ovx),
                               ("vel_y", state.velocity[1], ovy), ("pressure", state.pressure, op)):
            scale = max(1.0, float(np.abs(exp).max()))
            close(got.numpy(), exp, 1e-5, 2e-6 * scale, f"step {k}: {name}")


@pytest.mark.parametrize("name", ["scene_a", "scene_b"])
def test_cpu_kernel_route_is_the_plain_route(name):
    """On the CPU the K9 route runs the twin, which is the plain solves: the
    kernel route, the twin path and ``kernel_backend="xla"`` agree bitwise
    after 3 steps."""
    cfg, _ = scene(name)
    arrays = seeded_state(cfg, 13, VMAX[name])
    engines = [Engine(cfg, "cpu"), Engine(cfg, "cpu", kernels=PLAIN_TWINS),
               Engine(cfg.replace(kernel_backend="xla"), "cpu")]
    calls = []
    kern = engines[0]
    kern.kernels = kern.kernels._replace(
        solve_2d=lambda *a, **k: calls.append(k.get("smooth", False))
        or lin_solve_2d_resident(*a, **k))
    for eng in engines:
        eng.state = state_from_numpy(arrays, "cpu")
        eng.step(3)
    # Per step: three smoothing and three fixed-rhs diffusion solves, two
    # pressure solves.
    assert calls == [True, False, True, False, False, False, True, False] * 3
    ref = state_to_numpy(engines[0].state)
    for eng in engines[1:]:
        got = state_to_numpy(eng.state)
        for f in FIELDS:
            bitwise(got[f], ref[f], f)


def test_use_2d_kernels_gate():
    """K9 on float32 fields unless the config forces the plain path; bf16
    storage takes the plain solves (the JAX package's XLA path), so a bf16
    step calls no solve of the kernel table."""
    cfg = tcfg.preset_scene_b()
    assert t_lin.use_2d_kernels(cfg)
    assert not t_lin.use_2d_kernels(cfg.replace(kernel_backend="xla"))
    assert not t_lin.use_2d_kernels(cfg, torch.bfloat16)

    def refuse(*args, **kwargs):
        raise AssertionError("K9 called on bf16 fields")

    eng = Engine(cfg.replace(dtype="bfloat16"), "cpu",
                 kernels=PLAIN_TWINS._replace(solve_2d=refuse))
    eng.step(1)
    assert eng.state.velocity.dtype == torch.bfloat16


def test_turbulent_noise_step_matches_jax():
    """scene_b with ``apply_turbulent_noise`` (which the 2D step honours and
    the 3D port does not yet): one step from a seeded state against the JAX
    step, re-synced class."""
    cfg, jc = scene("scene_b")
    cfg, jc = cfg.replace(apply_turbulent_noise=True), jc.replace(apply_turbulent_noise=True)
    arrays = seeded_state(cfg, 17, VMAX["scene_b"])
    got = state_to_numpy(t_s2.simulate_step_2d(state_from_numpy(arrays, "cpu"), cfg))
    ref = j_step_2d(j_state(arrays), jc)
    for f in FIELDS:
        r = np.asarray(getattr(ref, f))
        close(got[f], r, 1e-5, 2e-6 * max(1.0, float(np.abs(r).max())), f)


def test_wrapper_checks_its_inputs():
    x = torch.zeros((16, 16))
    with pytest.raises(TypeError):
        lin_solve_2d_resident(0, x.double(), x.double(), 1.0, 6.0, None, 2)
    with pytest.raises(ValueError, match="square"):
        lin_solve_2d_resident(0, torch.zeros((16, 8)), torch.zeros((16, 8)), 1.0, 6.0, None, 2)
    with pytest.raises(ValueError, match="contiguous"):
        lin_solve_2d_resident(0, torch.zeros((16, 16)).t(), x, 1.0, 6.0, None, 2)
    with pytest.raises(ValueError, match="boundary"):
        lin_solve_2d_resident(3, x, x, 1.0, 6.0, None, 2)
    with pytest.raises(ValueError, match="iters"):
        lin_solve_2d_resident(0, x, x, 1.0, 6.0, None, 0)
    got = lin_solve_2d_resident(1, x + 1.0, x, 1.0, 6.0, torch.zeros((16, 16), dtype=torch.bool), 3)
    assert torch.equal(got, lin_solve_2d_resident_plain(
        1, x + 1.0, x, 1.0, 6.0, torch.zeros((16, 16), dtype=torch.bool), 3))


def test_zero_start_stays_zero_without_an_emitter():
    """scene_b's stock config has no emitter: from zeros every field stays
    exactly zero (why the card run starts scene_b from a seeded state)."""
    cfg, _ = scene("scene_b")
    eng = Engine(cfg, "cpu")
    eng.step(2)
    for f in FIELDS:
        assert not getattr(eng.state, f).any()


def test_2d_ignores_the_3d_solver_options():
    """As in the JAX package, the 2D step ignores ``pressure_solver`` and
    ``advection_scheme``: with the FFT solver and MacCormack asked for, two
    scene_b steps equal the stock config's bitwise."""
    cfg, _ = scene("scene_b")
    arrays = seeded_state(cfg, 19, VMAX["scene_b"])
    states = []
    for c in (cfg, cfg.replace(pressure_solver="fft", advection_scheme="maccormack")):
        eng = Engine(c, "cpu")
        eng.state = state_from_numpy(arrays, "cpu")
        eng.step(2)
        states.append(state_to_numpy(eng.state))
    for f in FIELDS:
        bitwise(states[1][f], states[0][f], f)
