"""The JAX package's randomized config matrix (tests/test_config_matrix.py),
stepped by both packages: every config the generator draws, with the same
seeds, is built in fluidsim_tpu and in fluidsim_tpu_torch and stepped 3
times on the CPU from one seeded NumPy start state.

Each field of the port is held to the JAX step's class: float32 within
rtol 1e-5, atol 1e-5·max|ref|; bfloat16 at storage precision, rtol and
atol 3e-2·max|ref| (tests/test_bf16.py).  A config whose fields leave that
class (a chaotic one: vorticity confinement's normalised gradient turns by
O(1) for a last-bit change, tests/test_torch_vortex.py) is held instead to
4× the JAX package's own divergence from a start velocity moved by one ulp.
The JAX turbulence leaves a bfloat16 config's velocity in float32, which the
port keeps in bfloat16; the reference is rounded back after each step the
same way (``run_jax``).  The plain path of either package ignores
``jacobi_sweep_block`` and the fusion flags, so no config raises on the CPU;
on the kernel path every sampled config passes ``check_supported`` (the
sweep-blocked solve, K5, included).
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsim_tpu.config import ObstacleShape, SimConfig
from fluidsim_tpu.engine import Engine as JEngine
from fluidsim_tpu.scene.obstacles import build_obstacle_mask as j_build_mask
from fluidsim_tpu.state import FluidState as JState

from fluidsim_tpu_torch import config as t_config
from fluidsim_tpu_torch.engine import Engine
from fluidsim_tpu_torch.io.convert import state_from_numpy
from fluidsim_tpu_torch.models import stable3d as t_s3

torch.set_num_threads(1)

STEPS = 3


def _random_cfg(rng: random.Random) -> SimConfig:
    """tests/test_config_matrix.py's generator, draw for draw."""
    ndim = rng.choice((2, 3))
    size = 32 if ndim == 3 else rng.choice((32, 48, 64))
    scheme = rng.choice(
        ("semi_lagrangian",) if ndim == 2
        else ("semi_lagrangian", "windowed", "substep")
    )
    enable_obstacle = rng.random() < 0.7
    shape = rng.choice(list(ObstacleShape))
    nd_pos = tuple(rng.uniform(0.3, 0.7) for _ in range(ndim))
    kwargs = dict(
        ndim=ndim,
        size=size,
        resolution_multiplier=1.0,
        time_step=rng.choice((0.02, 0.1)),
        diffusion=rng.choice((0.0, 1e-4)),
        viscosity=rng.choice((0.0, 1e-4)),
        jacobi_iters=rng.choice((4, 20)),
        double_diffuse=rng.random() < 0.5,
        auto_adjust_parameters=rng.random() < 0.5,
        advection_scheme=scheme,
        enable_obstacle=enable_obstacle,
        obstacle_shape=shape,
        obstacle_position=nd_pos,
        obstacle_radius=rng.uniform(0.05, 0.2),
        enable_custom_source=rng.random() < 0.8,
        source_position=nd_pos,
        source_strength=rng.uniform(10.0, 200.0),
        source_emits_velocity=rng.random() < 0.5,
        source_pulsing=rng.random() < 0.3,
        pulse_clock=rng.choice(("sim", "wall")),
        apply_turbulent_noise=rng.random() < 0.3,
        dtype=rng.choice(("float32", "bfloat16")),
    )
    if scheme == "substep":
        kwargs["advect_substeps"] = rng.choice((1, 2, 3))
        if rng.random() < 0.4:
            kwargs["fuse_project_advect"] = True
            kwargs["fuse_self_advect"] = rng.random() < 0.5
    kwargs["jacobi_sweep_block"] = rng.choice((1, 1, 2, 4))
    if ndim == 3:
        kwargs.update(
            buoyancy=rng.choice((0.0, 1.0)),
            vorticity_confinement=rng.choice((0.0, 0.2)),
            gravity=rng.choice((0.0, 0.5)),
            density_dissipation=rng.choice((0.0, 3.0)),
            velocity_damping=rng.choice((0.0, 2.0)),
        )
    return SimConfig(**kwargs)


def port_cfg(jcfg: SimConfig) -> t_config.SimConfig:
    """The same config built by the port (its ``SimConfig`` takes the same
    fields; the obstacle shape by value)."""
    kw = {f: getattr(jcfg, f) for f in t_config.SimConfig.__dataclass_fields__}
    kw["obstacle_shape"] = t_config.ObstacleShape(jcfg.obstacle_shape.value)
    return t_config.SimConfig(**kw).validate()


def start_arrays(cfg, seed: int, ulp: bool = False):
    """A seeded start state (fields rounded to the config's dtype, held as
    float32), optionally with every velocity value moved up by one ulp of
    that dtype."""
    rng = np.random.default_rng(seed)
    n = cfg.current_size
    grid = (n,) * cfg.ndim
    fdt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def stored(a):
        return torch.from_numpy(a.astype(np.float32)).to(fdt).float().numpy()

    vel = stored(rng.standard_normal((cfg.ndim,) + grid) * 0.3)
    if ulp:
        vel = torch.nextafter(torch.from_numpy(vel).to(fdt),
                              torch.tensor(np.inf, dtype=fdt)).float().numpy()
    return {
        "density": stored(np.abs(rng.standard_normal(grid)) * 3.0),
        "velocity": vel,
        "pressure": np.zeros(grid, np.float32),
        "obstacles": np.asarray(j_build_mask(cfg)),
        "step": np.zeros((), np.int32),
        "time": np.zeros((), np.float32),
    }


def fake_clock():
    """A deterministic frame clock, 50 ms a frame (``pulse_clock="wall"``)."""
    ticks = iter(np.arange(0.0, 10.0, 0.05))
    return lambda: float(next(ticks))


def run_jax(eng, arrays):
    """``STEPS`` steps of the JAX engine ``eng`` from ``arrays``.  The JAX
    turbulence returns a float32 velocity for bfloat16 fields (its Perlin
    gradients are a float32 table), which the port rounds back to the
    storage dtype; the reference does the same after each step, so both
    sample the noise at the same coordinates."""
    cfg = eng.cfg
    eng._clock = fake_clock()
    eng._elapsed, eng._wall_prev = 0.0, None
    jdt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    eng.state = JState(**{k: jnp.asarray(v).astype(jdt)
                          if k in ("density", "velocity", "pressure") else jnp.asarray(v)
                          for k, v in arrays.items()})
    for _ in range(STEPS):
        eng.step(1)
        eng.state = eng.state.replace(velocity=eng.state.velocity.astype(jdt))
    return {k: np.asarray(getattr(eng.state, k), np.float32)
            for k in ("density", "velocity", "pressure")}


def run_port(cfg, arrays):
    eng = Engine(cfg, "cpu")
    eng._clock = fake_clock()
    eng.state = state_from_numpy(arrays, "cpu", dtype=cfg.dtype)
    for _ in range(STEPS):
        eng.step(1)
    assert eng.state.velocity.dtype == (torch.bfloat16 if cfg.dtype == "bfloat16"
                                        else torch.float32)
    return {k: getattr(eng.state, k).float().numpy()
            for k in ("density", "velocity", "pressure")}


def within_class(got, ref, bf16: bool) -> bool:
    tol = 3e-2 if bf16 else 1e-5
    scale = max(float(np.abs(ref).max()), 1e-6)
    return bool(np.all(np.abs(got - ref) <= tol * scale + tol * np.abs(ref)))


@pytest.mark.parametrize("seed", range(16))
def test_random_config_steps_like_jax(seed):
    jcfg = _random_cfg(random.Random(1000 + seed))
    cfg = port_cfg(jcfg)
    label = (f"seed={seed} ndim={cfg.ndim} scheme={cfg.advection_scheme} "
             f"obst={cfg.enable_obstacle} dtype={cfg.dtype} noise={cfg.apply_turbulent_noise}")
    arrays = start_arrays(jcfg, seed)
    jeng = JEngine(jcfg)
    ref = run_jax(jeng, arrays)
    got = run_port(cfg, arrays)
    off = [f for f in ref if not within_class(got[f], ref[f], cfg.dtype == "bfloat16")]
    if off:
        own = run_jax(jeng, start_arrays(jcfg, seed, ulp=True))
        for f in off:
            diff = float(np.abs(got[f] - ref[f]).max())
            spread = float(np.abs(own[f] - ref[f]).max())
            assert diff <= 4.0 * spread, (
                f"{label} {f}: max abs diff {diff:.3e} > 4 x the JAX package's own "
                f"one-ulp divergence {spread:.3e}")
    for f in got:
        assert np.isfinite(got[f]).all(), f"{label} {f}"
    if cfg.ndim == 3:
        # On the card's kernel path every sampled config steps (the
        # sweep-blocked solve included).
        t_s3.check_supported(cfg, t_s3._kernels_usable(cfg, torch.device("cuda")))
