"""Reference-parity 2D stable-fluids step (counterpart of
``fluidsim_tpu/models/stable2d.py``): the reference's ``Simulate``
(FluidSim.cs:551-721).

``VelocityStep`` (FluidSim.cs:703-714)::

    vx0 = Diffuse(1, vx);  vy0 = Diffuse(2, vy)          # 40 sweeps each
    (vx0, vy0) = Project(vx0, vy0)                        # 20-sweep Jacobi
    (vx, vy) = Advect(1 and 2, (vx0, vy0) by (vx0, vy0))  # one backtrace
    (vx, vy, pressure) = Project(vx, vy)

``DensityStep`` (FluidSim.cs:716-721)::

    tmp = Diffuse(0, density);  density = Advect(0, tmp by (vx, vy))

then the optional turbulence and the obstacle enforcement with Reynolds
drag (FluidSim.cs:561-570).  Every Jacobi solve (three smoothing and three
fixed-rhs diffusion solves and two pressure solves a step, with the
reference's ``double_diffuse``) goes through ``kernels.solve_2d`` where
``ops/linsolve.use_2d_kernels`` holds (float32 fields): K9 on a card
(``kernels/resident2d.py``), its twin on the CPU.  On bfloat16 fields the
solves are the plain sweeps in bfloat16, as the JAX package takes XLA there.
Everything else is plain PyTorch, as the JAX package leaves it to XLA.  The 2D path ignores
``pressure_solver`` and ``advection_scheme``, as the JAX package does.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..ops.advect import advect_2d, advect_2d_pair
from ..ops.forces import apply_turbulent_noise_2d, enforce_obstacle_boundaries_2d
from ..ops.linsolve import diffuse_2d, use_2d_kernels
from ..ops.project import project_2d
from ..state import FluidState
from .step_kernels import HAND_KERNELS, StepKernels


def velocity_step_2d(vel_x, vel_y, obst, dt: float, visc: float, cfg: SimConfig,
                     solve=None):
    """FluidSim.cs:703-714; ``solve`` replaces the Jacobi solves (K9).
    Returns ``(vel_x, vel_y, pressure)``."""
    iters = cfg.jacobi_iters
    vx0 = diffuse_2d(1, vel_x, visc, dt, obst, cfg, solve)
    vy0 = diffuse_2d(2, vel_y, visc, dt, obst, cfg, solve)
    vx0, vy0, _ = project_2d(vx0, vy0, obst, iters, solve)
    vel_x, vel_y = advect_2d_pair(vx0, vy0, vx0, vy0, dt, obst)
    return project_2d(vel_x, vel_y, obst, iters, solve)


def density_step_2d(density, vel_x, vel_y, obst, dt: float, diff: float,
                    cfg: SimConfig, solve=None):
    """FluidSim.cs:716-721."""
    tmp = diffuse_2d(0, density, diff, dt, obst, cfg, solve)
    return advect_2d(0, tmp, vel_x, vel_y, dt, obst)


def simulate_step_2d(state: FluidState, cfg: SimConfig,
                     kernels: StepKernels = HAND_KERNELS) -> FluidState:
    """One reference ``Simulate()`` (FluidSim.cs:551-576).  ``kernels``
    supplies the solve (``PLAIN_TWINS`` runs K9's twin)."""
    dt, diff, visc = cfg.effective_params()
    obst = state.obstacles
    solve = kernels.solve_2d if use_2d_kernels(cfg, state.density.dtype) else None

    vel_x, vel_y, pressure = velocity_step_2d(
        state.velocity[0], state.velocity[1], obst, dt, visc, cfg, solve)
    density = density_step_2d(state.density, vel_x, vel_y, obst, dt, diff, cfg, solve)
    if cfg.apply_turbulent_noise:
        vel_x, vel_y = apply_turbulent_noise_2d(vel_x, vel_y)
    if cfg.enable_obstacle:
        vel_x, vel_y = enforce_obstacle_boundaries_2d(
            vel_x, vel_y, obst, cfg.cell_size, cfg.viscosity)
    return state.replace(
        density=density,
        velocity=torch.stack([vel_x, vel_y]),
        pressure=pressure,
        step=state.step + 1,
        time=state.time + dt,
    )


def make_step_2d(cfg: SimConfig, n_substeps: int = 1,
                 kernels: StepKernels = HAND_KERNELS):
    """An ``n_substeps``-step advance (a Python loop of ``simulate_step_2d``;
    the JAX package's ``make_step_2d`` rolls the same steps with
    ``lax.scan``)."""

    def step(state: FluidState) -> FluidState:
        for _ in range(n_substeps):
            state = simulate_step_2d(state, cfg, kernels)
        return state

    return step
