"""3D stable-fluids step (counterpart of ``fluidsim_tpu/models/stable3d.py``).

Two branches, as in the JAX package:

* the kernel path (``_kernels_usable``: a CUDA device and
  ``kernel_backend != "xla"``): buoyancy folded into the K1 self-advection
  kernel, then the K2 kernel (projection + density advection, with the
  velocity and density sinks folded in);
* the plain path (``kernel_backend="xla"`` or a CPU device): buoyancy force,
  windowed advection, float32 Jacobi projection, sinks, density advection —
  the JAX package's XLA composition.

Configurations the port does not cover yet raise ``NotImplementedError``
naming the missing piece (``check_supported``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import SimConfig
from ..kernels.advect import advect_multi_3d_kernel, advect_multi_3d_plain
from ..kernels.resident import (
    project_advect_density_3d,
    project_advect_density_3d_plain,
)
from ..ops.advect import advect_multi_3d, advect_substep_3d
from ..ops.forces import buoyancy_force
from ..ops.project import project_3d
from ..state import FluidState


class StepKernels(NamedTuple):
    """The two calls of the kernel path: ``advect(bs, fields, vel, dt,
    buoy=...)`` and ``project_advect(vel, density, iters, dt, solve_dtype=,
    damp=, dens_damp=)``."""

    advect: Callable
    project_advect: Callable


HAND_KERNELS = StepKernels(advect_multi_3d_kernel, project_advect_density_3d)
# The kernels' plain twins, for running the kernel path's arithmetic on a
# card without the kernels (the reference ``chip_smoke.py`` compares with).
PLAIN_TWINS = StepKernels(advect_multi_3d_plain, project_advect_density_3d_plain)


def _kernels_usable(cfg: SimConfig, device) -> bool:
    """Whether the hand kernels apply: a CUDA device, unless the config
    forces the plain path.  ``kernel_backend="pallas"`` requires them."""
    if cfg.kernel_backend == "xla":
        return False
    ok = torch.device(device).type == "cuda"
    if cfg.kernel_backend == "pallas" and not ok:
        raise RuntimeError(
            "kernel_backend='pallas' but the hand kernels are not usable "
            "here (they need a CUDA device)"
        )
    return ok


def _unported(what: str):
    raise NotImplementedError(f"{what} is not ported to fluidsim_tpu_torch yet")


def check_supported(cfg: SimConfig, use_kernels: bool) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot step."""
    _, diff, visc = cfg.effective_params()
    if cfg.ndim != 3:
        _unported("the 2D reference-parity mode (ndim=2)")
    if cfg.dtype != "float32":
        _unported(f"field dtype {cfg.dtype!r}")
    if cfg.enable_obstacle:
        _unported("obstacles (enable_obstacle)")
    if cfg.vorticity_confinement != 0.0:
        _unported("vorticity confinement")
    if visc > 0.0:
        _unported("viscous diffusion (viscosity > 0)")
    if diff > 0.0:
        _unported("density diffusion (diffusion > 0)")
    if cfg.double_project:
        _unported("double_project")
    if cfg.pressure_solver == "fft":
        _unported("the FFT pressure solver")
    if cfg.advection_scheme == "maccormack":
        _unported("MacCormack advection")
    if cfg.advect_window == 0:
        _unported("exact-gather advection (advect_window=0)")
    if cfg.apply_turbulent_noise:
        _unported("turbulent noise")
    if not use_kernels:
        return
    if cfg.advection_scheme != "substep" or not cfg.fuse_project_advect:
        _unported("the unfused projection kernel (K3, needed without "
                  "advection_scheme='substep' and fuse_project_advect)")
    if cfg.fuse_self_advect:
        _unported("the full-step kernel (K8, fuse_self_advect)")
    if cfg.fuse_emitter:
        _unported("the emitter-folded projection kernel (K2s, fuse_emitter)")
    if cfg.jacobi_sweep_block > 1:
        _unported("sweep-blocked Jacobi (K5, jacobi_sweep_block > 1)")
    if cfg.advect_window != 1 or cfg.advect_substeps != 1:
        _unported("kernel advection with advect_window != 1 or "
                  "advect_substeps != 1")


def sink_factor(dt: float, rate: float) -> float:
    """The implicit sink factor ``1/(1 + dt·rate)``, computed as the JAX
    package computes it."""
    return float(1.0 / (1.0 + np.float32(dt) * np.float32(rate)))


def simulate_step_3d(state: FluidState, cfg: SimConfig,
                     kernels: StepKernels = HAND_KERNELS) -> FluidState:
    """One product step.  ``kernels`` replaces the two calls of the kernel
    path (``PLAIN_TWINS`` runs their plain twins instead)."""
    dt = cfg.effective_params()[0]
    use_kernels = _kernels_usable(cfg, state.density.device)
    check_supported(cfg, use_kernels)
    vel = state.velocity
    density = state.density

    has_force = cfg.buoyancy != 0.0 or cfg.gravity != 0.0
    fold_buoy = has_force and cfg.fuse_buoyancy and use_kernels
    if has_force and not fold_buoy:
        vel = buoyancy_force(vel, density, dt, cfg.buoyancy,
                             cfg.ambient_density, cfg.gravity)
    damp = sink_factor(dt, cfg.velocity_damping) if cfg.velocity_damping else 1.0
    ddamp = (sink_factor(dt, cfg.density_dissipation)
             if cfg.density_dissipation else 1.0)

    if use_kernels:
        buoy = ((density, cfg.buoyancy, cfg.ambient_density, cfg.gravity)
                if fold_buoy else None)
        vel = kernels.advect((1, 2, 3), vel, vel, dt, buoy=buoy)
        vel, pressure, density = kernels.project_advect(
            vel, density, cfg.jacobi_iters, dt,
            solve_dtype=cfg.solve_dtype, damp=damp, dens_damp=ddamp,
        )
    else:
        win = cfg.advect_window

        def advect_fields(bs, fields, velocity):
            if cfg.advection_scheme == "substep":
                return advect_substep_3d(bs, fields, velocity, dt, None, win,
                                         n_sub=cfg.advect_substeps)
            return advect_multi_3d(bs, fields, velocity, dt, None, win)

        vel = advect_fields((1, 2, 3), vel, vel)
        vel, pressure = project_3d(vel, None, cfg.jacobi_iters)
        if cfg.velocity_damping != 0.0:
            vel = vel * damp
        density = advect_fields((0,), density[None], vel)[0]
        if cfg.density_dissipation != 0.0:
            density = density * ddamp

    return state.replace(
        density=density,
        velocity=vel,
        pressure=pressure,
        step=state.step + 1,
        time=state.time + dt,
    )


def make_step_3d(cfg: SimConfig, n_substeps: int = 1,
                 kernels: StepKernels = HAND_KERNELS):
    """An ``n_substeps``-step advance (a Python loop of ``simulate_step_3d``)."""

    def step(state: FluidState) -> FluidState:
        for _ in range(n_substeps):
            state = simulate_step_3d(state, cfg, kernels)
        return state

    return step
