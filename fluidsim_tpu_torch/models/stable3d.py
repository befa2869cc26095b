"""3D stable-fluids step (counterpart of ``fluidsim_tpu/models/stable3d.py``).

Step order, as in the JAX package: buoyancy → vorticity confinement →
[viscous diffusion] → [pre-projection] → self-advect velocity → pressure
projection → velocity damping → [density diffusion] → advect density →
density dissipation → obstacle enforcement.  Two branches:

* the kernel path (``_kernels_usable``: a CUDA device, ``kernel_backend !=
  "xla"`` and a windowed advection): where ``fuses_projection`` allows and
  ``fuse_self_advect`` asks for it without a mask, K8 (the whole step in
  one launch); else K1 for the self-advection (with the buoyancy folded in
  where ``fold_buoyancy`` allows; once with ``n_sub = 1`` for the
  semi-Lagrangian scheme, as MacCormack's forward and backward step for
  that scheme), then either K2 (projection + density advection, the sinks
  folded in; K2o with a mask; where ``fuses_projection`` allows) or the
  projection alone followed by K1 for the density; the projection is K3, or
  the slab route K7 → K6 → K7 when the solve does not fit the card's L2
  (``kernels/project.py``); K1 and K2 run the substeps and the obstacle
  contract in the kernel.  The pre-projection (``double_project``) is the
  plain divergence and gradient around K4 (or K6 above the L2 gate), as the
  JAX ``project_3d(use_pallas=True)``.  Where ``emitter_folds`` holds, the
  caller passes the emitter as ``src`` and K1 and K2 add it to the density
  they read (K2s);
* the plain path (``kernel_backend="xla"``, window 0, or a CPU device): the
  JAX package's XLA composition of the ``ops`` functions.

The sharded step (``parallel.sharding.sharded_step_fn``) passes two hooks,
as in the JAX package: ``advect_fn`` takes every advection (K11 per shard)
and ``jacobi_fn`` the pressure solve, inside ``ops/project.project_3d``'s
plain divergence and gradient (K10 per shard).  Either hook turns the
fused kernels and the buoyancy fold off.

Buoyancy (when not folded), vorticity confinement, diffusion, MacCormack's
limiter, the FFT projection (``pressure_solver="fft"``, ``torch.fft``),
turbulent noise and obstacle enforcement are plain PyTorch on both paths,
as the JAX package leaves them to XLA.  Fields are float32 or bfloat16
(``cfg.dtype``); the kernels take either, and the sinks multiply in the
field dtype.  ``cfg.jacobi_sweep_block`` reaches K2, K3 and K8, as the JAX
step passes it to its fused, unfused and whole-step projections: on float32
fields their solve runs K5, the sweep-blocked solve; the pre-projection's
K4 and the slab route solve sequentially, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..dtypes import scale_in
from ..kernels.advect import check_window
from ..kernels.project import resident_route
from ..ops.advect import advect_maccormack_3d, advect_multi_3d, advect_substep_3d
from ..ops.fft_poisson import project_3d_fft
from ..ops.forces import (
    apply_turbulent_noise_3d,
    buoyancy_force,
    enforce_obstacle_boundaries_3d,
    vorticity_confinement_3d,
)
from ..ops.linsolve import diffuse_3d
from ..ops.project import project_3d
from ..scene.sources import emitter_foldable
from ..state import FluidState
from ..utils.profiling import span
from .step_kernels import HAND_KERNELS, StepKernels


def _kernels_usable(cfg: SimConfig, device) -> bool:
    """Whether the hand kernels apply: a CUDA device and a windowed
    advection (``advect_window > 0``: no kernel takes the exact gather, as
    in the JAX package's ``_pallas_usable``), unless the config forces the
    plain path.  ``kernel_backend="pallas"`` requires them."""
    if cfg.kernel_backend == "xla":
        return False
    ok = torch.device(device).type == "cuda" and cfg.advect_window > 0
    if cfg.kernel_backend == "pallas" and not ok:
        raise RuntimeError(
            "kernel_backend='pallas' but the hand kernels are not usable "
            "here (they need a CUDA device and advect_window > 0)"
        )
    return ok


def fuses_projection(cfg: SimConfig, use_kernels: bool, resident: bool,
                     jacobi_fn=None, advect_fn=None) -> bool:
    """Whether the step runs a fused kernel, K2 (the projection + density
    advection) or, with ``fuse_self_advect`` and no mask, K8 (the whole
    step): asked for (``fuse_project_advect``) on the kernel path with the
    substep scheme and the Jacobi solver and without the sharded step's
    hooks (the JAX ``fuse_ok``), and the solve fits the card's L2
    (``resident``, from ``resident_route``; as the JAX step takes its fused
    kernels only where they fit on chip)."""
    return (
        use_kernels
        and jacobi_fn is None
        and advect_fn is None
        and cfg.fuse_project_advect
        and cfg.advection_scheme == "substep"
        and cfg.pressure_solver != "fft"
        and resident
    )


def check_supported(cfg: SimConfig, use_kernels: bool) -> None:
    """Raise ``ValueError`` for a config the port cannot step on the kernel
    path: a window of K cells on a grid smaller than ``2K+1`` (the kernels
    take any K >= 1, ``kernels.advect.check_window``)."""
    if cfg.ndim != 3:
        raise ValueError("a 2D config steps with models.stable2d, not the 3D step")
    if use_kernels:
        check_window(cfg.advect_window, cfg.current_size)


def emitter_folds(cfg: SimConfig, use_kernels: bool, resident: bool) -> bool:
    """Whether the main emitter's density add folds into the kernels'
    density reads: the caller then skips ``apply_custom_source`` and passes
    ``src=emitter_fold_operand(cfg, t)`` to ``simulate_step_3d``.  The JAX
    package's gate (``fluidsim_tpu/models/stable3d.emitter_folds``) with its
    kernel test replaced by the port's: a foldable emitter, the fused
    projection (``fuses_projection``, so the solve fits the card's L2) and
    not the full step, no obstacle, no density diffusion, and, with a body
    force, the buoyancy fold (the force must see the emitted density)."""
    if not (cfg.fuse_emitter and emitter_foldable(cfg)):
        return False
    _, diff, visc = cfg.effective_params()
    has_force = cfg.buoyancy != 0.0 or cfg.gravity != 0.0
    return (
        fuses_projection(cfg, use_kernels, resident)
        and cfg.advection_scheme == "substep"
        and not cfg.fuse_self_advect
        and not cfg.enable_obstacle
        and cfg.pressure_solver != "fft"
        and diff == 0.0
        and (not has_force
             or (cfg.fuse_buoyancy
                 and cfg.vorticity_confinement == 0.0
                 and visc <= 0.0
                 and not cfg.double_project))
    )


def fold_buoyancy(cfg: SimConfig, use_kernels: bool, advect_fn=None) -> bool:
    """Whether the buoyancy force folds into the self-advection kernel: the
    JAX package's gate (``fluidsim_tpu/models/stable3d.py``), valid only
    when nothing acts on the velocity between the force and the advection
    (no obstacle, vorticity, viscosity or pre-projection), the kernel path
    runs the substep scheme and no ``advect_fn`` hook replaces K1."""
    _, _, visc = cfg.effective_params()
    has_force = cfg.buoyancy != 0.0 or cfg.gravity != 0.0
    return (
        has_force
        and cfg.fuse_buoyancy
        and use_kernels
        and advect_fn is None
        and not cfg.enable_obstacle
        and cfg.vorticity_confinement == 0.0
        and visc <= 0.0
        and not cfg.double_project
        and cfg.advection_scheme == "substep"
        and not cfg.fuse_self_advect
        and cfg.dtype == "float32"
    )


def sink_factor(dt: float, rate: float) -> float:
    """The implicit sink factor ``1/(1 + dt·rate)``, computed as the JAX
    package computes it."""
    return float(1.0 / (1.0 + np.float32(dt) * np.float32(rate)))


def simulate_step_3d(state: FluidState, cfg: SimConfig,
                     kernels: StepKernels = HAND_KERNELS,
                     resident=None, src=None, jacobi_fn=None,
                     advect_fn=None) -> FluidState:
    """One product step.  ``kernels`` replaces the calls of the kernel path
    (``PLAIN_TWINS`` runs their plain twins instead).  ``resident`` is
    ``resident_route``'s answer for this grid and device where the caller
    decided it once (``Engine`` does); None decides it here.  ``src`` is
    the folded emitter's descriptor (``scene.sources.emitter_fold_operand``),
    only where ``emitter_folds`` holds: the caller has then skipped
    ``apply_custom_source``.

    ``jacobi_fn(p, div, iters, obst)`` replaces the pressure solve, between
    the plain divergence and gradient of ``ops/project.project_3d``, and
    ``advect_fn(bs, fields, vel, dt, obst)`` replaces every advection (it
    implements the whole scheme and the per-substep obstacle contract): the
    hooks of the explicit halo-exchange sharded step
    (``parallel.sharding.sharded_step_fn``), as in the JAX package.  Without
    them the step is unchanged."""
    dt, diff, visc = cfg.effective_params()
    device = state.density.device
    use_kernels = _kernels_usable(cfg, device)
    if resident is None:
        resident = resident_route(cfg.current_size, cfg.solve_dtype, device)
    check_supported(cfg, use_kernels)
    if src is not None and (jacobi_fn is not None or advect_fn is not None):
        raise ValueError("src folding is incompatible with solver hooks "
                         "(sharded paths apply the emitter themselves)")
    if src is not None and not emitter_folds(cfg, use_kernels, resident):
        raise ValueError(
            "src (folded emitter) passed but emitter_folds is False for this "
            "config: the caller must apply apply_custom_source itself")
    obst = state.obstacles if cfg.enable_obstacle else None
    win = cfg.advect_window
    vel = state.velocity
    density = state.density

    has_force = cfg.buoyancy != 0.0 or cfg.gravity != 0.0
    fold_buoy = fold_buoyancy(cfg, use_kernels, advect_fn)
    with span("phase.forces", device):
        if has_force and not fold_buoy:
            vel = buoyancy_force(vel, density, dt, cfg.buoyancy,
                                 cfg.ambient_density, cfg.gravity)
        if cfg.vorticity_confinement != 0.0:
            vel = vorticity_confinement_3d(vel, dt, cfg.vorticity_confinement)
        if visc > 0.0:
            vel = torch.stack([diffuse_3d(c + 1, vel[c], visc, dt, obst, cfg)
                               for c in range(3)])
    if cfg.double_project:
        solve = None
        if use_kernels:
            # K4's route is the float32 solve's: the projection's where that
            # solves in float32 too.
            fits = resident if cfg.solve_dtype == "float32" else None

            def solve(p, div, iters, mask):
                return kernels.jacobi(0, p, div, 1.0, 6.0, iters, obst=mask,
                                      resident=fits)
        with span("phase.project", device):
            vel, _ = project_3d(vel, obst, cfg.jacobi_iters, jacobi_fn=solve)
    damp = sink_factor(dt, cfg.velocity_damping) if cfg.velocity_damping else 1.0
    ddamp = (sink_factor(dt, cfg.density_dissipation)
             if cfg.density_dissipation else 1.0)

    if advect_fn is not None:
        def advect(bs, fields, velocity, buoy=None):
            return advect_fn(bs, fields, velocity, dt, obst)
    elif use_kernels:
        def base(bs, fields, velocity, d):
            return kernels.advect(bs, fields, velocity, d, obst=obst, window=win)

        if cfg.advection_scheme == "substep":
            def advect(bs, fields, velocity, buoy=None):
                return kernels.advect(bs, fields, velocity, dt, obst=obst,
                                      window=win, n_sub=cfg.advect_substeps,
                                      buoy=buoy,
                                      src=src if buoy is not None else None)
        elif cfg.advection_scheme == "maccormack":
            def advect(bs, fields, velocity, buoy=None):
                return advect_maccormack_3d(bs, fields, velocity, dt, obst, win,
                                            advect_fn=base)
        else:
            def advect(bs, fields, velocity, buoy=None):
                return base(bs, fields, velocity, dt)
    else:
        def advect(bs, fields, velocity, buoy=None):
            if cfg.advection_scheme == "substep":
                return advect_substep_3d(bs, fields, velocity, dt, obst, win,
                                         n_sub=cfg.advect_substeps)
            if cfg.advection_scheme == "maccormack":
                return advect_maccormack_3d(bs, fields, velocity, dt, obst, win)
            return advect_multi_3d(bs, fields, velocity, dt, obst, win)

    fused = fuses_projection(cfg, use_kernels, resident, jacobi_fn, advect_fn)
    if fused:
        dens_in = density
        if diff > 0.0:
            # Density diffusion touches no velocity, so it runs before the
            # fused kernel (as in the JAX package).
            with span("phase.advect_density", device):
                dens_in = diffuse_3d(0, density, diff, dt, obst, cfg)
    if fused and cfg.fuse_self_advect and obst is None:
        with span("phase.project", device):
            vel, pressure, density = kernels.full_step(
                vel, dens_in, cfg.jacobi_iters, dt, window=win,
                n_sub=cfg.advect_substeps, solve_dtype=cfg.solve_dtype, damp=damp,
                dens_damp=ddamp, sweep_block=cfg.jacobi_sweep_block,
            )
    else:
        buoy = ((density, cfg.buoyancy, cfg.ambient_density, cfg.gravity)
                if fold_buoy else None)
        with span("phase.advect_velocity", device):
            vel = advect((1, 2, 3), vel, vel, buoy)
        with span("phase.project", device):
            if fused:
                vel, pressure, density = kernels.project_advect(
                    vel, dens_in, cfg.jacobi_iters, dt, window=win, obst=obst,
                    n_sub=cfg.advect_substeps, src=src,
                    solve_dtype=cfg.solve_dtype, damp=damp, dens_damp=ddamp,
                    sweep_block=cfg.jacobi_sweep_block,
                )
            elif jacobi_fn is not None:
                vel, pressure = project_3d(vel, obst, cfg.jacobi_iters,
                                           jacobi_fn=jacobi_fn)
            elif cfg.pressure_solver == "fft":
                if cfg.enable_obstacle:
                    raise ValueError("pressure_solver='fft' requires no obstacles")
                vel, pressure = project_3d_fft(vel)
            elif use_kernels:
                vel, pressure = kernels.project(vel, cfg.jacobi_iters, obst=obst,
                                                solve_dtype=cfg.solve_dtype,
                                                resident=resident,
                                                sweep_block=cfg.jacobi_sweep_block)
            else:
                vel, pressure = project_3d(vel, obst, cfg.jacobi_iters)

    if not fused:
        if cfg.velocity_damping != 0.0:
            with span("phase.sinks", device):
                vel = scale_in(vel, damp)
        with span("phase.advect_density", device):
            if diff > 0.0:
                density = diffuse_3d(0, density, diff, dt, obst, cfg)
            density = advect((0,), density[None], vel)[0]
        if cfg.density_dissipation != 0.0:
            with span("phase.sinks", device):
                density = scale_in(density, ddamp)

    if cfg.apply_turbulent_noise:
        with span("phase.forces", device):
            vel = apply_turbulent_noise_3d(vel)
    if cfg.enable_obstacle:
        with span("phase.obstacles", device):
            vel = enforce_obstacle_boundaries_3d(vel, state.obstacles,
                                                 cfg.cell_size, cfg.viscosity)

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


def make_step(cfg: SimConfig, n_substeps: int = 1, kernels: StepKernels = HAND_KERNELS):
    """The step factory of ``cfg``'s dimension: ``make_step_3d`` or
    ``models.stable2d.make_step_2d`` (the JAX package's ``make_step``)."""
    if cfg.ndim == 3:
        return make_step_3d(cfg, n_substeps, kernels)
    from .stable2d import make_step_2d

    return make_step_2d(cfg, n_substeps, kernels)
