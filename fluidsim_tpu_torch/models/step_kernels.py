"""The kernel table of both steps: which call each kernel slot of
``models/stable3d.simulate_step_3d`` and ``models/stable2d.simulate_step_2d``
takes.  ``HAND_KERNELS`` (the default) launches the hand kernels on CUDA
tensors; ``PLAIN_TWINS`` runs their plain PyTorch twins, for running the
kernel path's arithmetic on a card without the kernels (what
``chip_smoke.py`` compares with)."""

from __future__ import annotations

from typing import Callable, NamedTuple

from ..kernels.advect import advect_multi_3d_kernel, advect_multi_3d_plain
from ..kernels.halo import (
    advect_ext_kernel,
    advect_ext_plain,
    halo_exchange_rdma,
    halo_exchange_rdma_plain,
    jacobi_ext_kernel,
    jacobi_ext_plain,
    jacobi_ext_rdma,
    jacobi_ext_rdma_plain,
)
from ..kernels.project import (
    divergence_ext_kernel,
    divergence_ext_plain,
    gradient_ext_kernel,
    gradient_ext_plain,
    jacobi_3d_solve,
    jacobi_3d_solve_plain,
    project_3d_kernel,
    project_3d_plain,
)
from ..kernels.resident import (
    full_step_3d,
    full_step_3d_plain,
    project_advect_density_3d,
    project_advect_density_3d_plain,
)
from ..kernels.resident2d import lin_solve_2d_resident, lin_solve_2d_resident_plain


class StepKernels(NamedTuple):
    """The calls of the kernel path: ``advect(bs, fields, vel, dt, obst=,
    window=, n_sub=, buoy=, src=)``, ``project_advect(vel, density, iters,
    dt, obst=, n_sub=, src=, solve_dtype=, damp=, dens_damp=,
    sweep_block=)``, ``project(vel, iters, obst=, solve_dtype=, resident=,
    sweep_block=)``, which takes K3 or the slab route, ``full_step(vel,
    density, iters, dt, n_sub=, solve_dtype=, damp=, dens_damp=,
    sweep_block=)``, ``jacobi(b, x, x0, a, c, iters,
    obst=, resident=)``, which takes K4 or K6 (all 3D), the 2D step's
    ``solve_2d(b, x, x0, a, c, obst, iters, smooth=)`` (K9), and the
    sharded step's per-shard calls ``jacobi_ext(xp, x0_ext, a, c, t_iters,
    wall_lo, wall_hi, b, obst_ext)`` (K10), ``advect_ext(bs, fields_ext,
    vel_ext, n, dt, z_offset, window, n_sub, obst_ext)`` (K11), and the
    ``"rdma"`` backend's calls over all shards ``jacobi_ext_rdma(xps,
    x0_exts, a, c, t_iters, b, obst_exts)`` (K12) and
    ``halo_exchange_rdma(arrays_by_shard, depth)`` (K13), and the
    projection's per-shard ``divergence_ext(vel_ext, wall_lo, wall_hi)`` and
    ``gradient_ext(vel_ext, p_ext, wall_lo, wall_hi)`` (K7e)."""

    advect: Callable
    project_advect: Callable
    project: Callable
    full_step: Callable
    jacobi: Callable
    solve_2d: Callable
    jacobi_ext: Callable
    advect_ext: Callable
    jacobi_ext_rdma: Callable
    halo_exchange_rdma: Callable
    divergence_ext: Callable
    gradient_ext: Callable


HAND_KERNELS = StepKernels(advect_multi_3d_kernel, project_advect_density_3d,
                           project_3d_kernel, full_step_3d, jacobi_3d_solve,
                           lin_solve_2d_resident, jacobi_ext_kernel, advect_ext_kernel,
                           jacobi_ext_rdma, halo_exchange_rdma, divergence_ext_kernel,
                           gradient_ext_kernel)
PLAIN_TWINS = StepKernels(advect_multi_3d_plain, project_advect_density_3d_plain,
                          project_3d_plain, full_step_3d_plain, jacobi_3d_solve_plain,
                          lin_solve_2d_resident_plain, jacobi_ext_plain, advect_ext_plain,
                          jacobi_ext_rdma_plain, halo_exchange_rdma_plain,
                          divergence_ext_plain, gradient_ext_plain)
