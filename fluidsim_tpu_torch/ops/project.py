"""Pressure projection (Helmholtz-Hodge), 2D and the 3D plain path.

Counterpart of ``fluidsim_tpu/ops/project.py`` (the reference's
``ProjectWithJobs``, FluidSim.cs:1417-1521): divergence ``−0.5·Σ∂v/N``,
a float32 Jacobi solve with ``a=1, c=6`` (dividing by ``c``), then
``v −= 0.5·N·∂p`` with ``set_bnd`` per component.
"""

from __future__ import annotations

import torch

from .boundary import set_bnd_2d, set_bnd_3d
from .linsolve import jacobi_3d, sweeps_2d


def project_2d(vel_x, vel_y, obst, iters: int = 20, solve=None):
    """Projection of the ``[y, x]`` velocity ``(vel_x, vel_y)``; returns
    ``(vel_x, vel_y, p)``.  ``solve(b, x, x0, a, c, obst, iters)`` replaces
    the pressure solve (the K9 wrapper or its twin); gradients are not
    subtracted at interior obstacle cells."""
    n = vel_x.shape[0]
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar by
    # multiplying with its reciprocal, which is not XLA's division.
    nf = torch.tensor(float(n), dtype=vel_x.dtype, device=vel_x.device)
    core = (slice(1, -1), slice(1, -1))
    div_int = (
        -0.5
        * (
            (vel_x[1:-1, 2:] - vel_x[1:-1, :-2])
            + vel_y[2:, 1:-1]
            - vel_y[:-2, 1:-1]
        )
        / nf
    )
    div = torch.zeros_like(vel_x)
    div[core] = div_int
    div = set_bnd_2d(0, div, obst)
    p = set_bnd_2d(0, torch.zeros_like(vel_x), obst)
    if solve is None:
        solve = sweeps_2d
    p = solve(0, p, div, 1.0, 6.0, obst, iters)

    gx = 0.5 * (p[1:-1, 2:] - p[1:-1, :-2]) * nf
    gy = 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1]) * nf
    obst_int = obst[core]
    out = []
    for b, comp, g in ((1, vel_x, gx), (2, vel_y, gy)):
        comp = comp.clone()
        comp[core] = torch.where(obst_int, comp[core], comp[core] - g)
        out.append(set_bnd_2d(b, comp, obst))
    return out[0], out[1], p


def project_3d(vel: torch.Tensor, obst=None, iters: int = 20, jacobi_fn=None):
    """Projection of a ``(3, N, N, N)`` velocity on a ``[z, y, x]`` grid.
    ``jacobi_fn(p, div, iters, obst)`` replaces the XLA-class solve (the
    kernel route of the JAX ``project_3d(use_pallas=True)`` passes its
    resident or slab Jacobi kernel here).  Returns ``(vel, p)``."""
    n = vel.shape[-1]
    in_dtype = vel.dtype
    vel = vel.to(torch.float32)
    nf = float(n)
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar by
    # multiplying with its reciprocal, which is not XLA's division.
    nf_t = torch.tensor(nf, dtype=torch.float32, device=vel.device)
    core = (slice(1, -1),) * 3
    vx, vy, vz = vel[0], vel[1], vel[2]

    div_int = (
        -0.5
        * (
            (vx[1:-1, 1:-1, 2:] - vx[1:-1, 1:-1, :-2])
            + (vy[1:-1, 2:, 1:-1] - vy[1:-1, :-2, 1:-1])
            + (vz[2:, 1:-1, 1:-1] - vz[:-2, 1:-1, 1:-1])
        )
        / nf_t
    )
    div = torch.zeros_like(vx)
    div[core] = div_int
    div = set_bnd_3d(0, div, obst)
    p = set_bnd_3d(0, torch.zeros_like(vx), obst)
    if jacobi_fn is not None:
        p = jacobi_fn(p, div, iters, obst)
    else:
        p = jacobi_3d(0, p, div, 1.0, 6.0, obst, iters)

    grads = (
        0.5 * (p[1:-1, 1:-1, 2:] - p[1:-1, 1:-1, :-2]) * nf,
        0.5 * (p[1:-1, 2:, 1:-1] - p[1:-1, :-2, 1:-1]) * nf,
        0.5 * (p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1]) * nf,
    )
    out = []
    for c, (comp, g) in enumerate(zip((vx, vy, vz), grads)):
        if obst is not None:
            g = torch.where(obst[core], 0.0, g)
        comp = comp.clone()
        comp[core] = comp[core] - g
        out.append(set_bnd_3d(c + 1, comp, obst))
    return torch.stack(out).to(in_dtype), p.to(in_dtype)
