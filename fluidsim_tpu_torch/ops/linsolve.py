"""Jacobi linear solves and diffusion, 2D and 3D (counterpart of
``fluidsim_tpu/ops/linsolve.py``).

2D, the reference's linear algebra (FluidSim.cs:1034-1069, 1188-1233): the
self-smoothing ``DiffuseJob`` sweep ``x ← (x + a·Σ₄x) / c`` with interior
obstacle cells reset to the original ``x0`` (the reference's stale-buffer
quirk), the fixed-rhs sweep ``x ← (x0 + a·Σ₄x) / c`` with obstacle cells
keeping the previous iterate, each followed by ``set_bnd_2d``; ``Diffuse``
runs both back to back (the 40-sweep quirk).  3D: the fixed-rhs sweep with
``set_bnd_3d``.  Every division is by ``c`` (a 0-d tensor, see
``jacobi_3d``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import storage_scalar
from .boundary import set_bnd_2d, set_bnd_3d


def _nbr_sum_2d(x: torch.Tensor) -> torch.Tensor:
    """4-neighbour sum over the interior of a ``[y, x]`` tensor, in the
    reference's add order ``((right + left) + up) + down``
    (FluidSim.cs:1062-1067)."""
    return ((x[1:-1, 2:] + x[1:-1, :-2]) + x[2:, 1:-1]) + x[:-2, 1:-1]


def sweeps_2d(b: int, x, x0, a: float, c: float, obst, iters: int,
              smooth: bool = False):
    """``iters`` 2D Jacobi sweeps from ``x``, ``set_bnd_2d(b)`` after each:
    ``smooth`` takes the current iterate as the rhs and resets interior
    obstacle cells to ``x0`` (the reference's ``DiffuseWithJobs``,
    FluidSim.cs:1292-1357, from ``x = x0``); otherwise the rhs is ``x0`` and
    obstacle cells keep the previous iterate (``LinearSolveWithJobs``,
    FluidSim.cs:1359-1415).  ``obst=None`` removes the obstacle branches and
    the mirror."""
    core = (slice(1, -1), slice(1, -1))
    x0_int = x0[core]
    obst_int = obst[core] if obst is not None else None
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar by
    # multiplying with its reciprocal, which is not XLA's division.
    c_t = torch.tensor(c, dtype=x.dtype, device=x.device)
    a = storage_scalar(a, x.dtype)
    for _ in range(iters):
        rhs = x[core] if smooth else x0_int
        upd = (rhs + a * _nbr_sum_2d(x)) / c_t
        if obst_int is not None:
            upd = torch.where(obst_int, x0_int if smooth else x[core], upd)
        out = x.clone()
        out[core] = upd
        x = set_bnd_2d(b, out, obst)
    return x


def use_2d_kernels(cfg, dtype=torch.float32) -> bool:
    """Whether the 2D solves take the whole-solve kernel (K9,
    ``kernels/resident2d.py``): the JAX package's physics terms, float32
    fields and a config not forced to the plain path.  On a CPU tensor the
    kernel's wrapper runs its plain twin, which is these functions."""
    return cfg.kernel_backend != "xla" and dtype == torch.float32


def diffuse_2d(b: int, x0, diff: float, dt: float, obst, cfg, solve=None):
    """The reference ``Diffuse`` (FluidSim.cs:740-745): ``a = dt·diff·(N−2)²``,
    ``c = 1 + 6a`` (float32, the reference's order), the smoothing solve,
    then (``cfg.double_diffuse``) the fixed-rhs solve.  ``solve(b, x, x0, a,
    c, obst, iters, smooth=)`` replaces both (the K9 wrapper or its twin)."""
    n = x0.shape[0]
    a = float(
        np.float32(dt) * np.float32(diff) * np.float32(n - 2) * np.float32(n - 2)
    )
    c = float(np.float32(1.0) + np.float32(6.0) * np.float32(a))
    iters = cfg.jacobi_iters
    if solve is None:
        solve = sweeps_2d
    x = solve(b, x0, x0, a, c, obst, iters, smooth=True)
    if cfg.double_diffuse:
        x = solve(b, x, x0, a, c, obst, iters, smooth=False)
    return x


def _nbr_sum_3d(x: torch.Tensor) -> torch.Tensor:
    """6-neighbour sum over the interior of a [z, y, x] tensor, in the add
    order ``((x₊+x₋) + (y₊+y₋)) + (z₊+z₋)``."""
    return (
        ((x[1:-1, 1:-1, 2:] + x[1:-1, 1:-1, :-2])
         + (x[1:-1, 2:, 1:-1] + x[1:-1, :-2, 1:-1]))
        + (x[2:, 1:-1, 1:-1] + x[:-2, 1:-1, 1:-1])
    )


def jacobi_3d(b: int, x, x0, a: float, c: float, obst, iters: int):
    """Fixed-rhs Jacobi sweeps ``x ← (x0 + a·Σ₆x) / c`` on interior
    non-obstacle cells; obstacle cells copy the previous iterate;
    ``set_bnd_3d(b)`` after every sweep.  ``obst=None`` removes the obstacle
    branches.  Narrow inputs are solved in float32."""
    in_dtype = x.dtype
    x = x.to(torch.float32)
    x0 = x0.to(torch.float32)
    core = (slice(1, -1),) * 3
    x0_int = x0[core]
    obst_int = obst[core] if obst is not None else None
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar by
    # multiplying with its reciprocal, which is not XLA's division.
    c_t = torch.tensor(c, dtype=torch.float32, device=x.device)
    for _ in range(iters):
        upd = (x0_int + a * _nbr_sum_3d(x)) / c_t
        if obst_int is not None:
            upd = torch.where(obst_int, x[core], upd)
        x = set_bnd_3d(b, F.pad(upd, (1, 1, 1, 1, 1, 1)), obst)
    return x.to(in_dtype)


def diffusion_coefficients(n: int, diff: float, dt: float):
    """``(a, c)`` of the 3D diffusion solve on an ``n³`` grid: ``a =
    dt·diff·(N−2)²`` and ``c = 1 + 6a`` (float32, the JAX package's
    order)."""
    a = float(
        np.float32(dt) * np.float32(diff) * np.float32(n - 2) * np.float32(n - 2)
    )
    return a, float(np.float32(1.0) + np.float32(6.0) * np.float32(a))


def diffuse_3d(b: int, x0, diff: float, dt: float, obst, cfg):
    """3D diffusion: ``cfg.jacobi_iters`` sweeps of ``jacobi_3d`` from ``x0``
    with ``diffusion_coefficients``."""
    a, c = diffusion_coefficients(x0.shape[-1], diff, dt)
    return jacobi_3d(b, x0, x0, a, c, obst, cfg.jacobi_iters)
