"""Jacobi linear solve and diffusion in 3D (counterpart of
``fluidsim_tpu/ops/linsolve.py``; the 2D solves are not ported yet)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .boundary import set_bnd_3d


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


def diffuse_3d(b: int, x0, diff: float, dt: float, obst, cfg):
    """3D diffusion: ``cfg.jacobi_iters`` sweeps of ``jacobi_3d`` from ``x0``
    with ``a = dt·diff·(N−2)²`` and ``c = 1 + 6a`` (float32, the JAX
    package's order)."""
    n = x0.shape[-1]
    a = float(
        np.float32(dt) * np.float32(diff) * np.float32(n - 2) * np.float32(n - 2)
    )
    c = float(np.float32(1.0) + np.float32(6.0) * np.float32(a))
    return jacobi_3d(b, x0, x0, a, c, obst, cfg.jacobi_iters)
