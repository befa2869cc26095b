"""Jacobi linear solve in 3D (counterpart of ``fluidsim_tpu/ops/linsolve.py``;
the 2D solves and ``diffuse_3d`` are not ported yet)."""

from __future__ import annotations

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
    for _ in range(iters):
        upd = (x0_int + a * _nbr_sum_3d(x)) / c
        if obst_int is not None:
            upd = torch.where(obst_int, x[core], upd)
        x = set_bnd_3d(b, F.pad(upd, (1, 1, 1, 1, 1, 1)), obst)
    return x.to(in_dtype)
