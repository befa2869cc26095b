"""Boundary conditions (the reference's ``set_bnd``), 3D.

Counterpart of ``fluidsim_tpu/ops/boundary.py``.  Faces mirror the adjacent
interior plane, negated for the velocity component normal to the wall, and
are written z→y→x so shared edges and corners take the later write.  The
obstacle mirror (FluidSim.cs:1261-1287, generalized to 3D) writes interior
obstacle cells from their non-obstacle neighbours along the component axis.
"""

from __future__ import annotations

import torch


def interior_mask(shape, device=None) -> torch.Tensor:
    """Bool mask of the cells with all coordinates in [1, N-2] (the solver
    interior)."""
    m = torch.zeros(shape, dtype=torch.bool, device=device)
    m[(slice(1, -1),) * len(shape)] = True
    return m


def apply_faces_3d(b: int, x: torch.Tensor) -> torch.Tensor:
    """Wall faces of a ``[z, y, x]`` tensor, written z→y→x (later write wins
    at shared edges/corners); ``b`` = 0 scalar, 1 = vx (x-walls negate),
    2 = vy, 3 = vz.  Returns a new tensor."""
    x = x.clone()
    for axis, neg_b in ((0, 3), (1, 2), (2, 1)):
        n = x.shape[axis]
        for dst, src in ((0, 1), (n - 1, n - 2)):
            plane = x.select(axis, src)
            x.select(axis, dst).copy_(-plane if b == neg_b else plane)
    return x


def _mirror_obstacles_axis(x, obst, axis):
    """Obstacle mirror along one axis (FluidSim.cs:1269-1284).

    Writes only obstacle cells in the interior (all coords 1..N-2); reads
    only non-obstacle neighbour cells, so there is no sequential dependency.
    """
    core = (slice(1, -1),) * x.ndim

    def shifted(arr, delta):
        idx = list(core)
        idx[axis] = slice(1 + delta, arr.shape[axis] - 1 + delta)
        return arr[tuple(idx)]

    prev_fluid = ~shifted(obst, -1)
    next_fluid = ~shifted(obst, +1)
    total = torch.where(prev_fluid, -shifted(x, -1), 0.0) + torch.where(
        next_fluid, -shifted(x, +1), 0.0
    )
    count = prev_fluid.to(x.dtype) + next_fluid.to(x.dtype)
    mirrored = torch.where(count > 0, total / torch.clamp(count, min=1.0), 0.0)
    out = x.clone()
    out[core] = torch.where(obst[core], mirrored, x[core])
    return out


def set_bnd_3d(b: int, x: torch.Tensor, obst=None) -> torch.Tensor:
    """3D boundary conditions on a ``[z, y, x]`` tensor: faces, then (for
    velocity components, when ``obst`` is given) the obstacle mirror."""
    x = apply_faces_3d(b, x)
    if obst is not None and b in (1, 2, 3):
        x = _mirror_obstacles_axis(x, obst, axis=3 - b)
    return x
