"""Boundary conditions (the reference's ``set_bnd``), 2D and 3D.

Counterpart of ``fluidsim_tpu/ops/boundary.py``.  2D (``set_bnd_2d``, the
reference's ``BoundaryJob``, FluidSim.cs:1243-1288): wall edges (corners
excluded) copy the adjacent interior cell, negated for the velocity
component normal to the wall; then each corner is the average of its two
just-written edge cells.  3D: faces mirror the adjacent interior plane,
negated likewise, written z→y→x so shared edges and corners take the later
write.  In both, the obstacle mirror (FluidSim.cs:1261-1287, generalized to
3D) then writes interior obstacle cells from their non-obstacle neighbours
along the component axis.
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


def set_bnd_2d(b: int, x: torch.Tensor, obst=None) -> torch.Tensor:
    """The reference ``BoundaryJob`` on a ``[y, x]`` tensor: ``b == 1``
    negates across the x walls (columns 0 and N-1), ``b == 2`` across the y
    walls (rows 0 and N-1); then, for ``b`` 1 and 2 when the bool mask
    ``obst`` is given, the obstacle mirror along the component's axis.
    Returns a new tensor."""
    sx = -1.0 if b == 1 else 1.0
    sy = -1.0 if b == 2 else 1.0
    x = x.clone()
    # Wall edges, excluding corners.
    x[1:-1, 0] = sx * x[1:-1, 1]
    x[1:-1, -1] = sx * x[1:-1, -2]
    x[0, 1:-1] = sy * x[1, 1:-1]
    x[-1, 1:-1] = sy * x[-2, 1:-1]
    # Corners, from the just-written edges (FluidSim.cs:1255-1258).
    x[0, 0] = 0.5 * (x[0, 1] + x[1, 0])
    x[-1, 0] = 0.5 * (x[-1, 1] + x[-2, 0])
    x[0, -1] = 0.5 * (x[0, -2] + x[1, -1])
    x[-1, -1] = 0.5 * (x[-1, -2] + x[-2, -1])
    if obst is not None and b in (1, 2):
        x = _mirror_obstacles_axis(x, obst, axis=2 - b)
    return x


def set_bnd_3d(b: int, x: torch.Tensor, obst=None) -> torch.Tensor:
    """3D boundary conditions on a ``[z, y, x]`` tensor: faces, then (for
    velocity components, when ``obst`` is given) the obstacle mirror."""
    x = apply_faces_3d(b, x)
    if obst is not None and b in (1, 2, 3):
        x = _mirror_obstacles_axis(x, obst, axis=3 - b)
    return x
