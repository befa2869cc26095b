"""Solid obstacle geometry: a NumPy copy of ``fluidsim_tpu/scene/obstacles.py``.

Reference: ``SetupObstacles`` / ``RecursiveFloodFill`` / ``IsInsideShape``
(FluidSim.cs:302-388).  Three shapes — circle, rectangle, and an
approximate NACA-0015 airfoil — rasterized by a 4-way flood fill from the
shape center, so only the connected component containing the start cell is
marked (and nothing at all if the center cell itself is outside the shape).
The fill is an iterative frontier BFS (identical result, any grid size).
Rasterization is host-side and runs once at scene setup.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import ObstacleShape, SimConfig


def inside_shape_mask(cfg: SimConfig) -> np.ndarray:
    """Vectorized ``IsInsideShape`` over the whole grid (FluidSim.cs:353-388).

    2D: exact reference formulas on an ``[y, x]`` grid.  3D: revolution or
    extrusion of each shape on a ``[z, y, x]`` grid (sphere, box, airfoil
    extruded along z).
    """
    n = cfg.current_size
    nf = np.float32(n)
    center = tuple(np.float32(p) * nf for p in cfg.obstacle_position)

    if cfg.ndim == 2:
        jj, ii = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        coords = (ii.astype(np.float32), jj.astype(np.float32))
        cx, cy = center
        dx = coords[0] - cx
        dy = coords[1] - cy
    else:
        kk, jj, ii = np.meshgrid(
            np.arange(n), np.arange(n), np.arange(n), indexing="ij"
        )
        coords = (
            ii.astype(np.float32),
            jj.astype(np.float32),
            kk.astype(np.float32),
        )
        cx, cy, cz = center
        dx = coords[0] - cx
        dy = coords[1] - cy
        dz = coords[2] - cz

    shape = cfg.obstacle_shape
    if shape == ObstacleShape.CIRCLE:
        r = np.float32(cfg.obstacle_radius) * nf
        d2 = dx * dx + dy * dy
        if cfg.ndim == 3:
            d2 = d2 + dz * dz
        return d2 < r * r

    if shape == ObstacleShape.RECTANGLE:
        hw = np.float32(cfg.obstacle_width) * nf * np.float32(0.5)
        hh = np.float32(cfg.obstacle_height) * nf * np.float32(0.5)
        m = (dx > -hw) & (dx < hw) & (dy > -hh) & (dy < hh)
        if cfg.ndim == 3:
            hd = hw  # extrude square along z with the width
            m &= (dz > -hd) & (dz < hd)
        return m

    if shape == ObstacleShape.AIRFOIL:
        # NACA-0015 polynomial (FluidSim.cs:369-383).
        chord = np.float32(2.0) * np.float32(cfg.obstacle_width) * nf
        thickness = np.float32(0.15)
        norm_x = (dx + chord / 2) / chord
        norm_y = dy / chord
        with np.errstate(invalid="ignore"):
            half_t = (
                5.0
                * thickness
                * (
                    0.2969 * np.sqrt(np.clip(norm_x, 0.0, None))
                    - 0.1260 * norm_x
                    - 0.3516 * norm_x**2
                    + 0.2843 * norm_x**3
                    - 0.1015 * norm_x**4
                )
            )
        m = (
            (norm_x >= 0.0)
            & (norm_x <= 1.0)
            & (np.abs(norm_y) <= thickness)
            & (np.abs(norm_y) <= half_t)
        )
        if cfg.ndim == 3:
            span = np.float32(cfg.obstacle_height) * nf
            m &= np.abs(dz) <= span
        return m

    raise ValueError(f"unknown obstacle shape {shape}")


def _flood_fill(mask: np.ndarray, start: Tuple[int, ...]) -> np.ndarray:
    """Connected component of ``mask`` containing ``start`` (face adjacency),
    matching the reference's 4-way recursive fill (FluidSim.cs:329-351)."""
    if any(not (0 <= s < d) for s, d in zip(start, mask.shape)):
        return np.zeros_like(mask)
    if not mask[start]:
        return np.zeros_like(mask)

    try:  # fast path for big 3D grids
        from scipy import ndimage

        structure = ndimage.generate_binary_structure(mask.ndim, 1)
        labels, _ = ndimage.label(mask, structure=structure)
        return labels == labels[start]
    except ImportError:
        pass

    comp = np.zeros_like(mask)
    comp[start] = True
    while True:
        grown = comp.copy()
        for axis in range(mask.ndim):
            grown |= np.roll(comp, 1, axis=axis) & _not_wrapped(mask.shape, axis, 1)
            grown |= np.roll(comp, -1, axis=axis) & _not_wrapped(mask.shape, axis, -1)
        grown &= mask
        if (grown == comp).all():
            return comp
        comp = grown


def _not_wrapped(shape, axis, delta):
    """Mask that excludes cells produced by np.roll wraparound."""
    m = np.ones(shape, dtype=bool)
    sl = [slice(None)] * len(shape)
    sl[axis] = 0 if delta == 1 else -1
    m[tuple(sl)] = False
    return m


def build_obstacle_mask(cfg: SimConfig) -> np.ndarray:
    """``SetupObstacles`` (FluidSim.cs:302-327): empty mask when disabled,
    else the flood-filled component from round(position · N)."""
    n = cfg.current_size
    shape = (n,) * cfg.ndim
    if not cfg.enable_obstacle:
        return np.zeros(shape, dtype=bool)

    mask = inside_shape_mask(cfg)
    # Start cell: Mathf.RoundToInt(position * N) per axis (FluidSim.cs:309).
    start_xy = [int(np.floor(p * n + 0.5)) for p in cfg.obstacle_position]
    # coords are (x, y[, z]); array index order is [y, x] / [z, y, x].
    start = tuple(reversed(start_xy))
    return _flood_fill(mask, start)
