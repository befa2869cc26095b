"""Interaction forces: the mouse-drag math as a scriptable API (counterpart
of ``fluidsim_tpu/scene/interact.py``).

Reference: ``Update()``'s drag handling (FluidSim.cs:414-436) and
``AddForceToArea`` (FluidSim.cs:452-483).  The force is added on the
fields' device, in their dtype, as the JAX package adds it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import SimConfig


def add_force_to_area(vel: torch.Tensor, density: torch.Tensor, center, force, radius,
                      source_strength: float):
    """``AddForceToArea`` (FluidSim.cs:452-483), vectorized.

    Adds ``force·(1 − dist/radius)`` to the velocity within ``radius`` of
    ``center`` (grid coords, (x, y[, z])) and ``source_strength·falloff``
    to the density within the inner 30 % of the radius.  Returns new
    ``(vel, density)``."""
    dtype, device = density.dtype, density.device
    grids = torch.meshgrid(*(torch.arange(s, dtype=dtype, device=device)
                             for s in density.shape), indexing="ij")
    coords = tuple(reversed(grids))  # (x, y[, z])

    dist = torch.sqrt(sum((c - torch.tensor(p, dtype=dtype, device=device)) ** 2
                          for c, p in zip(coords, center)))
    radius = torch.tensor(radius, dtype=dtype, device=device)
    falloff = torch.where(dist <= radius, 1.0 - dist / radius, 0.0)

    vel = torch.stack([vel[c] + torch.tensor(force[c], dtype=dtype, device=device) * falloff
                       if c < len(force) else vel[c] for c in range(vel.shape[0])])
    inner = dist < radius * 0.3
    density = density + torch.where(inner, source_strength * falloff, 0.0)
    return vel, density


def mouse_drag_force(prev_pos: Tuple[float, ...], cur_pos: Tuple[float, ...],
                     cfg: SimConfig):
    """The reference's drag → force mapping (FluidSim.cs:419-432): returns
    ``(center, force, radius)`` for ``add_force_to_area``, a force of
    ``|Δ|^1.5 · 0.8`` along the drag and a radius of ``clamp(|Δ|·0.5, 2,
    10)``."""
    delta = np.asarray(cur_pos, np.float32) - np.asarray(prev_pos, np.float32)
    mag = float(np.linalg.norm(delta) * np.float32(cfg.resolution_multiplier))
    if mag == 0.0:
        return cur_pos, tuple(0.0 for _ in cur_pos), 2.0
    direction = delta / np.linalg.norm(delta)
    scaled = np.float32(mag) ** np.float32(1.5) * np.float32(0.8)
    radius = float(np.clip(mag * 0.5, 2.0, 10.0))
    return cur_pos, tuple(float(d * scaled) for d in direction), radius


def screen_to_grid(screen_pos, viewport_min, viewport_max, grid_size: int):
    """Screen/world position → grid coordinates (``GetMousePositionInGrid``,
    FluidSim.cs:535-549): ``(p − min)/(max − min)·N`` for the caller's
    viewport bounds."""
    p = np.asarray(screen_pos, np.float32)
    lo = np.asarray(viewport_min, np.float32)
    hi = np.asarray(viewport_max, np.float32)
    normalized = (p - lo) / (hi - lo)
    return tuple(float(v) for v in normalized * np.float32(grid_size))
