"""Body forces (counterpart of ``fluidsim_tpu/ops/forces.py``; only the
buoyancy force is ported so far)."""

from __future__ import annotations

import torch


def buoyancy_force(vel: torch.Tensor, density: torch.Tensor, dt: float,
                   buoyancy: float, ambient: float = 0.0,
                   gravity: float = 0.0) -> torch.Tensor:
    """Upward force ∝ (density − ambient) on the y component (axis 1 of a
    [z, y, x] grid); optional downward gravity ∝ density."""
    accel = buoyancy * (density - ambient) - gravity * density
    out = vel.clone()
    out[1] = vel[1] + dt * accel
    return out
