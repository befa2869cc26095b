"""Volumetric raymarcher (counterpart of ``fluidsim_tpu/render/raymarch.py``).

Emission–absorption integration along axis-aligned rays through the density
volume (orthographic camera looking down −z of the ``[z, y, x]`` grid).
The front-to-back recurrence ``acc += T_k·α_k·c_k, T_{k+1} = T_k·(1−α_k)``
is evaluated in parallel: ``T_k = exp(Σ_{j<k} log1p(−α_j))`` is one
log-space exclusive cumsum over the marched axis plus a weighted sum.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import SimConfig
from ..utils.profiling import spanned


def raymarch_density(density: torch.Tensor, obstacles=None, *, axis: int = 0,
                     absorption: float = 0.04,
                     emission_color=(1.0, 1.0, 1.0),
                     density_scale: float = 0.02,
                     background=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """Front-to-back emission–absorption along ``axis``; obstacle voxels are
    opaque gray.  Returns an (N, N, 3) image of the two other axes."""
    dtype, device = density.dtype, density.device
    tint = torch.tensor(emission_color, dtype=dtype, device=device)
    gray = torch.tensor([0.5, 0.5, 0.5], dtype=dtype, device=device)
    bg = torch.tensor(background, dtype=dtype, device=device)

    d = torch.movedim(density, axis, 0)
    alpha = 1.0 - torch.exp(-absorption * d)
    color = tint * (d * density_scale)[..., None]
    if obstacles is not None:
        ob = torch.movedim(obstacles, axis, 0)
        alpha = torch.where(ob, 1.0, alpha)
        color = torch.where(ob[..., None], gray, color)

    log_keep = torch.log1p(-alpha)
    cum = torch.cumsum(log_keep, dim=0)
    # Exclusive prefix by shifting, not ``cum − log_keep``: at an opaque
    # voxel that would be −inf − (−inf) = NaN.
    excl = torch.cat([torch.zeros_like(cum[:1]), cum[:-1]], dim=0)
    acc = torch.sum((torch.exp(excl) * alpha)[..., None] * color, dim=0)
    return acc + torch.exp(cum[-1])[..., None] * bg


@spanned("render.frame")
def render_frame_3d(state, cfg: SimConfig, *, axis: int = 0,
                    absorption: Optional[float] = None) -> torch.Tensor:
    """Render one frame of a 3D state. Returns (N, N, 3)."""
    if absorption is None:
        absorption = float(2.0 / max(cfg.medium_density_threshold, 1e-3))
    return raymarch_density(
        state.density,
        state.obstacles if cfg.enable_obstacle else None,
        axis=axis,
        absorption=absorption,
        emission_color=cfg.fluid_color[:3],
        density_scale=float(1.0 / max(cfg.high_density_threshold, 1e-3)),
    )
