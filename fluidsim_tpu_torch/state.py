"""Fluid state: the counterpart of ``fluidsim_tpu/state.py``.

2D arrays are indexed ``[y, x]``, 3D arrays ``[z, y, x]``; ``velocity`` is
one ``(ndim, *grid)`` tensor with components (vx, vy[, vz]), component c
flowing along grid axis ``ndim-1-c``.  ``step`` is a 0-d int32 tensor and
``time`` a 0-d float32 tensor, as in the JAX state.  ``density``,
``velocity`` and ``pressure`` are stored in ``SimConfig.dtype`` (float32 or
bfloat16).
"""

from __future__ import annotations

import dataclasses

import torch

from .config import SimConfig
from .dtypes import torch_dtype


@dataclasses.dataclass(frozen=True)
class FluidState:
    """density / velocity / pressure fields + static obstacle mask."""

    density: torch.Tensor
    velocity: torch.Tensor
    pressure: torch.Tensor
    obstacles: torch.Tensor
    step: torch.Tensor
    time: torch.Tensor

    def replace(self, **kw) -> "FluidState":
        return dataclasses.replace(self, **kw)


def zeros_state(cfg: SimConfig, device, obstacles=None) -> FluidState:
    """Allocate an all-zero state for ``cfg`` on ``device``: the fields in
    ``cfg.dtype``, ``step`` int32 and ``time`` float32."""
    fdt = torch_dtype(cfg.dtype)
    device = torch.device(device)
    shape = cfg.grid_shape
    if obstacles is None:
        obstacles = torch.zeros(shape, dtype=torch.bool, device=device)
    else:
        obstacles = torch.as_tensor(obstacles, dtype=torch.bool, device=device)
        if tuple(obstacles.shape) != shape:
            raise ValueError(
                f"obstacle mask shape {tuple(obstacles.shape)} != grid {shape}"
            )
    return FluidState(
        density=torch.zeros(shape, dtype=fdt, device=device),
        velocity=torch.zeros((cfg.ndim,) + shape, dtype=fdt, device=device),
        pressure=torch.zeros(shape, dtype=fdt, device=device),
        obstacles=obstacles,
        step=torch.zeros((), dtype=torch.int32, device=device),
        time=torch.zeros((), dtype=torch.float32, device=device),
    )
