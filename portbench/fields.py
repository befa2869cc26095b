"""The inputs of a run, made from ``--seed`` on the run's device.

A copy of ``smooth``, ``velocity_field`` and ``density_field`` from
``chip_smoke.py``, frozen here so that the inputs stay the same whatever the
program's tools do later.  The initial velocity and density are sums of
plane waves of low wavenumber; the velocity is scaled so that the largest
displacement of a substep is ``inputs.cells`` cells, inside the window of the
configuration's backtrace.  Only a few dozen numbers come from the host's
generator: the volumes are computed on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def smooth(n, rng, dev, modes=6):
    """A float32 ``(n, n, n)`` tensor on ``dev``: a sum of plane waves of
    low wavenumber and unit amplitude, drawn from the NumPy generator
    ``rng``."""
    ax = torch.arange(n, dtype=torch.float32, device=dev)
    out = torch.zeros((n, n, n), dtype=torch.float32, device=dev)
    for _ in range(modes):
        k = rng.integers(-3, 4, size=3)
        phase = float(np.float32(rng.uniform(0, 2 * np.pi)))
        w = [float(v) for v in (2 * np.pi / n) * k.astype(np.float32)]
        out += torch.sin(w[0] * ax[:, None, None] + w[1] * ax[None, :, None]
                         + w[2] * ax[None, None, :] + phase)
    return out / float(np.sqrt(modes))


def velocity_field(n, rng, dev, scale):
    return torch.stack([smooth(n, rng, dev) for _ in range(3)]) * scale


def density_field(n, rng, dev):
    return (20.0 * (1.0 + smooth(n, rng, dev))).clamp(min=0.0)


def velocity_scale(sim: dict, cells: float, modes: int = 6) -> float:
    """The factor that bounds a substep's displacement to ``cells`` cells:
    ``smooth`` is at most ``sqrt(modes)`` in magnitude, and a substep moves a
    cell by ``dt·(n − 2)/n_sub`` times the velocity."""
    n = grid_size(sim)
    n_sub = sim["advect_substeps"] if sim["advection_scheme"] == "substep" else 1
    per_unit = float(np.float32(sim["time_step"])) * (n - 2) / n_sub
    return cells / (per_unit * math.sqrt(modes))


def grid_size(sim: dict) -> int:
    """``currentSize``: the grid's cells along an axis."""
    return int(math.floor(sim["size"] * sim["resolution_multiplier"] + 0.5))


def make_inputs(sim: dict, inputs: dict, seed: int, device) -> dict:
    """The float32 ``density`` ``(n, n, n)`` and ``velocity`` ``(3, n, n, n)``
    of ``seed`` (any integer) on ``device``; the same seed gives the same
    fields."""
    rng = np.random.default_rng(seed % 2 ** 64)
    n = grid_size(sim)
    scale = velocity_scale(sim, inputs["cells"])
    velocity = velocity_field(n, rng, device, scale)
    density = density_field(n, rng, device)
    return {"density": density, "velocity": velocity}
