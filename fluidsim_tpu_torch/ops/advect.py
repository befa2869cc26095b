"""Semi-Lagrangian advection, 3D plain path.

Counterpart of ``fluidsim_tpu/ops/advect.py`` (the reference's ``AdvectJob``,
FluidSim.cs:1125-1186): backtrace ``x = i − dt0·u`` with ``dt0 = dt·(N−2)``,
clamp to ``[0.5, N−1.5]``, trilinear interpolation, written into a fresh
zero buffer (walls come out 0) before ``set_bnd``.

Only the windowed formulation (``window = K > 0``) is ported: the trilinear
sample as a ``(2K+1)³``-term sum of shifted fields weighted by per-cell hat
functions, with the displacement clamped to K cells.  The exact 8-tap
gather (``window = 0``) and MacCormack advection are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .boundary import set_bnd_3d


def _mask_and_bnd_3d(b: int, val, d0, obst):
    """Fresh-zero-buffer semantics: interior non-obstacle cells take ``val``,
    everything else 0, then ``set_bnd_3d``."""
    core = (slice(1, -1),) * 3
    inner = val[core].to(d0.dtype)
    if obst is not None:
        inner = torch.where(obst[core], 0.0, inner)
    out = torch.zeros_like(d0)
    out[core] = inner
    return set_bnd_3d(b, out, obst)


def advect_multi_3d(bs, fields, vel, dt: float, obst=None, window: int = 1):
    """Advect the ``(C, N, N, N)`` ``fields`` (boundary codes ``bs``) through
    ``vel`` with one shared backtrace and hat weights.  Returns the stacked
    advected fields."""
    if window <= 0:
        raise NotImplementedError(
            "advect_window=0 (exact 8-tap gather advection) is not ported"
        )
    n = fields.shape[-1]
    dt0 = np.float32(dt) * np.float32(n - 2)
    f32 = torch.float32
    ar = torch.arange(n, dtype=f32, device=fields.device)
    kk, jj, ii = torch.meshgrid(ar, ar, ar, indexing="ij")

    def frac_disp(v, coord):
        x = coord - float(dt0) * v
        x = torch.where(x < 0.5, 0.5, x)
        x = torch.where(x > n - 1.5, n - 1.5, x)
        x = torch.clamp(x, coord - window, coord + window)
        return x - coord

    fx = frac_disp(vel[0].to(f32), ii)
    fy = frac_disp(vel[1].to(f32), jj)
    fz = frac_disp(vel[2].to(f32), kk)

    def hat(f, d):
        return torch.clamp(1.0 - torch.abs(f - d), min=0.0)

    out = torch.zeros(fields.shape, dtype=f32, device=fields.device)
    for dz in range(-window, window + 1):
        wz = hat(fz, dz)
        for dy in range(-window, window + 1):
            wzy = wz * hat(fy, dy)
            for dx in range(-window, window + 1):
                w = wzy * hat(fx, dx)
                # shifted[c] = fields[c + (dz, dy, dx)]; wrapped cells get
                # zero weight (the clamp keeps targets in [0.5, n-1.5]).
                shifted = torch.roll(fields, (-dz, -dy, -dx), (1, 2, 3))
                out = out + w[None] * shifted
    vals = out.to(fields.dtype)
    return torch.stack(
        [_mask_and_bnd_3d(b, vals[c], fields[c], obst) for c, b in enumerate(bs)]
    )


def advect_substep_3d(bs, fields, vel, dt: float, obst=None, window: int = 1,
                      n_sub: int = 2, advect_fn=None):
    """``n_sub`` sub-advections of ``dt/n_sub`` through the same velocity
    (``advection_scheme='substep'``)."""
    if advect_fn is None:
        def advect_fn(b_, f_, v_, d_):
            return advect_multi_3d(b_, f_, v_, d_, obst, window)
    sub_dt = float(np.float32(dt) / np.float32(n_sub))
    out = fields
    for _ in range(n_sub):
        out = advect_fn(bs, out, vel, sub_dt)
    return out
