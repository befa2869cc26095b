"""Semi-Lagrangian advection, 2D and the 3D plain path.

Counterpart of ``fluidsim_tpu/ops/advect.py`` (the reference's ``AdvectJob``,
FluidSim.cs:1125-1186): backtrace ``x = i − dt0·u`` with ``dt0 = dt·(N−2)``,
clamp to ``[0.5, N−1.5]``, bilinear (2D) or trilinear (3D) interpolation,
written into a fresh zero buffer (walls and obstacle cells come out 0)
before ``set_bnd``.

In 3D, two formulations, as in the JAX package: ``window = 0`` is the exact
8-tap gather; ``window = K > 0`` is the trilinear sample as a
``(2K+1)³``-term sum of shifted fields weighted by per-cell hat functions,
with the displacement clamped to K cells.  ``advect_maccormack_3d`` and
``advect_substep_3d`` compose either one.
"""

from __future__ import annotations

import numpy as np
import torch

from .boundary import set_bnd_2d, set_bnd_3d


def _backtrace_1d(coord, vel, dt0: float, n: int):
    """Clamped backtrace along one axis: ``(i0, frac)`` with
    ``i0 = floor(clamp(coord − dt0·vel, 0.5, n−1.5))``."""
    x = coord - float(dt0) * vel
    x = torch.where(x < 0.5, 0.5, x)
    x = torch.where(x > n - 1.5, n - 1.5, x)
    i0 = torch.floor(x).to(torch.int32)
    return i0, x - i0.to(x.dtype)


def _bilinear_2d(fields, vel_x, vel_y, dt: float):
    """The bilinear sample of each of the ``(C, N, N)`` ``[y, x]`` fields at
    every cell's backtrace through ``(vel_x, vel_y)``, in the reference's
    term order (FluidSim.cs:1183-1184), one backtrace for all fields."""
    n = fields.shape[-1]
    dt0 = np.float32(dt) * np.float32(n - 2)
    ar = torch.arange(n, dtype=torch.float32, device=fields.device)
    jj, ii = torch.meshgrid(ar, ar, indexing="ij")
    i0, s1 = _backtrace_1d(ii, vel_x.to(torch.float32), dt0, n)
    j0, t1 = _backtrace_1d(jj, vel_y.to(torch.float32), dt0, n)
    s0 = 1.0 - s1
    t0 = 1.0 - t1
    i0, j0 = i0.long(), j0.long()
    i1, j1 = i0 + 1, j0 + 1
    return [s0 * (t0 * f[j0, i0] + t1 * f[j1, i0]) + s1 * (t0 * f[j0, i1] + t1 * f[j1, i1])
            for f in fields]


def _mask_and_bnd_2d(b: int, val, d0, obst):
    """Fresh-zero-buffer semantics in 2D: interior non-obstacle cells take
    ``val``, everything else 0, then ``set_bnd_2d``."""
    core = (slice(1, -1), slice(1, -1))
    out = torch.zeros_like(d0)
    out[core] = torch.where(obst[core], 0.0, val[core].to(d0.dtype))
    return set_bnd_2d(b, out, obst)


def advect_2d(b: int, d0, vel_x, vel_y, dt: float, obst):
    """The reference advection of the ``[y, x]`` field ``d0`` (boundary code
    ``b``) through ``(vel_x, vel_y)``."""
    val = _bilinear_2d(d0[None], vel_x, vel_y, dt)[0]
    return _mask_and_bnd_2d(b, val, d0, obst)


def advect_2d_pair(d0x, d0y, vel_x, vel_y, dt: float, obst):
    """Advect the two velocity components with one shared backtrace
    (bitwise two ``advect_2d`` calls, as in the JAX package); returns
    ``(vel_x', vel_y')`` after ``set_bnd_2d`` 1 and 2."""
    vx, vy = _bilinear_2d(torch.stack([d0x, d0y]), vel_x, vel_y, dt)
    return _mask_and_bnd_2d(1, vx, d0x, obst), _mask_and_bnd_2d(2, vy, d0y, obst)


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


def _coords(n: int, device):
    ar = torch.arange(n, dtype=torch.float32, device=device)
    return torch.meshgrid(ar, ar, ar, indexing="ij")


def window_sum_3d(fields, vel, dt0: float, window: int, z_offset: int = 0):
    """The windowed trilinear sample of the ``(C, N, N, N)`` ``fields`` at
    every cell (before the output contract), for the backtrace scale
    ``dt0``: ``Σ_{dz,dy,dx ∈ [−K, K]} ((hat(fz,dz)·hat(fy,dy))·hat(fx,dx))·
    f[z+dz, y+dy, x+dx]`` accumulated in that order from zero, with
    ``hat(f, d) = max(0, 1 − |f − d|)`` and the displacement ``f`` clamped to
    ``[0.5, n−1.5]`` and then to ``coord ± K``.  Taps are read at wrapped
    indices; the clamp gives every tap outside the grid zero weight.

    On a z-slab of the grid (``fields`` ``(C, nz, N, N)`` and ``vel``
    ``(3, nz, N, N)``, plane 0 at global z ``z_offset``) the backtrace takes
    global z and the z taps wrap modulo ``nz``."""
    n, nz = fields.shape[-1], fields.shape[1]
    f32 = torch.float32
    ar = torch.arange(n, dtype=f32, device=fields.device)
    kk = (torch.arange(nz, device=fields.device) + z_offset).to(f32)[:, None, None]
    jj, ii = ar[None, :, None], ar[None, None, :]

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
                # shifted[c] = fields[c + (dz, dy, dx)], wrapped.
                shifted = torch.roll(fields, (-dz, -dy, -dx), (1, 2, 3))
                out = out + w[None] * shifted
    return out


def _gather_3d(fields, vel, dt0: float):
    """The exact 8-tap trilinear sample of each of the ``(C, N, N, N)``
    ``fields`` at every cell, in the JAX package's term order."""
    n = fields.shape[-1]
    f32 = torch.float32
    kk, jj, ii = _coords(n, fields.device)
    i0, s1 = _backtrace_1d(ii, vel[0].to(f32), dt0, n)
    j0, t1 = _backtrace_1d(jj, vel[1].to(f32), dt0, n)
    k0, u1 = _backtrace_1d(kk, vel[2].to(f32), dt0, n)
    s0, t0, u0 = 1.0 - s1, 1.0 - t1, 1.0 - u1
    i0, j0, k0 = i0.long(), j0.long(), k0.long()
    i1, j1, k1 = i0 + 1, j0 + 1, k0 + 1

    def tri(f):
        return u0 * (
            s0 * (t0 * f[k0, j0, i0] + t1 * f[k0, j1, i0])
            + s1 * (t0 * f[k0, j0, i1] + t1 * f[k0, j1, i1])
        ) + u1 * (
            s0 * (t0 * f[k1, j0, i0] + t1 * f[k1, j1, i0])
            + s1 * (t0 * f[k1, j0, i1] + t1 * f[k1, j1, i1])
        )

    return torch.stack([tri(fields[c]) for c in range(fields.shape[0])])


def advect_multi_3d(bs, fields, vel, dt: float, obst=None, window: int = 0):
    """Advect the ``(C, N, N, N)`` ``fields`` (boundary codes ``bs``) through
    ``vel`` with one shared backtrace: the exact gather for ``window = 0``,
    the windowed hat sum for ``window > 0``.  Returns the stacked advected
    fields."""
    n = fields.shape[-1]
    dt0 = np.float32(dt) * np.float32(n - 2)
    if window > 0:
        vals = window_sum_3d(fields, vel, float(dt0), window)
    else:
        vals = _gather_3d(fields, vel, float(dt0))
    vals = vals.to(fields.dtype)
    return torch.stack(
        [_mask_and_bnd_3d(b, vals[c], fields[c], obst) for c, b in enumerate(bs)]
    )


def advect_3d(b: int, d0, vel, dt: float, obst=None, window: int = 0):
    """Advect one ``(N, N, N)`` field with boundary code ``b``."""
    return advect_multi_3d((b,), d0[None], vel, dt, obst, window)[0]


def advect_maccormack_3d(bs, fields, vel, dt: float, obst=None,
                         window: int = 2, advect_fn=None):
    """MacCormack advection (``advection_scheme='maccormack'``): forward
    ``A(φ)``, backward ``A⁻¹(forward)`` through ``−vel``, ``forward +
    0.5·(φ − backward)`` clamped to the extremes of forward over each cell
    and its six (wrapped) face neighbours, then the output contract.
    ``advect_fn(bs, fields, vel, dt)`` is the semi-Lagrangian step ``A``
    (``advect_multi_3d`` with ``window`` by default)."""
    if advect_fn is None:
        def advect_fn(b_, f_, v_, d_):
            return advect_multi_3d(b_, f_, v_, d_, obst, window)
    forward = advect_fn(bs, fields, vel, dt)
    backward = advect_fn(bs, forward, -vel, dt)
    corrected = forward + 0.5 * (fields - backward)

    lo = forward
    hi = forward
    for axis in (1, 2, 3):
        for s in (-1, 1):
            shifted = torch.roll(forward, s, axis)
            lo = torch.minimum(lo, shifted)
            hi = torch.maximum(hi, shifted)
    limited = torch.clamp(corrected, lo, hi)
    return torch.stack(
        [_mask_and_bnd_3d(b, limited[c], fields[c], obst) for c, b in enumerate(bs)]
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
