"""Body forces, obstacle interaction and turbulence, 2D and 3D (counterpart
of ``fluidsim_tpu/ops/forces.py``).

These are plain PyTorch elementwise passes, as the JAX package leaves them
to XLA.  Each keeps the JAX operation order, so the two differ only where
XLA on the CPU contracts a multiply-add into one FMA.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .boundary import interior_mask


def _shift_no_wrap(mask: torch.Tensor, delta: int, axis: int) -> torch.Tensor:
    """result[t] = mask[t + delta] along ``axis``; out-of-range = False."""
    return _shift_arr(mask, delta, axis)


def enforce_obstacle_boundaries_2d(vel_x, vel_y, obst, cell_size: float,
                                   viscosity: float):
    """FluidSim.cs:617-673: zero velocity inside interior obstacle cells,
    then Reynolds-adaptive drag on each fluid cell next to one, as four
    masked passes in the reference's per-cell event order: obstacle to the
    left (x−1), below (y−1), above (y+1), right (x+1)."""
    interior = interior_mask(obst.shape, obst.device)
    obst_int = obst & interior
    vel_x = torch.where(obst_int, 0.0, vel_x)
    vel_y = torch.where(obst_int, 0.0, vel_y)

    length = float(np.float32(cell_size))
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar by
    # multiplying with its reciprocal, which is not XLA's division.
    visc = torch.tensor(max(np.float32(viscosity), np.float32(1e-5)),
                        dtype=vel_x.dtype, device=vel_x.device)
    lo = float(np.float32(0.8))
    span = float(np.float32(0.98) - np.float32(0.8))
    for delta, axis in ((-1, 1), (-1, 0), (1, 0), (1, 1)):
        mask = interior & (~obst) & _shift_no_wrap(obst_int, delta, axis)
        u = torch.sqrt(vel_x * vel_x + vel_y * vel_y)
        re = (u * length) / visc
        factor = lo + span * (1.0 - torch.exp(-re * 0.01))
        factor = torch.where(mask, factor, 1.0)
        vel_x = vel_x * factor
        vel_y = vel_y * factor
    return vel_x, vel_y


# Perlin turbulence (FluidSim.cs:675-701).  Unity's noise table is private,
# so this is the JAX package's classic permutation-table Perlin: the same
# table, from the same seed.
_PERM = np.random.RandomState(1337).permutation(256)
_PERM = np.concatenate([_PERM, _PERM]).astype(np.int64)
_GRADS = np.array(
    [[1, 1], [-1, 1], [1, -1], [-1, -1], [1, 0], [-1, 0], [0, 1], [0, -1]],
    dtype=np.float32,
)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin_2d(x, y):
    """Classic Perlin gradient noise of the float32 coordinates ``(x, y)``,
    output ≈ [0, 1] like ``Mathf.PerlinNoise``."""
    perm = torch.from_numpy(_PERM).to(x.device)
    grads = torch.from_numpy(_GRADS).to(x.device)
    xi = torch.floor(x).to(torch.int64)
    yi = torch.floor(y).to(torch.int64)
    xf = x - xi.to(x.dtype)
    yf = y - yi.to(y.dtype)
    xi = xi & 255
    yi = yi & 255

    def grad_dot(ix, iy, dx, dy):
        g = grads[perm[perm[ix] + iy] & 7]
        return g[..., 0] * dx + g[..., 1] * dy

    n00 = grad_dot(xi, yi, xf, yf)
    n10 = grad_dot(xi + 1, yi, xf - 1.0, yf)
    n01 = grad_dot(xi, yi + 1, xf, yf - 1.0)
    n11 = grad_dot(xi + 1, yi + 1, xf - 1.0, yf - 1.0)
    u = _fade(xf)
    v = _fade(yf)
    nx0 = n00 + u * (n10 - n00)
    nx1 = n01 + u * (n11 - n01)
    n = nx0 + v * (nx1 - nx0)
    return 0.5 * (n + 1.0)


def apply_turbulent_noise_2d(vel_x, vel_y, noise_scale: float = 0.1,
                             frequency: float = 0.05):
    """FluidSim.cs:675-701: ``v += (perlin − 0.5)·noise_scale·|v|`` on the
    interior, with transposed coordinates for the y component."""
    n = vel_x.shape[0]
    ar = torch.arange(n, dtype=vel_x.dtype, device=vel_x.device)
    jj, ii = torch.meshgrid(ar, ar, indexing="ij")
    u = torch.sqrt(vel_x * vel_x + vel_y * vel_y)
    noise_x = perlin_2d(ii * frequency, jj * frequency) - 0.5
    noise_y = perlin_2d(jj * frequency, ii * frequency) - 0.5
    interior = interior_mask(vel_x.shape, vel_x.device)
    strength = noise_scale * u
    vel_x = torch.where(interior, vel_x + noise_x * strength, vel_x)
    vel_y = torch.where(interior, vel_y + noise_y * strength, vel_y)
    return vel_x, vel_y


def buoyancy_force(vel: torch.Tensor, density: torch.Tensor, dt: float,
                   buoyancy: float, ambient: float = 0.0,
                   gravity: float = 0.0) -> torch.Tensor:
    """Upward force ∝ (density − ambient) on the y component (axis 1 of a
    [z, y, x] grid); optional downward gravity ∝ density."""
    accel = buoyancy * (density - ambient) - gravity * density
    out = vel.clone()
    out[1] = vel[1] + dt * accel
    return out


def vorticity_confinement_3d(vel: torch.Tensor, dt: float,
                             eps: float) -> torch.Tensor:
    """Fedkiw-style vorticity confinement: v += dt·ε·(N̂ × ω) with
    ω = ∇×v and N = ∇|ω| (central differences, zero-padded borders)."""

    def ddx(f, axis):
        return 0.5 * (_shift_arr(f, 1, axis) - _shift_arr(f, -1, axis))

    in_dtype = vel.dtype
    vel = vel.to(torch.float32)
    vx, vy, vz = vel[0], vel[1], vel[2]
    # ω = ∇×v on the [z, y, x] grid: x derivative = axis 2, y = 1, z = 0.
    wx = ddx(vz, 1) - ddx(vy, 0)
    wy = ddx(vx, 0) - ddx(vz, 2)
    wz = ddx(vy, 2) - ddx(vx, 1)
    wmag = torch.sqrt(wx * wx + wy * wy + wz * wz)

    nx = ddx(wmag, 2)
    ny = ddx(wmag, 1)
    nz = ddx(wmag, 0)
    nlen = torch.sqrt(nx * nx + ny * ny + nz * nz) + 1e-5
    nx, ny, nz = nx / nlen, ny / nlen, nz / nlen

    fx = ny * wz - nz * wy
    fy = nz * wx - nx * wz
    fz = nx * wy - ny * wx

    scale = dt * eps
    return torch.stack(
        [vx + scale * fx, vy + scale * fy, vz + scale * fz]
    ).to(in_dtype)


def _shift_arr(f: torch.Tensor, delta: int, axis: int) -> torch.Tensor:
    """result[t] = f[t + delta]; zero beyond the border."""
    pad = [0, 0] * f.ndim
    # F.pad lists (before, after) pairs from the last axis backwards.
    k = 2 * (f.ndim - 1 - axis)
    pad[k + (1 if delta > 0 else 0)] = abs(delta)
    padded = F.pad(f, pad)
    start = delta if delta > 0 else 0
    return padded.narrow(axis, start, f.shape[axis])


def enforce_obstacle_boundaries_3d(vel: torch.Tensor, obst: torch.Tensor,
                                   cell_size: float,
                                   viscosity: float) -> torch.Tensor:
    """3D generalization of FluidSim.cs:617-673: zero velocity inside
    interior obstacle cells, Reynolds-adaptive drag on the 6 face-adjacent
    fluid neighbours (one masked pass per direction)."""
    interior = interior_mask(obst.shape, obst.device)
    obst_int = obst & interior
    vel = torch.where(obst_int[None], 0.0, vel)

    length = float(np.float32(cell_size))
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar by
    # multiplying with its reciprocal, which is not XLA's division.
    visc = torch.tensor(max(np.float32(viscosity), np.float32(1e-5)),
                        dtype=vel.dtype, device=vel.device)
    lo = float(np.float32(0.8))
    span = float(np.float32(0.98) - np.float32(0.8))

    for axis in (2, 1, 0):
        for delta in (-1, 1):
            obst_nbr = _shift_no_wrap(obst_int, delta, axis)
            mask = interior & (~obst) & obst_nbr
            u = torch.sqrt(torch.sum(vel * vel, dim=0))
            re = (u * length) / visc
            factor = lo + span * (1.0 - torch.exp(-re * 0.01))
            factor = torch.where(mask, factor, 1.0)
            vel = vel * factor[None]
    return vel
