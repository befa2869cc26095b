"""Body forces, obstacle interaction and turbulence, 2D and 3D (counterpart
of ``fluidsim_tpu/ops/forces.py``).

These are plain PyTorch elementwise passes, as the JAX package leaves them
to XLA.  Each keeps the JAX operation order, so the two differ only where
XLA on the CPU contracts a multiply-add into one FMA.  On bfloat16 fields
the constants take the field's dtype (the JAX package's weakly typed Python
scalars) and every operation rounds to it, where XLA may keep float32
between fused operations; vorticity confinement computes in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import storage_scalar
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

    sdt = vel_x.dtype
    length = storage_scalar(np.float32(cell_size), sdt)
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar by
    # multiplying with its reciprocal, which is not XLA's division.
    visc = torch.tensor(max(np.float32(viscosity), np.float32(1e-5)),
                        dtype=sdt, device=vel_x.device)
    lo = storage_scalar(np.float32(0.8), sdt)
    span = storage_scalar(np.float32(0.98) - np.float32(0.8), sdt)
    hundredth = storage_scalar(0.01, sdt)
    for delta, axis in ((-1, 1), (-1, 0), (1, 0), (1, 1)):
        mask = interior & (~obst) & _shift_no_wrap(obst_int, delta, axis)
        u = torch.sqrt(vel_x * vel_x + vel_y * vel_y)
        re = (u * length) / visc
        factor = lo + span * (1.0 - torch.exp(-re * hundredth))
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
    interior, with transposed coordinates for the y component.  The result
    is rounded to the velocity's dtype (float32 in the JAX package)."""
    n = vel_x.shape[0]
    sdt = vel_x.dtype
    ar = torch.arange(n, dtype=sdt, device=vel_x.device)
    jj, ii = torch.meshgrid(ar, ar, indexing="ij")
    u = torch.sqrt(vel_x * vel_x + vel_y * vel_y)
    f = storage_scalar(frequency, sdt)
    noise_x = perlin_2d(ii * f, jj * f) - 0.5
    noise_y = perlin_2d(jj * f, ii * f) - 0.5
    interior = interior_mask(vel_x.shape, vel_x.device)
    strength = storage_scalar(noise_scale, sdt) * u
    vel_x = torch.where(interior, vel_x + noise_x * strength, vel_x).to(sdt)
    vel_y = torch.where(interior, vel_y + noise_y * strength, vel_y).to(sdt)
    return vel_x, vel_y


def buoyancy_force(vel: torch.Tensor, density: torch.Tensor, dt: float,
                   buoyancy: float, ambient: float = 0.0,
                   gravity: float = 0.0) -> torch.Tensor:
    """Upward force ∝ (density − ambient) on the y component (axis 1 of a
    [z, y, x] grid); optional downward gravity ∝ density.  In the fields'
    dtype."""
    b, amb, g, dt = (storage_scalar(x, density.dtype)
                     for x in (buoyancy, ambient, gravity, dt))
    accel = b * (density - amb) - g * density
    out = vel.clone()
    out[1] = vel[1] + dt * accel
    return out


def vorticity_confinement_3d(vel: torch.Tensor, dt: float,
                             eps: float) -> torch.Tensor:
    """Fedkiw-style vorticity confinement: v += dt·ε·(N̂ × ω) with
    ω = ∇×v and N = ∇|ω| (central differences, zero-padded borders)."""
    return _confinement(vel, dt, eps)


def vorticity_confinement_slab(vel_ext: torch.Tensor, dt: float, eps: float,
                               z0: int, n: int) -> torch.Tensor:
    """``vorticity_confinement_3d`` on a shard: ``vel_ext`` ``(3, lz + 4, n,
    n)`` is the shard's velocity between two planes of each neighbour (zeros
    past the global ends), the shard's plane 0 at global z ``z0``; returns
    the shard's ``(3, lz, n, n)`` planes, each the whole-grid value.

    The whole grid zero-pads each derivative at its walls: past a global
    wall both ``v`` and ``|ω|`` read as zero.  The zero halo gives the first;
    ``|ω|`` on the halo planes past a global wall is zeroed for the second,
    not taken from the zero-padded velocity."""
    zg = torch.arange(vel_ext.shape[1], device=vel_ext.device) + (z0 - 2)
    inside = ((zg >= 0) & (zg < n))[:, None, None]
    return _confinement(vel_ext, dt, eps, inside)[:, 2:-2]


def _confinement(vel, dt, eps, inside=None):
    """The confinement step on ``vel``, ``|ω|`` zeroed on the planes where
    ``inside`` is False."""

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
    if inside is not None:
        wmag = torch.where(inside, wmag, 0.0)

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
    return _obstacle_drag(vel, interior, obst, obst_int,
                          lambda delta, axis: _shift_no_wrap(obst_int, delta, axis),
                          cell_size, viscosity)


def enforce_obstacle_boundaries_slab(vel: torch.Tensor, obst_ext: torch.Tensor,
                                     cell_size: float, viscosity: float, z0: int,
                                     n: int) -> torch.Tensor:
    """``enforce_obstacle_boundaries_3d`` on a shard: ``vel`` ``(3, lz, n,
    n)`` is the shard's velocity, plane 0 at global z ``z0``, and
    ``obst_ext`` ``(lz + 2, n, n)`` its mask between one plane of each
    neighbour's (False past the global ends).  The interior is the global
    grid's: z faces only on the first and last shard."""
    dev = obst_ext.device
    zg = torch.arange(obst_ext.shape[0], device=dev) + (z0 - 1)
    inner = (torch.arange(n, device=dev) >= 1) & (torch.arange(n, device=dev) <= n - 2)
    interior_ext = (((zg >= 1) & (zg <= n - 2))[:, None, None]
                    & inner[None, :, None] & inner[None, None, :])
    obst_int_ext = obst_ext & interior_ext
    return _obstacle_drag(vel, interior_ext[1:-1], obst_ext[1:-1], obst_int_ext[1:-1],
                          lambda delta, axis: _shift_no_wrap(obst_int_ext, delta, axis)[1:-1],
                          cell_size, viscosity)


def _obstacle_drag(vel, interior, obst, obst_int, shifted_solid, cell_size, viscosity):
    """Zero ``vel`` in the interior solids ``obst_int``, then the six drag
    passes; ``shifted_solid(delta, axis)`` is ``obst_int`` read ``delta``
    cells along ``axis``, False past the grid."""
    vel = torch.where(obst_int[None], 0.0, vel)

    sdt = vel.dtype
    length = storage_scalar(np.float32(cell_size), sdt)
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar by
    # multiplying with its reciprocal, which is not XLA's division.
    visc = torch.tensor(max(np.float32(viscosity), np.float32(1e-5)),
                        dtype=sdt, device=vel.device)
    lo = storage_scalar(np.float32(0.8), sdt)
    span = storage_scalar(np.float32(0.98) - np.float32(0.8), sdt)
    hundredth = storage_scalar(0.01, sdt)

    for axis in (2, 1, 0):
        for delta in (-1, 1):
            mask = interior & (~obst) & shifted_solid(delta, axis)
            u = torch.sqrt(torch.sum(vel * vel, dim=0))
            re = (u * length) / visc
            factor = lo + span * (1.0 - torch.exp(-re * hundredth))
            factor = torch.where(mask, factor, 1.0)
            vel = vel * factor[None]
    return vel


# The 3D Perlin gradients (the JAX package's table).
_GRADS3 = np.array(
    [[1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
     [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
     [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1]],
    dtype=np.float32,
)


def perlin_3d(x, y, z):
    """Classic 3D Perlin gradient noise of the coordinates ``(x, y, z)``,
    output ≈ [0, 1] (float32: the gradients are a float32 table, so every
    product with them widens, as in the JAX package)."""
    perm = torch.from_numpy(_PERM).to(x.device)
    g3 = torch.from_numpy(_GRADS3).to(x.device)
    xi = torch.floor(x).to(torch.int64)
    yi = torch.floor(y).to(torch.int64)
    zi = torch.floor(z).to(torch.int64)
    xf = x - xi.to(x.dtype)
    yf = y - yi.to(y.dtype)
    zf = z - zi.to(z.dtype)
    xi = xi & 255
    yi = yi & 255
    zi = zi & 255

    def grad_dot(ix, iy, iz, dx, dy, dz):
        g = g3[perm[perm[perm[ix] + iy] + iz] % 12]
        return g[..., 0] * dx + g[..., 1] * dy + g[..., 2] * dz

    u, v, w = _fade(xf), _fade(yf), _fade(zf)

    def lerp(a, b, t):
        return a + t * (b - a)

    n000 = grad_dot(xi, yi, zi, xf, yf, zf)
    n100 = grad_dot(xi + 1, yi, zi, xf - 1, yf, zf)
    n010 = grad_dot(xi, yi + 1, zi, xf, yf - 1, zf)
    n110 = grad_dot(xi + 1, yi + 1, zi, xf - 1, yf - 1, zf)
    n001 = grad_dot(xi, yi, zi + 1, xf, yf, zf - 1)
    n101 = grad_dot(xi + 1, yi, zi + 1, xf - 1, yf, zf - 1)
    n011 = grad_dot(xi, yi + 1, zi + 1, xf, yf - 1, zf - 1)
    n111 = grad_dot(xi + 1, yi + 1, zi + 1, xf - 1, yf - 1, zf - 1)

    nx00 = lerp(n000, n100, u)
    nx10 = lerp(n010, n110, u)
    nx01 = lerp(n001, n101, u)
    nx11 = lerp(n011, n111, u)
    nxy0 = lerp(nx00, nx10, v)
    nxy1 = lerp(nx01, nx11, v)
    return 0.5 * (lerp(nxy0, nxy1, w) + 1.0)


def apply_turbulent_noise_3d(vel, noise_scale: float = 0.1, frequency: float = 0.05,
                             z0: int = 0, n: int = None):
    """3D generalization of FluidSim.cs:675-701: perturb each velocity
    component on the interior by ``(perlin − 0.5)·noise_scale·|v|``, the
    noise sampled at the cell coordinates times ``frequency`` (permuted per
    component).  The coordinates are built in the velocity's dtype, as in
    the JAX package (in bfloat16 they round above 256).  The perturbed
    velocity is float32 there; it is rounded back to the velocity's dtype
    here, so the state keeps its storage dtype.  On a shard ``vel`` is the
    z-slab of the ``n³`` grid whose plane 0 is global plane ``z0``: each
    cell gets the whole-grid value."""
    n = vel.shape[-1] if n is None else n
    nz = vel.shape[1]
    sdt = vel.dtype
    ar = torch.arange(n, dtype=sdt, device=vel.device)
    kk, jj, ii = torch.meshgrid(ar[z0:z0 + nz], ar, ar, indexing="ij")
    speed = torch.sqrt(torch.sum(vel * vel, dim=0))
    strength = storage_scalar(noise_scale, sdt) * speed
    f = storage_scalar(frequency, sdt)
    nx = perlin_3d(ii * f, jj * f, kk * f) - 0.5
    ny = perlin_3d(jj * f, kk * f, ii * f) - 0.5
    nz_ = perlin_3d(kk * f, ii * f, jj * f) - 0.5
    interior = interior_mask((n, n, n), vel.device)[z0:z0 + nz]
    delta = torch.stack([nx, ny, nz_]) * strength[None]
    return torch.where(interior[None], vel + delta, vel).to(sdt)
