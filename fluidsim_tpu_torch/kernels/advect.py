"""K1: the K=1 semi-Lagrangian advection kernel, its plain twin and its wrapper.

Counterpart of ``fluidsim_tpu/pallas/advect.py`` (``advect_multi_3d_pallas``
→ ``_advect_kernel``, core ``_substep_window_vals``).  The CUDA kernel is
``csrc/advect.cu``; ``advect_multi_3d_plain`` is the same arithmetic in plain
PyTorch (the two-tap form, not the 27-term hat sum of ``ops/advect.py``),
used for CPU tensors and as the reference the kernel is checked against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.boundary import apply_faces_3d
from ..ops.forces import buoyancy_force
from . import _build


def _comb(gm, g0, gp, wp, wm):
    """Two-tap interpolation ``g0 + wp·(g₊−g0) + wm·(g₋−g0)``, left to right."""
    return g0 + wp * (gp - g0) + wm * (gm - g0)


def advect_multi_3d_plain(bs, fields, vel, dt: float, buoy=None):
    """Plain PyTorch twin of the K1 kernel: advect the ``(F, N, N, N)``
    ``fields`` (boundary codes ``bs``) through ``vel`` with the clamped K=1
    backtrace, then the fresh-zero + ``set_bnd`` face contract.

    ``buoy = (density, buoyancy, ambient, gravity)`` (self-advection only)
    adds the buoyancy force to the y velocity first, at the cell and at
    every tap, exactly as the kernel does."""
    n = fields.shape[-1]
    dt0 = float(np.float32(dt) * np.float32(n - 2))
    if buoy is not None:
        dens, b_f, amb, grav = buoy
        vel = buoyancy_force(vel, dens, dt, b_f, amb, grav)
        fields = vel
    f32 = torch.float32
    inner = slice(1, n - 1)
    coord = torch.arange(1, n - 1, dtype=f32, device=fields.device)

    def frac(c, v):
        t = c - dt0 * v
        t = torch.where(t < 0.5, 0.5, t)
        t = torch.where(t > n - 1.5, n - 1.5, t)
        t = torch.minimum(torch.maximum(t, c - 1.0), c + 1.0)
        return t - c

    v = vel[:, inner, inner, inner]
    fx = frac(coord[None, None, :], v[0])
    fy = frac(coord[None, :, None], v[1])
    fz = frac(coord[:, None, None], v[2])
    fxp, fxm = torch.clamp(fx, min=0.0), torch.clamp(-fx, min=0.0)
    fyp, fym = torch.clamp(fy, min=0.0), torch.clamp(-fy, min=0.0)
    fzp, fzm = torch.clamp(fz, min=0.0), torch.clamp(-fz, min=0.0)

    def sl(d):
        return slice(1 + d, n - 1 + d)

    planes = []
    for dz in (-1, 0, 1):
        rows = []
        for dy in (-1, 0, 1):
            g = fields[:, sl(dz), sl(dy)]
            rows.append(_comb(g[..., sl(-1)], g[..., sl(0)], g[..., sl(1)],
                              fxp, fxm))
        planes.append(_comb(*rows, fyp, fym))
    vals = _comb(*planes, fzp, fzm)

    out = []
    for c, b in enumerate(bs):
        field = torch.zeros((n, n, n), dtype=fields.dtype, device=fields.device)
        field[inner, inner, inner] = vals[c]
        out.append(apply_faces_3d(b, field))
    return torch.stack(out)


def _check_volume(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def advect_multi_3d_kernel(bs, fields, vel, dt: float, obst=None, window: int = 1,
                           n_sub: int = 1, buoy=None):
    """Advect ``fields`` (F = 1 or 3) through ``vel`` with the K1 kernel.

    CUDA tensors launch ``csrc/advect.cu``; CPU tensors run
    ``advect_multi_3d_plain``.  ``buoy = (density, buoyancy, ambient,
    gravity)`` folds the buoyancy force into a self-advection call
    (``fields is vel``, ``bs == (1, 2, 3)``).  Raises for what the kernel
    does not take.  ``advect_multi_3d_kernel.launches`` counts launches."""
    bs = tuple(bs)
    if obst is not None:
        raise NotImplementedError(
            "obstacle masks in the advection kernel are not ported")
    if window != 1 or n_sub != 1:
        raise NotImplementedError(
            f"advection kernel with window={window}, n_sub={n_sub}: only "
            "window=1, n_sub=1 is ported")
    if buoy is not None and not (fields is vel and bs == (1, 2, 3)):
        raise ValueError("buoy folding requires a self-advect call")
    n_fields, n = fields.shape[0], fields.shape[-1]
    if n_fields not in (1, 3) or len(bs) != n_fields:
        raise ValueError(f"unsupported fields {tuple(fields.shape)} with bs={bs}")
    if n < 3:
        raise ValueError(f"grid too small: {n}")
    _check_volume("fields", fields, (n_fields, n, n, n))
    _check_volume("vel", vel, (3, n, n, n))
    tensors = [fields, vel]
    if buoy is not None:
        _check_volume("buoy density", buoy[0], (n, n, n))
        tensors.append(buoy[0])
    if any(t.device != fields.device for t in tensors):
        raise ValueError("all tensors must be on one device")

    if fields.device.type == "cpu":
        return advect_multi_3d_plain(bs, fields, vel, dt, buoy)
    if fields.device.type != "cuda":
        raise ValueError(f"unsupported device {fields.device}")

    lib = _build.load_library()
    out = torch.empty_like(fields)
    dt0 = float(np.float32(dt) * np.float32(n - 2))
    if buoy is None:
        dens_ptr, bp = None, (0.0, 0.0, 0.0, 0.0)
    else:
        dens_ptr = buoy[0].data_ptr()
        bp = (float(dt), float(buoy[1]), float(buoy[2]), float(buoy[3]))
    b = bs + (0,) * (3 - n_fields)
    with torch.cuda.device(fields.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_advect_k1(
            fields.data_ptr(), vel.data_ptr(), dens_ptr, out.data_ptr(),
            n, n_fields, b[0], b[1], b[2], dt0,
            int(buoy is not None), *bp, stream,
        )
    _build.check(lib, err, "advect kernel launch")
    advect_multi_3d_kernel.launches += 1
    return out


advect_multi_3d_kernel.launches = 0
