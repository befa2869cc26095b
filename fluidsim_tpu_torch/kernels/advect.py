"""K1: the windowed semi-Lagrangian advection kernel, its plain twin and its
wrapper.

Counterpart of ``fluidsim_tpu/pallas/advect.py`` (``advect_multi_3d_pallas``
→ ``_advect_kernel``, core ``_substep_window_vals``), with the buoyancy and
the folded emitter (``src``) of its self-advection.  The CUDA kernel is
``csrc/advect.cu``; ``advect_multi_3d_plain`` is the same arithmetic in plain
PyTorch, used for CPU tensors and as the reference the kernel is checked
against: for a window of K = 1 the two-tap form (``windowed_sum_k1``), for
any K > 1 the ``(2K+1)³``-term hat sum (``windowed_sum``, the same sum as
``ops/advect.window_sum_3d``).  At K = 1 the kernel stages tiles of the
fields in shared memory (``csrc/advect_tiled.cuh``), and at K >= 2 tiles
widened by K where their ring fits the card's shared memory
(``csrc/advect_window.cuh``, ``advect_route``); ``advect_launches`` counts
substep launches by route.

Fields are stored in float32 or bfloat16 (``fields`` and ``vel`` in one
dtype); the backtrace, the weights and the substeps between the first read
and the last write are float32, and the result is rounded to the storage
dtype once, as the TPU kernel keeps its windows in VMEM as float32
(``advect.py:392-453``).  The buoyancy and emitter folds take float32
fields only, as the JAX package folds them only there.

The obstacle mask is a ``torch.bool`` tensor (one byte per cell, which the
kernel reads as ``uint8``, nonzero = solid).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.advect import _mask_and_bnd_3d, window_sum_3d
from ..ops.boundary import set_bnd_3d
from ..ops.forces import buoyancy_force
from ..scene.sources import src_field_add
from ..utils.profiling import spanned
from . import _build


def _comb(gm, g0, gp, wp, wm):
    """Two-tap interpolation ``g0 + wp·(g₊−g0) + wm·(g₋−g0)``, left to right."""
    return g0 + wp * (gp - g0) + wm * (gm - g0)


def substep_dt0(dt: float, n: int, n_sub: int) -> float:
    """The backtrace scale of one substep as the TPU kernel computes it:
    ``dt0 = f32(dt)·f32(n−2)`` as a Python float, divided by ``n_sub`` in
    double and rounded to float32 (not the XLA path's
    ``f32(f32(dt)/f32(n_sub))·f32(n−2)``; the two can differ in the last
    bit)."""
    dt0 = float(np.float32(dt) * np.float32(n - 2))
    return float(np.float32(dt0 / n_sub))


def check_window(window, n: int, nz: int = None) -> int:
    """The window K of a kernel's backtrace: any integer K >= 1 on a grid of
    ``n >= 2K+1`` cells (and a slab of ``nz >= 2K+1`` planes), since the taps
    K cells away are read at wrapped indices.  ``csrc/advect.cuh`` compiles
    K = 1, 2 and 3 and one body for every K >= 4 (K8 and K14 run them; K1,
    K11 and K2's density phase launch K = 1 or the runtime window).  Raises
    ``ValueError``."""
    if int(window) != window or window < 1:
        raise ValueError(f"window must be an integer >= 1, got {window}")
    window = int(window)
    if nz is None and n < 2 * window + 1:
        raise ValueError(f"grid too small for window={window}: {n}")
    if nz is not None and (n < 2 * window + 1 or nz < 2 * window + 1):
        raise ValueError(f"slab too small for window={window}: n={n}, nz={nz}")
    return window

# fs_advect_k1's src_on for K1's fold: the emitter goes onto the buoyancy's
# density (csrc/advect.cuh's kSrcDensity; K2s's kSrcFields is K2's own).
SRC_ON_DENSITY = 1

# The field storage dtypes the kernels take, and their flag in the C
# entry points.
STORAGE = (torch.float32, torch.bfloat16)


def storage_flag(dtype: torch.dtype) -> int:
    """1 for bfloat16 storage, 0 for float32 (the kernels' ``field_bf16``)."""
    return int(dtype == torch.bfloat16)


# Substep launches of the backtrace kernels by route, counted by the wrappers
# that launch them (K1, K11 and K2's density phase): "tiled" at K = 1
# (csrc/advect_tiled.cuh), "window" at K >= 2 where the ring of
# csrc/advect_window.cuh fits, one thread a cell ("cell") above that.
advect_launches = {"tiled": 0, "window": 0, "cell": 0}

# csrc/advect_window.cuh: a block's tile (one cell a thread), the float32
# values a thread stages a plane for each field at most (its registers), and
# the shared memory a block may opt in to on an NVIDIA H100, which the gate
# takes where no card is asked.
WIN_TILE = (32, 16)
WIN_SHARE_MAX = {1: 5, 3: 3}
H100_SMEM_OPTIN = 232_448


def win_ring_bytes(window: int, n_fields: int) -> int:
    """Shared memory of the windowed tiles' z ring: ``2K + 2`` slots of
    ``n_fields`` float32 planes of the tile widened by K on each side."""
    tx, ty = WIN_TILE
    return 4 * (2 * window + 2) * n_fields * (tx + 2 * window) * (ty + 2 * window)


def win_share(window: int) -> int:
    """The values a thread stages of a plane of one field."""
    tx, ty = WIN_TILE
    return -(-((tx + 2 * window) * (ty + 2 * window)) // (tx * ty))


def advect_route(window: int, n_fields: int, smem_optin: int = H100_SMEM_OPTIN) -> str:
    """The route of a substep of ``n_fields`` fields with a window of
    ``window`` cells, as ``csrc/advect.cuh``'s ``launch`` takes it on a card
    whose blocks may opt in to ``smem_optin`` bytes of shared memory
    (``win_tiled``): on an H100 the windowed tiles take F = 3 up to K = 6 and
    F = 1 up to K = 11."""
    if window == 1:
        return "tiled"
    fits = (win_share(window) <= WIN_SHARE_MAX[n_fields]
            and win_ring_bytes(window, n_fields) <= smem_optin)
    return "window" if fits else "cell"


@functools.lru_cache(maxsize=None)
def card_smem_optin(index: int) -> int:
    """The shared memory a block may opt in to on card ``index``."""
    lib = _build.load_library()
    with torch.cuda.device(index):
        optin = lib.fs_smem_optin()
    if optin < 0:
        _build.check(lib, -optin, "shared memory query")
    return optin


def count_substeps(window: int, n_fields: int, n_sub: int, device) -> None:
    """Add a call's ``n_sub`` substep launches on ``device`` (a card) to
    ``advect_launches``."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    advect_launches[advect_route(window, n_fields, card_smem_optin(index))] += n_sub


def advect_multi_3d_plain(bs, fields, vel, dt: float, buoy=None, obst=None,
                          n_sub: int = 1, src=None, window: int = 1):
    """Plain PyTorch twin of the K1 kernel: advect the ``(F, N, N, N)``
    ``fields`` (boundary codes ``bs``) through ``vel`` with the backtrace
    clamped to ``window`` cells in ``n_sub`` substeps of ``dt/n_sub``.
    After every substep comes the output contract: the fresh-zero +
    ``set_bnd`` faces, and with the bool mask ``obst`` the solid cells
    zeroed before the faces and the obstacle mirror of the velocity codes
    after them (``ops/advect._mask_and_bnd_3d``).

    ``buoy = (density, buoyancy, ambient, gravity)`` (self-advection only)
    adds the buoyancy force to the y velocity first, at the cell and at
    every tap, exactly as the kernel does.  ``src``, the ``(5,)`` emitter
    descriptor (``scene.sources.emitter_fold_operand``), is first added to
    that density (``src_field_add``); it needs ``buoy``.

    On bfloat16 fields the whole call runs on their float32 values and the
    result is rounded once (the folds take float32 only)."""
    if fields.dtype == torch.bfloat16:
        if buoy is not None or src is not None:
            raise TypeError("the buoyancy and emitter folds take float32 fields")
        out = advect_multi_3d_plain(bs, fields.float(), vel.float(), dt, obst=obst,
                                    n_sub=n_sub, window=window)
        return out.to(fields.dtype)
    n = fields.shape[-1]
    dt0 = substep_dt0(dt, n, n_sub)
    if src is not None and buoy is None:
        raise ValueError("src folding rides the buoy density reads")
    if buoy is not None:
        dens, b_f, amb, grav = buoy
        if src is not None:
            dens = src_field_add(dens, src)
        vel = buoyancy_force(vel, dens, dt, b_f, amb, grav)
        fields = vel
    if window != 1:
        for _ in range(n_sub):
            vals = window_sum_3d(fields, vel, dt0, window)
            fields = torch.stack([_mask_and_bnd_3d(b, vals[c], fields[c], obst)
                                  for c, b in enumerate(bs)])
        return fields
    f32 = torch.float32
    inner = slice(1, n - 1)
    core = (inner,) * 3
    coord = torch.arange(1, n - 1, dtype=f32, device=fields.device)

    def frac(c, v):
        t = c - dt0 * v
        t = torch.where(t < 0.5, 0.5, t)
        t = torch.where(t > n - 1.5, n - 1.5, t)
        t = torch.minimum(torch.maximum(t, c - 1.0), c + 1.0)
        return t - c

    v = vel[(slice(None),) + core]
    fx = frac(coord[None, None, :], v[0])
    fy = frac(coord[None, :, None], v[1])
    fz = frac(coord[:, None, None], v[2])
    fxp, fxm = torch.clamp(fx, min=0.0), torch.clamp(-fx, min=0.0)
    fyp, fym = torch.clamp(fy, min=0.0), torch.clamp(-fy, min=0.0)
    fzp, fzm = torch.clamp(fz, min=0.0), torch.clamp(-fz, min=0.0)

    def sl(d):
        return slice(1 + d, n - 1 + d)

    for _ in range(n_sub):
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
            field = torch.zeros((n, n, n), dtype=fields.dtype,
                                device=fields.device)
            field[core] = (vals[c] if obst is None
                           else torch.where(obst[core], 0.0, vals[c]))
            out.append(set_bnd_3d(b, field, obst))
        fields = torch.stack(out)
    return fields


def _check_volume(name: str, t: torch.Tensor, shape,
                  dtype: torch.dtype = torch.float32) -> None:
    """``t`` has ``dtype`` (or one of a tuple of dtypes), ``shape`` and a
    contiguous layout."""
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_substeps(n_sub) -> int:
    if int(n_sub) != n_sub or n_sub < 1:
        raise ValueError(f"n_sub must be a positive integer, got {n_sub}")
    return int(n_sub)


def _check_src(src, device) -> None:
    """The emitter descriptor: a contiguous ``(5,)`` float32 tensor on
    ``device``."""
    _check_volume("src", src, (5,))
    if src.device != device:
        raise ValueError("src must be on the fields' device")


def _scratch(n_fields: int, n: int, n_sub: int, mirror: bool, dtype, device,
             nz: int = None):
    """The float32 scratch of ``n_sub`` substeps (``csrc/advect.cuh``'s
    ``advect_substeps``) on ``(n_fields, nz, n, n)`` (``nz`` = n: the whole
    grid): float32 storage ping-pongs with the output through one buffer;
    bfloat16 keeps the substeps before the last write (and a velocity's
    mirror) in float32, in up to two buffers."""
    shape = (n_fields, n if nz is None else nz, n, n)
    if dtype == torch.float32:
        need = 1 if n_sub > 1 else 0
    else:
        need = min(2, n_sub - 1 + int(mirror))
    bufs = [torch.empty(shape, dtype=torch.float32, device=device) for _ in range(need)]
    return tuple(bufs) + (None,) * (2 - need)


def _ptr(t):
    return None if t is None else t.data_ptr()


@spanned("kernel.K1")
def advect_multi_3d_kernel(bs, fields, vel, dt: float, obst=None, window: int = 1,
                           n_sub: int = 1, buoy=None, src=None):
    """Advect ``fields`` (F = 1 or 3) through ``vel`` with the K1 kernel for
    a ``window`` of K >= 1 cells, in ``n_sub`` substeps, with the obstacle
    contract after each when the bool mask ``obst`` is given.  ``fields``
    and ``vel`` are float32 or bfloat16, in one dtype.

    CUDA tensors launch ``csrc/advect.cu`` (``csrc/advect_bf16.cu`` for
    bfloat16); CPU tensors run ``advect_multi_3d_plain``.  ``buoy =
    (density, buoyancy, ambient, gravity)`` folds the buoyancy force into a
    float32 self-advection call (``fields is vel``, ``bs == (1, 2, 3)``)
    without a mask; ``src`` (the ``(5,)`` emitter descriptor) adds the
    emitter to that density.  Raises for what the kernel does not take.
    ``advect_multi_3d_kernel.launches`` counts calls that launched the
    kernel, ``advect_launches`` their substeps by route."""
    bs = tuple(bs)
    n_sub = _check_substeps(n_sub)
    if buoy is not None and not (fields is vel and bs == (1, 2, 3)):
        raise ValueError("buoy folding requires a self-advect call")
    if buoy is not None and obst is not None:
        raise NotImplementedError(
            "the buoyancy fold with an obstacle mask is not ported")
    if src is not None and buoy is None:
        raise ValueError("src folding rides the buoy density reads")
    n_fields, n = fields.shape[0], fields.shape[-1]
    if n_fields not in (1, 3) or len(bs) != n_fields:
        raise ValueError(f"unsupported fields {tuple(fields.shape)} with bs={bs}")
    window = check_window(window, n)
    _check_volume("fields", fields, (n_fields, n, n, n), STORAGE)
    _check_volume("vel", vel, (3, n, n, n), fields.dtype)
    if buoy is not None and fields.dtype != torch.float32:
        raise TypeError("the buoyancy and emitter folds take float32 fields")
    tensors = [fields, vel]
    if buoy is not None:
        _check_volume("buoy density", buoy[0], (n, n, n))
        tensors.append(buoy[0])
    if obst is not None:
        _check_volume("obst", obst, (n, n, n), torch.bool)
        tensors.append(obst)
    if any(t.device != fields.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    if src is not None:
        _check_src(src, fields.device)

    if fields.device.type == "cpu":
        return advect_multi_3d_plain(bs, fields, vel, dt, buoy, obst, n_sub, src,
                                     window)
    if fields.device.type != "cuda":
        raise ValueError(f"unsupported device {fields.device}")

    lib = _build.load_library()
    out = torch.empty_like(fields)
    mirror = obst is not None and any(b in (1, 2, 3) for b in bs)
    tmp0, tmp1 = _scratch(n_fields, n, n_sub, mirror, fields.dtype, fields.device)
    if buoy is None:
        dens_ptr, bp = None, (0.0, 0.0, 0.0, 0.0)
    else:
        dens_ptr = buoy[0].data_ptr()
        bp = (float(dt), float(buoy[1]), float(buoy[2]), float(buoy[3]))
    b = bs + (0,) * (3 - n_fields)
    with torch.cuda.device(fields.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_advect_k1(
            fields.data_ptr(), vel.data_ptr(), dens_ptr, _ptr(obst), _ptr(src),
            SRC_ON_DENSITY, out.data_ptr(), _ptr(tmp0), _ptr(tmp1),
            n, n_fields, b[0], b[1], b[2], substep_dt0(dt, n, n_sub), n_sub,
            window, int(buoy is not None), *bp, 1.0,
            storage_flag(fields.dtype), stream,
        )
    _build.check(lib, err, "advect kernel launch")
    advect_multi_3d_kernel.launches += 1
    count_substeps(window, n_fields, n_sub, fields.device)
    return out


advect_multi_3d_kernel.launches = 0
