"""Streamline visualization (counterpart of
``fluidsim_tpu/render/streamlines.py``).

Reference pipeline (FluidSim.cs:886-976, 1657-1849):

1. ``StreamlineCalculationJob``: on a subsampled seed grid (``skip =
   max(1, N // (density·10))``, seeds at ``(x·skip+skip, y·skip+skip)``),
   the flow angle and a length ``min(skip−1, |v|·scale)``; obstacle seeds
   and ``|v| < 0.01`` are invalid (FluidSim.cs:1680-1727).
2. ``StreamlineDrawJob``: line segments (FluidSim.cs:1739-1762).
3. Bresenham rasterization with thickness (FluidSim.cs:1765-1849), on the
   host: scatter-heavy and tiny, as the reference keeps it on the CPU.

Steps 1–2 run on the velocity's device in torch.  Step 3 is host code: the
repository's native rasterizer (``native/librasterizer.so``, built from
``native/rasterizer.cpp``) through ``ctypes`` where it loads, else a NumPy
loop of the same semantics, exactly as the JAX package does;
``native_rasterizer_available`` says which one runs.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np
import torch

from ..config import SimConfig

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "librasterizer.so"),
    os.path.join(os.path.dirname(__file__), "librasterizer.so"),
]


def _load_native():
    for p in _LIB_PATHS:
        p = os.path.abspath(p)
        if os.path.exists(p):
            try:
                lib = ctypes.CDLL(p)
            except OSError:
                continue
            lib.draw_segments.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_float,
            ]
            lib.draw_segments.restype = None
            lib.composite_over.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int,
            ]
            lib.composite_over.restype = None
            return lib
    return None


_NATIVE = _load_native()


def streamline_skip(cfg: SimConfig) -> int:
    """skip = max(1, N // (streamlineDensity·10)) (FluidSim.cs:892)."""
    return max(1, cfg.current_size // (cfg.streamline_density * 10))


def compute_streamline_segments(vel_x: torch.Tensor, vel_y: torch.Tensor,
                                obstacles: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """Steps 1–2 on the velocity's device: an ``(M, 4)`` float32 tensor of
    segments (x0, y0, x1, y1); invalid entries have x0 = −1
    (FluidSim.cs:1744-1748)."""
    n = cfg.current_size
    skip = streamline_skip(cfg)
    n_seeds = n // skip
    device = vel_x.device

    idx = torch.arange(n_seeds * n_seeds, dtype=torch.int32, device=device)
    sx = (idx % n_seeds) * skip + skip   # grid x (FluidSim.cs:1687)
    sy = (idx // n_seeds) * skip + skip  # grid y
    in_range = (sx > 0) & (sx < n - 1) & (sy > 0) & (sy < n - 1)
    sx_c = torch.clamp(sx, 0, n - 1).long()
    sy_c = torch.clamp(sy, 0, n - 1).long()

    vx = vel_x[sy_c, sx_c]
    vy = vel_y[sy_c, sx_c]
    obst = obstacles[sy_c, sx_c]

    mag = torch.sqrt(vx * vx + vy * vy)
    valid = in_range & ~obst & (mag >= 0.01)

    length = torch.clamp(mag * cfg.streamline_scale, max=float(skip - 1))
    angle = torch.atan2(vy, vx)
    fx, fy = sx.to(torch.float32), sy.to(torch.float32)
    ex = fx + torch.cos(angle) * length
    ey = fy + torch.sin(angle) * length
    return torch.stack([torch.where(valid, v, -1.0) for v in (fx, fy, ex, ey)], dim=-1)


def _rasterize_numpy(segments, rgba, color, size, thickness):
    """The NumPy rasterizer, the semantics of native/rasterizer.cpp (and
    FluidSim.cs:1783-1849)."""
    half = int(np.floor(thickness / 2.0))
    for seg in segments:
        if seg[0] < 0:
            continue
        x0, y0 = int(seg[0]), int(seg[1])
        x1, y1 = int(round(float(seg[2]))), int(round(float(seg[3])))
        steep = abs(y1 - y0) > abs(x1 - x0)
        if steep:
            x0, y0 = y0, x0
            x1, y1 = y1, x1
        if x0 > x1:
            x0, x1 = x1, x0
            y0, y1 = y1, y0
        dx = x1 - x0
        dy = abs(y1 - y0)
        error = dx // 2
        y = y0
        ystep = 1 if y0 < y1 else -1
        for x in range(x0, x1 + 1):
            for tx in range(-half, half + 1):
                for ty in range(-half, half + 1):
                    draw_x = (y if steep else x) + tx
                    draw_y = (x if steep else y) + ty
                    if 0 <= draw_x < size and 0 <= draw_y < size:
                        rgba[draw_y, draw_x] = color
            error -= dy
            if error < 0:
                y += ystep
                error += dx


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), np.float32)


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def rasterize_streamlines(segments, cfg: SimConfig,
                          base_frame: Optional[np.ndarray] = None) -> np.ndarray:
    """Step 3 (host): rasterize ``segments`` into an RGBA overlay and, with a
    base frame, composite it on top (CombineTextures, FluidSim.cs:868-884).
    Returns a host ``(N, N, 4)`` float32 array."""
    n = cfg.current_size
    segs = _host(segments)
    overlay = np.zeros((n, n, 4), np.float32)
    color = np.asarray(cfg.streamline_color, np.float32)

    if _NATIVE is not None:
        _NATIVE.draw_segments(_fp(segs), len(segs), _fp(overlay), _fp(color), n,
                              float(cfg.streamline_thickness))
    else:
        _rasterize_numpy(segs, overlay, color, n, cfg.streamline_thickness)

    if base_frame is None:
        return overlay
    base = _host(base_frame).copy()
    if _NATIVE is not None:
        _NATIVE.composite_over(_fp(base), _fp(overlay), n * n)
        return base
    mask = overlay[..., 3] > 0
    base[mask] = overlay[mask]
    return base


def native_rasterizer_available() -> bool:
    return _NATIVE is not None
