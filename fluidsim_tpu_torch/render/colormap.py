"""Scalar-field visualization of a 2D state (counterpart of
``fluidsim_tpu/render/colormap.py``): the reference's
``UpdateVisualizationJob`` (FluidSim.cs:1851-2002) computed on the fields'
device.

Five color modes (``ColorMode``, FluidSim.cs:32): SINGLE_COLOR (the tint
times density·intensity), GRADIENT (piecewise-linear keys over clamped
density·intensity), DENSITY_BASED (a three-threshold lerp chain),
PRESSURE_BASED (low/neutral/high thresholds with an orange overflow) and
STREAMLINES (the single-color base layer the streamlines are drawn on).
Obstacles paint ``obstacle_color``; the emitter marker is a 3-px disk of
``source_position_color``.  The frame is an ``(N, N, 4)`` float32 RGBA
tensor, row j = grid y.
"""

from __future__ import annotations

import torch

from ..config import ColorMode, SimConfig


def _col(c, device):
    return torch.tensor(c, dtype=torch.float32, device=device)


def _lerp(a, b, t):
    """Color.Lerp: a + (b−a)·clamp01(t), over pixels."""
    t = torch.clamp(t, 0.0, 1.0)[..., None]
    return a + (b - a) * t


def evaluate_gradient(t: torch.Tensor, colors, times) -> torch.Tensor:
    """Gradient-key interpolation (FluidSim.cs:1981-2001): ``t`` (...,) in
    [0, 1], ``colors`` (K, 4), ``times`` (K,)."""
    colors = torch.as_tensor(colors, dtype=torch.float32, device=t.device)
    times = torch.as_tensor(times, dtype=torch.float32, device=t.device)
    k = colors.shape[0]
    if k == 0:
        return torch.ones(t.shape + (4,), dtype=torch.float32, device=t.device)
    if k == 1:
        return colors[0].expand(t.shape + (4,))
    # The reference walks `while time > times[index+1]: index++` from 0:
    # the count of keys i >= 1 with times[i] < t.
    idx = torch.clamp(torch.sum(t[..., None] > times[1:], dim=-1), 0, k - 2)
    t0 = times[idx]
    t1 = times[idx + 1]
    frac = (t - t0) / torch.clamp(t1 - t0, min=1e-12)
    mid = _lerp(colors[idx], colors[idx + 1], frac)
    out = torch.where((t <= times[0])[..., None], colors[0], mid)
    return torch.where((t >= times[-1])[..., None], colors[-1], out)


def render_frame_2d(density: torch.Tensor, pressure: torch.Tensor,
                    obstacles: torch.Tensor, cfg: SimConfig,
                    elapsed_time: float = 0.0) -> torch.Tensor:
    """The per-pixel frame (FluidSim.cs:1888-1978), ``(N, N, 4)``."""
    d = density
    device = d.device
    nd = d * torch.tensor(cfg.colour_intensity, dtype=d.dtype, device=device)

    fluid_color = _col(cfg.fluid_color, device)
    if cfg.use_lerp:
        # PingPong(t·0.1, 1) color cycling (FluidSim.cs:790-794).
        t = torch.tensor(elapsed_time, dtype=torch.float32, device=device) * 0.1
        cycle = 1.0 - torch.abs(torch.remainder(t, 2.0) - 1.0)
        start = _col(cfg.start_color, device)
        fluid_color = start + (_col(cfg.end_color, device) - start) * cycle

    mode = cfg.color_mode
    if mode == ColorMode.DENSITY_BASED:
        mt = cfg.medium_density_threshold
        ht = cfg.high_density_threshold
        low = _col(cfg.low_density_color, device)
        med = _col(cfg.medium_density_color, device)
        high = _col(cfg.high_density_color, device)
        black = _col((0.0, 0.0, 0.0, 1.0), device)
        c_lo = _lerp(black, low, d / mt)
        c_mid = _lerp(low, med, (d - mt) / (ht - mt))
        c_hi = _lerp(med, high, torch.clamp((d - ht) / ht, max=1.0))
        pixel = torch.where((d < mt)[..., None], c_lo,
                            torch.where((d < ht)[..., None], c_mid, c_hi))
    elif mode == ColorMode.GRADIENT:
        pixel = evaluate_gradient(torch.clamp(nd, 0.0, 1.0), cfg.gradient_colors,
                                  cfg.gradient_times)
    elif mode == ColorMode.PRESSURE_BASED:
        p = pressure
        lt = cfg.low_pressure_threshold
        ht = cfg.high_pressure_threshold
        lowc = _col(cfg.low_pressure_color, device)
        neu = _col(cfg.neutral_pressure_color, device)
        highc = _col(cfg.high_pressure_color, device)
        orange = _col((1.0, 0.5, 0.0, 1.0), device)
        c_low = _lerp(lowc, neu, 1.0 + p / lt)
        c_mid = _lerp(neu, highc, (p - lt) / (ht - lt))
        c_hi = _lerp(highc, orange, torch.clamp((p - ht) / ht, max=1.0))
        pixel = torch.where((p < lt)[..., None], c_low,
                            torch.where((p <= ht)[..., None], c_mid, c_hi))
    else:  # SINGLE_COLOR / STREAMLINES base layer
        # float32 tint times the field's values (a bfloat16 field widens, as
        # JAX promotes it against the float32 tint), the alpha in its dtype.
        ndf = nd.float()
        alpha = torch.full_like(nd, float(fluid_color[3])).float()
        pixel = torch.stack([fluid_color[0] * ndf, fluid_color[1] * ndf,
                             fluid_color[2] * ndf, alpha], dim=-1)

    # Obstacles painted last-but-one (FluidSim.cs:1894-1899).
    pixel = torch.where(obstacles[..., None], _col(cfg.obstacle_color, device), pixel)

    # Source marker: 3-px disk (FluidSim.cs:1969-1978).
    if cfg.visualize_source_position and cfg.enable_custom_source:
        n = density.shape[0]
        ar = torch.arange(n, dtype=d.dtype, device=device)
        jj, ii = torch.meshgrid(ar, ar, indexing="ij")
        sx = cfg.source_position[0] * n
        sy = cfg.source_position[1] * n
        marker = (ii - sx) ** 2 + (jj - sy) ** 2 < 9.0  # visualMarkerRadius = 3
        pixel = torch.where(marker[..., None], _col(cfg.source_position_color, device),
                            pixel)
    return pixel
