"""Continuous emitters.

Counterpart of ``fluidsim_tpu/scene/sources.py`` (the reference's
``UpdateCustomSource``, FluidSim.cs:485-533): a full-grid masked add with a
radial linear falloff, optional pulsing and optional directional velocity.
Coordinates and falloff are float32; the add happens in the field dtype.
Scalar parameters are float32 host values, so moving the emitter costs
nothing on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SimConfig, SourceSpec


def pulse_scale(t: torch.Tensor, rate: float) -> torch.Tensor:
    """|sin(t · rate · π)| (FluidSim.cs:492-494), float32."""
    return torch.abs(torch.sin(t * float(np.float32(rate))
                               * float(np.float32(np.pi))))


class SourceParams(NamedTuple):
    """Scene-dynamic emitter values (float32 host scalars and vectors)."""

    position: np.ndarray   # (ndim,) normalized [0, 1], (x, y[, z]) order
    strength: np.float32   # base strength (pre resolution scaling)
    radius: np.float32     # base radius in cells (pre resolution scaling)
    velocity: np.float32   # emitted |v| (pre resolution scaling)
    dir_vec: np.ndarray    # (ndim,) unit emission direction
    pulse_t: np.float32    # wall-clock elapsedTime (pulse_clock="wall")


def _dir_vec(ndim: int, direction_deg: float, velocity_dir) -> np.ndarray:
    if ndim == 2:
        ang = np.float32(np.deg2rad(np.float32(direction_deg)))
        return np.array([np.cos(ang), np.sin(ang)], dtype=np.float32)
    d = np.asarray(velocity_dir, dtype=np.float32)
    return (d / max(np.linalg.norm(d), 1e-8)).astype(np.float32)


def source_params(cfg: SimConfig) -> SourceParams:
    """The main emitter's values from the current config."""
    return SourceParams(
        position=np.asarray(cfg.source_position[: cfg.ndim], np.float32),
        strength=np.float32(cfg.source_strength),
        radius=np.float32(cfg.source_radius),
        velocity=np.float32(cfg.source_velocity),
        dir_vec=_dir_vec(cfg.ndim, cfg.source_direction,
                         cfg.source_velocity_dir),
        pulse_t=np.float32(0.0),
    )


def _spec_params(spec: SourceSpec, ndim: int) -> SourceParams:
    """``SourceParams`` for an ``extra_sources`` entry."""
    return SourceParams(
        position=np.asarray(spec.position[:ndim], np.float32),
        strength=np.float32(spec.strength),
        radius=np.float32(spec.radius),
        velocity=np.float32(spec.velocity),
        dir_vec=_dir_vec(ndim, spec.direction, spec.velocity_dir),
        pulse_t=np.float32(0.0),
    )


def _cell_centers(shape, device, z0: int = 0):
    """Per-axis float32 coordinate grids in (x, y[, z]) order; the first
    (slowest) axis starts at ``z0`` (a shard's global z origin)."""
    ranges = [torch.arange(o, o + s, dtype=torch.float32, device=device)
              for o, s in zip((z0,) + (0,) * (len(shape) - 1), shape)]
    return tuple(reversed(torch.meshgrid(*ranges, indexing="ij")))


def _apply_one(density, vel, cfg: SimConfig, t, params: SourceParams, *,
               emits_velocity: bool, pulsing: bool, pulse_rate: float, z0: int = 0):
    """One emitter, resolution-scaled, in the JAX package's float32 op order:
    ``dist = sqrt((dx² + dy²) + dz²)``, ``falloff = 1 − dist/r`` inside the
    ball, ``density += strength·falloff``.  ``density`` may be the z-slab of
    the grid whose plane 0 is global plane ``z0``."""
    nf = np.float32(cfg.current_size)
    res_mult = np.float32(cfg.resolution_multiplier)
    radius_cells = float(np.float32(params.radius) * res_mult)
    base = np.float32(params.strength)
    if pulsing:
        eff_strength = (float(base) * pulse_scale(t, pulse_rate)) * float(res_mult)
    else:
        eff_strength = float(base * np.float32(1.0) * res_mult)

    coords = _cell_centers(density.shape, density.device, z0)
    d2 = None
    for i, c in enumerate(coords):
        d = c - float(np.float32(params.position[i]) * nf)
        d2 = d * d if d2 is None else d2 + d * d
    dist = torch.sqrt(d2)
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar by
    # multiplying with its reciprocal, which is not the JAX package's division
    # (nor the folded emitter's, src_field_add).
    radius = torch.full((), radius_cells, dtype=torch.float32, device=density.device)
    falloff = torch.where(dist <= radius, 1.0 - dist / radius, 0.0)

    density = density + (eff_strength * falloff).to(density.dtype)

    if emits_velocity:
        vmag = np.float32(params.velocity) * res_mult
        vel = vel.clone()
        for c in range(cfg.ndim):
            scale = float(np.float32(params.dir_vec[c]) * vmag)
            vel[c] = vel[c] + (scale * falloff).to(vel.dtype)
    return density, vel


def emitter_foldable(cfg: SimConfig) -> bool:
    """True when the main emitter's density add can be deferred into the
    kernels' density reads (the ``src`` operand of
    ``models.stable3d.simulate_step_3d``): a single 3D density-only emitter
    on float32 fields.  The step's half of the gate is
    ``stable3d.emitter_folds``."""
    return (
        cfg.ndim == 3
        and cfg.enable_custom_source
        and not cfg.extra_sources
        and not cfg.source_emits_velocity
        and cfg.dtype == "float32"
    )


def emitter_fold_values(cfg: SimConfig, params: SourceParams = None) -> np.ndarray:
    """The host half of ``emitter_fold_operand``: ``[px·n, py·n, pz·n,
    strength·res, radius·res]`` float32, the strength without its pulse."""
    if params is None:
        params = source_params(cfg)
    nf = np.float32(cfg.current_size)
    res_mult = np.float32(cfg.resolution_multiplier)
    pos = np.asarray(params.position, np.float32)
    return np.array([
        pos[0] * nf, pos[1] * nf, pos[2] * nf,
        np.float32(params.strength) * np.float32(1.0) * res_mult,
        np.float32(params.radius) * res_mult,
    ], np.float32)


def emitter_fold_operand(cfg: SimConfig, t, params: SourceParams = None,
                         values: torch.Tensor = None) -> torch.Tensor:
    """The ``(5,)`` float32 emitter descriptor ``[px, py, pz, strength,
    radius]`` (centre and radius in cells, the pulsed and scaled strength)
    on ``t``'s device, which the kernels' folded add (``src_field_add``)
    reads: ``_apply_one``'s float32 operations, scalar for scalar.

    ``t`` is the 0-d float32 time on the device; a pulsing strength is
    computed from it there, so building the descriptor never waits for the
    device.  ``values`` is ``emitter_fold_values`` already on that device
    (``Engine`` keeps it there; None copies it from the host)."""
    if params is None:
        params = source_params(cfg)
    if values is None:
        values = torch.from_numpy(emitter_fold_values(cfg, params)).to(t.device)
    if not cfg.source_pulsing:
        return values
    if cfg.pulse_clock == "wall":
        t = torch.tensor(params.pulse_t, dtype=torch.float32, device=t.device)
    res_mult = float(np.float32(cfg.resolution_multiplier))
    strength = (float(np.float32(params.strength))
                * pulse_scale(t, cfg.source_pulse_rate)) * res_mult
    return torch.cat([values[:3], strength.reshape(1), values[4:]])


def src_field_add(vals, src, z0: int = 0, y0: int = 0, x0: int = 0):
    """Add the ``emitter_fold_operand`` source ``src`` to the float32
    ``[z, y, x]`` block ``vals`` whose global origin is ``(z0, y0, x0)``:
    ``dist = sqrt(((dx²) + (dy²)) + (dz²))``, ``where(dist ≤ r, 1 − dist/r,
    0)``, ``vals + strength·falloff``, the float32 operations of
    ``_apply_one`` and of the kernels' folded add."""
    dev = vals.device
    coords = [o + torch.arange(s, dtype=torch.float32, device=dev)
              for o, s in zip((z0, y0, x0), vals.shape)]
    zi, yi, xi = torch.meshgrid(*coords, indexing="ij")
    src = src.to(torch.float32)
    px, py, pz, strength, radius = src.unbind()
    dx, dy, dz = xi - px, yi - py, zi - pz
    dist = torch.sqrt((dx * dx + dy * dy) + dz * dz)
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar by
    # multiplying with its reciprocal, which is not the kernels' division.
    falloff = torch.where(dist <= radius, 1.0 - dist / radius, 0.0)
    return vals + strength * falloff


def apply_custom_source(density, vel, cfg: SimConfig, t,
                        params: SourceParams = None, z0: int = 0):
    """One frame of all continuous emitters; no-op config ⇒ identity.

    ``t`` (a 0-d float32 tensor) is the elapsed time used for pulsing; with
    ``cfg.pulse_clock == "wall"`` and ``params`` given, ``params.pulse_t`` is
    used instead.  On a shard (3D) ``density`` and ``vel`` are its z-slab,
    plane 0 at global z ``z0``: each cell gets the whole-grid add.  Returns
    (density, vel)."""
    if cfg.pulse_clock == "wall" and params is not None:
        t = torch.tensor(params.pulse_t, dtype=torch.float32,
                         device=density.device)
    if cfg.enable_custom_source:
        density, vel = _apply_one(
            density, vel, cfg, t,
            params if params is not None else source_params(cfg),
            emits_velocity=cfg.source_emits_velocity,
            pulsing=cfg.source_pulsing,
            pulse_rate=cfg.source_pulse_rate,
            z0=z0,
        )
    for spec in cfg.extra_sources:
        density, vel = _apply_one(
            density, vel, cfg, t, _spec_params(spec, cfg.ndim),
            emits_velocity=spec.emits_velocity,
            pulsing=spec.pulsing,
            pulse_rate=spec.pulse_rate,
            z0=z0,
        )
    return density, vel


def add_density(density: torch.Tensor, x: float, y: float, amount, z: float = None):
    """Point injector (FluidSim.cs:723-729): ``amount`` added at the cell of
    the truncated, clamped coordinates.  Returns a new tensor."""
    idx = _clamp_idx((x, y) if z is None else (x, y, z), density.shape[-1])
    out = density.clone()
    out[idx] = out[idx] + amount
    return out


def add_velocity(vel: torch.Tensor, x: float, y: float, amounts, z: float = None):
    """Point injector (FluidSim.cs:731-738): ``amounts[c]`` added to
    component c at the cell.  Returns a new tensor."""
    idx = _clamp_idx((x, y) if z is None else (x, y, z), vel.shape[-1])
    out = vel.clone()
    for c, amt in enumerate(amounts):
        out[(c,) + idx] = out[(c,) + idx] + amt
    return out


def _clamp_idx(coords_xy, n):
    """(x, y[, z]) floats → clamped int array index ([y, x] / [z, y, x])."""
    ints = [int(np.clip(int(c), 0, n - 1)) for c in coords_xy]
    return tuple(reversed(ints))
