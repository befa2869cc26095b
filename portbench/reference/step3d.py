"""The plain PyTorch reference of the 3D step that ``bench128`` and
``sharded512`` run, and of the raymarched frame of the live view.

It is a frozen copy of the arithmetic of the port's plain twins of its
kernels (K1's two-tap backtrace at a window of one cell, the projection's
divergence, Jacobi sweeps from zero and gradient, the emitter and the
buoyancy), written out again here so that it imports nothing of the
program: the same float32 operations in the same order, so that on the same
inputs it gives what the kernels, which are built to be bitwise their
twins, give.  It works each step out from the fields it is handed and takes
nothing that the program made but the state it is asked to follow.

One step, in the order of ``models/stable3d.simulate_step_3d`` on the
kernel path: the emitter's density add, the buoyancy on the y velocity, the
self-advection in ``advect_substeps`` substeps, the projection (the
divergence rounded to the solve dtype, ``jacobi_iters`` sweeps of ``(rhs +
Σ₆p)·(1/6)`` with every iterate rounded to the solve dtype, the gradient,
the velocity's faces, the velocity damping), the density advected through
the projected velocity, the density dissipation.  Configurations that ask
for anything else are refused.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

INV6 = float(np.float32(1.0) / np.float32(6.0))
SOLVE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Settings the reference implements, with the only value it takes.
REQUIRED = {
    "ndim": 3, "enable_obstacle": False, "vorticity_confinement": 0.0,
    "viscosity": 0.0, "diffusion": 0.0, "double_project": False,
    "advection_scheme": "substep", "advect_window": 1, "pressure_solver": "jacobi",
    "apply_turbulent_noise": False, "extra_sources": [], "source_emits_velocity": False,
    "source_pulsing": False, "jacobi_sweep_block": 1, "auto_adjust_parameters": False,
    "dtype": "float32", "fuse_self_advect": False, "fuse_emitter": False,
    "enable_custom_source": True, "pulse_clock": "sim",
}


def _f32(x) -> float:
    return float(np.float32(x))


def _faces(b: int, x: torch.Tensor) -> torch.Tensor:
    """The wall faces, z then y then x (a later write wins at edges),
    mirroring the adjacent plane, negated for the velocity component normal
    to the wall (b = 1: x walls, 2: y, 3: z)."""
    x = x.clone()
    for axis, neg_b in ((0, 3), (1, 2), (2, 1)):
        n = x.shape[axis]
        for dst, src in ((0, 1), (n - 1, n - 2)):
            plane = x.select(axis, src)
            x.select(axis, dst).copy_(-plane if b == neg_b else plane)
    return x


def _nbr_sum(x: torch.Tensor) -> torch.Tensor:
    """The six neighbours of every interior cell, ``((x₊+x₋) + (y₊+y₋)) +
    (z₊+z₋)``."""
    return (
        ((x[1:-1, 1:-1, 2:] + x[1:-1, 1:-1, :-2])
         + (x[1:-1, 2:, 1:-1] + x[1:-1, :-2, 1:-1]))
        + (x[2:, 1:-1, 1:-1] + x[:-2, 1:-1, 1:-1])
    )


def _comb(gm, g0, gp, wp, wm):
    return g0 + wp * (gp - g0) + wm * (gm - g0)


def advect_k1(bs, fields, vel, dt0: float, n_sub: int) -> torch.Tensor:
    """``fields`` ``(F, n, n, n)`` backtraced through ``vel`` at a window of
    one cell in ``n_sub`` substeps of ``dt0`` cells per unit velocity, each
    followed by the faces of the boundary codes ``bs``."""
    n = fields.shape[-1]
    inner = slice(1, n - 1)
    core = (inner,) * 3
    coord = torch.arange(1, n - 1, dtype=torch.float32, device=fields.device)

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
    del fx, fy, fz, v

    def sl(d):
        return slice(1 + d, n - 1 + d)

    for _ in range(n_sub):
        out = []
        for c, b in enumerate(bs):
            f = fields[c]
            planes = []
            for dz in (-1, 0, 1):
                rows = []
                for dy in (-1, 0, 1):
                    g = f[sl(dz), sl(dy)]
                    rows.append(_comb(g[..., sl(-1)], g[..., sl(0)], g[..., sl(1)],
                                      fxp, fxm))
                planes.append(_comb(*rows, fyp, fym))
                del rows
            val = _comb(*planes, fzp, fzm)
            del planes
            field = torch.zeros((n, n, n), dtype=fields.dtype, device=fields.device)
            field[core] = val
            del val
            out.append(_faces(b, field))
        fields = torch.stack(out)
        del out
    return fields


def divergence(vel: torch.Tensor) -> torch.Tensor:
    """``−0.5·((∂vx + ∂vy) + ∂vz)/n`` on the interior, divided by a tensor
    (a Python divisor would be multiplied by its reciprocal on a card)."""
    n = vel.shape[-1]
    vx, vy, vz = vel[0], vel[1], vel[2]
    return (
        -0.5
        * (
            (vx[1:-1, 1:-1, 2:] - vx[1:-1, 1:-1, :-2])
            + (vy[1:-1, 2:, 1:-1] - vy[1:-1, :-2, 1:-1])
            + (vz[2:, 1:-1, 1:-1] - vz[:-2, 1:-1, 1:-1])
        )
        / torch.tensor(float(n), dtype=torch.float32, device=vel.device)
    )


def solve(rhs_int: torch.Tensor, iters: int, sdt: torch.dtype) -> torch.Tensor:
    """``iters`` Jacobi sweeps from zero of ``(rhs + Σ₆p)·(1/6)`` on the
    interior, every iterate rounded to ``sdt``, the scalar faces after each.
    Returns the float32 pressure."""
    n = rhs_int.shape[-1] + 2
    rhs = F.pad(rhs_int.to(sdt), (1, 1, 1, 1, 1, 1)).float()[(slice(1, -1),) * 3]
    p = torch.zeros((n, n, n), dtype=sdt, device=rhs_int.device)
    for _ in range(iters):
        upd = (rhs + _nbr_sum(p.float())) * INV6
        p = _faces(0, F.pad(upd.to(sdt), (1, 1, 1, 1, 1, 1)))
    return p.float()


def gradient(vel: torch.Tensor, p: torch.Tensor, damp: float) -> torch.Tensor:
    """``v − 0.5·(p₊ − p₋)·n`` per component on the interior, each
    component's faces, then ``· damp``."""
    nf = float(vel.shape[-1])
    core = (slice(1, -1),) * 3
    grads = (
        lambda: 0.5 * (p[1:-1, 1:-1, 2:] - p[1:-1, 1:-1, :-2]) * nf,
        lambda: 0.5 * (p[1:-1, 2:, 1:-1] - p[1:-1, :-2, 1:-1]) * nf,
        lambda: 0.5 * (p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1]) * nf,
    )
    comps = []
    for c, g in enumerate(grads):
        comp = vel[c].clone()
        comp[core] = vel[c][core] - g()
        comps.append(_faces(c + 1, comp) * damp)
    return torch.stack(comps)


def sink_factor(dt: float, rate: float) -> float:
    """The implicit sink factor ``1/(1 + dt·rate)``, as the program computes
    it."""
    return float(1.0 / (1.0 + np.float32(dt) * np.float32(rate)))


class Reference:
    """The reference step and frame of one configuration (``sim``, the
    configuration file's settings) on ``device``."""

    def __init__(self, sim: dict, device):
        bad = {k: sim.get(k) for k, v in REQUIRED.items() if sim.get(k, v) != v}
        if bad:
            raise ValueError(f"the reference does not implement these settings: {bad}")
        self.sim = sim
        self.device = torch.device(device)
        self.n = int(math.floor(sim["size"] * sim["resolution_multiplier"] + 0.5))
        self.dt = _f32(sim["time_step"])
        self.n_sub = int(sim["advect_substeps"])
        dt0 = float(np.float32(self.dt) * np.float32(self.n - 2))
        self.dt0 = float(np.float32(dt0 / self.n_sub))
        # The resident kernels round the solve's iterates to the solve dtype;
        # the slab route above the card's L2 solves in float32, so a
        # bfloat16 solve is taken only where the configuration fuses the
        # projection (and its grid fits the resident route).
        self.sdt = SOLVE_DTYPES[sim["solve_dtype"]]
        self.damp = (sink_factor(self.dt, sim["velocity_damping"])
                     if sim["velocity_damping"] else 1.0)
        self.ddamp = (sink_factor(self.dt, sim["density_dissipation"])
                      if sim["density_dissipation"] else 1.0)
        self.emit = self._emitter()

    def _emitter(self) -> torch.Tensor:
        """The emitter's density add, ``strength·max(0, 1 − dist/r)`` over
        the ball, its distance summed ``(dx² + dy²) + dz²`` from the cell
        centres."""
        sim, n, dev = self.sim, self.n, self.device
        nf = np.float32(n)
        res = np.float32(sim["resolution_multiplier"])
        ax = torch.arange(0, n, dtype=torch.float32, device=dev)
        zs, ys, xs = torch.meshgrid(ax, ax, ax, indexing="ij")
        d2 = None
        for i, c in enumerate((xs, ys, zs)):
            d = c - float(np.float32(np.float32(sim["source_position"][i])) * nf)
            d2 = d * d if d2 is None else d2 + d * d
        dist = torch.sqrt(d2)
        radius = torch.full((), float(np.float32(sim["source_radius"]) * res),
                            dtype=torch.float32, device=dev)
        falloff = torch.where(dist <= radius, 1.0 - dist / radius, 0.0)
        strength = float(np.float32(sim["source_strength"]) * np.float32(1.0) * res)
        return strength * falloff

    def step(self, density: torch.Tensor, velocity: torch.Tensor):
        """One step from float32 ``density`` and ``velocity``; returns
        ``(density, velocity, pressure)``."""
        sim = self.sim
        density = density + self.emit
        b, amb, g, dt = (_f32(x) for x in (sim["buoyancy"], sim["ambient_density"],
                                           sim["gravity"], self.dt))
        if sim["buoyancy"] != 0.0 or sim["gravity"] != 0.0:
            accel = b * (density - amb) - g * density
            velocity = velocity.clone()
            velocity[1] = velocity[1] + dt * accel
            del accel
        velocity = advect_k1((1, 2, 3), velocity, velocity, self.dt0, self.n_sub)
        p = solve(divergence(velocity), int(sim["jacobi_iters"]), self.sdt)
        velocity = gradient(velocity, p, self.damp)
        density = advect_k1((0,), density[None], velocity, self.dt0, self.n_sub)[0]
        if sim["density_dissipation"] != 0.0:
            density = density * self.ddamp
        return density, velocity, p

    def steps(self, density, velocity, count: int):
        p = None
        for _ in range(count):
            density, velocity, p = self.step(density, velocity)
        return density, velocity, p

    def render(self, density: torch.Tensor) -> torch.Tensor:
        """The live view's frame: front-to-back emission and absorption down
        z, ``T_k = exp(Σ_{j<k} log1p(−α_j))``; an ``(n, n, 3)`` image."""
        sim = self.sim
        absorption = float(2.0 / max(sim["medium_density_threshold"], 1e-3))
        scale = float(1.0 / max(sim["high_density_threshold"], 1e-3))
        dev = density.device
        tint = torch.tensor(sim["fluid_color"][:3], dtype=density.dtype, device=dev)
        bg = torch.tensor((0.0, 0.0, 0.0), dtype=density.dtype, device=dev)
        alpha = 1.0 - torch.exp(-absorption * density)
        color = tint * (density * scale)[..., None]
        cum = torch.cumsum(torch.log1p(-alpha), dim=0)
        excl = torch.cat([torch.zeros_like(cum[:1]), cum[:-1]], dim=0)
        acc = torch.sum((torch.exp(excl) * alpha)[..., None] * color, dim=0)
        return acc + torch.exp(cum[-1])[..., None] * bg
