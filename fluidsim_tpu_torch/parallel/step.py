"""The 3D step on a mesh of more than one shard, every op on the shards' own
slabs (the JAX package's ``sharded_step_fn`` as XLA's partitioner splits
it; ``parallel/sharding.sharded_step_fn`` builds it).

The order is ``models/stable3d.simulate_step_3d``'s: the emitter, then
buoyancy, vorticity confinement and viscous diffusion; the pre-projection;
the self-advection; the projection; damping, density diffusion and the
density advection; dissipation, noise and obstacle enforcement.  Each op
does on a shard what the whole-volume op does on the shard's planes:

* pointwise ops (the emitter, buoyancy, the sinks, noise) take the slab's
  global z origin;
* stencils read across a shard's edge only through halos: the projection's
  divergence and gradient the neighbours' edge planes of the velocity's z
  component and of the pressure, read in place
  (``parallel/halo.neighbour_planes``); vorticity a two-plane extended slab,
  and with a mask the gradient the velocity's one plane and the pressure's
  two for the obstacle mirror (``parallel/halo.exchange``); the diffusion's
  sweeps one plane a sweep; the mask's one-plane halo is the state's own;
* the pressure solve is ``parallel/halo.jacobi_shards`` (the explicit
  path's backend, or the plain sweeps at one plane a sweep), and the
  advection K11 per shard (``advect_shards``) or the plain advection on
  halo-extended slabs (``advect_shards_plain``); MacCormack composes
  either per shard (``advect_maccormack_shards``: one exchange of the
  velocity, one of the forward field, which the limiter reads too);
* the FFT projection (``pressure_solver="fft"``) is
  ``ops/fft_poisson.project_3d_fft_shards``: the x and y transforms on each
  shard's planes, z-pencils by an all-to-all.

Where the kernels run (``halo="explicit"`` off the ``"xla"`` backend), the
projection's divergence and gradient are K7e on each shard's planes and
halo planes without a mask; with one they are the plain per-shard forms (K7 has no mask
in the JAX package either).  The pre-projection and the diffusion are the
plain forms, as the JAX package's step leaves them to XLA.  The exact
gather of window 0 (its backtrace has no bound, so no fixed halo covers
it) runs through ``parallel/halo.gathered``, the one route that assembles
a whole volume, counted in ``gathered_ops``.

Every op of a shard runs on the shard's own stream and card
(``parallel/streams.ShardOrder``, the mesh's ``order``): the pointwise ops
under ``order.each``, the stencils through ``parallel/halo.py``, whose
cross-shard reads wait on the writers' marks.  The shards' ops run
concurrently, in the order of ``simulate_step_3d`` on each shard.

Every op but the FFT projection is bitwise the whole-volume op on the
shard's planes, so the step is bitwise the unsharded composition with the
same solve and advection; the FFT projection's split transforms round
differently from the whole-volume ones (by about the float32 error of
either).
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..dtypes import scale_in
from ..kernels.halo import rank_walls
from ..kernels.project import divergence_ext_plain, gradient_ext_plain, gradient_slab
from ..models.stable3d import sink_factor
from ..models.step_kernels import StepKernels
from ..ops.advect import advect_maccormack_3d, advect_multi_3d, advect_substep_3d
from ..ops.fft_poisson import project_3d_fft_shards
from ..ops.forces import (
    apply_turbulent_noise_3d,
    buoyancy_force,
    enforce_obstacle_boundaries_slab,
    vorticity_confinement_slab,
)
from ..ops.linsolve import diffusion_coefficients
from ..scene.sources import apply_custom_source
from ..utils.profiling import span
from .halo import (
    advect_maccormack_shards,
    advect_shards,
    advect_shards_plain,
    exchange,
    gathered,
    jacobi_shards,
    neighbour_planes,
)


class ShardStep:
    """One step ``ShardedState -> ShardedState`` on a mesh of ``k > 1``
    shards.  ``advect_kernel`` (decided by ``sharded_step_fn``) routes the
    windowed advection to K11 per shard; ``kernels`` supplies K7e and K10
    to K13."""

    def __init__(self, cfg: SimConfig, mesh, with_source: bool, halo: str, block_iters: int,
                 backend: str, advect_kernel: bool, kernels: StepKernels):
        self.cfg = cfg
        self.devices = mesh.devices
        self.order = mesh.order
        self.k = len(mesh.devices)
        self.n = cfg.current_size
        self.lz = self.n // self.k
        self.with_source = with_source
        self.explicit = halo == "explicit"
        self.block_iters = block_iters
        self.backend = backend
        self.advect_kernel = advect_kernel
        self.kernels = kernels
        # The kernels run per shard where the explicit path is not on the
        # plain backend: K11 (where it applies) and K7e.
        self.use_kernels = self.explicit and backend != "xla" and (
            mesh.devices[0].type == "cuda" or backend in ("pallas", "rdma"))
        self.exchange_backend = "rdma" if self.explicit and backend == "rdma" else "pallas"
        # The global z walls on each shard's planes, and on its one-plane
        # extended slab.
        self.walls = [rank_walls(r, self.k, 0, self.lz) for r in range(self.k)]
        self.ext_walls = [rank_walls(r, self.k, 1, self.lz) for r in range(self.k)]
        # The cards whose memory a phase's span reads at its end.
        self.cards = tuple(dict.fromkeys(d for d in mesh.devices if d.type == "cuda"))

    def _exchange(self, xs, depth, axis):
        return exchange(xs, depth, axis, self.exchange_backend, self.kernels)

    # -- the stencils --------------------------------------------------------

    def vorticity(self, vel, z0s, dt: float):
        ext = self._exchange(vel, 2, 1)
        return self.order.each(lambda r: vorticity_confinement_slab(
            ext[r], dt, self.cfg.vorticity_confinement, z0s[r], self.n))

    def diffuse(self, b: int, xs, diff: float, dt: float, masks):
        """``ops/linsolve.diffuse_3d`` per shard: the plain sweeps (a division
        by ``c``) one plane a sweep, in float32, rounded back."""
        a, c = diffusion_coefficients(self.n, diff, dt)
        in_dtype = xs[0].dtype
        xf = self.order.each(lambda r: xs[r].to(torch.float32))
        out = jacobi_shards(xf, xf, a, c, self.cfg.jacobi_iters, b=b, backend="xla",
                            obsts=None if masks is None else [m[1:-1] for m in masks])
        return self.order.each(lambda r: out[r].to(in_dtype))

    def project(self, vel, masks, pre: bool = False):
        """The projection per shard: the divergence with the z component's
        halo planes, the solve (the explicit path's ``jacobi_shards``, or
        for the pre-projection and ``halo="auto"`` the plain sweeps), the
        gradient with the pressure's halo planes (with a mask, on the
        exchanged slabs the obstacle mirror reads); in float32, rounded back
        to the fields' dtype.  Returns ``(vel, pressure)`` lists."""
        cfg = self.cfg
        in_dtype = vel[0].dtype
        k7e = self.use_kernels and masks is None and not pre
        # K7e takes K11's kept planes as they are, a view with a component
        # stride of its own.
        velf = self.order.each(lambda r: vel[r].to(torch.float32))
        divergence = self.kernels.divergence_ext if k7e else divergence_ext_plain
        # The kernels read a neighbour's plane in place, across cards too; the
        # twins take it on the shard's card.
        in_place = getattr(divergence, "reads_peers", False)
        vz = neighbour_planes([v[2] for v in velf], in_place)
        div = self.order.each(lambda r: divergence(velf[r], *vz[r], *self.walls[r]))
        zeros = self.order.each(lambda r: torch.zeros_like(div[r]))
        local_masks = None if masks is None else [m[1:-1] for m in masks]
        if self.explicit and not pre:
            p = jacobi_shards(zeros, div, 1.0, 6.0, cfg.jacobi_iters, 0, self.block_iters,
                              self.backend, local_masks, self.kernels)
        else:
            p = jacobi_shards(zeros, div, 1.0, 6.0, cfg.jacobi_iters, backend="xla",
                              obsts=local_masks)
        if masks is None:
            gradient = self.kernels.gradient_ext if k7e else gradient_ext_plain
            ph = neighbour_planes(p, getattr(gradient, "reads_peers", False))
            out = self.order.each(lambda r: gradient(velf[r], p[r], *ph[r], *self.walls[r]))
        else:
            # The mirror along z reads the neighbours' post-face planes: the
            # step and the faces on one plane more each side.
            vel_ext = self._exchange(velf, 1, 1)
            p_ext = self._exchange(p, 2, 0)
            out = self.order.each(lambda r: gradient_slab(
                vel_ext[r], p_ext[r], *self.ext_walls[r], masks[r],
                r * self.lz - 1)[:, 1:-1])
        return (self.order.each(lambda r: out[r].to(in_dtype)),
                self.order.each(lambda r: p[r].to(in_dtype)))

    def project_fft(self, vel):
        res = project_3d_fft_shards(vel, self.order)
        return [r[0] for r in res], [r[1] for r in res]

    def advect(self, bs, fields, vel, dt: float, masks):
        """Every advection of the step: K11 per shard, the plain advection on
        halo-extended slabs, MacCormack per shard on either, or (window 0)
        ``gathered``."""
        cfg = self.cfg
        win = cfg.advect_window
        local_masks = None if masks is None else [m[1:-1] for m in masks]
        n_sub = cfg.advect_substeps if cfg.advection_scheme == "substep" else 1
        transport = "rdma" if self.backend == "rdma" else "ppermute"
        if win >= 1 and cfg.advection_scheme == "maccormack":
            return advect_maccormack_shards(bs, fields, vel, dt, self.n, win, local_masks,
                                            transport if self.advect_kernel else "plain",
                                            self.kernels)
        if self.advect_kernel:
            return advect_shards(bs, fields, vel, dt, self.n, win, n_sub, transport,
                                 local_masks, self.kernels)
        if win >= 1:
            return advect_shards_plain(bs, fields, vel, dt, self.n, cfg.advection_scheme, win,
                                       n_sub, local_masks)

        # Window 0, the exact gather: its backtrace has no bound, so no fixed
        # halo covers it.
        def op(f, v, m):
            if cfg.advection_scheme == "maccormack":
                return (advect_maccormack_3d(bs, f, v, dt, m, win),)
            if cfg.advection_scheme == "substep":
                return (advect_substep_3d(bs, f, v, dt, m, win, n_sub=n_sub),)
            return (advect_multi_3d(bs, f, v, dt, m, win),)

        res = gathered("window0", op, [fields, vel, local_masks], (1, 1, 0), (1,), self.devices)
        return [r[0] for r in res]

    # -- the step ------------------------------------------------------------

    def __call__(self, state):
        with span("shard.step"), self.order.scope():
            return self._step(state)

    def _step(self, state):
        cfg = self.cfg
        dt, diff, visc = cfg.effective_params()
        slabs = state.slabs
        z0s = [s.z0 for s in slabs]
        dens = [s.density for s in slabs]
        vel = [s.velocity for s in slabs]
        masks = [s.obstacles for s in slabs] if cfg.enable_obstacle else None
        each = self.order.each
        cards = self.cards

        if self.with_source and cfg.enable_custom_source:
            with span("phase.source", cards):
                pairs = each(lambda r: apply_custom_source(dens[r], vel[r], cfg,
                                                           slabs[r].time + dt, z0=z0s[r]))
                dens, vel = [p[0] for p in pairs], [p[1] for p in pairs]
        with span("phase.forces", cards):
            if cfg.buoyancy != 0.0 or cfg.gravity != 0.0:
                vel = each(lambda r: buoyancy_force(vel[r], dens[r], dt, cfg.buoyancy,
                                                    cfg.ambient_density, cfg.gravity))
            if cfg.vorticity_confinement != 0.0:
                vel = self.vorticity(vel, z0s, dt)
            if visc > 0.0:
                comps = [self.diffuse(c + 1, [v[c] for v in vel], visc, dt, masks)
                         for c in range(3)]
                vel = each(lambda r: torch.stack([comps[c][r] for c in range(3)]))
        if cfg.double_project:
            with span("phase.project", cards):
                vel, _ = self.project(vel, masks, pre=True)

        with span("phase.advect_velocity", cards):
            vel = self.advect((1, 2, 3), vel, vel, dt, masks)
        with span("phase.project", cards):
            if cfg.pressure_solver == "fft":
                if cfg.enable_obstacle:
                    raise ValueError("pressure_solver='fft' requires no obstacles")
                vel, pressure = self.project_fft(vel)
            else:
                vel, pressure = self.project(vel, masks)

        if cfg.velocity_damping != 0.0:
            with span("phase.sinks", cards):
                damp = sink_factor(dt, cfg.velocity_damping)
                vel = each(lambda r: scale_in(vel[r], damp))
        with span("phase.advect_density", cards):
            if diff > 0.0:
                dens = self.diffuse(0, dens, diff, dt, masks)
            dens = [d[0] for d in self.advect((0,), [d[None] for d in dens], vel, dt, masks)]
        if cfg.density_dissipation != 0.0:
            with span("phase.sinks", cards):
                ddamp = sink_factor(dt, cfg.density_dissipation)
                dens = each(lambda r: scale_in(dens[r], ddamp))

        if cfg.apply_turbulent_noise:
            with span("phase.forces", cards):
                vel = each(lambda r: apply_turbulent_noise_3d(vel[r], z0=z0s[r], n=self.n))
        if cfg.enable_obstacle:
            with span("phase.obstacles", cards):
                vel = each(lambda r: enforce_obstacle_boundaries_slab(
                    vel[r], masks[r], cfg.cell_size, cfg.viscosity, z0s[r], self.n))

        return state.replace(slabs=tuple(each(lambda r: slabs[r].replace(
            density=dens[r], velocity=vel[r], pressure=pressure[r], step=slabs[r].step + 1,
            time=slabs[r].time + dt))))
