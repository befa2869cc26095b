"""Spatial domain decomposition of the 3D step into z-slab shards
(counterpart of ``fluidsim_tpu/parallel/sharding.py``).

The scaling axis of the product (BASELINE config 5: 512³ across eight chips)
is a slab decomposition: the ``[z, y, x]`` grid is cut along z (axis 0 of a
field, axis 1 of the velocity) into the shards of a 1-D mesh.  A sharded
state (``ShardedState``, from ``shard_state``) holds one slab ``FluidState``
per shard on the shard's device, each owning its storage: its ``lz`` planes
of the density, the velocity and the pressure, and its mask with one plane
of each neighbour's.  ``unshard_state`` gives the global state back, the
pair standing where the JAX package's ``device_put`` and global arrays do.

Every op of the step runs on the slabs (``parallel/step.py``), halos
exchanged only where a stencil reads across a shard's edge, the global
volume never assembled (but for window 0's exact gather, which
``parallel/halo.gathered`` counts: its backtrace has no bound).  The FFT
projection transposes z-slabs to z-pencils and back by all-to-alls
(``ops/fft_poisson.project_3d_fft_shards``).  Two strategies, as in the
JAX package:

* ``halo="auto"``: the JAX package's auto-partitioned program, the plain
  step per shard with one-plane exchanges a sweep, which equals the
  unsharded step;
* ``halo="explicit"``: the pressure solve and the advection run per shard
  with explicit halo exchanges (``parallel/halo.py``): K10 and K11 on each
  shard's extended slab, or on the ``"rdma"`` backend K12 and K11, every
  exchange a kernel's (K12's rounds, K13's extended arrays); the
  projection's divergence and gradient are K7e on each shard's extended
  slab.

A mesh here is a list of devices, one per shard in rank order, which may
repeat and may name distinct cards: ``make_mesh(["cuda"] * 8)`` is eight
shards on one card, ``["cuda:0"] * 4 + ["cuda:1"] * 4`` eight over two cards
(``cli.mesh_devices`` maps N shards onto the visible cards so).  Each shard
owns its slab buffers, its kernel launches and, on CUDA, a stream of its own
on its card (eight shards on one card get eight streams); events between
the shards' streams (``parallel/streams.ShardOrder``) order every read or
store across shards.  Neighbouring shards on distinct cards reach each
other's buffers through peer pointers (K12 and K13 store their halo planes
into the neighbours' buffers, K7e reads the neighbours' edge planes in
place): ``make_mesh`` turns peer access on, and raises for a pair of cards
that cannot reach each other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..config import SimConfig
from ..models.step_kernels import HAND_KERNELS, StepKernels
from ..state import FluidState
from .streams import order_for


class Mesh:
    """A 1-D mesh of shards: ``devices`` (one ``torch.device`` per shard, in
    rank order, all of one type), ``axis_names`` and ``shape``
    (``{axis_name: shards}``), read as the JAX ``Mesh``'s are; ``order``,
    the shards' ``parallel/streams.ShardOrder``, and ``streams``, its
    ``torch.cuda.Stream`` a shard on CUDA (None on the CPU)."""

    def __init__(self, devices: Sequence, axis_names=("z",)):
        if len(devices) < 1:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(_device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = {self.axis_names[0]: len(self.devices)}
        self.order = order_for(self.devices)
        self.streams = self.order.streams

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA device with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a 'cuda' mesh entry")
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = "z") -> Mesh:
    """1-D mesh for slab decomposition.  ``devices`` defaults to every
    visible CUDA device (raises without one: there is no CPU default).
    Entries may repeat and may name distinct cards, in rank order:
    ``make_mesh(["cuda"] * 8)`` is eight shards on one card,
    ``make_mesh([f"cuda:{i}" for i in range(8)])`` one a card,
    ``make_mesh(["cpu"] * 4)`` four on the CPU.  A mesh that mixes device
    types raises; so does one where two neighbouring cards cannot reach each
    other's memory (peer access is turned on for every such pair)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: name the mesh's devices, "
                               "e.g. make_mesh(['cpu'] * 4)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices, (axis_name,))


def state_sharding(mesh: Mesh, axis_name: str = "z") -> FluidState:
    """For each ``FluidState`` leaf, the axis it is split along z: 0 for the
    ``[z, y, x]`` fields and the mask, 1 for the ``(3, z, y, x)`` velocity,
    None for the scalars."""
    return FluidState(density=0, velocity=1, pressure=0, obstacles=0, step=None, time=None)


@dataclasses.dataclass(frozen=True)
class SlabState(FluidState):
    """One shard's part of a sharded state: ``density`` and ``pressure``
    ``(lz, N, N)``, ``velocity`` ``(3, lz, N, N)``, ``obstacles`` ``(lz + 2,
    N, N)`` (the shard's mask between one plane of each neighbour's, False
    past the global ends), ``step`` and ``time`` (every shard's the same),
    all on the shard's device; ``rank`` and ``z0``, the global z of plane
    0."""

    rank: int = 0
    z0: int = 0


@dataclasses.dataclass(frozen=True)
class ShardedState:
    """A state on a mesh: one ``SlabState`` per shard, in rank order."""

    slabs: Tuple[SlabState, ...]

    @property
    def step(self) -> torch.Tensor:
        return self.slabs[0].step

    @property
    def time(self) -> torch.Tensor:
        return self.slabs[0].time

    def replace(self, **kw) -> "ShardedState":
        return dataclasses.replace(self, **kw)


def _own(x: torch.Tensor, device) -> torch.Tensor:
    """A contiguous copy of ``x`` on ``device`` with storage of its own."""
    return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)


def shard_state(state: FluidState, mesh: Mesh, axis_name: str = "z") -> ShardedState:
    """Place an (unsharded) state onto the mesh: the z extent must split into
    the mesh's shards; shard r's slab, copied onto ``mesh.devices[r]``, holds
    planes ``[r·lz, (r+1)·lz)`` and its mask one plane of each neighbour's
    (the mask is static: this is its one exchange).  The copies run on the
    caller's current streams, which a step's shards wait on."""
    k = mesh.shape[axis_name]
    n = state.density.shape[0]
    if n % k:
        raise ValueError(f"z extent {n} not divisible by {k} shards")
    lz = n // k
    mask = torch.nn.functional.pad(state.obstacles.to(torch.bool), (0, 0, 0, 0, 1, 1))
    slabs = []
    for r, dev in enumerate(mesh.devices):
        z0 = r * lz
        slabs.append(SlabState(
            density=_own(state.density[z0:z0 + lz], dev),
            velocity=_own(state.velocity[:, z0:z0 + lz], dev),
            pressure=_own(state.pressure[z0:z0 + lz], dev),
            obstacles=_own(mask[z0:z0 + lz + 2], dev),
            step=_own(state.step, dev),
            time=_own(state.time, dev),
            rank=r,
            z0=z0,
        ))
    return ShardedState(tuple(slabs))


def unshard_state(sharded: ShardedState) -> FluidState:
    """The global ``FluidState`` of a sharded state, gathered onto the first
    shard's device (``mesh.devices[0]``; for checkpoints, renders and tests),
    on the caller's current streams, which a step's exit orders after its
    shards."""
    slabs = sharded.slabs
    dev = slabs[0].density.device
    return FluidState(
        density=torch.cat([s.density.to(dev) for s in slabs]),
        velocity=torch.cat([s.velocity.to(dev) for s in slabs], dim=1),
        pressure=torch.cat([s.pressure.to(dev) for s in slabs]),
        obstacles=torch.cat([s.obstacles[1:-1].to(dev) for s in slabs]),
        step=slabs[0].step,
        time=slabs[0].time,
    )


def sharded_step_fn(cfg: SimConfig, mesh: Mesh, axis_name: str = "z", n_substeps: int = 1,
                    with_source: bool = True, halo: str = "auto", halo_block_iters: int = 1,
                    halo_backend: str = "auto", kernels: StepKernels = HAND_KERNELS):
    """The full 3D step for a ``ShardedState`` on ``mesh``, as a function
    ``ShardedState -> ShardedState`` running ``n_substeps`` steps.

    ``halo`` selects the strategy for the stencils:

    * ``"auto"``: the plain step per shard (``parallel/step.py``), the
      solve's exchanges one plane a sweep, the advection on halo-extended
      slabs: what the JAX package's auto-partitioned program computes, the
      unsharded step's values.
    * ``"explicit"``: the pressure solve routes through
      ``parallel.halo.jacobi_shards`` (T-deep halos every T =
      ``halo_block_iters`` sweeps; ``halo_backend`` ``"pallas"`` runs K10 per
      shard, ``"xla"`` the plain sweeps, ``"auto"`` K10 on a CUDA mesh at
      T >= 2), and the advection through ``parallel.halo.advect_shards``
      (K11 per shard; MacCormack's forward and backward advections
      through ``parallel.halo.advect_maccormack_shards``) where the window
      is K >= 1 cells and the halo fits a shard, unless
      ``halo_backend="xla"`` (or ``"auto"`` off the card); where the kernels
      run, the projection's divergence and gradient are K7e per shard
      without a mask.  Obstacle scenes run both, the mask's halo riding the
      exchanges.  ``halo_backend="rdma"`` does every exchange in kernels:
      the solve's rounds in K12, its priming, each advection's slabs and
      the projection's one-plane halos in K13 (bitwise the ``"pallas"``
      step).  Fields may be float32 or bfloat16 (``cfg.dtype``): K11 takes
      either, the solve and the projection are float32.

    ``kernels`` supplies K7e and K10 to K13 (``divergence_ext``,
    ``gradient_ext``, ``jacobi_ext``, ``advect_ext``, ``jacobi_ext_rdma``,
    ``halo_exchange_rdma``) and, on a one-shard mesh, the single-card
    kernels; ``PLAIN_TWINS`` runs the same path on the twins.  On a one-shard
    mesh the slab is the whole volume and the step is
    ``models.stable3d.simulate_step_3d`` (with the explicit hooks on the
    global wrappers for ``halo="explicit"``).  On a mesh of more than one
    shard the single-card kernels never run (``kernel_backend="pallas"``
    raises), as in the JAX package.  The emitter is applied by
    ``apply_custom_source`` each step, per shard."""
    from ..kernels.halo import ext_halo
    from .step import ShardStep

    if cfg.ndim != 3:
        raise ValueError("sharded_step_fn is for the 3D engine")
    if halo not in ("auto", "explicit"):
        raise ValueError(f"halo must be 'auto' or 'explicit', got {halo!r}")
    if halo == "auto" and halo_block_iters != 1:
        raise ValueError(
            "halo_block_iters only applies to halo='explicit' (the auto path's "
            "exchange cadence is not the caller's); pass halo='explicit' to use the "
            "communication-avoiding schedule")
    if halo_backend not in ("auto", "xla", "pallas", "rdma"):
        raise ValueError(f"halo_backend must be auto/xla/pallas/rdma, got {halo_backend!r}")
    device = mesh.devices[0]
    k = mesh.shape[axis_name]
    if halo == "explicit" and cfg.pressure_solver == "fft":
        raise ValueError(
            "halo='explicit' replaces the Jacobi pressure solve and cannot be "
            "combined with pressure_solver='fft'")
    n = cfg.current_size
    n_sub = cfg.advect_substeps if cfg.advection_scheme == "substep" else 1
    h = ext_halo(cfg.advect_window, n_sub, bool(cfg.enable_obstacle))
    # K11 per shard: a window and a halo that fits (MacCormack runs it for
    # its forward and backward advections).
    advect_kernel = (halo == "explicit" and halo_backend != "xla"
                     and cfg.advect_window >= 1 and h <= n // k
                     and (device.type == "cuda" or halo_backend in ("pallas", "rdma")))

    # On a mesh of more than one shard the single-card kernels would run on
    # the whole volume, not per shard: as in the JAX package, they are off
    # there, and asking for them is an error.
    if k > 1 and cfg.kernel_backend != "xla":
        if cfg.kernel_backend == "pallas":
            raise ValueError(
                "kernel_backend='pallas' (single-card kernels) cannot run on a "
                "multi-shard mesh; use halo='explicit', halo_backend='pallas' for "
                "per-shard kernels")
        cfg = cfg.replace(kernel_backend="xla")

    if k > 1:
        one = ShardStep(cfg, mesh, with_source, halo, halo_block_iters, halo_backend,
                        advect_kernel, kernels)
    else:
        one = _one_shard_step(cfg, mesh, with_source, halo, halo_block_iters, halo_backend,
                              advect_kernel, kernels)

    def step(state: ShardedState) -> ShardedState:
        if len(state.slabs) != k:
            raise ValueError(f"the state has {len(state.slabs)} slabs, the mesh {k} shards: "
                             "place it with shard_state")
        for r, (s, dev) in enumerate(zip(state.slabs, mesh.devices)):
            if s.density.device != dev:
                raise ValueError(f"slab {r} is on {s.density.device}, its shard on {dev}: "
                                 "place the state with shard_state")
        with mesh.order.scope():
            for _ in range(n_substeps):
                state = one(state)
        return state

    return step


def _one_shard_step(cfg, mesh, with_source, halo, halo_block_iters, halo_backend,
                    advect_kernel, kernels):
    """The step on a one-shard mesh: ``simulate_step_3d`` on the slab, the
    whole volume (with the single-card kernels; for ``halo="explicit"`` with
    its hooks on ``jacobi_3d_sharded`` and ``advect_multi_3d_sharded``)."""
    from ..kernels.project import resident_route
    from ..models.stable3d import simulate_step_3d
    from ..scene.sources import apply_custom_source

    device = mesh.devices[0]
    dt = cfg.effective_params()[0]
    jacobi_fn = advect_fn = None
    if halo == "explicit":
        from .halo import advect_multi_3d_sharded, jacobi_3d_sharded

        transport = "rdma" if halo_backend == "rdma" else "ppermute"
        n_sub = cfg.advect_substeps if cfg.advection_scheme == "substep" else 1

        def jacobi_fn(p, div, iters, obst=None):
            return jacobi_3d_sharded(p, div, 1.0, 6.0, iters, mesh, b=0,
                                     block_iters=halo_block_iters, backend=halo_backend,
                                     obst=obst, kernels=kernels)

        # MacCormack on one shard is the whole-volume step's, on K1.
        if advect_kernel and cfg.advection_scheme != "maccormack":
            def advect_fn(bs, fields, velocity, d_t, obst=None):
                return advect_multi_3d_sharded(bs, fields, velocity, float(d_t), mesh,
                                               window=cfg.advect_window, n_sub=n_sub,
                                               transport=transport, obst=obst,
                                               kernels=kernels)

    resident = resident_route(cfg.current_size, cfg.solve_dtype, device)

    def one(state: ShardedState) -> ShardedState:
        with mesh.order.on(0):
            return on_the_shard(state)

    def on_the_shard(state: ShardedState) -> ShardedState:
        slab = state.slabs[0]
        glob = FluidState(density=slab.density, velocity=slab.velocity,
                          pressure=slab.pressure, obstacles=slab.obstacles[1:-1],
                          step=slab.step, time=slab.time)
        if with_source and cfg.enable_custom_source:
            density, velocity = apply_custom_source(glob.density, glob.velocity, cfg,
                                                    glob.time + dt)
            glob = glob.replace(density=density, velocity=velocity)
        out = simulate_step_3d(glob, cfg, kernels, resident, jacobi_fn=jacobi_fn,
                               advect_fn=advect_fn)
        return state.replace(slabs=(slab.replace(
            density=out.density, velocity=out.velocity, pressure=out.pressure,
            step=out.step, time=out.time),))

    return one
