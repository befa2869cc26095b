"""Spatial domain decomposition of the 3D step into z-slab shards
(counterpart of ``fluidsim_tpu/parallel/sharding.py``).

The scaling axis of the product (BASELINE config 5: 512³ across eight chips)
is a slab decomposition: the ``[z, y, x]`` grid is cut along z (axis 0 of a
field, axis 1 of the velocity) into the shards of a 1-D mesh.  Two paths, as
in the JAX package:

* ``halo="auto"``: the unsharded step.  The JAX package jits the unchanged
  solver with sharded inputs and lets XLA's partitioner insert the halo
  collectives, which gives the unsharded values; the port runs that step.
* ``halo="explicit"``: the pressure solve and the advection run per shard
  with explicit halo exchanges (``parallel/halo.py``): K10 and K11 on each
  shard's extended slab, or on the ``"rdma"`` backend K12 and K11, every
  exchange a kernel's (K12's rounds, K13's extended arrays).

A mesh here is a list of devices, one per shard, which may repeat:
``make_mesh(["cuda"] * 8)`` is eight shards on one card, each with its own
slab buffers and kernel launches, the programs a multi-card mesh runs.  In
this port every entry of a mesh must be the same device: the global state
lives there and the parts of the step that the JAX package leaves to XLA's
partitioner (the emitter, buoyancy, the projection's divergence and
gradient, the sinks) run on it as whole-tensor ops, which the partitioner's
values equal.  A mesh over distinct cards needs those ops partitioned and
K12 and K13 given peer pointers to the neighbours' buffers and a
cross-device event a round: the multi-card slice.  ``mesh_device`` raises
for such a mesh.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import SimConfig
from ..models.step_kernels import HAND_KERNELS, StepKernels
from ..state import FluidState

MULTI_CARD = ("the multi-card slice (distinct devices per shard: peer pointers into "
              "K12/K13, a cross-device event a round, the partitioned whole-volume ops)")


class Mesh:
    """A 1-D mesh of shards: ``devices`` (one ``torch.device`` per shard, in
    rank order), ``axis_names`` and ``shape`` (``{axis_name: shards}``), read
    as the JAX ``Mesh``'s are."""

    def __init__(self, devices: Sequence, axis_names=("z",)):
        if len(devices) < 1:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(_device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = {self.axis_names[0]: len(self.devices)}

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


def mesh_device(mesh: Mesh) -> torch.device:
    """The one device every entry of ``mesh`` names; raises for a mesh over
    distinct devices."""
    devices = set(mesh.devices)
    if len(devices) != 1:
        raise NotImplementedError(
            f"a mesh over distinct devices ({sorted(str(d) for d in devices)}) is not "
            f"ported: every entry of a mesh must be one device until {MULTI_CARD}")
    return mesh.devices[0]


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = "z") -> Mesh:
    """1-D mesh for slab decomposition.  ``devices`` defaults to every
    visible CUDA device (raises without one: there is no CPU default).
    Entries may repeat: ``make_mesh(["cuda"] * 8)`` is eight shards on one
    card, ``make_mesh(["cpu"] * 4)`` four on the CPU.  Every entry must be
    the same device (``mesh_device``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: name the mesh's devices, "
                               "e.g. make_mesh(['cpu'] * 4)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = Mesh(devices, (axis_name,))
    mesh_device(mesh)
    return mesh


def state_sharding(mesh: Mesh, axis_name: str = "z") -> FluidState:
    """For each ``FluidState`` leaf, the axis it is split along z: 0 for the
    ``[z, y, x]`` fields and the mask, 1 for the ``(3, z, y, x)`` velocity,
    None for the scalars."""
    mesh_device(mesh)
    return FluidState(density=0, velocity=1, pressure=0, obstacles=0, step=None, time=None)


def shard_state(state: FluidState, mesh: Mesh, axis_name: str = "z") -> FluidState:
    """Place an (unsharded) state onto the mesh: the z extent must split
    into the mesh's shards; every leaf goes to the mesh's device."""
    device = mesh_device(mesh)
    k = mesh.shape[axis_name]
    n = state.density.shape[0]
    if n % k:
        raise ValueError(f"z extent {n} not divisible by {k} shards")
    return state.replace(**{f: getattr(state, f).to(device) for f in
                            ("density", "velocity", "pressure", "obstacles", "step", "time")})


def sharded_step_fn(cfg: SimConfig, mesh: Mesh, axis_name: str = "z", n_substeps: int = 1,
                    with_source: bool = True, halo: str = "auto", halo_block_iters: int = 1,
                    halo_backend: str = "auto", kernels: StepKernels = HAND_KERNELS):
    """The full 3D step for a slab-sharded state on ``mesh``, as a function
    ``state -> state`` running ``n_substeps`` steps.

    ``halo`` selects the strategy for the stencils:

    * ``"auto"``: the unsharded step (``models.stable3d.simulate_step_3d``).
      On a one-device mesh, which every mesh of this port is, that is what
      the JAX package's auto-partitioned program computes.
    * ``"explicit"``: the pressure solve routes through
      ``parallel.halo.jacobi_3d_sharded`` (T-deep halos every T =
      ``halo_block_iters`` sweeps; ``halo_backend`` ``"pallas"`` runs K10 per
      shard, ``"xla"`` the plain sweeps, ``"auto"`` K10 on a CUDA mesh at
      T >= 2), and the advection through
      ``parallel.halo.advect_multi_3d_sharded`` (K11 per shard) where the
      scheme is semi-Lagrangian or substep, the window is K >= 1 cells and
      the halo fits a shard, unless ``halo_backend="xla"`` (or ``"auto"`` off the
      card).  Obstacle scenes run both, the mask's halo riding the
      exchanges.  ``halo_backend="rdma"`` does every exchange in kernels:
      the solve's rounds in K12, its priming and each advection's slabs in
      K13 (bitwise the ``"pallas"`` step).  Fields may be float32 or
      bfloat16 (``cfg.dtype``): K11 takes either, the solve is float32.

    ``kernels`` supplies K10 to K13 (``jacobi_ext``, ``advect_ext``,
    ``jacobi_ext_rdma``, ``halo_exchange_rdma``) and, on
    a one-shard mesh, the single-card kernels; ``PLAIN_TWINS`` runs the same
    path on the twins.  On a mesh of more than one shard the single-card
    kernels never run (``kernel_backend="pallas"`` raises), as in the JAX
    package.  The emitter is applied by ``apply_custom_source`` each step."""
    from ..kernels.halo import ext_halo
    from ..kernels.project import resident_route
    from ..models.stable3d import simulate_step_3d
    from ..scene.sources import apply_custom_source

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
    device = mesh_device(mesh)
    k = mesh.shape[axis_name]
    jacobi_fn = advect_fn = None
    if halo == "explicit":
        from .halo import advect_multi_3d_sharded, jacobi_3d_sharded

        if cfg.pressure_solver == "fft":
            raise ValueError(
                "halo='explicit' replaces the Jacobi pressure solve and cannot be "
                "combined with pressure_solver='fft'")
        transport = "rdma" if halo_backend == "rdma" else "ppermute"

        def jacobi_fn(p, div, iters, obst=None):
            return jacobi_3d_sharded(p, div, 1.0, 6.0, iters, mesh, axis_name, b=0,
                                     block_iters=halo_block_iters, backend=halo_backend,
                                     obst=obst, kernels=kernels)

        n = cfg.current_size
        n_sub = cfg.advect_substeps if cfg.advection_scheme == "substep" else 1
        h = ext_halo(cfg.advect_window, n_sub, bool(cfg.enable_obstacle))
        feasible = (cfg.advection_scheme in ("semi_lagrangian", "substep")
                    and cfg.advect_window >= 1 and h <= n // k)
        if (halo_backend != "xla" and feasible
                and (device.type == "cuda" or halo_backend in ("pallas", "rdma"))):

            def advect_fn(bs, fields, velocity, d_t, obst=None):
                return advect_multi_3d_sharded(bs, fields, velocity, float(d_t), mesh,
                                               axis_name, window=cfg.advect_window,
                                               n_sub=n_sub, transport=transport, obst=obst,
                                               kernels=kernels)

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
    resident = resident_route(cfg.current_size, cfg.solve_dtype, device)
    dt = cfg.effective_params()[0]

    def one(state: FluidState) -> FluidState:
        if with_source and cfg.enable_custom_source:
            t = state.time + dt
            density, velocity = apply_custom_source(state.density, state.velocity, cfg, t)
            state = state.replace(density=density, velocity=velocity)
        return simulate_step_3d(state, cfg, kernels, resident, jacobi_fn=jacobi_fn,
                                advect_fn=advect_fn)

    def step(state: FluidState) -> FluidState:
        if state.density.device != device:
            raise ValueError(f"the state is on {state.density.device}, the mesh on {device}: "
                             "place it with shard_state")
        if state.density.shape[0] % k:
            raise ValueError(f"z extent {state.density.shape[0]} not divisible by {k} shards")
        for _ in range(n_substeps):
            state = one(state)
        return state

    return step
