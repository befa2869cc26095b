"""Explicit halo exchange between z-slab shards, and the solver functions of
the sharded step that run per shard (counterpart of
``fluidsim_tpu/parallel/halo.py``).

A global ``[z, y, x]`` field is cut into ``k = mesh.shape[axis_name]`` slabs
of ``lz = N/k`` planes along z.  The slab-decomposed Jacobi sweep needs each
shard's neighbour planes; ``halo_exchange_z`` hands every shard the edge
slabs of the shards below and above it (zeros past the global edges):

* ``block_iters=1``: one single-plane exchange per sweep;
* ``block_iters=T>1``: the communication-avoiding deep halo, a T-plane
  exchange once per T sweeps.  A T-deep halo covers the dependency cone of T
  sweeps exactly (each sweep erodes one plane of halo validity), so the
  result equals the per-sweep schedule's, with T times fewer exchanges.

Each shard owns its halo-extended slab buffer and its own kernel launches:
K10 (``kernels/halo.jacobi_ext_kernel``) runs the T sweeps of a round, K11
(``kernels/halo.advect_ext_kernel``) the whole substepped advection.  Where
the JAX package's shards run together under ``shard_map``, the port's run
one after another from the host, each round's exchange after every shard's
round.  Every entry of the mesh is one device in this port
(``sharding.mesh_device``), so an exchange is a copy on that device: a
``torch.cat`` of the slabs (``"pallas"``/``"ppermute"``), or on the
``"rdma"`` backend a kernel's stores into the neighbour shards' buffers,
K13 (``kernels/halo.halo_exchange_rdma``) for the extended arrays and K12
(``kernels/halo.jacobi_ext_rdma``) for a round's sweeps and its exchange
together.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..kernels.halo import ext_halo, rank_walls, slab_faces
from ..models.step_kernels import HAND_KERNELS, StepKernels
from .sharding import Mesh, mesh_device


def halo_exchange_z(x_locals: Sequence[torch.Tensor], depth: int = 1,
                    axis: int = 0) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``(below, above)`` for each shard of ``x_locals`` (the shards' local
    slabs, in rank order): ``below`` holds the last ``depth`` z-planes of the
    shard below (zeros at the global bottom), ``above`` the first ``depth``
    planes of the shard above (zeros at the global top), each on its
    shard's device.  ``axis`` is the position of the sharded z axis (0 for a
    plain ``(lz, N, N)`` field, 1 for channel-stacked ``(C, lz, N, N)``
    fields, whose channels are exchanged together).  The slabs are views of
    the neighbours' planes where the devices agree.

    ``depth`` must not exceed the local slab depth: a shard owns only ``lz``
    planes."""
    lz = x_locals[0].shape[axis]
    if depth > lz:
        raise ValueError(f"halo depth={depth} exceeds the local slab depth {lz}")
    k = len(x_locals)
    out = []
    for r, x in enumerate(x_locals):
        if r > 0:
            below = x_locals[r - 1].narrow(axis, lz - depth, depth).to(x.device)
        else:
            below = torch.zeros_like(x.narrow(axis, 0, depth))
        if r < k - 1:
            above = x_locals[r + 1].narrow(axis, 0, depth).to(x.device)
        else:
            above = torch.zeros_like(x.narrow(axis, 0, depth))
        out.append((below, above))
    return out


def _split(x, mesh: Mesh, axis_name: str, axis: int = 0) -> List[torch.Tensor]:
    """The shards' local slabs of the global ``x``: views, ``lz`` planes each
    along ``axis``."""
    k = mesh.shape[axis_name]
    if x.shape[axis] % k:
        raise ValueError(f"z extent {x.shape[axis]} not divisible by {k} shards")
    return list(torch.chunk(x, k, dim=axis))


def _extended(locals_, depth: int, axis: int = 0) -> List[torch.Tensor]:
    """Each shard's halo-extended slab ``[below(depth), local, above(depth)]``,
    a fresh buffer."""
    return [torch.cat([below, x, above], dim=axis)
            for x, (below, above) in zip(locals_, halo_exchange_z(locals_, depth, axis))]


def _ext_faces(b: int, out, rank: int, n_dev: int, halo: int, lz: int):
    """The wall faces of a halo-extended slab as the single-device
    ``set_bnd_3d`` face pass writes them: the global z faces (slab planes
    ``halo`` / ``halo + lz − 1``) only on the first / last shard, y and x
    faces on every plane, z → y → x, with the sign of field code ``b``."""
    return slab_faces(b, out, *rank_walls(rank, n_dev, halo, lz))


def _ext_sweep(b: int, xp, x0_ext, a: float, c_t, rank: int, n_dev: int, halo: int,
               lz: int, obst_ext=None):
    """One Jacobi update ``(x0 + a·nbr) / c`` of the JAX package's plain
    backend on the halo-extended slab ``xp`` ``(lz + 2·halo, N, N)``: every
    interior cell of the slab (its halo planes erode one a sweep), solid
    cells of ``obst_ext`` copying the previous iterate, then ``_ext_faces``.
    ``c_t`` is ``c`` as a 0-d float32 tensor on the slab's device: PyTorch on
    CUDA divides by a Python scalar by multiplying with its reciprocal,
    which is not XLA's division."""
    nbr = (
        ((xp[1:-1, 1:-1, 2:] + xp[1:-1, 1:-1, :-2])
         + (xp[1:-1, 2:, 1:-1] + xp[1:-1, :-2, 1:-1]))
        + (xp[2:, 1:-1, 1:-1] + xp[:-2, 1:-1, 1:-1])
    )
    upd = (x0_ext[1:-1, 1:-1, 1:-1] + a * nbr) / c_t
    if obst_ext is not None:
        upd = torch.where(obst_ext[1:-1, 1:-1, 1:-1], xp[1:-1, 1:-1, 1:-1], upd)
    out = torch.nn.functional.pad(upd, (1, 1, 1, 1, 1, 1))
    return _ext_faces(b, out, rank, n_dev, halo, lz)


def jacobi_3d_sharded(x, x0, a: float, c: float, iters: int, mesh: Mesh,
                      axis_name: str = "z", b: int = 0, block_iters: int = 1,
                      backend: str = "auto", obst=None,
                      kernels: StepKernels = HAND_KERNELS):
    """Slab-sharded fixed-rhs Jacobi with explicit halo exchange: ``iters``
    sweeps from the global ``(N, N, N)`` ``x`` with rhs ``x0`` on the mesh's
    shards, the result the global ``(N, N, N)`` solution (equal to the
    single-device ``jacobi_3d`` for any ``block_iters``).

    ``b`` selects the wall rule as in ``set_bnd_3d``; ``obst`` (``b == 0``
    only) is a bool mask whose solid cells keep the previous iterate (the
    plain backend) or get the coefficient 0 (the kernel; exact where the
    iterate is zero in solids, as in the pressure solve).  The mask's and
    the rhs's halos are exchanged once.  ``block_iters`` (T) sets the
    exchange cadence; ``iters % T == 0`` and ``T <= lz``.

    ``backend``: ``"xla"`` runs the JAX package's plain sweeps on every
    shard's extended slab (``_ext_sweep``, a division by ``c``);
    ``"pallas"`` runs K10 (``kernels.jacobi_ext``; the hand kernels run their
    twins on CPU tensors) once per round per shard on a persistent extended
    buffer whose 2T halo planes alone are refreshed between rounds, after
    normalising the input's faces (the kernel's corrected reads assume
    ``set_bnd``-consistent faces); T >= 2.  ``"rdma"`` does the exchanges
    in kernels, as in the JAX package: one K13
    (``kernels.halo_exchange_rdma``) builds the extended x (faces
    normalised), rhs and mask together, then each round is one K12
    (``kernels.jacobi_ext_rdma``) that sweeps every shard and hands each its next
    extended slab; bitwise the ``"pallas"`` solve; T >= 2.  ``"auto"``
    takes K10 on a CUDA mesh with T >= 2, else the plain sweeps (never
    ``"rdma"``, as in the JAX package)."""
    T = int(block_iters)
    if iters % T:
        raise ValueError(f"iters={iters} not divisible by block_iters={T}")
    if backend not in ("auto", "xla", "pallas", "rdma"):
        raise ValueError(f"backend must be auto/xla/pallas/rdma, got {backend!r}")
    if obst is not None and b != 0:
        raise ValueError(
            "jacobi_3d_sharded: obst requires b == 0 (the scalar set_bnd "
            "contract; velocity components need the obstacle mirror, which this "
            "solver does not implement)")
    device = mesh_device(mesh)
    k = mesh.shape[axis_name]
    lz = x.shape[0] // k
    if T > lz:
        raise ValueError(f"block_iters={T} exceeds the local slab depth {lz}")
    if backend in ("pallas", "rdma") and T < 2:
        raise ValueError(
            f"backend={backend!r} requires block_iters >= 2 (the kernel amortizes T "
            "sweeps per pass; at T=1 it has nothing to amortize)")
    use_kernel = backend == "pallas" or (backend == "auto" and T >= 2
                                         and device.type == "cuda")
    for name, t in (("x", x), ("x0", x0)) + ((("obst", obst),) if obst is not None else ()):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the mesh on {device}")

    if backend == "rdma":
        return _jacobi_rdma(x, x0, a, c, iters, mesh, axis_name, b, T, obst, kernels)
    x0_ext = _extended(_split(x0, mesh, axis_name), T)
    obst_ext = (None if obst is None
                else _extended(_split(obst.to(torch.bool), mesh, axis_name), T))
    mask = (lambda r: None) if obst_ext is None else (lambda r: obst_ext[r])
    locals_ = _split(x, mesh, axis_name)
    rounds = iters // T

    if not use_kernel:
        c_t = torch.tensor(c, dtype=torch.float32, device=device)
        for _ in range(rounds):
            exts = _extended(locals_, T)
            for r in range(k):
                for _ in range(T):
                    exts[r] = _ext_sweep(b, exts[r], x0_ext[r], a, c_t, r, k, T, lz, mask(r))
            locals_ = [e[T:T + lz] for e in exts]
        return torch.cat(locals_)

    kernel = kernels.jacobi_ext
    exts = _extended([_ext_faces(b, x_r, r, k, 0, lz) for r, x_r in enumerate(locals_)], T)
    for rnd in range(rounds):
        exts = [kernel(exts[r], x0_ext[r], a, c, T, *rank_walls(r, k, T, lz), b, mask(r))
                for r in range(k)]
        if rnd + 1 < rounds:
            # Only the 2T halo planes are refreshed; the exchange reads the
            # shards' valid planes, which no shard's refresh writes.
            pairs = halo_exchange_z([e[T:T + lz] for e in exts], T)
            for e, (below, above) in zip(exts, pairs):
                e[:T].copy_(below)
                e[T + lz:].copy_(above)
    return torch.cat([e[T:T + lz] for e in exts])


def _jacobi_rdma(x, x0, a, c, iters, mesh, axis_name, b, T, obst, kernels):
    """The ``"rdma"`` backend of ``jacobi_3d_sharded`` (JAX
    ``parallel/halo.py:390-424``): the input's faces normalised per shard,
    one exchange that primes x, x0 and the mask together, ``iters / T``
    rounds of K12, the local planes."""
    k = mesh.shape[axis_name]
    lz = x.shape[0] // k
    x0_locals = _split(x0, mesh, axis_name)
    obst_locals = None if obst is None else _split(obst.to(torch.bool), mesh, axis_name)
    prime = []
    for r, x_r in enumerate(_split(x, mesh, axis_name)):
        arrays = [_ext_faces(b, x_r, r, k, 0, lz)[None], x0_locals[r][None]]
        if obst_locals is not None:
            arrays.append(obst_locals[r][None])
        prime.append(arrays)
    exts = kernels.halo_exchange_rdma(prime, T)
    xps = [e[0][0] for e in exts]
    x0_exts = [e[1][0] for e in exts]
    obst_exts = None if obst is None else [e[2][0] for e in exts]
    for _ in range(iters // T):
        xps = kernels.jacobi_ext_rdma(xps, x0_exts, a, c, T, b, obst_exts)
    return torch.cat([e[T:T + lz] for e in xps])


def advect_multi_3d_sharded(bs, fields, vel, dt: float, mesh: Mesh, axis_name: str = "z",
                            window: int = 1, n_sub: int = 1, transport: str = "ppermute",
                            obst=None, kernels: StepKernels = HAND_KERNELS):
    """Slab-sharded windowed substepped advection with explicit halo exchange
    and per-shard K11 (``kernels.advect_ext``; the hand kernels run their
    twins on CPU tensors).  ``fields`` ``(F, N, N, N)`` (F = 1 or 3) and ``vel``
    ``(3, N, N, N)`` are global tensors of one dtype, float32 or bfloat16;
    the result is the global advected ``(F, N, N, N)``, equal to
    ``ops.advect.advect_substep_3d`` through K1 on the whole grid.

    The backtrace is clamped to ``window`` cells a substep, so a
    ``window·n_sub``-plane halo covers every sample (``n_sub·(window+1)``
    with the bool mask ``obst``, whose mirror reads one plane further each
    substep): one exchange of the fields, the velocity and the mask a call.
    Self-advection (``fields is vel``, ``bs == (1, 2, 3)``) shares one
    exchange.  ``transport="ppermute"`` builds each shard's extended slabs
    with ``torch.cat`` when its turn comes; ``"rdma"`` builds every shard's
    in one K13 call (``kernels.halo_exchange_rdma``) that
    carries the fields, the velocity and the mask, as in the JAX package:
    the same slabs, so the same result bitwise."""
    if transport not in ("ppermute", "rdma"):
        raise ValueError(f"transport must be ppermute/rdma, got {transport!r}")
    device = mesh_device(mesh)
    n = fields.shape[-1]
    k = mesh.shape[axis_name]
    lz = fields.shape[1] // k
    has_obst = obst is not None
    h = ext_halo(window, n_sub, has_obst)
    if h > lz:
        kind = "n_sub·(window+1), obstacle mirror" if has_obst else "window·n_sub"
        raise ValueError(f"advect halo {h} ({kind}) exceeds local slab depth {lz}")
    for name, t in (("fields", fields), ("vel", vel)) + (
            (("obst", obst),) if has_obst else ()):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the mesh on {device}")
    self_adv = fields is vel and tuple(bs) == (1, 2, 3) and fields.shape[0] == 3

    def exchanged(x, axis):
        """Each shard's extended slab, built when its turn comes (so one
        shard's buffers live at a time): the exchange hands out views."""
        locals_ = _split(x, mesh, axis_name, axis)
        pairs = halo_exchange_z(locals_, h, axis)
        return lambda r: torch.cat([pairs[r][0], locals_[r], pairs[r][1]], dim=axis)

    if transport == "rdma":
        arrays = [[v] if self_adv else [f, v] for f, v in
                  zip(_split(fields, mesh, axis_name, 1), _split(vel, mesh, axis_name, 1))]
        if has_obst:
            for arrays_r, m in zip(arrays, _split(obst.to(torch.bool), mesh, axis_name)):
                arrays_r.append(m[None])
        exts = kernels.halo_exchange_rdma(arrays, h)
        v_ext = (lambda r: exts[r][0]) if self_adv else (lambda r: exts[r][1])
        f_ext = None if self_adv else (lambda r: exts[r][0])
        m_ext = None if not has_obst else (lambda r: exts[r][-1][0])
    else:
        v_ext = exchanged(vel, 1)
        f_ext = None if self_adv else exchanged(fields, 1)
        m_ext = None if not has_obst else exchanged(obst.to(torch.bool), 0)
    out = torch.empty_like(fields)
    for r in range(k):
        v = v_ext(r)
        res = kernels.advect_ext(tuple(bs), v if self_adv else f_ext(r), v, n, dt, r * lz - h,
                                 window, n_sub, None if m_ext is None else m_ext(r))
        out[:, r * lz:(r + 1) * lz].copy_(res[:, h:h + lz])
    return out
