"""Explicit halo exchange between z-slab shards, the solver functions of
the sharded step that run per shard, and the one route that gathers
(counterpart of ``fluidsim_tpu/parallel/halo.py``).

A ``[z, y, x]`` field of the ``N³`` grid is held as ``k = mesh.shape[axis_name]``
slabs of ``lz = N/k`` planes along z, one per shard (``sharding.ShardedState``).
A stencil that reads across a shard's edge needs the neighbours' planes;
``halo_exchange_z`` hands every shard the edge slabs of the shards below and
above it (zeros past the global edges), ``extend`` and ``exchange`` build
each shard's halo-extended slab from them:

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
round.  An exchange is a copy onto the shard's device: a ``torch.cat`` of
the slabs (``"pallas"``/``"ppermute"``), or on the ``"rdma"`` backend a
kernel's stores into the neighbour shards' buffers, K13
(``kernels/halo.halo_exchange_rdma``) for the extended arrays and K12
(``kernels/halo.jacobi_ext_rdma``) for a round's sweeps and its exchange
together.

``jacobi_shards`` and ``advect_shards`` take and return the shards' slabs
(the sharded step's own); ``jacobi_3d_sharded`` and
``advect_multi_3d_sharded`` are their forms on global tensors (split, per
shard, joined), which the JAX package's functions take.
``advect_shards_plain`` is the plain advection per shard.  ``gathered`` is
the one route that assembles a whole volume: an op that no halo bounds runs
on the all-gathered inputs and each shard keeps its planes, counted in
``gathered_ops``.
"""

from __future__ import annotations

import collections
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..kernels.halo import _mirror_ext, _nonborder_solid, ext_halo, rank_walls, slab_faces
from ..models.step_kernels import HAND_KERNELS, StepKernels
from ..ops.advect import advect_substep_3d, window_sum_3d
from .sharding import Mesh, mesh_device

# Calls of ``gathered`` by op name: the ops that still assemble a whole
# volume inside a sharded step.
gathered_ops: collections.Counter = collections.Counter()


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


def neighbour_planes(xs: Sequence[torch.Tensor]) -> List[Tuple]:
    """The one-plane halos of the shards' ``(lz, N, N)`` slabs ``xs`` that
    K7e reads in place: ``(below, above)`` for each shard, the last plane of
    the shard below and the first of the shard above, None past the global
    ends.  Each is a view of the neighbour's storage, copied onto the
    shard's device only where that differs: no slab is assembled."""
    k = len(xs)
    return [(xs[r - 1][-1].to(x.device) if r > 0 else None,
             xs[r + 1][0].to(x.device) if r < k - 1 else None) for r, x in enumerate(xs)]


def _split(x, mesh: Mesh, axis_name: str, axis: int = 0) -> List[torch.Tensor]:
    """The shards' local slabs of the global ``x``: views, ``lz`` planes each
    along ``axis``."""
    k = mesh.shape[axis_name]
    if x.shape[axis] % k:
        raise ValueError(f"z extent {x.shape[axis]} not divisible by {k} shards")
    return list(torch.chunk(x, k, dim=axis))


def extend(xs: Sequence[torch.Tensor], depth: int, axis: int = 0) -> List[torch.Tensor]:
    """Each shard's slab of ``xs`` between ``depth`` planes of the shards
    below and above it along ``axis`` (from as many shards as ``depth``
    spans; zeros past the global ends), a fresh buffer on the shard's
    device."""
    lz = xs[0].shape[axis]
    if depth <= lz:
        return [torch.cat([below, x, above], dim=axis)
                for x, (below, above) in zip(xs, halo_exchange_z(xs, depth, axis))]
    k = len(xs)
    out = []
    for r, x in enumerate(xs):
        parts, z, hi = [], r * lz - depth, (r + 1) * lz + depth
        while z < hi:
            s = z // lz
            if 0 <= s < k:
                end = min(hi, (s + 1) * lz)
                parts.append(xs[s].narrow(axis, z - s * lz, end - z).to(x.device))
            else:
                end = min(hi, 0) if s < 0 else hi
                shape = list(x.shape)
                shape[axis] = end - z
                parts.append(x.new_zeros(shape))
            z = end
        out.append(torch.cat(parts, dim=axis))
    return out


def exchange(xs: Sequence[torch.Tensor], depth: int = 1, axis: int = 0,
             backend: str = "pallas", kernels: StepKernels = HAND_KERNELS) -> List[torch.Tensor]:
    """The halo exchange of the sharded step's stencils outside the solve,
    K11 and K7e (vorticity, and with a mask the gradient's velocity and
    pressure), one plane deep unless ``depth`` says more: each
    shard's slab of ``xs`` (``axis`` 0 for ``(lz, N, N)`` fields, 1 for
    ``(C, lz, N, N)``) extended as ``extend`` does.  ``backend="rdma"``
    builds every shard's in one K13 call (``kernels.halo_exchange_rdma``),
    any other value with ``torch.cat``; the two give the same slabs."""
    if backend != "rdma":
        return extend(xs, depth, axis)
    exts = kernels.halo_exchange_rdma([[x if axis else x[None]] for x in xs], depth)
    return [e[0] if axis else e[0][0] for e in exts]


def _shard_devices(name: str, xs, devices=None):
    if devices is not None and len(xs) != len(devices):
        raise ValueError(f"{name}: {len(xs)} slabs for {len(devices)} shards")
    for r, x in enumerate(xs):
        want = xs[0].device if devices is None else devices[r]
        if x.device != want:
            raise ValueError(f"{name}[{r}] is on {x.device}, its shard on {want}")


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
    """Slab-sharded fixed-rhs Jacobi with explicit halo exchange on global
    tensors: ``iters`` sweeps from the global ``(N, N, N)`` ``x`` with rhs
    ``x0`` on the mesh's shards, the result the global ``(N, N, N)``
    solution (equal to the single-device ``jacobi_3d`` for any
    ``block_iters``): ``jacobi_shards`` on the split tensors, joined.

    ``b`` selects the wall rule as in ``set_bnd_3d``; ``obst`` (``b == 0``
    only) is a bool mask whose solid cells keep the previous iterate (the
    plain backend) or get the coefficient 0 (the kernel; exact where the
    iterate is zero in solids, as in the pressure solve).  ``block_iters``
    (T) sets the exchange cadence; ``iters % T == 0`` and ``T <= lz``.
    ``backend`` as ``jacobi_shards``'s."""
    if obst is not None and b != 0:
        raise ValueError(
            "jacobi_3d_sharded: obst requires b == 0 (the scalar set_bnd "
            "contract; velocity components need the obstacle mirror, which this "
            "solver does not implement)")
    device = mesh_device(mesh)
    for name, t in (("x", x), ("x0", x0)) + ((("obst", obst),) if obst is not None else ()):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the mesh on {device}")
    masks = None if obst is None else _split(obst.to(torch.bool), mesh, axis_name)
    return torch.cat(jacobi_shards(_split(x, mesh, axis_name), _split(x0, mesh, axis_name),
                                   a, c, iters, b, block_iters, backend, masks, kernels))


def jacobi_shards(xs, x0s, a: float, c: float, iters: int, b: int = 0,
                  block_iters: int = 1, backend: str = "auto", obsts=None,
                  kernels: StepKernels = HAND_KERNELS) -> List[torch.Tensor]:
    """``iters`` fixed-rhs Jacobi sweeps on the shards' float32 ``(lz, N, N)``
    slabs ``xs`` (rank order, plane 0 of shard r at global z ``r·lz``) with
    the rhs slabs ``x0s``; returns each shard's ``lz`` planes of the
    solution (views of its last extended buffer, no copy).

    ``obsts`` are the shards' bool masks ``(lz, N, N)``: solid cells keep the
    previous iterate (the plain sweeps) or get the coefficient 0 (the
    kernels).  Their halos and the rhs's are exchanged once.  With a
    velocity code ``b`` in 1..3 the mask also brings the obstacle mirror
    after each sweep's faces (``set_bnd_3d``), which only the plain sweeps at
    ``block_iters = 1`` do: one two-plane exchange a sweep, so the mirror
    along z reads its neighbours' post-face planes.

    ``backend``: ``"xla"`` runs the JAX package's plain sweeps on every
    shard's extended slab (``_ext_sweep``, a division by ``c``);
    ``"pallas"`` runs K10 (``kernels.jacobi_ext``) once per round per shard
    on a persistent extended buffer whose 2T halo planes alone are
    refreshed between rounds, after normalising the input's faces (the
    kernel's corrected reads assume ``set_bnd``-consistent faces); T >= 2.
    ``"rdma"`` does the exchanges in kernels, as in the JAX package: one K13
    (``kernels.halo_exchange_rdma``) builds the extended x (faces
    normalised), rhs and mask together, then each round is one K12
    (``kernels.jacobi_ext_rdma``) that sweeps every shard and hands each
    its next extended slab; bitwise the ``"pallas"`` solve; T >= 2.
    ``"auto"`` takes K10 on CUDA slabs with T >= 2, else the plain sweeps
    (never ``"rdma"``, as in the JAX package)."""
    T = int(block_iters)
    if iters % T:
        raise ValueError(f"iters={iters} not divisible by block_iters={T}")
    if backend not in ("auto", "xla", "pallas", "rdma"):
        raise ValueError(f"backend must be auto/xla/pallas/rdma, got {backend!r}")
    mirrored = obsts is not None and b != 0
    if mirrored and (backend != "xla" or T != 1):
        raise ValueError("the obstacle mirror of a velocity component (b != 0 with a mask) "
                         "runs the plain sweeps only: backend='xla', block_iters=1")
    k, lz = len(xs), xs[0].shape[0]
    if T > lz:
        raise ValueError(f"block_iters={T} exceeds the local slab depth {lz}")
    if backend in ("pallas", "rdma") and T < 2:
        raise ValueError(
            f"backend={backend!r} requires block_iters >= 2 (the kernel amortizes T "
            "sweeps per pass; at T=1 it has nothing to amortize)")
    for name, ts in (("x0s", x0s),) + ((("obsts", obsts),) if obsts is not None else ()):
        _shard_devices(name, ts, [x.device for x in xs])
    use_kernel = backend == "pallas" or (backend == "auto" and T >= 2
                                         and xs[0].device.type == "cuda")
    masks = None if obsts is None else [m.to(torch.bool) for m in obsts]

    if backend == "rdma":
        return _jacobi_rdma(xs, x0s, a, c, iters, b, T, masks, kernels)
    if mirrored:
        return _sweeps_mirrored(b, xs, x0s, a, c, iters, masks)
    x0_ext = extend(x0s, T)
    obst_ext = None if masks is None else extend(masks, T)
    mask = (lambda r: None) if obst_ext is None else (lambda r: obst_ext[r])
    rounds = iters // T

    if not use_kernel:
        c_ts = [torch.tensor(c, dtype=torch.float32, device=x.device) for x in xs]
        locals_ = list(xs)
        for _ in range(rounds):
            exts = extend(locals_, T)
            for r in range(k):
                for _ in range(T):
                    exts[r] = _ext_sweep(b, exts[r], x0_ext[r], a, c_ts[r], r, k, T, lz,
                                         mask(r))
            locals_ = [e[T:T + lz] for e in exts]
        return locals_

    kernel = kernels.jacobi_ext
    exts = extend([_ext_faces(b, x_r, r, k, 0, lz) for r, x_r in enumerate(xs)], T)
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
    return [e[T:T + lz] for e in exts]


def _sweeps_mirrored(b, xs, x0s, a, c, iters, masks):
    """The plain sweeps with the obstacle mirror of velocity code ``b``
    (``ops/linsolve.jacobi_3d``'s ``set_bnd_3d(b, ·, obst)``) on each shard:
    a two-plane exchange a sweep, the update and the faces on the extended
    slab, then the mirror, whose neighbours along z are the extended slab's
    post-face planes."""
    k, lz, n = len(xs), xs[0].shape[0], xs[0].shape[-1]
    x0_ext = extend(x0s, 2)
    m_ext = extend(masks, 2)
    writes = [_nonborder_solid(m, n, r * lz - 2) for r, m in enumerate(m_ext)]
    c_ts = [torch.tensor(c, dtype=torch.float32, device=x.device) for x in xs]
    for _ in range(iters):
        exts = extend(xs, 2)
        xs = [_mirror_ext(_ext_sweep(b, exts[r], x0_ext[r], a, c_ts[r], r, k, 2, lz, m_ext[r]),
                          m_ext[r], writes[r], 3 - b)[2:2 + lz] for r in range(k)]
    return xs


def _jacobi_rdma(xs, x0s, a, c, iters, b, T, masks, kernels):
    """The ``"rdma"`` backend of ``jacobi_shards`` (JAX
    ``parallel/halo.py:390-424``): the input's faces normalised per shard,
    one exchange that primes x, x0 and the mask together, ``iters / T``
    rounds of K12, the local planes."""
    k, lz = len(xs), xs[0].shape[0]
    prime = []
    for r, x_r in enumerate(xs):
        arrays = [_ext_faces(b, x_r, r, k, 0, lz)[None], x0s[r][None]]
        if masks is not None:
            arrays.append(masks[r][None])
        prime.append(arrays)
    exts = kernels.halo_exchange_rdma(prime, T)
    xps = [e[0][0] for e in exts]
    x0_exts = [e[1][0] for e in exts]
    obst_exts = None if masks is None else [e[2][0] for e in exts]
    for _ in range(iters // T):
        xps = kernels.jacobi_ext_rdma(xps, x0_exts, a, c, T, b, obst_exts)
    return [e[T:T + lz] for e in xps]


def advect_multi_3d_sharded(bs, fields, vel, dt: float, mesh: Mesh, axis_name: str = "z",
                            window: int = 1, n_sub: int = 1, transport: str = "ppermute",
                            obst=None, kernels: StepKernels = HAND_KERNELS):
    """Slab-sharded windowed substepped advection with explicit halo exchange
    and per-shard K11 on global tensors: ``fields`` ``(F, N, N, N)`` (F = 1
    or 3) and ``vel`` ``(3, N, N, N)`` of one dtype, float32 or bfloat16, and
    the bool mask ``obst``; the result is the global advected ``(F, N, N,
    N)``, equal to ``ops.advect.advect_substep_3d`` through K1 on the whole
    grid: ``advect_shards`` on the split tensors, joined.  Self-advection is
    ``fields is vel`` with ``bs == (1, 2, 3)``."""
    device = mesh_device(mesh)
    for name, t in (("fields", fields), ("vel", vel)) + (
            (("obst", obst),) if obst is not None else ()):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the mesh on {device}")
    vs = _split(vel, mesh, axis_name, 1)
    fs = vs if fields is vel else _split(fields, mesh, axis_name, 1)
    masks = None if obst is None else _split(obst.to(torch.bool), mesh, axis_name)
    return torch.cat(advect_shards(bs, fs, vs, dt, fields.shape[-1], window, n_sub, transport,
                                   masks, kernels), dim=1)


def advect_shards(bs, fields, vel, dt: float, n: int, window: int = 1, n_sub: int = 1,
                  transport: str = "ppermute", obsts=None,
                  kernels: StepKernels = HAND_KERNELS) -> List[torch.Tensor]:
    """Windowed substepped advection with per-shard K11 (``kernels.
    advect_ext``; the hand kernels run their twins on CPU tensors) on the
    shards' slabs of the ``n³`` grid: ``fields`` ``(F, lz, n, n)`` and ``vel``
    ``(3, lz, n, n)`` of one dtype, float32 or bfloat16, and the bool masks
    ``obsts`` ``(lz, n, n)``, in rank order.  Returns each shard's advected
    ``(F, lz, n, n)`` planes: views of its K11 result, no copy.

    The backtrace is clamped to ``window`` cells a substep, so a
    ``window·n_sub``-plane halo covers every sample (``n_sub·(window+1)``
    with the masks, whose mirror reads one plane further each substep): one
    exchange of the fields, the velocity and the mask a call.
    Self-advection (``fields is vel``, ``bs == (1, 2, 3)``) shares one
    exchange.  ``transport="ppermute"`` builds each shard's extended slabs
    with ``torch.cat`` when its turn comes; ``"rdma"`` builds every shard's
    in one K13 call (``kernels.halo_exchange_rdma``) that carries the fields,
    the velocity and the mask, as in the JAX package: the same slabs, so the
    same result bitwise."""
    if transport not in ("ppermute", "rdma"):
        raise ValueError(f"transport must be ppermute/rdma, got {transport!r}")
    k, lz = len(fields), fields[0].shape[1]
    has_obst = obsts is not None
    h = ext_halo(window, n_sub, has_obst)
    if h > lz:
        kind = "n_sub·(window+1), obstacle mirror" if has_obst else "window·n_sub"
        raise ValueError(f"advect halo {h} ({kind}) exceeds local slab depth {lz}")
    devices = [f.device for f in fields]
    for name, ts in (("vel", vel),) + ((("obsts", obsts),) if has_obst else ()):
        _shard_devices(name, ts, devices)
    self_adv = fields is vel and tuple(bs) == (1, 2, 3) and fields[0].shape[0] == 3
    masks = None if not has_obst else [m.to(torch.bool) for m in obsts]

    def exchanged(xs, axis):
        """Each shard's extended slab, built when its turn comes (so one
        shard's buffers live at a time): the exchange hands out views."""
        pairs = halo_exchange_z(xs, h, axis)
        return lambda r: torch.cat([pairs[r][0], xs[r], pairs[r][1]], dim=axis)

    if transport == "rdma":
        arrays = [[v] if self_adv else [f, v] for f, v in zip(fields, vel)]
        if has_obst:
            for arrays_r, m in zip(arrays, masks):
                arrays_r.append(m[None])
        exts = kernels.halo_exchange_rdma(arrays, h)
        v_ext = (lambda r: exts[r][0]) if self_adv else (lambda r: exts[r][1])
        f_ext = None if self_adv else (lambda r: exts[r][0])
        m_ext = None if not has_obst else (lambda r: exts[r][-1][0])
    else:
        v_ext = exchanged(vel, 1)
        f_ext = None if self_adv else exchanged(fields, 1)
        m_ext = None if not has_obst else exchanged(masks, 0)
    out = []
    for r in range(k):
        v = v_ext(r)
        res = kernels.advect_ext(tuple(bs), v if self_adv else f_ext(r), v, n, dt, r * lz - h,
                                 window, n_sub, None if m_ext is None else m_ext(r))
        out.append(res[:, h:h + lz])
    return out


def _contract_slab(b: int, val, obst_ext, n: int, z_offset: int, writes):
    """``ops/advect._mask_and_bnd_3d`` on a slab whose plane 0 is global z
    ``z_offset``: the cells inside the global interior and out of the mask
    keep ``val``, the rest are 0, then the faces at the global walls the slab
    holds and, for a velocity code with the mask, the obstacle mirror (its
    neighbours read wrapped, in the margin the caller drops)."""
    dev = val.device
    zg = torch.arange(val.shape[0], device=dev) + z_offset
    inner = (torch.arange(n, device=dev) >= 1) & (torch.arange(n, device=dev) <= n - 2)
    keep = (((zg >= 1) & (zg <= n - 2))[:, None, None]
            & inner[None, :, None] & inner[None, None, :])
    if obst_ext is not None:
        keep = keep & ~obst_ext
    out = slab_faces(b, torch.where(keep, val, 0.0), -z_offset, n - 1 - z_offset)
    if obst_ext is not None and b in (1, 2, 3):
        out = _mirror_ext(out, obst_ext, writes, 3 - b)
    return out


def advect_slab(bs, fields, vel, dt: float, n: int, z_offset: int, obst_ext=None,
                window: int = 1):
    """``ops/advect.advect_multi_3d`` at a window of K >= 1 on a slab of the
    ``n³`` grid (plane 0 at global z ``z_offset``): ``window_sum_3d`` with the
    slab's global z, rounded to the fields' dtype, then ``_contract_slab``.
    The outer ``window`` planes (``window + 1`` with the mask) are margin."""
    dt0 = np.float32(dt) * np.float32(n - 2)
    vals = window_sum_3d(fields, vel, float(dt0), window, z_offset).to(fields.dtype)
    writes = None if obst_ext is None else _nonborder_solid(obst_ext, n, z_offset)
    return torch.stack([_contract_slab(b, vals[c], obst_ext, n, z_offset, writes)
                        for c, b in enumerate(bs)])


def advect_shards_plain(bs, fields, vel, dt: float, n: int, scheme: str, window: int,
                        n_sub: int = 1, obsts=None) -> List[torch.Tensor]:
    """The plain advection of the ``ops`` functions per shard: the
    semi-Lagrangian (``advect_multi_3d``) or substep (``advect_substep_3d``)
    scheme at a window of K >= 1 on each shard's slab extended by the halo
    the scheme erodes (``ext_halo``; from several shards where it is deeper
    than a slab), each shard's planes kept.  Arguments as
    ``advect_shards``'s; bitwise the whole-grid functions."""
    k, lz = len(fields), fields[0].shape[1]
    masked = obsts is not None
    h = ext_halo(window, n_sub if scheme == "substep" else 1, masked)
    v_ext = extend(vel, h, 1)
    f_ext = v_ext if fields is vel else extend(fields, h, 1)
    m_ext = [None] * k if not masked else extend([m.to(torch.bool) for m in obsts], h)
    out = []
    for r in range(k):
        z_off = r * lz - h

        def one(b_, f_, v_, d_, m=m_ext[r], z_off=z_off):
            return advect_slab(b_, f_, v_, d_, n, z_off, m, window)

        if scheme == "substep":
            res = advect_substep_3d(bs, f_ext[r], v_ext[r], dt, None, window, n_sub,
                                    advect_fn=one)
        else:
            res = one(bs, f_ext[r], v_ext[r], dt)
        out.append(res[:, h:h + lz])
    return out


def gathered(name: str, fn, shards, axes, out_axes, devices) -> List[Tuple[torch.Tensor, ...]]:
    """The op ``fn`` on all-gathered inputs, each shard keeping its planes:
    what XLA's partitioner does for an op that no halo bounds.  ``shards``
    holds for each argument of ``fn`` the shards' slabs (or None, passed
    through), ``axes`` each argument's z axis; ``fn`` returns a tuple of
    global tensors whose z axes are ``out_axes``.  The op runs once on each
    distinct device of ``devices`` (the mesh's), on the inputs gathered
    there; each shard's planes are copied out, so no shard keeps a view of
    the whole volume.  Counted in ``gathered_ops[name]``."""
    gathered_ops[name] += 1
    k = len(devices)
    results = {}
    out = []
    for r, dev in enumerate(devices):
        if dev not in results:
            args = [None if part is None else torch.cat([x.to(dev) for x in part], dim=ax)
                    for part, ax in zip(shards, axes)]
            results[dev] = fn(*args)
        out.append(tuple(o.narrow(ax, r * (o.shape[ax] // k), o.shape[ax] // k).clone()
                         for o, ax in zip(results[dev], out_axes)))
    return out
