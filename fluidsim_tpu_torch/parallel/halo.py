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
the JAX package's shards run together under ``shard_map``, the port's are
issued one after another from the host onto each shard's own stream
(``parallel/streams.ShardOrder``), where they run concurrently; a shard
reads what another wrote only after its stream has waited on the writer's
mark, taken before the reading phase began.  An exchange is a copy on the
reading shard's stream: a ``torch.cat`` of the slabs
(``"pallas"``/``"ppermute"``; across cards, each neighbour's planes copied
first with ``ShardOrder.fetch``), or on the ``"rdma"`` backend a kernel's
stores into the neighbour shards' buffers, K13
(``kernels/halo.halo_exchange_rdma``) for the extended arrays and K12
(``kernels/halo.jacobi_ext_rdma``) for a round's sweeps and its exchange
together.  Every function here returns each shard's results complete on
the shard's own stream.

``jacobi_shards`` and ``advect_shards`` take and return the shards' slabs
(the sharded step's own); ``jacobi_3d_sharded`` and
``advect_multi_3d_sharded`` are their forms on global tensors (split, per
shard, joined), which the JAX package's functions take.
``advect_shards_plain`` is the plain advection per shard, and
``advect_maccormack_shards`` MacCormack on either.  ``gathered`` is the one
route that assembles a whole volume: an op that no halo bounds (window 0's
exact gather) runs on the all-gathered inputs and each shard keeps its
planes, counted in ``gathered_ops``.
"""

from __future__ import annotations

import collections
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..kernels.halo import _mirror_ext, _nonborder_solid, ext_halo, rank_walls, slab_faces
from ..models.step_kernels import HAND_KERNELS, StepKernels
from ..ops.advect import advect_substep_3d, window_sum_3d
from ..utils.profiling import span, spanned
from .sharding import Mesh
from .streams import order_for, order_of

# Calls of ``gathered`` by op name: the ops that still assemble a whole
# volume inside a sharded step.
gathered_ops: collections.Counter = collections.Counter()


@spanned("halo.exchange")
def halo_exchange_z(x_locals: Sequence[torch.Tensor], depth: int = 1,
                    axis: int = 0) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``(below, above)`` for each shard of ``x_locals`` (the shards' local
    slabs, in rank order): ``below`` holds the last ``depth`` z-planes of the
    shard below (zeros at the global bottom), ``above`` the first ``depth``
    planes of the shard above (zeros at the global top), each on its
    shard's device and ready on its stream.  ``axis`` is the position of
    the sharded z axis (0 for a plain ``(lz, N, N)`` field, 1 for
    channel-stacked ``(C, lz, N, N)`` fields, whose channels are exchanged
    together).  The slabs are views of the neighbours' planes where the
    devices agree.

    ``depth`` must not exceed the local slab depth: a shard owns only ``lz``
    planes."""
    lz = x_locals[0].shape[axis]
    if depth > lz:
        raise ValueError(f"halo depth={depth} exceeds the local slab depth {lz}")
    k = len(x_locals)
    order = order_of(x_locals)
    out = []
    with order.scope():
        marks = order.marks()
        for r, x in enumerate(x_locals):
            with order.on(r):
                order.wait(r, marks, r - 1, r + 1)
                if r > 0:
                    below = order.fetch(x_locals[r - 1].narrow(axis, lz - depth, depth), r)
                else:
                    below = torch.zeros_like(x.narrow(axis, 0, depth))
                if r < k - 1:
                    above = order.fetch(x_locals[r + 1].narrow(axis, 0, depth), r)
                else:
                    above = torch.zeros_like(x.narrow(axis, 0, depth))
            out.append((below, above))
    return out


@spanned("halo.exchange")
def neighbour_planes(xs: Sequence[torch.Tensor], in_place: bool = True) -> List[Tuple]:
    """The one-plane halos of the shards' ``(lz, N, N)`` slabs ``xs`` that
    K7e reads: ``(below, above)`` for each shard, the last plane of the
    shard below and the first of the shard above, None past the global
    ends, each shard's stream having waited on its neighbours' marks.  With
    ``in_place`` each is a view of the neighbour's storage, on the
    neighbour's device (K7e's kernels read it through a peer pointer across
    cards); else it is on the shard's device (a copy only where that
    differs, for the plain twins).  No slab is assembled."""
    k = len(xs)
    order = order_of(xs)
    out = []
    with order.scope():
        marks = order.marks()
        for r in range(k):
            order.wait(r, marks, r - 1, r + 1)
            planes = (xs[r - 1][-1] if r > 0 else None, xs[r + 1][0] if r < k - 1 else None)
            if in_place:
                for plane in planes:
                    order.hold(plane, r)
                out.append(planes)
            else:
                with order.on(r):
                    out.append(tuple(None if p is None else order.fetch(p, r) for p in planes))
    return out


def _split(x, mesh: Mesh, axis_name: str, axis: int = 0) -> List[torch.Tensor]:
    """The shards' local slabs of the global ``x``: ``lz`` planes each along
    ``axis``, on the shards' devices (views where ``x`` is already there),
    moved on the caller's streams, which the shards' scope waits on."""
    k = mesh.shape[axis_name]
    if x.shape[axis] % k:
        raise ValueError(f"z extent {x.shape[axis]} not divisible by {k} shards")
    return [c.to(d) for c, d in zip(torch.chunk(x, k, dim=axis), mesh.devices)]


def _join(xs: Sequence[torch.Tensor], device, axis: int = 0) -> torch.Tensor:
    """The shards' slabs joined along ``axis`` on ``device`` (after the
    shards' scope: on the caller's streams)."""
    return torch.cat([x.to(device) for x in xs], dim=axis)


@spanned("halo.exchange")
def extend(xs: Sequence[torch.Tensor], depth: int, axis: int = 0) -> List[torch.Tensor]:
    """Each shard's slab of ``xs`` between ``depth`` planes of the shards
    below and above it along ``axis`` (from as many shards as ``depth``
    spans; zeros past the global ends), a fresh buffer on the shard's
    device, built on its stream after it waited on every shard it reads."""
    lz = xs[0].shape[axis]
    k = len(xs)
    order = order_of(xs)
    out = []
    with order.scope():
        marks = order.marks()
        for r, x in enumerate(xs):
            with order.on(r):
                parts, z, hi = [], r * lz - depth, (r + 1) * lz + depth
                while z < hi:
                    s = z // lz
                    if 0 <= s < k:
                        end = min(hi, (s + 1) * lz)
                        order.wait(r, marks, s)
                        parts.append(order.fetch(xs[s].narrow(axis, z - s * lz, end - z), r))
                    else:
                        end = min(hi, 0) if s < 0 else hi
                        shape = list(x.shape)
                        shape[axis] = end - z
                        parts.append(x.new_zeros(shape))
                    z = end
                out.append(torch.cat(parts, dim=axis))
    return out


@spanned("halo.exchange")
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
    for name, t in (("x0", x0),) + ((("obst", obst),) if obst is not None else ()):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    masks = None if obst is None else _split(obst.to(torch.bool), mesh, axis_name)
    return _join(jacobi_shards(_split(x, mesh, axis_name), _split(x0, mesh, axis_name),
                               a, c, iters, b, block_iters, backend, masks, kernels), x.device)


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
    lz = xs[0].shape[0]
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
    order = order_of(xs)
    with order.scope():
        masks = None if obsts is None else order.each(lambda r: obsts[r].to(torch.bool))
        if backend == "rdma":
            return _jacobi_rdma(order, xs, x0s, a, c, iters, b, T, masks, kernels)
        if mirrored:
            return _sweeps_mirrored(order, b, xs, x0s, a, c, iters, masks)
        return _jacobi_rounds(order, xs, x0s, a, c, iters, b, T, masks, use_kernel, kernels)


def _jacobi_rounds(order, xs, x0s, a, c, iters, b, T, masks, use_kernel, kernels):
    """``jacobi_shards`` on the plain sweeps or K10: ``iters / T`` rounds on
    each shard's T-deep extended slab, the halos exchanged between rounds."""
    k, lz = len(xs), xs[0].shape[0]
    x0_ext = extend(x0s, T)
    obst_ext = None if masks is None else extend(masks, T)
    mask = (lambda r: None) if obst_ext is None else (lambda r: obst_ext[r])
    rounds = iters // T

    if not use_kernel:
        c_ts = order.each(lambda r: torch.tensor(c, dtype=torch.float32,
                                                        device=xs[r].device))
        locals_ = list(xs)
        for _ in range(rounds):
            exts = extend(locals_, T)
            for r in range(k):
                with order.on(r):
                    for _ in range(T):
                        exts[r] = _ext_sweep(b, exts[r], x0_ext[r], a, c_ts[r], r, k, T, lz,
                                             mask(r))
            locals_ = [e[T:T + lz] for e in exts]
        return locals_

    kernel = kernels.jacobi_ext
    exts = extend(order.each(lambda r: _ext_faces(b, xs[r], r, k, 0, lz)), T)
    for rnd in range(rounds):
        exts = order.each(lambda r: kernel(exts[r], x0_ext[r], a, c, T,
                                                  *rank_walls(r, k, T, lz), b, mask(r)))
        if rnd + 1 < rounds:
            # Only the 2T halo planes are refreshed, each on its shard's
            # stream after the neighbours' rounds; the refresh reads the
            # neighbours' valid planes, which no shard's refresh writes.
            with span("halo.exchange"):
                marks = order.marks()
                for r, e in enumerate(exts):
                    with order.on(r):
                        order.wait(r, marks, r - 1, r + 1)
                        if r > 0:
                            e[:T].copy_(order.fetch(exts[r - 1][lz:lz + T], r))
                        else:
                            e[:T].zero_()
                        if r < k - 1:
                            e[T + lz:].copy_(order.fetch(exts[r + 1][T:2 * T], r))
                        else:
                            e[T + lz:].zero_()
    return [e[T:T + lz] for e in exts]


def _sweeps_mirrored(order, b, xs, x0s, a, c, iters, masks):
    """The plain sweeps with the obstacle mirror of velocity code ``b``
    (``ops/linsolve.jacobi_3d``'s ``set_bnd_3d(b, ·, obst)``) on each shard:
    a two-plane exchange a sweep, the update and the faces on the extended
    slab, then the mirror, whose neighbours along z are the extended slab's
    post-face planes."""
    k, lz, n = len(xs), xs[0].shape[0], xs[0].shape[-1]
    x0_ext = extend(x0s, 2)
    m_ext = extend(masks, 2)
    writes = order.each(lambda r: _nonborder_solid(m_ext[r], n, r * lz - 2))
    c_ts = order.each(lambda r: torch.tensor(c, dtype=torch.float32,
                                                    device=xs[r].device))
    for _ in range(iters):
        exts = extend(xs, 2)
        xs = order.each(lambda r: _mirror_ext(
            _ext_sweep(b, exts[r], x0_ext[r], a, c_ts[r], r, k, 2, lz, m_ext[r]),
            m_ext[r], writes[r], 3 - b)[2:2 + lz])
    return xs


def _jacobi_rdma(order, xs, x0s, a, c, iters, b, T, masks, kernels):
    """The ``"rdma"`` backend of ``jacobi_shards`` (JAX
    ``parallel/halo.py:390-424``): the input's faces normalised per shard,
    one exchange that primes x, x0 and the mask together, ``iters / T``
    rounds of K12, the local planes."""
    k, lz = len(xs), xs[0].shape[0]

    def prime(r):
        arrays = [_ext_faces(b, xs[r], r, k, 0, lz)[None], x0s[r][None]]
        if masks is not None:
            arrays.append(masks[r][None])
        return arrays

    arrays = order.each(prime)
    with span("halo.exchange"):
        exts = kernels.halo_exchange_rdma(arrays, T)
    del arrays  # the faces' copies: freed before the rounds
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
    N)`` on ``fields``' device, equal to ``ops.advect.advect_substep_3d``
    through K1 on the whole grid: ``advect_shards`` on the tensors split
    onto the shards' devices, joined.  Self-advection is ``fields is vel``
    with ``bs == (1, 2, 3)``."""
    for name, t in (("vel", vel),) + ((("obst", obst),) if obst is not None else ()):
        if t.device != fields.device:
            raise ValueError(f"{name} is on {t.device}, fields on {fields.device}")
    vs = _split(vel, mesh, axis_name, 1)
    fs = vs if fields is vel else _split(fields, mesh, axis_name, 1)
    masks = None if obst is None else _split(obst.to(torch.bool), mesh, axis_name)
    return _join(advect_shards(bs, fs, vs, dt, fields.shape[-1], window, n_sub, transport,
                               masks, kernels), fields.device, 1)


@spanned("halo.exchange")
def _advection_slabs(fields, vel, masks, h: int, transport: str, kernels: StepKernels):
    """Each shard's ``h``-plane extended fields, velocity and mask (None
    for each without ``masks``) for one advection: one K13 call
    (``kernels.halo_exchange_rdma``) carrying all three on ``"rdma"``, else
    ``extend`` (for ``"ppermute"`` and the plain advection).
    Self-advection (``fields is vel``) shares the velocity's slabs."""
    k = len(fields)
    self_adv = fields is vel
    if transport == "rdma":
        arrays = [[v] if self_adv else [f, v] for f, v in zip(fields, vel)]
        if masks is not None:
            for arrays_r, m in zip(arrays, masks):
                arrays_r.append(m[None])
        exts = kernels.halo_exchange_rdma(arrays, h)
        v_ext = [e[0] if self_adv else e[1] for e in exts]
        f_ext = v_ext if self_adv else [e[0] for e in exts]
        m_ext = [None] * k if masks is None else [e[-1][0] for e in exts]
    else:
        v_ext = extend(vel, h, 1)
        f_ext = v_ext if self_adv else extend(fields, h, 1)
        m_ext = [None] * k if masks is None else extend(masks, h)
    return f_ext, v_ext, m_ext


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
    Self-advection (``fields is vel``) shares one exchange.
    ``transport="ppermute"`` builds each shard's extended slabs with
    ``torch.cat`` (``extend``); ``"rdma"`` builds every shard's in one K13
    call (``kernels.halo_exchange_rdma``) that carries the fields, the
    velocity and the mask, as in the JAX package: the same slabs, so the
    same result bitwise."""
    if transport not in ("ppermute", "rdma"):
        raise ValueError(f"transport must be ppermute/rdma, got {transport!r}")
    lz = fields[0].shape[1]
    has_obst = obsts is not None
    h = ext_halo(window, n_sub, has_obst)
    if h > lz:
        kind = "n_sub·(window+1), obstacle mirror" if has_obst else "window·n_sub"
        raise ValueError(f"advect halo {h} ({kind}) exceeds local slab depth {lz}")
    devices = [f.device for f in fields]
    for name, ts in (("vel", vel),) + ((("obsts", obsts),) if has_obst else ()):
        _shard_devices(name, ts, devices)
    order = order_of(fields)
    with order.scope():
        masks = None if not has_obst else order.each(lambda r: obsts[r].to(torch.bool))
        f_ext, v_ext, m_ext = _advection_slabs(fields, vel, masks, h, transport, kernels)
        return order.each(lambda r: kernels.advect_ext(
            tuple(bs), f_ext[r], v_ext[r], n, dt, r * lz - h, window, n_sub,
            m_ext[r])[:, h:h + lz])


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
    lz = fields[0].shape[1]
    masked = obsts is not None
    h = ext_halo(window, n_sub if scheme == "substep" else 1, masked)
    order = order_of(fields)
    with order.scope():
        masks = None if not masked else order.each(lambda r: obsts[r].to(torch.bool))
        f_ext, v_ext, m_ext = _advection_slabs(fields, vel, masks, h, "plain", None)

        def shard(r):
            z_off = r * lz - h

            def one(b_, f_, v_, d_):
                return advect_slab(b_, f_, v_, d_, n, z_off, m_ext[r], window)

            if scheme == "substep":
                res = advect_substep_3d(bs, f_ext[r], v_ext[r], dt, None, window, n_sub,
                                        advect_fn=one)
            else:
                res = one(bs, f_ext[r], v_ext[r], dt)
            return res[:, h:h + lz]

        return order.each(shard)


def advect_maccormack_shards(bs, fields, vel, dt: float, n: int, window: int, obsts=None,
                             transport: str = "plain",
                             kernels: StepKernels = HAND_KERNELS) -> List[torch.Tensor]:
    """``ops/advect.advect_maccormack_3d`` at a window of K >= 1 on the
    shards' slabs (arguments as ``advect_shards``'s, ``obsts`` the shards'
    ``(lz, n, n)`` masks); returns each shard's ``(F, lz, n, n)`` planes.

    The velocity (with the fields and the mask) is exchanged once, at the
    depth one advection erodes (``ext_halo(window, 1, masked)``); the forward
    advection runs on each shard's extended slab, its result is exchanged at
    that depth, and the backward advection of it runs through the extended
    velocity negated (exact), so the velocity is not exchanged again.
    ``transport`` ``"ppermute"`` or ``"rdma"`` runs both advections in K11
    (``kernels.advect_ext``; ``"rdma"`` exchanges in K13), as the
    whole-grid op runs them in K1; ``"plain"`` runs ``advect_slab``, as
    ``advect_multi_3d``.  The limiter reads the forward field's one plane
    past each shard edge from its exchange: a kept cell (global z in
    ``[1, n−2]``) reads only planes ``[0, n−1]``, so where the whole-grid
    op's ``torch.roll`` wraps across a global wall, the shard reads zeros
    at a plane the output contract discards.  The contract then runs per
    shard; with a mask, on the limited field extended by one plane (the
    obstacle mirror of vz reads its neighbours along z).  Bitwise the
    whole-grid op (on K1 for the kernel transports)."""
    if transport not in ("plain", "ppermute", "rdma"):
        raise ValueError(f"transport must be plain/ppermute/rdma, got {transport!r}")
    lz = fields[0].shape[1]
    masked = obsts is not None
    h = ext_halo(window, 1, masked)
    if transport != "plain" and h > lz:
        raise ValueError(f"advect halo {h} exceeds local slab depth {lz}")
    order = order_of(fields)
    with order.scope():
        masks = None if not masked else order.each(lambda r: obsts[r].to(torch.bool))
        f_ext, v_ext, m_ext = _advection_slabs(fields, vel, masks, h, transport, kernels)

        def advect(r, f_e, v_e):
            if transport == "plain":
                res = advect_slab(bs, f_e, v_e, dt, n, r * lz - h, m_ext[r], window)
            else:
                res = kernels.advect_ext(tuple(bs), f_e, v_e, n, dt, r * lz - h, window, 1,
                                         m_ext[r])
            return res[:, h:h + lz]

        forward = order.each(lambda r: advect(r, f_ext[r], v_ext[r]))
        fwd_ext = _advection_slabs(forward, forward, None, h, transport, kernels)[0]
        backward = order.each(lambda r: advect(r, fwd_ext[r], -v_ext[r]))

        def limit(r):
            fwd, fe = forward[r], fwd_ext[r]
            corrected = fwd + 0.5 * (fields[r] - backward[r])
            lo = hi = fwd
            # The whole-grid op's shifts in its order: z (the exchanged
            # planes), y, x; roll by s reads the plane at -s.
            for axis in (1, 2, 3):
                for s in (-1, 1):
                    if axis == 1:
                        shifted = fe[:, h + 1:h + 1 + lz] if s < 0 else fe[:, h - 1:h - 1 + lz]
                    else:
                        shifted = torch.roll(fwd, s, axis)
                    lo = torch.minimum(lo, shifted)
                    hi = torch.maximum(hi, shifted)
            return torch.clamp(corrected, lo, hi)

        limited = order.each(limit)
        if masked and 3 in tuple(bs):
            lim_ext = exchange(limited, 1, 1, "rdma" if transport == "rdma" else "pallas",
                               kernels)

            def contract(r):
                m1 = m_ext[r][h - 1:h + lz + 1]
                writes = _nonborder_solid(m1, n, r * lz - 1)
                return torch.stack([_contract_slab(b, lim_ext[r][c], m1, n, r * lz - 1, writes)
                                    for c, b in enumerate(bs)])[:, 1:-1]
        else:
            def contract(r):
                m = None if not masked else m_ext[r][h:h + lz]
                writes = None if not masked else _nonborder_solid(m, n, r * lz)
                return torch.stack([_contract_slab(b, limited[r][c], m, n, r * lz, writes)
                                    for c, b in enumerate(bs)])

        return order.each(contract)


def gathered(name: str, fn, shards, axes, out_axes, devices) -> List[Tuple[torch.Tensor, ...]]:
    """The op ``fn`` on all-gathered inputs, each shard keeping its planes:
    what XLA's partitioner does for an op that no halo bounds.  ``shards``
    holds for each argument of ``fn`` the shards' slabs (or None, passed
    through), ``axes`` each argument's z axis; ``fn`` returns a tuple of
    global tensors whose z axes are ``out_axes``.  The op runs once on each
    distinct device of ``devices`` (the mesh's), on the stream of the first
    shard there, after it waited on every shard, on the inputs gathered
    there; each shard's planes are copied out on its own stream, so no
    shard keeps a view of the whole volume.  Counted in
    ``gathered_ops[name]``."""
    gathered_ops[name] += 1
    k = len(devices)
    order = order_for(devices)
    first = {}
    for r, dev in enumerate(devices):
        first.setdefault(dev, r)
    results = {}
    with order.scope():
        marks = order.marks()
        for dev, r0 in first.items():
            with order.on(r0):
                order.wait(r0, marks, *range(k))
                args = [None if part is None else
                        torch.cat([order.fetch(x, r0) for x in part], dim=ax)
                        for part, ax in zip(shards, axes)]
                results[dev] = fn(*args)
        marks = order.marks()
        out = []
        for r, dev in enumerate(devices):
            with order.on(r):
                order.wait(r, marks, first[dev])
                out.append(tuple(order.fetch(o, r).narrow(ax, r * (o.shape[ax] // k),
                                                          o.shape[ax] // k).clone()
                                 for o, ax in zip(results[dev], out_axes)))
    return out
