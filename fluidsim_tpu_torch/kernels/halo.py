"""K10 to K13, the kernels of the explicit halo-exchange sharded step: their
plain twins and their wrappers.

Counterpart of ``fluidsim_tpu/pallas/halo_kernel.py``.  K10 and K11 run on
one shard's halo-extended z-slab: its ``lz`` planes between the neighbours'
edge planes (``parallel/halo.py`` exchanges them).  K12 and K13 are the
``"rdma"`` backend, where the exchange is a kernel's own work: each takes
every shard of the mesh, launches once per shard on the shard's own stream
and card and stores into the neighbour shards' buffers through their device
pointers, peer pointers where a neighbour is on another card (the TPU
kernels' remote DMAs).  The TPU kernels' entry barrier is the shards'
events (``parallel/streams.ShardOrder``): a call returns each shard's
outputs complete on its own stream, its stream having waited on both
neighbours' launches, which stored into them.

* K10, ``jacobi_ext_kernel`` (``jacobi_ext_pallas`` → ``_ext_jacobi_kernel``):
  ``t_iters`` Jacobi sweeps ``(x0 + a·nbr)·coef`` on the ``(nz, n, n)`` slab,
  with open z edges and the global z walls at the run-time slab planes
  ``(wall_lo, wall_hi)`` (``NO_WALL`` for none), then the ``set_bnd`` faces.
  The CUDA kernel is ``csrc/jacobi_ext.cu`` (K6's round on a slab: a round
  of ``t_iters ≤ 4`` sweeps and its faces in one launch).
* K11, ``advect_ext_kernel`` (``advect_ext_pallas`` → ``_ext_advect_kernel``):
  K1's windowed substep advection of F fields on the ``(F, nz, n, n)`` slab
  whose plane 0 is global plane ``z_offset``.  The CUDA kernel is
  ``csrc/advect_ext.cu`` (K1's per-cell bodies on a slab).

A sweep or a substep reads one plane (``window`` planes, plus one for the
obstacle mirror) past each cell, so validity erodes from the slab's open
ends: after the call only planes at least ``t_iters`` (K10) or the halo
(K11) from an end hold the global computation's values, and the callers
keep those.  Past the ends the twins define what the kernels compute, so
the two agree on every plane: K10 reads zeros past the slab's ends, K11
reads taps (and mirror neighbours) at planes wrapped modulo ``nz``.  The TPU
kernels leave other values there (their windows wrap inside VMEM); no
caller reads them.

* K12, ``jacobi_ext_rdma`` (``jacobi_ext_rdma`` → ``_rdma_jacobi_kernel``):
  one round over all shards, K10's sweeps with each shard's fresh edge
  planes pushed into its neighbours' next slabs by the last sweep.  The CUDA
  kernel is ``fs_jacobi_ext_rdma`` in ``csrc/jacobi_ext.cu``.
* K13, ``halo_exchange_rdma`` (``halo_exchange_rdma`` →
  ``_halo_exchange_kernel``): every shard's extended arrays of one call,
  any element size.  The CUDA kernel is ``csrc/halo_exchange.cu``.

K10 and K12 take float32 slabs (the sharded step's pressure solve is float32,
as the JAX package's ``project_3d`` upcasts); K11 float32 or bfloat16 fields,
computing in float32 and rounding once, as the TPU kernel casts at its store.
Masks are ``torch.bool`` (one byte per cell, nonzero = solid in the kernels).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.advect import window_sum_3d
from ..utils.profiling import span, spanned
from . import _build
from .advect import (
    STORAGE,
    _check_substeps,
    _check_volume,
    _comb,
    _ptr,
    _scratch,
    check_window,
    count_substeps,
    storage_flag,
    substep_dt0,
)
from .jacobi import ROUND_MAX_SWEEPS, check_offsets, solve_coefficients

# "No wall on this side" for K10's wall positions: any value <= -2 (-1 would
# put a corrected read at slab plane 0), as the TPU kernel's NO_WALL.
NO_WALL = -5


def _signs(b: int):
    """``(sz, sy, sx)``: -1 across the walls normal to field code ``b``."""
    return tuple(-1.0 if b == code else 1.0 for code in (3, 2, 1))


def rank_walls(rank: int, n_dev: int, halo: int, lz: int):
    """The slab planes of the global z walls on shard ``rank``'s extended
    slab: ``halo`` on the first shard, ``halo + lz − 1`` on the last,
    ``NO_WALL`` elsewhere."""
    return (halo if rank == 0 else NO_WALL,
            halo + lz - 1 if rank == n_dev - 1 else NO_WALL)


def _check_wall(name: str, wall: int, lo: int, hi: int) -> int:
    if int(wall) != wall or not (wall <= -2 or lo <= wall <= hi):
        raise ValueError(f"{name}={wall}: expected a slab plane in [{lo}, {hi}] or "
                         f"NO_WALL (<= -2)")
    return int(wall)


def slab_faces(b: int, v, wall_lo: int, wall_hi: int):
    """The ``set_bnd_3d(b)`` faces of the ``(nz, n, n)`` slab ``v`` in the TPU
    kernel's z → y → x order: the z faces at the slab planes ``wall_lo`` and
    ``wall_hi`` where they lie in the slab (each the signed copy of the plane
    inwards, wrapped), then y and x on every plane.  Returns a new tensor."""
    sz, sy, sx = _signs(b)
    v = v.clone()
    nz = v.shape[0]
    for wall, src in ((wall_lo, wall_lo + 1), (wall_hi, wall_hi - 1)):
        if 0 <= wall < nz:
            v[wall] = sz * v[src % nz]
    for dst, src in ((0, 1), (-1, -2)):
        v[:, dst] = sy * v[:, src]
    for dst, src in ((0, 1), (-1, -2)):
        v[:, :, dst] = sx * v[:, :, src]
    return v


def jacobi_ext_plain(xp, x0_ext, a: float, c: float, t_iters: int, wall_lo: int,
                     wall_hi: int, b: int = 0, obst_ext=None):
    """Plain PyTorch twin of K10: ``t_iters`` sweeps of
    ``(x0 + a·nbr)·coef`` on every plane of the float32 ``(nz, n, n)`` slab
    ``xp`` (``coef = f32(1)/f32(c)``, 0 in the solid cells of the bool mask
    ``obst_ext``), then the faces (``slab_faces``).  ``nbr`` is
    ``((x₊+x₋) + (y₊+y₋)) + (z₊+z₋)`` with zeros past the slab's ends and the
    corrected reads of the TPU kernel: ``s·`` the cell itself for the
    neighbour across an x or y wall (next to x, y = 1 and n−2) and across a z
    wall (at planes ``wall_lo + 1`` and ``wall_hi − 1``), ``s`` the wall's
    sign for code ``b``."""
    a32, inv_c = solve_coefficients(a, c)
    nz, n = xp.shape[0], xp.shape[-1]
    sz, sy, sx = _signs(b)
    dev = xp.device
    coef = (inv_c if obst_ext is None
            else torch.where(obst_ext, 0.0, torch.tensor(inv_c, device=dev)))
    zi = torch.arange(nz, device=dev)[:, None, None]
    yi = torch.arange(n, device=dev)[None, :, None]
    xi = torch.arange(n, device=dev)[None, None, :]
    v = xp
    for _ in range(t_iters):
        p = F.pad(v, (1, 1, 1, 1, 1, 1))
        right = torch.where(xi == n - 2, sx * v, p[1:-1, 1:-1, 2:])
        left = torch.where(xi == 1, sx * v, p[1:-1, 1:-1, :-2])
        up = torch.where(yi == n - 2, sy * v, p[1:-1, 2:, 1:-1])
        down = torch.where(yi == 1, sy * v, p[1:-1, :-2, 1:-1])
        above = torch.where(zi == wall_hi - 1, sz * v, p[2:, 1:-1, 1:-1])
        below = torch.where(zi == wall_lo + 1, sz * v, p[:-2, 1:-1, 1:-1])
        nbr = ((right + left) + (up + down)) + (above + below)
        v = (x0_ext + a32 * nbr) * coef
    return slab_faces(b, v, wall_lo, wall_hi)


@spanned("kernel.K10")
def jacobi_ext_kernel(xp, x0_ext, a: float, c: float, t_iters: int, wall_lo: int,
                      wall_hi: int, b: int = 0, obst_ext=None):
    """K10: ``t_iters`` Jacobi sweeps on the float32 halo-extended slab ``xp``
    ``(nz, n, n)`` with rhs ``x0_ext``, the global z walls at slab planes
    ``wall_lo`` and ``wall_hi`` (``NO_WALL``: none on that side), then the
    faces; the bool mask ``obst_ext`` makes the coefficient 0 in solids.
    The outer ``t_iters`` planes of the result are erosion margin.

    CUDA tensors launch ``csrc/jacobi_ext.cu``; CPU tensors run
    ``jacobi_ext_plain``.  Returns a new tensor.
    ``jacobi_ext_kernel.launches`` counts calls that launched the kernel."""
    if b not in (0, 1, 2, 3):
        raise ValueError(f"boundary code must be 0..3, got {b}")
    if int(t_iters) != t_iters or t_iters < 1:
        raise ValueError(f"t_iters must be a positive integer, got {t_iters}")
    nz, n = xp.shape[0], xp.shape[-1]
    if n < 3 or xp.dim() != 3:
        raise ValueError(f"expected an (nz, n, n) slab with n >= 3, got {tuple(xp.shape)}")
    if xp.device.type == "cuda":
        check_offsets(nz, n)
    _check_volume("xp", xp, (nz, n, n))
    _check_volume("x0_ext", x0_ext, (nz, n, n))
    wall_lo = _check_wall("wall_lo", wall_lo, 0, nz - 2)
    wall_hi = _check_wall("wall_hi", wall_hi, 1, nz - 1)
    tensors = [x0_ext]
    if obst_ext is not None:
        _check_volume("obst_ext", obst_ext, (nz, n, n), torch.bool)
        tensors.append(obst_ext)
    if any(t.device != xp.device for t in tensors):
        raise ValueError("all tensors must be on one device")

    if xp.device.type == "cpu":
        return jacobi_ext_plain(xp, x0_ext, a, c, t_iters, wall_lo, wall_hi, b, obst_ext)
    if xp.device.type != "cuda":
        raise ValueError(f"unsupported device {xp.device}")

    lib = _build.load_library()
    out = torch.empty_like(xp)
    tmp = torch.empty_like(xp) if t_iters > ROUND_MAX_SWEEPS else None
    a32, inv_c = solve_coefficients(a, c)
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_jacobi_ext(
            xp.data_ptr(), x0_ext.data_ptr(), _ptr(obst_ext), out.data_ptr(), _ptr(tmp),
            nz, n, int(b), a32, inv_c, int(t_iters), wall_lo, wall_hi, stream,
        )
    _build.check(lib, err, "extended-slab Jacobi kernel launch")
    jacobi_ext_kernel.launches += 1
    return out


jacobi_ext_kernel.launches = 0


def _check_shards(name: str, xs, shape, dtype=torch.float32):
    for r, x in enumerate(xs):
        _check_volume(f"{name}[{r}]", x, shape, dtype)


def jacobi_ext_rdma_plain(xps, x0_exts, a: float, c: float, t_iters: int, b: int = 0,
                          obst_exts=None):
    """Plain PyTorch twin of K12: one round of the sharded solve over all
    shards.  ``xps``, ``x0_exts`` (and the bool masks ``obst_exts``) hold
    each shard's ``(lz + 2T, n, n)`` extended slab in rank order, T =
    ``t_iters``.  Each shard runs ``jacobi_ext_plain`` with its rank's walls;
    the result is each shard's complete next extended slab: its sweep
    results in planes ``[T, T + lz)``, the lower neighbour's planes
    ``[lz, lz + T)`` below them and the upper neighbour's ``[T, 2T)`` above
    (zeros past the global ends).  Each shard's share runs as the kernel's
    does (``_shards_round``), its edge planes stored into the neighbours'
    outputs."""
    T = int(t_iters)
    return _shards_round(xps, lambda r, outs: _k12_share_plain(
        r, outs, xps, x0_exts, a, c, T, b, obst_exts))


def _k12_share_plain(r, outs, xps, x0_exts, a, c, T, b, obst_exts):
    """Shard ``r``'s share of a K12 round on the twins: its kept planes into
    its output (zeros in its halo at a global end) and its edge planes into
    the neighbours' outputs."""
    k = len(xps)
    lz = xps[r].shape[0] - 2 * T
    kept = jacobi_ext_plain(xps[r], x0_exts[r], a, c, T, *rank_walls(r, k, T, lz), b,
                            None if obst_exts is None else obst_exts[r])[T:T + lz]
    outs[r][T:T + lz] = kept
    if r == 0:
        outs[r][:T] = 0.0
    else:
        outs[r - 1][T + lz:] = kept[:T]
    if r == k - 1:
        outs[r][T + lz:] = 0.0
    else:
        outs[r + 1][:T] = kept[lz - T:]


def _shards_round(firsts, share, outputs=None):
    """One call over all shards: an output like each ``firsts[r]`` (or
    ``outputs(r)``), allocated on shard r's stream; ``share(r, outs)`` on
    shard r's stream for each shard, which may store into the neighbours'
    outputs (held for r's stream); then each shard's stream waits on both
    neighbours', so every output is complete on its own shard's stream when
    the call returns.

    Before its share, shard r waits on both neighbours' work up to their
    outputs' allocation: the caching allocator may hand a neighbour a block
    that the neighbour's stream still reads or writes as an earlier
    temporary, which is safe on that stream alone, not for r's stores."""
    from ..parallel.streams import order_of

    order = order_of(firsts)
    k = len(firsts)
    make = outputs or (lambda r: torch.empty_like(firsts[r]))
    with order.scope():
        outs = []
        for r in range(k):
            with order.on(r, count=False):
                outs.append(make(r))
        marks = order.marks()
        for r in range(k):
            with order.on(r):
                order.wait(r, marks, r - 1, r + 1)
                for s in (r - 1, r + 1):
                    if 0 <= s < k:
                        for out in (outs[s] if isinstance(outs[s], list) else [outs[s]]):
                            order.hold(out, r)
                share(r, outs)
        marks = order.marks()
        for r in range(k):
            order.wait(r, marks, r - 1, r + 1)
    return outs


def jacobi_ext_rdma(xps, x0_exts, a: float, c: float, t_iters: int, b: int = 0,
                    obst_exts=None):
    """K12: one round of the sharded solve on every shard, ``t_iters`` (T)
    sweeps of each float32 extended slab of ``xps`` (``(lz + 2T, n, n)``, in
    rank order, each shard's on its own device) with rhs ``x0_exts`` and the
    rank's global z walls, then the exchange: each shard's fresh edge planes
    go into its neighbours' halos.  Returns each shard's complete next
    extended slab (see ``jacobi_ext_rdma_plain``), new tensors, so rounds
    chain with no other exchange.  The bool masks ``obst_exts`` make the
    coefficient 0 in solids.

    CUDA tensors launch ``fs_jacobi_ext_rdma`` (``csrc/jacobi_ext.cu``) once
    per shard, on the shard's stream, the pushes stored through the
    neighbours' output pointers (peer pointers across cards); CPU tensors
    run ``jacobi_ext_rdma_plain``.  Each shard's output is complete on its
    stream when the call returns (``_shards_round``).
    ``jacobi_ext_rdma.launches`` counts the launches."""
    if b not in (0, 1, 2, 3):
        raise ValueError(f"boundary code must be 0..3, got {b}")
    if int(t_iters) != t_iters or t_iters < 1:
        raise ValueError(f"t_iters must be a positive integer, got {t_iters}")
    T, k = int(t_iters), len(xps)
    if k < 1 or len(x0_exts) != k or (obst_exts is not None and len(obst_exts) != k):
        raise ValueError("xps, x0_exts and obst_exts need one slab per shard")
    nz, n = xps[0].shape[0], xps[0].shape[-1]
    lz = nz - 2 * T
    if xps[0].dim() != 3 or n < 3 or lz < T:
        raise ValueError(f"expected (lz + 2T, n, n) slabs with lz >= T = {T} and n >= 3, "
                         f"got {tuple(xps[0].shape)}")
    if xps[0].device.type == "cuda":
        check_offsets(nz, n)
    _check_shards("xps", xps, (nz, n, n))
    _check_shards("x0_exts", x0_exts, (nz, n, n))
    if obst_exts is not None:
        _check_shards("obst_exts", obst_exts, (nz, n, n), torch.bool)
    for r in range(k):
        own = [x0_exts[r]] + ([] if obst_exts is None else [obst_exts[r]])
        if any(t.device != xps[r].device for t in own):
            raise ValueError(f"shard {r}'s tensors must be on one device")
    device = xps[0].device
    if device.type == "cpu":
        return jacobi_ext_rdma_plain(xps, x0_exts, a, c, T, b, obst_exts)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")

    lib = _build.load_library()
    a32, inv_c = solve_coefficients(a, c)

    def share(r, outs):
        # Each shard's scratch of its own: the shards' rounds run at once.
        with span("kernel.K12"):
            tmp = torch.empty_like(xps[r]) if T > ROUND_MAX_SWEEPS else None
            spare = torch.empty_like(xps[r]) if T > 2 * ROUND_MAX_SWEEPS else None
            err = lib.fs_jacobi_ext_rdma(
                xps[r].data_ptr(), x0_exts[r].data_ptr(),
                None if obst_exts is None else obst_exts[r].data_ptr(), outs[r].data_ptr(),
                _ptr(tmp), _ptr(spare), outs[r - 1].data_ptr() if r > 0 else None,
                outs[r + 1].data_ptr() if r < k - 1 else None, nz, n, int(b), a32, inv_c, T,
                *rank_walls(r, k, T, lz), torch.cuda.current_stream().cuda_stream,
            )
            _build.check(lib, err, "sharded Jacobi round kernel launch")
            jacobi_ext_rdma.launches += 1

    return _shards_round(xps, share)


jacobi_ext_rdma.launches = 0


def ext_halo(window: int, n_sub: int, masked: bool) -> int:
    """The planes a K11 call erodes from each end of its slab (and so the
    halo its caller exchanges): ``window·n_sub``, or ``n_sub·(window+1)``
    with a mask, whose mirror reads one plane further each substep."""
    return n_sub * (window + 1) if masked else window * n_sub


def _nonborder_solid(obst_ext, n: int, z_offset: int):
    """Solid cells of the slab's mask that are not border cells (x, y in
    [1, n−2], global z not 0 or n−1): where the obstacle mirror writes."""
    nz = obst_ext.shape[0]
    dev = obst_ext.device
    zg = torch.arange(nz, device=dev)[:, None, None] + z_offset
    ar = torch.arange(n, device=dev)
    inner = (ar >= 1) & (ar <= n - 2)
    return obst_ext & (zg != 0) & (zg != n - 1) & inner[None, :, None] & inner[None, None, :]


def _mirror_ext(v, obst_ext, writes, axis: int):
    """The obstacle mirror along ``axis`` of the slab ``v`` (the arithmetic of
    ``ops/boundary._mirror_obstacles_axis``) at the cells ``writes``,
    neighbours read wrapped."""
    fluid = ~obst_ext
    prev_fluid = torch.roll(fluid, 1, axis)
    next_fluid = torch.roll(fluid, -1, axis)
    total = (torch.where(prev_fluid, -torch.roll(v, 1, axis), 0.0)
             + torch.where(next_fluid, -torch.roll(v, -1, axis), 0.0))
    count = prev_fluid.to(v.dtype) + next_fluid.to(v.dtype)
    mirrored = torch.where(count > 0, total / torch.clamp(count, min=1.0), 0.0)
    return torch.where(writes, mirrored, v)


def advect_ext_plain(bs, fields_ext, vel_ext, n: int, dt: float, z_offset: int,
                     window: int = 1, n_sub: int = 1, obst_ext=None):
    """Plain PyTorch twin of K11: advect the ``(F, nz, n, n)`` slab
    ``fields_ext`` (boundary codes ``bs``) through ``vel_ext`` in ``n_sub``
    substeps with the backtrace clamped to ``window`` cells, the slab's plane
    0 at global z ``z_offset`` of the ``n³`` grid.  Per substep: the sample
    (K = 1: the two-tap form, x innermost, then y, then z; K > 1:
    ``window_sum_3d`` on the slab), with the bool mask the solid cells
    zeroed, the faces (``slab_faces`` at the global walls' slab planes
    ``-z_offset`` and ``n−1−z_offset``), and for velocity codes with the mask
    the obstacle mirror.  Taps past the slab's ends wrap modulo ``nz``.

    On bfloat16 slabs the whole call runs on their float32 values and the
    result is rounded once."""
    if fields_ext.dtype == torch.bfloat16:
        return advect_ext_plain(bs, fields_ext.float(), vel_ext.float(), n, dt, z_offset,
                                window, n_sub, obst_ext).to(torch.bfloat16)
    nz = fields_ext.shape[1]
    dt0 = substep_dt0(dt, n, n_sub)
    f32 = torch.float32
    dev = fields_ext.device
    fields = fields_ext
    if window == 1:
        ar = torch.arange(n, dtype=f32, device=dev)
        zc = (torch.arange(nz, device=dev) + z_offset).to(f32)[:, None, None]

        def frac(c, v):
            t = c - dt0 * v
            t = torch.where(t < 0.5, 0.5, t)
            t = torch.where(t > n - 1.5, n - 1.5, t)
            t = torch.minimum(torch.maximum(t, c - 1.0), c + 1.0)
            return t - c

        fx = frac(ar[None, None, :], vel_ext[0])
        fy = frac(ar[None, :, None], vel_ext[1])
        fz = frac(zc, vel_ext[2])
        w = [(torch.clamp(f, min=0.0), torch.clamp(-f, min=0.0)) for f in (fx, fy, fz)]

        def interp(g, dim, wts, inner):
            # (g at -1, g, g at +1 along dim), each through `inner` first.
            return _comb(inner(torch.roll(g, 1, dim)), inner(g), inner(torch.roll(g, -1, dim)),
                         *wts)

        def sample(f):
            def x_i(g):
                return _comb(torch.roll(g, 1, -1), g, torch.roll(g, -1, -1), *w[0])

            def yx_i(g):
                return interp(g, -2, w[1], x_i)

            return interp(f, -3, w[2], yx_i)
    else:
        def sample(f):
            return window_sum_3d(f, vel_ext, dt0, window, z_offset)

    writes = None if obst_ext is None else _nonborder_solid(obst_ext, n, z_offset)
    for _ in range(n_sub):
        vals = sample(fields)
        out = []
        for c, b in enumerate(bs):
            v = vals[c]
            if obst_ext is not None:
                v = torch.where(obst_ext, 0.0, v)
            v = slab_faces(b, v, -z_offset, n - 1 - z_offset)
            if obst_ext is not None and b in (1, 2, 3):
                v = _mirror_ext(v, obst_ext, writes, 3 - b)
            out.append(v)
        fields = torch.stack(out)
    return fields


@spanned("kernel.K11")
def advect_ext_kernel(bs, fields_ext, vel_ext, n: int, dt: float, z_offset: int,
                      window: int = 1, n_sub: int = 1, obst_ext=None):
    """K11: advect the float32 or bfloat16 ``(F, nz, n, n)`` halo-extended slab
    ``fields_ext`` (F = 1 or 3, boundary codes ``bs``; ``fields_ext is
    vel_ext`` for self-advection) through ``vel_ext`` with a ``window`` of K
    >= 1 cells in ``n_sub`` substeps, the slab's plane 0 at global z
    ``z_offset`` of the ``n³`` grid, with the obstacle contract after each
    substep when the bool mask ``obst_ext`` is given.  The outer
    ``ext_halo(window, n_sub, masked)`` planes of the result are erosion
    margin.

    ``vel_ext`` has the fields' dtype.  CUDA tensors launch
    ``csrc/advect_ext.cu`` (bfloat16: K1's bfloat16 instantiations of
    ``csrc/advect_bf16.cu`` on the slab); CPU tensors run
    ``advect_ext_plain``.  Returns a new tensor.
    ``advect_ext_kernel.launches`` counts calls that launched the kernel,
    ``kernels.advect.advect_launches`` their substeps by route."""
    bs = tuple(bs)
    n_sub = _check_substeps(n_sub)
    if fields_ext.dim() != 4 or vel_ext.dim() != 4:
        raise ValueError("expected (F, nz, n, n) fields and a (3, nz, n, n) velocity")
    n_fields, nz = fields_ext.shape[0], fields_ext.shape[1]
    if n_fields not in (1, 3) or len(bs) != n_fields:
        raise ValueError(f"unsupported fields {tuple(fields_ext.shape)} with bs={bs}")
    window = check_window(window, n, nz)
    if int(z_offset) != z_offset:
        raise ValueError(f"z_offset must be an integer, got {z_offset}")
    z_offset = int(z_offset)
    _check_volume("fields_ext", fields_ext, (n_fields, nz, n, n), STORAGE)
    _check_volume("vel_ext", vel_ext, (3, nz, n, n), fields_ext.dtype)
    tensors = [vel_ext]
    if obst_ext is not None:
        _check_volume("obst_ext", obst_ext, (nz, n, n), torch.bool)
        tensors.append(obst_ext)
    if any(t.device != fields_ext.device for t in tensors):
        raise ValueError("all tensors must be on one device")

    if fields_ext.device.type == "cpu":
        return advect_ext_plain(bs, fields_ext, vel_ext, n, dt, z_offset, window, n_sub,
                                obst_ext)
    if fields_ext.device.type != "cuda":
        raise ValueError(f"unsupported device {fields_ext.device}")

    lib = _build.load_library()
    out = torch.empty_like(fields_ext)
    mirror = obst_ext is not None and any(c in (1, 2, 3) for c in bs)
    tmp0, tmp1 = _scratch(n_fields, n, n_sub, mirror, fields_ext.dtype, fields_ext.device,
                          nz=nz)
    b = bs + (0,) * (3 - n_fields)
    with torch.cuda.device(fields_ext.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_advect_ext(
            fields_ext.data_ptr(), vel_ext.data_ptr(), _ptr(obst_ext), out.data_ptr(),
            _ptr(tmp0), _ptr(tmp1), n, nz, z_offset, n_fields, b[0], b[1], b[2],
            substep_dt0(dt, n, n_sub), n_sub, window, storage_flag(fields_ext.dtype),
            stream,
        )
    _build.check(lib, err, "extended-slab advection kernel launch")
    advect_ext_kernel.launches += 1
    count_substeps(window, n_fields, n_sub, fields_ext.device)
    return out


advect_ext_kernel.launches = 0


def _exchange_geometry(arrays_by_shard, depth: int):
    """``(lz, n, h)`` of a K13 call, with the JAX package's errors."""
    if not arrays_by_shard or not arrays_by_shard[0]:
        raise ValueError("a halo exchange needs at least one shard and one array")
    n_arrays = len(arrays_by_shard[0])
    first = arrays_by_shard[0][0]
    if first.dim() != 4:
        raise ValueError(f"expected (C, lz, n, n) arrays, got {tuple(first.shape)}")
    lz, n = first.shape[1], first.shape[-1]
    h = int(depth)
    if h != depth or h < 0:
        raise ValueError(f"halo depth must be a non-negative integer, got {depth}")
    if h > lz:
        raise ValueError(f"halo depth={h} exceeds local slab depth {lz}")
    for arrays in arrays_by_shard:
        if len(arrays) != n_arrays:
            raise ValueError("every shard needs the same arrays")
        for x, x_first in zip(arrays, arrays_by_shard[0]):
            if x.dim() != 4 or tuple(x.shape[1:]) != (lz, n, n):
                raise ValueError("all arrays must share (lz, n, n) geometry")
            if x.shape != x_first.shape or x.dtype != x_first.dtype:
                raise ValueError("an array must have one shape and dtype on every shard")
    return lz, n, h


def halo_exchange_rdma_plain(arrays_by_shard, depth: int):
    """Plain PyTorch twin of K13: for each shard (in rank order) a list of
    ``(C_j, lz, n, n)`` arrays of any dtype; returns for each shard the
    ``(C_j, lz + 2·depth, n, n)`` extended arrays: the lower neighbour's last
    ``depth`` planes, the local planes, the upper neighbour's first
    ``depth`` planes, zeros past the global ends (``halo_exchange_z``
    followed by ``cat``).  Each shard's share runs as the kernel's does
    (``_shards_round``), its edge planes stored into the neighbours'
    outputs."""
    lz, n, h = _exchange_geometry(arrays_by_shard, depth)
    return _shards_round([arrays[0] for arrays in arrays_by_shard],
                         lambda r, outs: _k13_share_plain(r, outs, arrays_by_shard, lz, h),
                         _exchange_outputs(arrays_by_shard, lz, h, n))


def _exchange_outputs(arrays_by_shard, lz: int, h: int, n: int):
    """Shard r's extended arrays of a K13 call, allocated (``outputs(r)`` of
    ``_shards_round``)."""
    return lambda r: [x.new_empty((x.shape[0], lz + 2 * h, n, n))
                      for x in arrays_by_shard[r]]


def _k13_share_plain(r, outs, arrays_by_shard, lz, h):
    """Shard ``r``'s share of a K13 call on the twins: its planes into its
    outputs (zeros in their halos at a global end) and its edge planes into
    the neighbours' outputs."""
    k = len(arrays_by_shard)
    for j, x in enumerate(arrays_by_shard[r]):
        outs[r][j][:, h:h + lz] = x
        if r == 0:
            outs[r][j][:, :h] = 0
        else:
            outs[r - 1][j][:, h + lz:] = x[:, :h]
        if r == k - 1:
            outs[r][j][:, h + lz:] = 0
        else:
            outs[r + 1][j][:, :h] = x[:, lz - h:]


def halo_exchange_rdma(arrays_by_shard, depth: int):
    """K13: halo-extend every shard's arrays in one call (each
    ``(C_j, lz, n, n)`` of a 4-, 2- or 1-byte dtype, every channel's planes
    contiguous; the channel stride is free, so a shard's view of a global
    ``(C, N, n, n)`` tensor needs no copy; each shard's arrays on its own
    device).  Returns for each shard its extended arrays, as
    ``halo_exchange_rdma_plain``.

    CUDA tensors launch ``csrc/halo_exchange.cu`` once per shard, on the
    shard's stream, every array of the shard in that launch (at most
    ``kMaxArrays`` of ``csrc/halo_copy.cuh``: the launch raises past it),
    the edge planes stored through the neighbours' output pointers (peer
    pointers across cards); CPU tensors run the twin.  Each shard's outputs
    are complete on its stream when the call returns.
    ``halo_exchange_rdma.launches`` counts the launches."""
    lz, n, h = _exchange_geometry(arrays_by_shard, depth)
    n_arrays = len(arrays_by_shard[0])
    for r, arrays in enumerate(arrays_by_shard):
        if any(x.device != arrays[0].device for x in arrays):
            raise ValueError(f"shard {r}'s tensors must be on one device")
    device = arrays_by_shard[0][0].device
    if device.type == "cpu":
        return halo_exchange_rdma_plain(arrays_by_shard, depth)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    for x in arrays_by_shard[0]:
        if x.element_size() not in (1, 2, 4):
            raise TypeError(f"the exchange moves 4-, 2- or 1-byte values, got {x.dtype}")
    for arrays in arrays_by_shard:
        for x in arrays:
            if x.stride()[1:] != (n * n, n, 1):
                raise ValueError("each channel's (lz, n, n) planes must be contiguous")

    lib = _build.load_library()
    k = len(arrays_by_shard)

    def share(r, outs):
        with span("kernel.K13"):
            arrays = arrays_by_shard[r]
            desc = (_build.HaloArray * n_arrays)(*(
                _build.HaloArray(x.data_ptr(), outs[r][j].data_ptr(),
                                 outs[r - 1][j].data_ptr() if r > 0 else None,
                                 outs[r + 1][j].data_ptr() if r < k - 1 else None,
                                 x.stride(0), x.shape[0], x.element_size())
                for j, x in enumerate(arrays)))
            err = lib.fs_halo_exchange(desc, n_arrays, lz, h, n,
                                       torch.cuda.current_stream().cuda_stream)
            _build.check(lib, err, "halo exchange kernel launch")
            halo_exchange_rdma.launches += 1

    return _shards_round([arrays[0] for arrays in arrays_by_shard], share,
                         _exchange_outputs(arrays_by_shard, lz, h, n))


halo_exchange_rdma.launches = 0
