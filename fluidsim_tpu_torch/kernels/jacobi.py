"""K6, the temporally blocked Jacobi solve, and K4, the whole-volume Jacobi
solve: their plain twins and their wrappers.

Counterpart of ``fluidsim_tpu/pallas/jacobi.py`` (``jacobi_3d_pallas`` →
``_jacobi_kernel``), the general no-obstacle solve ``x ← (x0 + a·Σ₆x)·inv_c``
with ``inv_c = f32(1)/f32(c)``, the ``set_bnd_3d(b)`` faces written once at
the end.  The CUDA kernel is ``csrc/jacobi.cu``: up to four sweeps a launch
(``csrc/jacobi_pass.cuh``), streamed along z with the z neighbours in
registers, corrected neighbour reads at the walls, and the faces stored by
the last launch's last sweep.
``jacobi_3d_plain`` is the same arithmetic in plain PyTorch: it writes the
faces after every sweep instead, which gives every interior cell the same
neighbour values as the corrected reads.  It serves CPU tensors and is the
reference the kernel is checked against.

K4 is the counterpart of ``fluidsim_tpu/pallas/resident.py``
(``jacobi_3d_resident`` → ``_jacobi_kernel`` / ``_jacobi_obst_kernel``,
solve ``_solve_loop``): the same sweeps from a given start, the faces after
each, and with an obstacle mask (``b = 0``) the solid cells held at their
start value through the ``coef`` and ``frozen`` volumes.  The CUDA kernel is
``csrc/jacobi_resident.cu``: one persistent launch of the tile program
(``csrc/solve_tiled.cuh``) where ``k4_tiles`` finds a tiling, else one
launch per sweep (per stage of a K5 block); ``k4_launches`` counts the
routes; ``jacobi_3d_resident_plain`` is its twin.

K5 is ``_solve_loop`` with ``block = T ≥ 2`` (the sweep-blocked solve), which
runs inside K4 without a mask and inside the projections (K2, K3, K8):
``solve_loop_plain`` is its twin, operation for operation, and
``csrc/sweep_block.cuh`` its arithmetic, run by the tile program on chip
where a tiling fits and one launch a stage elsewhere.  ``T = 2`` is the delta form
``x1 + (a·ic)²·N(N(p))`` with six plane corrections; ``T ≥ 3`` the hoisted
chain ``X + a^T·(C·N)^T(p)`` with planes ``1..T−1`` of each wall recomputed
by the sequential shell recurrence.  ``N`` is the toroidal neighbour sum of
the TPU kernel (``roll``): the chain reads wrapped planes at the walls.

Both solves are float32: bfloat16 inputs are solved on their float32 values
and the result rounded back (the JAX ``jacobi_3d_resident``'s edge upcast).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.boundary import apply_faces_3d, set_bnd_3d
from ..ops.linsolve import _nbr_sum_3d
from ..utils.profiling import spanned
from . import _build
from .advect import _check_volume, _ptr


def solve_coefficients(a: float, c: float):
    """``(f32(a), f32(1)/f32(c))`` as Python floats, as the TPU kernel takes
    them."""
    return float(np.float32(a)), float(np.float32(1.0) / np.float32(c))


# Sweeps a launch of K6, K10 and K12 (``kMaxLevels`` in csrc/jacobi_pass.cuh).
ROUND_MAX_SWEEPS = 4


def round_passes(iters: int) -> int:
    """The launches of a K6, K10 or K12 call of ``iters`` sweeps."""
    return -(-int(iters) // ROUND_MAX_SWEEPS)


def check_offsets(nz: int, n: int) -> None:
    """Raise unless an ``(nz, n, n)`` volume fits the Jacobi round's 32-bit
    offsets (``nz·n² < 2³¹``)."""
    if nz * n * n >= 2 ** 31:
        raise ValueError(f"({nz}, {n}, {n}) has nz*n^2 >= 2^31 cells: the kernel's offsets "
                         "are 32-bit")


def jacobi_3d_plain(b: int, x, x0, a: float, c: float, iters: int):
    """Plain PyTorch twin of the K6 kernel: ``iters`` sweeps of
    ``(x0 + a·nbr)·inv_c`` on the interior of the float32 ``(N, N, N)``
    ``x`` (normalised by ``set_bnd_3d(b)`` first), the faces after each."""
    if x.dtype == torch.bfloat16:
        return jacobi_3d_plain(b, x.float(), x0.float(), a, c, iters).to(x.dtype)
    a32, inv_c = solve_coefficients(a, c)
    x0_int = x0[(slice(1, -1),) * 3]
    x = set_bnd_3d(b, x)
    for _ in range(iters):
        upd = (x0_int + a32 * _nbr_sum_3d(x)) * inv_c
        x = apply_faces_3d(b, F.pad(upd, (1, 1, 1, 1, 1, 1)))
    return x


@spanned("kernel.K6")
def jacobi_3d_kernel(b: int, x, x0, a: float, c: float, iters: int):
    """Solve with the K6 kernel: ``iters`` Jacobi sweeps, then the
    ``set_bnd_3d(b)`` faces.

    CUDA tensors launch ``csrc/jacobi.cu``; CPU tensors run
    ``jacobi_3d_plain``.  Returns a new float32 ``(N, N, N)`` tensor.
    ``jacobi_3d_kernel.launches`` counts calls that launched the kernel."""
    if x.dtype == torch.bfloat16:
        return jacobi_3d_kernel(b, x.float(), x0.float(), a, c, iters).to(x.dtype)
    if b not in (0, 1, 2, 3):
        raise ValueError(f"boundary code must be 0..3, got {b}")
    if int(iters) != iters or iters < 1:
        raise ValueError(f"iters must be a positive integer, got {iters}")
    n = x.shape[-1]
    if n < 3:
        raise ValueError(f"grid too small: {n}")
    if x.device.type == "cuda":
        check_offsets(n, n)
    _check_volume("x", x, (n, n, n))
    _check_volume("x0", x0, (n, n, n))
    if x0.device != x.device:
        raise ValueError("x and x0 must be on one device")

    if x.device.type == "cpu":
        return jacobi_3d_plain(b, x, x0, a, c, iters)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")

    lib = _build.load_library()
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if iters > ROUND_MAX_SWEEPS else None
    a32, inv_c = solve_coefficients(a, c)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_jacobi(
            x.data_ptr(), x0.data_ptr(), out.data_ptr(), _ptr(tmp), n,
            int(b), a32, inv_c, int(iters), stream,
        )
    _build.check(lib, err, "Jacobi kernel launch")
    jacobi_3d_kernel.launches += 1
    return out


jacobi_3d_kernel.launches = 0


def nbr_sum_torus(v):
    """The TPU kernel's ``_nbr_sum`` on a whole float32 ``(N, N, N)`` volume:
    the 6-neighbour sum with ``roll``'s toroidal wrap at the walls, in the add
    order ``((x₊+x₋) + (y₊+y₋)) + (z₊+z₋)``."""
    r = torch.roll
    return (((r(v, -1, 2) + r(v, 1, 2)) + (r(v, -1, 1) + r(v, 1, 1)))
            + (r(v, -1, 0) + r(v, 1, 0)))


def composite_block(n: int, iters: int, block: int, b: int = 0,
                    frozen: bool = False) -> int:
    """The sweep block a solve of ``iters`` sweeps on an ``n³`` grid runs:
    ``block`` where ``_solve_loop``'s gate ``use_block`` holds (``b == 0``,
    no frozen volume, ``iters ≥ T``, and ``T == 2`` or ``n ≥ 4·T``), else 1
    (sequential sweeps)."""
    t = int(block)
    ok = (b == 0 and not frozen and t >= 2 and iters >= t
          and (t == 2 or n >= 4 * t))
    return t if ok else 1


def block_constants(a: float, inv_c: float, block: int):
    """The float32 constants of the composite, as numpy computes them in the
    TPU kernel: ``(aic, aicic, a2, a2ic2, aT)`` with ``aic = a·ic``,
    ``aicic = aic·ic``, ``a2 = a·a``, ``a2ic2 = aic·aic`` (the ``T = 2``
    form) and ``aT = a^T`` by repeated float32 products (the chain)."""
    f = np.float32
    a32, ic = f(a), f(inv_c)
    aic = f(a32 * ic)
    pw = f(1.0)
    for _ in range(block):
        pw = f(pw * a32)
    return tuple(float(v) for v in (aic, f(aic * ic), f(a32 * a32), f(aic * aic), pw))


def solve_block_arg(n: int, block: int, a: float, inv_c: float, device,
                    tiled: bool = False):
    """K5's ``SolveBlock`` for the C entries: None for ``block == 1``
    (sequential sweeps), else the block, its constants and fresh float32
    scratch (``x1``, the chain volumes except on the tiles, which keep the
    chain on chip, and for ``T ≥ 3`` the shell levels), which the struct
    keeps alive as ``scratch``."""
    if block == 1:
        return None

    def buf(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    x1 = buf(n, n, n)
    w0 = w1 = s0 = s1 = None
    if not tiled:
        w0 = buf(n, n, n)
    if block >= 3:
        s0, s1 = buf(6 * 2 * block, n, n), buf(6 * 2 * block, n, n)
        if not tiled:
            w1 = buf(n, n, n)
    blk = _build.SolveBlock(block, a, inv_c, *block_constants(a, inv_c, block),
                            *(_ptr(v) for v in (x1, w0, w1, s0, s1)))
    blk.scratch = (x1, w0, w1, s0, s1)
    return blk


def _plane_faces(v, axis: int):
    """The ``b = 0`` face copies along the two in-plane axes of a plane value
    (size 1 along ``axis``), in ascending axis order (the TPU kernel's
    ``_plane_faces``)."""
    for ax in range(3):
        if ax == axis:
            continue
        m = v.shape[ax]
        idx = torch.tensor([1, *range(1, m - 1), m - 2], device=v.device)
        v = v.index_select(ax, idx)
    return v


def shell_planes_plain(src, x0, coef, *, block: int, a: float, inv_c: float):
    """Planes ``1..T−1`` of each wall after ``T = block`` sequential sweeps
    from the face-consistent ``src``, from the TPU kernel's shell recurrence
    (``_shell_exact_planes``): per axis and side, level ``k`` recomputes
    planes ``1..2T−1−k`` with the sweep's arithmetic in float32 and the
    in-plane faces, its wall plane an alias of plane 1.  Returns ``[(axis,
    plane index, (N, N) value), ...]`` in the order the kernel writes them:
    z lo, z hi, y lo, y hi, x lo, x hi."""
    n = src.shape[-1]
    out = []
    for axis in range(3):
        for lo in (True, False):
            def idx(j, lo=lo):
                return j if lo else n - 1 - j

            def plane(v, j, axis=axis, idx=idx):
                return v.narrow(axis, idx(j), 1).float()

            prev = [plane(src, j) for j in range(2 * block)]
            for k in range(1, block + 1):
                depth = 2 * block - 1 - k
                cur = [None] * (depth + 1)
                for j in range(1, depth + 1):
                    c = prev[j]

                    def pair(ax):
                        if ax == axis:
                            plus, minus = ((prev[j + 1], prev[j - 1]) if lo
                                           else (prev[j - 1], prev[j + 1]))
                            return plus + minus
                        return torch.roll(c, -1, ax) + torch.roll(c, 1, ax)

                    nbr = (pair(2) + pair(1)) + pair(0)
                    mul = inv_c if coef is None else plane(coef, j)
                    cur[j] = _plane_faces((plane(x0, j) + a * nbr) * mul, axis)
                cur[0] = cur[1]
                prev = cur
            out.extend((axis, idx(j), prev[j].squeeze(axis))
                       for j in range(1, block))
    return out


def solve_loop_plain(x0, p, *, b: int, a: float, inv_c: float, iters: int,
                     coef=None, frozen=None, block: int = 1):
    """Plain PyTorch twin of the TPU solve ``_solve_loop``: ``iters`` Jacobi
    sweeps of ``(x0 + a·nbr)·C (+ frozen)`` from the start ``p`` (its dtype
    is the solve dtype; every iterate rounds to it), ``C`` the scalar
    ``inv_c`` or the float32 volume ``coef``, the ``set_bnd_3d(b)`` faces
    after each.  The first sweep without ``coef`` reads the x face rule
    (``_nbr_sum_selx``) instead of the start's x faces.

    Where ``composite_block`` allows ``T = block ≥ 2`` (K5), the sweeps run
    in blocks of T and the ``iters % T`` left over run one by one:

    * ``T = 2``: ``x1 = ic·x0 + (aic·ic)·N(x0)`` once (with ``coef``:
      ``C·x0 + (a·C)·N(C·x0)``), then per block ``x1 + a2ic2·N(N(p))``
      (``x1 + (a2·C)·N(C·N(p))``) rounded to the solve dtype, plus the
      corrections ``mul·(tmp_raw[j] − tmp_raw[wall])`` on the first interior
      plane of each wall (axis 0 lo, hi, then 1, then 2; each rounded),
      ``tmp_raw = (x0 + a·N(p))·C``, ``mul = aic`` (``a·C``), then the faces;
    * ``T ≥ 3``: ``X = Σ_{k<T} a^k·g_k``, ``g_0 = C·x0``, ``g_k = C·N(g_{k−1})``
      once, then per block ``X + a^T·C·N(C·…N(p))`` rounded, planes
      ``1..T−1`` of each wall overwritten by ``shell_planes_plain``, then the
      faces.

    ``N`` is ``nbr_sum_torus``.  ``x0`` (any float dtype) and the volumes are
    ``(N, N, N)``; returns the final iterate in the solve dtype."""
    n = p.shape[-1]
    sdt = p.dtype
    core = (slice(1, -1),) * 3
    x0v = x0.float()
    x0_int = x0v[core]
    mul_int = inv_c if coef is None else coef[core]
    fr_int = None if frozen is None else frozen[core]

    def sweep(q, substitute):
        src = q.float()
        if substitute:
            src = src.clone()
            for dst, own in ((0, 1), (-1, -2)):
                src[..., dst] = -src[..., own] if b == 1 else src[..., own]
        nbr = _nbr_sum_3d(src)
        upd = (x0_int + (nbr if a == 1.0 else a * nbr)) * mul_int
        if fr_int is not None:
            upd = upd + fr_int
        return apply_faces_3d(b, F.pad(upd.to(sdt), (1, 1, 1, 1, 1, 1)))

    t = composite_block(n, iters, block, b, frozen is not None)
    if t == 1:
        for it in range(iters):
            p = sweep(p, it == 0 and coef is None)
        return p

    aic, aicic, a2, a2ic2, a_t = block_constants(a, inv_c, t)

    def cmul(v):
        return inv_c * v if coef is None else coef * v

    if t == 2:
        if coef is None:
            x1 = inv_c * x0v + aicic * nbr_sum_torus(x0v)
        else:
            x1 = coef * x0v + (a * coef) * nbr_sum_torus(coef * x0v)

        def blockstep(src):
            u = nbr_sum_torus(src.float())
            if coef is None:
                out = x1 + a2ic2 * nbr_sum_torus(u)
            else:
                out = x1 + (a2 * coef) * nbr_sum_torus(coef * u)
            dst = out.to(sdt)
            raw = cmul(x0v + a * u)
            for axis in range(3):
                for j, w in ((1, 0), (n - 2, n - 1)):
                    corr = raw.select(axis, j) - raw.select(axis, w)
                    mul = aic if coef is None else a * coef.select(axis, j)
                    d = dst.select(axis, j)
                    d.copy_((d.float() + mul * corr).to(sdt))
            return apply_faces_3d(0, dst)
    else:
        pw = np.float32(1.0)
        g = cmul(x0v)
        x1 = g
        for _ in range(t - 1):
            pw = np.float32(pw * np.float32(a))
            g = cmul(nbr_sum_torus(g))
            x1 = x1 + float(pw) * g

        def blockstep(src):
            h = nbr_sum_torus(src.float())
            for _ in range(t - 1):
                h = nbr_sum_torus(cmul(h))
            dst = (x1 + a_t * cmul(h)).to(sdt)
            for axis, j, val in shell_planes_plain(src, x0v, coef, block=t, a=a,
                                                   inv_c=inv_c):
                dst.select(axis, j).copy_(val.to(sdt))
            return apply_faces_3d(0, dst)

    for _ in range(iters // t):
        p = blockstep(p)
    for _ in range(iters % t):
        p = sweep(p, False)
    return p


def jacobi_3d_resident_plain(b: int, x, x0, a: float, c: float, iters: int,
                             obst=None, sweep_block: int = 1):
    """Plain PyTorch twin of the K4 kernel: ``iters`` sweeps of
    ``(x0 + a·nbr)·inv_c`` (``x0 + nbr`` when ``a == 1``) from the float32
    ``(N, N, N)`` start ``x``, the faces after each (``solve_loop_plain``).
    Without a mask the x operands take the x face rule (``sx·`` the cell
    itself next to an x wall, the TPU kernel's ``_nbr_sum_selx``) and the
    sweeps run in blocks of ``sweep_block`` (K5) where ``composite_block``
    allows; with the bool mask ``obst`` (``b == 0``) the sweep is
    ``rhs·((1 − m)·inv_c) + m·x_start``.  bfloat16 inputs are solved in
    float32 with sequential sweeps, as the JAX entry's upcast drops
    ``sweep_block``."""
    if x.dtype == torch.bfloat16:
        return jacobi_3d_resident_plain(b, x.float(), x0.float(), a, c, iters,
                                        obst).to(x.dtype)
    a32, inv_c = solve_coefficients(a, c)
    coef = frozen = None
    if obst is not None:
        mf = obst.to(torch.float32)
        coef = (1.0 - mf) * inv_c
        frozen = mf * x
    return solve_loop_plain(x0, x, b=b, a=a32, inv_c=inv_c, iters=iters,
                            coef=coef, frozen=frozen, block=sweep_block)


# Launches of K4 (csrc/jacobi_resident.cu) by route: "tiled" counts tiled
# solves, one launch each; "sweep" the per-sweep route's launches (a sweep
# each, and the sweeps K5's per-stage route leaves over).
k4_launches = {"tiled": 0, "sweep": 0}


def k4_tiles(n: int, iters: int, sweep_block: int = 1, b: int = 0, masked: bool = False,
             device=None):
    """The tiling K4's ``n³`` solve of ``iters`` sweeps takes on ``device``
    (``kernels/resident.solve_tiles`` for the float32 tile program of K4's
    sweeps, or of K5's blocks where ``composite_block`` allows them), or
    None, where one launch a sweep (a stage of K5's block) runs."""
    from . import resident

    block = composite_block(n, iters, sweep_block, b, masked)
    return resident.solve_tiles(n, torch.float32, device, block, masked, True)


@spanned("kernel.K4")
def jacobi_3d_resident(b: int, x, x0, a: float, c: float, iters: int, obst=None,
                       sweep_block: int = 1):
    """Solve with the K4 kernel: ``iters`` Jacobi sweeps from ``x``, the
    ``set_bnd_3d(b)`` faces after each, with the obstacle copy-through when
    the bool mask ``obst`` is given (``b == 0`` only), and without a mask in
    blocks of ``sweep_block`` (K5) where ``composite_block`` allows.

    CUDA tensors launch ``csrc/jacobi_resident.cu``: one persistent launch
    on ``k4_tiles``'s tiling, else one a sweep; CPU tensors run
    ``jacobi_3d_resident_plain``.  Returns a new float32 ``(N, N, N)``
    tensor (bfloat16 inputs: solved in float32 with sequential sweeps, the
    result rounded back).  ``jacobi_3d_resident.launches`` counts calls
    that launched the kernel, ``k4_launches`` the launches by route."""
    if x.dtype == torch.bfloat16:
        return jacobi_3d_resident(b, x.float(), x0.float(), a, c, iters, obst).to(x.dtype)
    if b not in (0, 1, 2, 3):
        raise ValueError(f"boundary code must be 0..3, got {b}")
    if obst is not None and b != 0:
        raise ValueError("the obstacle copy-through is for b == 0 only")
    if int(iters) != iters or iters < 1:
        raise ValueError(f"iters must be a positive integer, got {iters}")
    if int(sweep_block) != sweep_block or sweep_block < 1:
        raise ValueError(f"sweep_block must be a positive integer, got {sweep_block}")
    n = x.shape[-1]
    if n < 3:
        raise ValueError(f"grid too small: {n}")
    _check_volume("x", x, (n, n, n))
    _check_volume("x0", x0, (n, n, n))
    tensors = [x0]
    if obst is not None:
        _check_volume("obst", obst, (n, n, n), torch.bool)
        tensors.append(obst)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all tensors must be on one device")

    if x.device.type == "cpu":
        return jacobi_3d_resident_plain(b, x, x0, a, c, iters, obst, sweep_block)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")

    from .resident import tiles_arg

    lib = _build.load_library()
    out = torch.empty_like(x)
    masked = obst is not None
    tiles = k4_tiles(n, iters, sweep_block, b, masked, x.device)
    tmp = torch.empty_like(x) if tiles is None and iters > 1 else None
    a32, inv_c = solve_coefficients(a, c)
    blk = solve_block_arg(n, composite_block(n, iters, sweep_block, b, masked), a32, inv_c,
                          x.device, tiles is not None)
    targ = None if tiles is None else tiles_arg(n, tiles, x.device, torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_jacobi_resident(
            x.data_ptr(), x0.data_ptr(), None if obst is None else obst.data_ptr(),
            out.data_ptr(), None if tmp is None else tmp.data_ptr(), n, int(b),
            a32, inv_c, int(iters), blk, targ, stream,
        )
    _build.check(lib, err, "resident Jacobi kernel launch")
    jacobi_3d_resident.launches += 1
    if tiles is not None:
        k4_launches["tiled"] += 1
    else:
        k4_launches["sweep"] += iters if blk is None else iters % blk.block
    return out


jacobi_3d_resident.launches = 0
