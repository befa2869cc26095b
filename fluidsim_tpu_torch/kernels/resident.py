"""K2, the fused projection + density advection kernel (with its emitter
and obstacle variants K2s and K2o), K3, the projection on its own with an
optional obstacle mask, K8, the whole step in one launch, and K14, the
self-advection and the projection in one launch: their plain twins and their
wrappers.  Every projection takes ``sweep_block``: on float32 fields its
solve runs K5, the sweep-blocked solve (``jacobi.solve_loop_plain``,
``csrc/sweep_block.cuh``), where ``projection_block`` allows.

Counterpart of ``fluidsim_tpu/pallas/resident.py``: K2 is
``project_advect_density_3d_resident`` → ``_project_advect_kernel`` (phases
``_project_body``, ``_solve_loop`` and ``_density_phase``; K2s is
``_project_advect_src_kernel``, K2o ``_project_advect_obst_kernel``), K3 is
``project_3d_resident`` → ``_project_kernel`` / ``_project_obst_kernel``, K8
is ``full_step_3d_resident`` → ``_full_step_kernel``, K14 is
``advect_project_3d_resident`` → ``_advect_project_kernel`` (its slab rule
is the TPU's scaffolding and is not copied).  The CUDA kernels are
``csrc/project_advect.cu``, ``csrc/project.cu`` and ``csrc/full_step.cu``,
which share the projection's phases (``csrc/project.cuh``) and K1's
backtrace (``csrc/advect.cuh``).  In K2 and K3 the divergence and every
sweep of the solve are one persistent launch (``csrc/solve_tiled.cuh``;
K5's blocks on its tile program) wherever ``solve_tiles`` finds a tiling of
the grid, and one launch a sweep (a K5 stage) elsewhere; ``solve_launches``
counts which route ran.  K8 and K14 run the
same tiled solve inside their one launch there (``fused_step_route``), and
a grid barrier a sweep elsewhere; ``full_step_launches`` and
``advect_project_launches`` count their routes.  The twins are
the same arithmetic in plain PyTorch: the ``inv6`` multiply (``(1 − m)·inv6``
with a mask), the rhs and every iterate rounded to the solve dtype, the
gradient held in solid cells, the faces, the obstacle mirror, then ``damp``
(and ``dens_damp`` after the density faces).  They serve CPU tensors and are
the references the kernels are checked against.  The obstacle mask is a
``torch.bool`` tensor, one byte per cell.

Fields (the velocity, the density, the returned pressure) are float32 or
bfloat16, as the TPU kernels' ``vbuf``, ``pstag`` and density windows take
the field dtype: the divergence reads the widened velocity, the gradient's
result is rounded to the field dtype before the faces, the mirror computes
in float32 from the rounded values and rounds again, ``damp`` and
``dens_damp`` multiply in the field dtype (``dtypes.scale_in``), and the
pressure is the final iterate rounded to the field dtype.  The density
phases take a window of K >= 1 cells.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..dtypes import scale_in, storage_scalar
from ..ops.boundary import set_bnd_3d
from ..scene.sources import src_field_add
from ..utils.profiling import spanned
from . import _build
from .advect import (
    H100_SMEM_OPTIN,
    STORAGE,
    _check_src,
    _check_substeps,
    _check_volume,
    _ptr,
    _scratch,
    advect_multi_3d_plain,
    card_smem_optin,
    check_window,
    count_substeps,
    storage_flag,
    substep_dt0,
)
from .jacobi import composite_block, solve_block_arg, solve_loop_plain

INV6 = float(np.float32(1.0) / np.float32(6.0))


def solve_torch_dtype(solve_dtype) -> torch.dtype:
    """The storage dtype of the solve buffers for ``solve_dtype`` None,
    "float32" or "bfloat16" (as in ``SimConfig.solve_dtype``)."""
    if solve_dtype in (None, "float32"):
        return torch.float32
    if solve_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unsupported solve_dtype {solve_dtype!r}")


def divergence_interior(vel):
    """``−0.5·((∂vx + ∂vy) + ∂vz)/N`` on the interior cells of a ``(3, N, N,
    N)`` velocity (widened to float32), the add order and the division of
    the kernels."""
    n = vel.shape[-1]
    vel = vel.float()
    vx, vy, vz = vel[0], vel[1], vel[2]
    # A tensor divisor: on CUDA, PyTorch divides by a Python scalar by
    # multiplying with its reciprocal, which is not the kernel's division.
    return (
        -0.5
        * (
            (vx[1:-1, 1:-1, 2:] - vx[1:-1, 1:-1, :-2])
            + (vy[1:-1, 2:, 1:-1] - vy[1:-1, :-2, 1:-1])
            + (vz[2:, 1:-1, 1:-1] - vz[:-2, 1:-1, 1:-1])
        )
        / torch.tensor(float(n), dtype=torch.float32, device=vel.device)
    )


def project_gradient(vel, p, obst=None, damp: float = 1.0):
    """``v − 0.5·(p₊ − p₋)·N`` per component on the interior cells (``v``
    itself in solid cells of the bool mask ``obst``) from the float32 ``p``,
    rounded to ``vel``'s dtype, then the component's ``set_bnd`` faces and
    the obstacle mirror (in float32 from the rounded values, rounded again),
    and ``· damp`` in ``vel``'s dtype."""
    nf = float(vel.shape[-1])
    sdt = vel.dtype
    core = (slice(1, -1),) * 3
    grads = (
        0.5 * (p[1:-1, 1:-1, 2:] - p[1:-1, 1:-1, :-2]) * nf,
        0.5 * (p[1:-1, 2:, 1:-1] - p[1:-1, :-2, 1:-1]) * nf,
        0.5 * (p[2:, 1:-1, 1:-1] - p[:-2, 1:-1, 1:-1]) * nf,
    )
    comps = []
    for c, g in enumerate(grads):
        v = vel[c].float()
        comp = v.clone()
        upd = v[core] - g
        comp[core] = upd if obst is None else torch.where(obst[core], v[core], upd)
        comp = set_bnd_3d(c + 1, comp.to(sdt).float(), obst).to(sdt)
        comps.append(scale_in(comp, damp))
    return torch.stack(comps)


def projection_block(vel, iters: int, sweep_block: int) -> int:
    """The sweep block the projection of ``vel`` solves with: ``sweep_block``
    on float32 fields where ``composite_block`` allows (the TPU kernel keeps
    the composite's ``x1`` in its ``pstag`` volume, which has the field
    dtype, and blocks only when that is float32), else 1."""
    if vel.dtype != torch.float32:
        return 1
    return composite_block(vel.shape[-1], iters, sweep_block)


def project_3d_resident_plain(vel, iters: int, obst=None, solve_dtype=None,
                              damp: float = 1.0, sweep_block: int = 1):
    """Plain PyTorch twin of the K3 kernel: the rhs (the divergence rounded to
    the solve dtype, zero on the faces), ``iters`` sweeps from zero with the
    coefficient ``(1 − m)·inv6`` (``solve_loop_plain``; in blocks of
    ``sweep_block``, K5, as ``projection_block`` decides), then the
    gradient.  Returns ``(vel', p)``, ``p`` being the final iterate in
    ``vel``'s dtype."""
    n = vel.shape[-1]
    sdt = solve_torch_dtype(solve_dtype)
    f32 = torch.float32
    rhs = F.pad(divergence_interior(vel).to(sdt), (1, 1, 1, 1, 1, 1))
    # (1 − m)·inv6: inv6 in fluid cells, 0 in solid ones.
    coef = None if obst is None else (1.0 - obst.to(f32)) * INV6
    p = torch.zeros((n, n, n), dtype=sdt, device=vel.device)
    p = solve_loop_plain(rhs, p, b=0, a=1.0, inv_c=INV6, iters=iters, coef=coef,
                         block=projection_block(vel, iters, sweep_block)).to(f32)
    return project_gradient(vel, p, obst, damp), p.to(vel.dtype)


def project_advect_density_3d_plain(vel, density, iters: int, dt: float, *,
                                    window: int = 1, obst=None, n_sub: int = 1,
                                    src=None, solve_dtype=None, damp: float = 1.0,
                                    dens_damp: float = 1.0, sweep_block: int = 1):
    """Plain PyTorch twin of the K2 kernel (K2o with the bool mask ``obst``,
    K2s with the ``(5,)`` emitter descriptor ``src``): the K3 twin (with
    ``sweep_block``), then the
    density (plus the emitter) advected through the damped projected
    velocity with a ``window`` of K cells in ``n_sub`` substeps with the
    mask's contract, then ``· dens_damp``.  Returns ``(vel', p,
    density')``, ``p`` being the final iterate in ``vel``'s dtype."""
    vel_out, p = project_3d_resident_plain(vel, iters, obst, solve_dtype, damp,
                                           sweep_block)
    if src is not None:
        density = src_field_add(density, src)
    dens_out = advect_multi_3d_plain((0,), density[None], vel_out, dt, obst=obst,
                                     n_sub=n_sub, window=window)[0]
    return vel_out, p, scale_in(dens_out, dens_damp)


def _checked_projection(vel, iters: int, solve_dtype, sweep_block: int = 1):
    """Check the arguments the projection kernels take; returns ``(n,
    solve storage dtype)``."""
    if int(iters) != iters or iters < 1:
        raise ValueError(f"iters must be a positive integer, got {iters}")
    if int(sweep_block) != sweep_block or sweep_block < 1:
        raise ValueError(f"sweep_block must be a positive integer, got {sweep_block}")
    sdt = solve_torch_dtype(solve_dtype)
    n = vel.shape[-1]
    if n < 3:
        raise ValueError(f"grid too small: {n}")
    _check_volume("vel", vel, (3, n, n, n), STORAGE)
    return n, sdt


def _check_density(density, vel, n: int) -> None:
    _check_volume("density", density, (n, n, n), vel.dtype)
    if density.device != vel.device:
        raise ValueError("vel and density must be on one device")


def _solve_scratch(n: int, sdt: torch.dtype, device, tiled: bool = False,
                   blocked: bool = False):
    """The two iterates and the rhs of the solve, in its storage dtype (the
    tiled solve keeps the rhs and the other iterate on chip: None; K5's
    tile program keeps the other iterate on chip and stores the rhs)."""
    def vol():
        return torch.empty((n, n, n), dtype=sdt, device=device)

    if tiled:
        return vol(), None, vol() if blocked else None
    return vol(), vol(), vol()


# The tiled solve (csrc/solve_tiled.cuh): its kernel's limits, and an NVIDIA
# H100's SM count and (H100_SMEM_OPTIN) the shared memory a block may opt in
# to, which the gate decides for where the tensors are not on a card (the
# CPU tests check the card's tiling).
TILE_THREADS = 512
BLOCK_THREADS = 256  # the tile program of K5 and K4: at most this many column pairs
TILE_MAX_ROW = 32
TILE_MAX_Z = 32
TILE_FLAG_STRIDE = 32
H100_SMS = 132

# Launches of the projection's solve kernels by K2 and K3 (csrc/project.cuh):
# "tiled" counts tiled solves (the tiled solve's, or K5's tile program's),
# "sweep" the per-sweep kernel's launches (the sweeps of the per-sweep
# route, and those K5's per-stage route leaves over).
solve_launches = {"tiled": 0, "sweep": 0}

# Launches of K8 and of K14 (csrc/full_step.cuh) by route: "tiled" on the
# tiled solve's tiles, "grid" the grid-stride kernel.
full_step_launches = {"tiled": 0, "grid": 0}
advect_project_launches = {"tiled": 0, "grid": 0}

# K8's and K14's vote at a window K >= 2 (csrc/full_step.cuh): the scratch
# of a launch, its header (the grid's block count), a block's cells by
# route, a block's vote slots.
VOTE_MAX_BLOCKS = 2048
VOTE_COUNTS = 2
VOTE_SETS = 4
VOTE_INTS = 1 + (VOTE_COUNTS + VOTE_SETS) * VOTE_MAX_BLOCKS


def _votes(window: int, device):
    """The vote scratch of a K8 or K14 launch at ``window`` (None at K =
    1, whose phases do not vote); the kernel writes every int it reads."""
    if window == 1:
        return None
    return torch.empty(VOTE_INTS, dtype=torch.int32, device=device)


def tap_routes(votes) -> dict:
    """The cells a K8 or K14 launch at a window K >= 2 summed by route, read
    from its vote scratch (``full_step_3d.votes``,
    ``advect_project_3d_resident.votes``: the last launch's) once the launch
    has run: ``"eight"`` the cells that took the <= 8-tap sum, ``"full"``
    those that took the (2K+1)³ sum (a substep whose source held a
    non-finite value, or a NaN displacement), over every substep of both
    advection phases.  Each of the grid's cells counts once a substep."""
    v = votes.cpu().to(torch.int64)
    blocks = int(v[0])
    counts = (v[1:1 + VOTE_COUNTS * blocks] & 0xFFFFFFFF).view(blocks, VOTE_COUNTS)
    return {"eight": int(counts[:, 0].sum()), "full": int(counts[:, 1].sum())}


def tile_bounds(n: int, g: int):
    """The ``[lo, hi)`` extents of ``g`` tiles along y or z of ``n`` cells,
    as the kernel cuts them: tile ``t`` holds ``[t·n//g, (t+1)·n//g)``."""
    return [(t * n // g, (t + 1) * n // g) for t in range(g)]


def tile_bounds_x(n: int, g: int):
    """The extents of ``g`` tiles along x: the inner bounds ``t·n//g``
    rounded down to the parity of ``n``, so that cells ``n − 2`` and
    ``n − 1`` fall in one of a tile's column pairs (its cells ``2k, 2k +
    1``), as cells 0 and 1 do."""
    p = n & 1
    lo = [0] + [((t * n // g - p) & ~1) + p for t in range(1, g)] + [n]
    return list(zip(lo[:-1], lo[1:]))


def tile_span(n: int, g: int) -> int:
    """The largest of ``g`` tiles' extent along y or z of ``n`` cells."""
    return -(-n // g)


def tile_extents(n: int, tiles):
    """The largest tile's extents ``(mx, my, mz)`` of the tiling ``tiles =
    (gx, gy, gz)``."""
    gx, gy, gz = tiles
    return (max(hi - lo for lo, hi in tile_bounds_x(n, gx)), tile_span(n, gy),
            tile_span(n, gz))


def tile_smem(n: int, tiles, itemsize: int) -> int:
    """Bytes of shared memory a block of the tiling takes: two copies of
    the largest tile padded by a cell on every side (rows of ``2·hx + 2``
    values, ``hx`` the most column pairs), 2 values of slack before each,
    and the rhs."""
    mx, my, mz = tile_extents(n, tiles)
    hx = (mx + 1) // 2
    padded = (2 * hx + 2) * (my + 2) * (mz + 2) + 2
    return (2 + 2 * padded + 2 * hx * my * mz) * itemsize


def _round16(v: int) -> int:
    return (v + 15) & ~15


def block_smem(n: int, tiles, itemsize: int, block: int, masked: bool = False) -> int:
    """Bytes of shared memory a block of the tile program of K5 and K4 takes
    (``block_layout`` in ``csrc/solve_tiled.cuh``): the iterate in the solve
    dtype and a float32 chain buffer, each a padded copy of the largest tile
    with 2 values of slack, rounded up to 16 bytes; for ``T = block ≥ 3`` a
    second chain buffer (a float32 solve's iterate is that buffer); for
    ``block`` 1 (K4's sequential sweeps) the rhs at the tile's cells; for K5
    with a mask the solid bits of the padded tile."""
    mx, my, mz = tile_extents(n, tiles)
    hx = (mx + 1) // 2
    cells = (2 * hx + 2) * (my + 2) * (mz + 2)
    pb, wb = _round16((cells + 2) * itemsize), _round16((cells + 2) * 4)
    total = pb + wb
    if block >= 3 and itemsize != 4:
        total += wb
    if block == 1:
        total += _round16(2 * hx * my * mz * itemsize)
    if masked and block >= 2:
        total += _round16(-(-cells // 32) * 4)
    return total


def shell_fits(n: int, tiles, block: int) -> bool:
    """Whether the tiles at the walls hold ``T = block ≥ 3``'s shell: ``2T −
    1`` planes or more along each axis (level 1 reads planes ``0..2T−1`` of a
    wall, the last in the halo)."""
    if block < 3:
        return True
    gx, gy, gz = tiles
    depth = 2 * block - 1
    return all(b[0][1] - b[0][0] >= depth and b[-1][1] - b[-1][0] >= depth
               for b in (tile_bounds_x(n, gx), tile_bounds(n, gy), tile_bounds(n, gz)))


def tile_face_values(n: int, tiles) -> int:
    """Values of the face buffer: two parities of six slots a tile, each as
    large as the largest face (its x rows ``2·hx`` long), rounded up to an
    even count."""
    mx, my, mz = tile_extents(n, tiles)
    row = 2 * ((mx + 1) // 2)
    face = max(my * mz, row * mz, row * my)
    return 2 * 6 * int(np.prod(tiles)) * (face + face % 2)


@functools.lru_cache(maxsize=None)
def tiling(n: int, itemsize: int, sms: int, smem_optin: int, block: int = 1,
           masked: bool = False, general: bool = False):
    """The tiling ``(gx, gy, gz)`` of an ``n³`` solve of ``itemsize``-byte
    values on a card of ``sms`` SMs that lets a block opt in to
    ``smem_optin`` bytes of shared memory, or None: at most one tile an SM,
    every tile 3 to ``TILE_MAX_ROW`` cells along x and y and at most
    ``TILE_MAX_Z`` along z, at most ``TILE_THREADS`` column pairs, two x
    tiles or more for an odd ``n``, and the block's shared memory within
    ``smem_optin``: the tiled solve's two padded copies and rhs
    (``tile_smem``) for the projection's sequential sweeps, or the tile
    program's (``block_smem``) for K5's ``block ≥ 2`` (``masked``: with the
    solid bits) and K4's sweeps (``general``), with at most
    ``BLOCK_THREADS`` column pairs and ``shell_fits``'s wall tiles for
    ``block ≥ 3``.  Of those, the one with the least work on its
    largest tile, then the fewest face cells, then the widest rows along x,
    then the longest columns."""
    program = general or block >= 2
    best, best_key = None, None
    top = n // 3
    for gz in range(1, min(top, sms) + 1):
        for gy in range(1, min(top, sms // gz) + 1):
            for gx in range(1, min(top, sms // (gz * gy)) + 1):
                if n % 2 and gx < 2:
                    continue
                if min(hi - lo for lo, hi in tile_bounds_x(n, gx)) < 3:
                    continue
                mx, my, mz = tile_extents(n, (gx, gy, gz))
                if (max(mx, my) > TILE_MAX_ROW or (mx + 1) // 2 * my > TILE_THREADS
                        or mz > TILE_MAX_Z):
                    continue
                if program:
                    if ((mx + 1) // 2 * my > BLOCK_THREADS or not shell_fits(n, (gx, gy, gz), block)
                            or block_smem(n, (gx, gy, gz), itemsize, block, masked) > smem_optin):
                        continue
                elif tile_smem(n, (gx, gy, gz), itemsize) > smem_optin:
                    continue
                key = (mx * my * mz, my * mz + mx * mz + mx * my, -mx, -mz)
                if best_key is None or key < best_key:
                    best, best_key = (gx, gy, gz), key
    return best


@functools.lru_cache(maxsize=None)
def _card_limits(index: int):
    """Card ``index``'s SM count and the shared memory a block may opt in
    to."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms, card_smem_optin(index)


def solve_tiles(n: int, sdt: torch.dtype, device=None, block: int = 1,
                masked: bool = False, general: bool = False):
    """The tiling of an ``n³`` solve in ``sdt`` on ``device`` (``tiling``
    with the card's SM count and shared memory; the H100's where ``device``
    is not a card), or None where one launch a sweep (a stage) runs: the
    tiled solve's for the projection's sequential sweeps (the mask takes no
    shared memory there: a bit a cell, in registers), the tile program's
    for K5's ``block ≥ 2`` (with its solid bits when ``masked``) and for
    K4's sweeps (``general``).  Callers pass the arguments by position."""
    limits = H100_SMS, H100_SMEM_OPTIN
    if device is not None and torch.device(device).type == "cuda":
        index = torch.device(device).index
        limits = _card_limits(torch.cuda.current_device() if index is None else index)
    return tiling(n, sdt.itemsize, *limits, block, masked, general)


def projection_tiles(n: int, dtype: torch.dtype, iters: int, sweep_block: int,
                     sdt: torch.dtype, device=None, masked: bool = False):
    """The tiling the solve of a projection of an ``n³`` velocity of
    ``dtype`` with ``iters`` sweeps takes on ``device`` (``solve_tiles`` for
    the block ``projection_block`` gives: K5's ``sweep_block`` on float32
    fields), or None where none fits.  K2 and K3 solve on the tiles where
    it returns one (the tiled solve, or K5's tile program), else one launch
    a sweep (or a K5 stage); K8 and K14 take their tiled route there, else
    their grid-stride route."""
    block = composite_block(n, iters, sweep_block) if dtype == torch.float32 else 1
    return solve_tiles(n, sdt, device, block, masked)


def fused_step_route(n: int, iters: int, solve_dtype=None, dtype=torch.float32,
                     sweep_block: int = 1, device=None) -> str:
    """The route K8 (and K14, float32 with ``sweep_block`` 1) takes for an
    ``n³`` step: "tiled" where ``projection_tiles`` finds a tiling, else
    "grid" (the grid-stride kernel with a grid barrier a sweep)."""
    tiles = projection_tiles(n, dtype, iters, sweep_block, solve_torch_dtype(solve_dtype),
                             device)
    return "grid" if tiles is None else "tiled"


def tiles_arg(n: int, tiles, device, faces_dtype: torch.dtype):
    """The ``SolveTiles`` of the tiling ``tiles`` of an ``n³`` solve, with
    its zeroed flags and its face buffer of ``faces_dtype`` (the tile
    program's: float32 slots whatever the solve dtype), which the struct
    keeps alive as ``scratch``."""
    flags = torch.zeros(int(np.prod(tiles)) * TILE_FLAG_STRIDE, dtype=torch.int32,
                        device=device)
    faces = torch.empty(tile_face_values(n, tiles), dtype=faces_dtype, device=device)
    arg = _build.SolveTiles(*tiles, flags.data_ptr(), faces.data_ptr())
    arg.scratch = (flags, faces)
    return arg


def _solve_tiles_arg(vel, iters: int, sweep_block: int, sdt: torch.dtype,
                     masked: bool = False):
    """The ``SolveTiles`` for a projection of ``vel`` (None where
    ``projection_tiles`` finds none)."""
    n = vel.shape[-1]
    tiles = projection_tiles(n, vel.dtype, iters, sweep_block, sdt, vel.device, masked)
    if tiles is None:
        return None
    blocked = projection_block(vel, iters, sweep_block) >= 2
    return tiles_arg(n, tiles, vel.device, torch.float32 if blocked else sdt)


def _count_solve(tiles, iters: int, blk) -> None:
    if tiles is not None:
        solve_launches["tiled"] += 1
    else:
        solve_launches["sweep"] += iters if blk is None else iters % blk.block


def _projection_block_arg(vel, iters: int, sweep_block: int, tiled: bool = False):
    """K5's ``SolveBlock`` for a projection of ``vel`` (None: sequential
    sweeps; ``tiled``: for the tile program)."""
    return solve_block_arg(vel.shape[-1], projection_block(vel, iters, sweep_block),
                           1.0, INV6, vel.device, tiled)


def _check_mask(obst, n: int, device) -> None:
    _check_volume("obst", obst, (n, n, n), torch.bool)
    if obst.device != device:
        raise ValueError("vel and obst must be on one device")


@spanned("kernel.K2")
def project_advect_density_3d(vel, density, iters: int, dt: float, *,
                              window: int = 1, n_sub: int = 1, obst=None,
                              src=None, solve_dtype=None, damp: float = 1.0,
                              dens_damp: float = 1.0, sweep_block: int = 1):
    """Project ``vel`` with ``iters`` Jacobi sweeps (in blocks of
    ``sweep_block``, K5, where ``projection_block`` allows) and advect ``density``
    through the damped projected velocity in ``n_sub`` substeps, with the
    K2 kernel: K2o with the bool obstacle mask ``obst``, K2s with the
    ``(5,)`` emitter descriptor ``src`` (added to the density the first
    substep reads; not with a mask, as in the JAX package), with a
    ``window`` of K >= 1 cells.  ``vel`` and ``density`` are float32 or
    bfloat16, in one dtype (the emitter takes float32).

    CUDA tensors launch ``csrc/project_advect.cu`` (its solve tiled where
    ``solve_tiles`` allows); CPU tensors run
    ``project_advect_density_3d_plain``.  Returns ``(vel', p, density')``.
    ``project_advect_density_3d.launches`` counts launches, and
    ``kernels.advect.advect_launches`` the density phase's substeps by route."""
    n_sub = _check_substeps(n_sub)
    if src is not None and obst is not None:
        raise ValueError("src folding requires an obstacle-free config")
    n, sdt = _checked_projection(vel, iters, solve_dtype, sweep_block)
    window = check_window(window, n)
    _check_density(density, vel, n)
    if obst is not None:
        _check_mask(obst, n, vel.device)
    if src is not None:
        _check_src(src, vel.device)
        if vel.dtype != torch.float32:
            raise TypeError("the emitter fold takes float32 fields")

    if vel.device.type == "cpu":
        return project_advect_density_3d_plain(
            vel, density, iters, dt, window=window, obst=obst, n_sub=n_sub,
            src=src, solve_dtype=solve_dtype, damp=damp, dens_damp=dens_damp,
            sweep_block=sweep_block)
    if vel.device.type != "cuda":
        raise ValueError(f"unsupported device {vel.device}")

    lib = _build.load_library()
    vel_out = torch.empty_like(vel)
    p = torch.empty_like(density)
    dens_out = torch.empty_like(density)
    tmp0, tmp1 = _scratch(1, n, n_sub, False, vel.dtype, vel.device)
    tiles = _solve_tiles_arg(vel, iters, sweep_block, sdt, obst is not None)
    blk = _projection_block_arg(vel, iters, sweep_block, tiles is not None)
    p_a, p_b, rhs = _solve_scratch(n, sdt, vel.device, tiles is not None, blk is not None)
    fdt = vel.dtype
    with torch.cuda.device(vel.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_project_advect_density(
            vel.data_ptr(), density.data_ptr(), _ptr(obst), _ptr(src),
            vel_out.data_ptr(), p.data_ptr(), dens_out.data_ptr(), _ptr(tmp0),
            _ptr(tmp1), p_a.data_ptr(), _ptr(p_b), _ptr(rhs), n,
            int(iters), int(sdt == torch.bfloat16), storage_flag(fdt),
            substep_dt0(dt, n, n_sub), n_sub, int(window),
            storage_scalar(damp, fdt), storage_scalar(dens_damp, fdt), blk, tiles, stream,
        )
    _build.check(lib, err, "fused projection kernel launch")
    project_advect_density_3d.launches += 1
    _count_solve(tiles, iters, blk)
    count_substeps(window, 1, n_sub, vel.device)
    return vel_out, p, dens_out


project_advect_density_3d.launches = 0


@spanned("kernel.K3")
def project_3d_resident(vel, iters: int, obst=None, solve_dtype=None,
                        damp: float = 1.0, sweep_block: int = 1):
    """Project ``vel`` with ``iters`` Jacobi sweeps with the K3 kernel, with
    the obstacle contract when the bool mask ``obst`` is given, the sweeps in
    blocks of ``sweep_block`` (K5) where ``projection_block`` allows.

    ``vel`` is float32 or bfloat16.

    CUDA tensors launch ``csrc/project.cu`` (its solve tiled where
    ``solve_tiles`` allows); CPU tensors run ``project_3d_resident_plain``.
    Returns ``(vel', p)``.
    ``project_3d_resident.launches`` counts calls that launched the kernel."""
    n, sdt = _checked_projection(vel, iters, solve_dtype, sweep_block)
    if obst is not None:
        _check_mask(obst, n, vel.device)

    if vel.device.type == "cpu":
        return project_3d_resident_plain(vel, iters, obst, solve_dtype, damp,
                                         sweep_block)
    if vel.device.type != "cuda":
        raise ValueError(f"unsupported device {vel.device}")

    lib = _build.load_library()
    vel_out = torch.empty_like(vel)
    p = torch.empty((n, n, n), dtype=vel.dtype, device=vel.device)
    tiles = _solve_tiles_arg(vel, iters, sweep_block, sdt, obst is not None)
    blk = _projection_block_arg(vel, iters, sweep_block, tiles is not None)
    p_a, p_b, rhs = _solve_scratch(n, sdt, vel.device, tiles is not None, blk is not None)
    with torch.cuda.device(vel.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_project(
            vel.data_ptr(), _ptr(obst), vel_out.data_ptr(), p.data_ptr(),
            p_a.data_ptr(), _ptr(p_b), _ptr(rhs), n, int(iters),
            int(sdt == torch.bfloat16), storage_flag(vel.dtype),
            storage_scalar(damp, vel.dtype), blk, tiles, stream,
        )
    _build.check(lib, err, "projection kernel launch")
    project_3d_resident.launches += 1
    _count_solve(tiles, iters, blk)
    return vel_out, p


project_3d_resident.launches = 0


def full_step_3d_plain(vel, density, iters: int, dt: float, *, window: int = 1,
                       n_sub: int = 1, solve_dtype=None, damp: float = 1.0,
                       dens_damp: float = 1.0, sweep_block: int = 1):
    """Plain PyTorch twin of the K8 kernel: the K1 twin's self-advection
    with a ``window`` of K cells in ``n_sub`` substeps, then the K2 twin with
    the same window and ``n_sub`` (the JAX ``full_step_3d_resident``'s
    contract).  Returns ``(vel', p, density')``."""
    adv = advect_multi_3d_plain((1, 2, 3), vel, vel, dt, n_sub=n_sub, window=window)
    return project_advect_density_3d_plain(
        adv, density, iters, dt, window=window, n_sub=n_sub,
        solve_dtype=solve_dtype, damp=damp, dens_damp=dens_damp,
        sweep_block=sweep_block)


@spanned("kernel.K8")
def full_step_3d(vel, density, iters: int, dt: float, *, window: int = 1,
                 n_sub: int = 1, solve_dtype=None, damp: float = 1.0,
                 dens_damp: float = 1.0, sweep_block: int = 1):
    """Self-advect ``vel``, project it with ``iters`` Jacobi sweeps (in
    blocks of ``sweep_block``, K5, where ``projection_block`` allows) and
    advect ``density`` through the damped result, each advection in
    ``n_sub`` substeps with a ``window`` of K >= 1 cells, with the K8
    kernel: one cooperative launch (obstacle-free).  ``vel`` and ``density``
    are float32 or bfloat16, in one dtype.

    CUDA tensors launch ``csrc/full_step.cu`` (``csrc/full_step_bf16.cu``
    for bfloat16) on ``fused_step_route``'s route, decided before the
    launch, and raise if the launch fails (there is no fallback to K1 + K2
    or to the other route); CPU tensors run ``full_step_3d_plain``.
    Returns ``(vel', p, density')``.  ``full_step_3d.launches`` counts
    launches, ``full_step_launches`` them by route; at a window K >= 2
    ``full_step_3d.votes`` keeps the launch's vote scratch, from which
    ``tap_routes`` reads the cells it summed by 8 taps and by the full
    window."""
    n_sub = _check_substeps(n_sub)
    n, sdt = _checked_projection(vel, iters, solve_dtype, sweep_block)
    window = check_window(window, n)
    _check_density(density, vel, n)

    if vel.device.type == "cpu":
        return full_step_3d_plain(vel, density, iters, dt, window=window,
                                  n_sub=n_sub, solve_dtype=solve_dtype, damp=damp,
                                  dens_damp=dens_damp, sweep_block=sweep_block)
    if vel.device.type != "cuda":
        raise ValueError(f"unsupported device {vel.device}")

    lib = _build.load_library()
    fdt = vel.dtype
    adv = torch.empty_like(vel)
    vel_out = torch.empty_like(vel)
    p = torch.empty_like(density)
    dens_out = torch.empty_like(density)
    # bfloat16: the substeps before each advection's last stay float32.
    tmp0, tmp1 = ((None, None) if fdt == torch.float32
                  else _scratch(3, n, n_sub, False, fdt, vel.device))
    tiles = _solve_tiles_arg(vel, iters, sweep_block, sdt)
    blk = _projection_block_arg(vel, iters, sweep_block, tiles is not None)
    p_a, p_b, rhs = _solve_scratch(n, sdt, vel.device, tiles is not None, blk is not None)
    votes = _votes(window, vel.device)
    with torch.cuda.device(vel.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_full_step(
            vel.data_ptr(), density.data_ptr(), adv.data_ptr(),
            vel_out.data_ptr(), p.data_ptr(), dens_out.data_ptr(), _ptr(tmp0),
            _ptr(tmp1), p_a.data_ptr(), _ptr(p_b), _ptr(rhs), n,
            int(iters), int(sdt == torch.bfloat16), storage_flag(fdt),
            substep_dt0(dt, n, n_sub), n_sub, int(window),
            storage_scalar(damp, fdt), storage_scalar(dens_damp, fdt), blk, tiles,
            _ptr(votes), stream,
        )
    _build.check(lib, err, "full-step kernel launch")
    full_step_3d.launches += 1
    full_step_3d.votes = votes
    full_step_launches["grid" if tiles is None else "tiled"] += 1
    return vel_out, p, dens_out


full_step_3d.launches = 0
full_step_3d.votes = None


def advect_project_3d_resident_plain(vel, iters: int, dt: float, *, window: int = 1,
                                    n_sub: int = 1):
    """Plain PyTorch twin of the K14 kernel: the K1 twin's self-advection
    with a ``window`` of K cells in ``n_sub`` substeps, then the K3 twin
    (no mask, sequential sweeps, no damping).  Returns ``(vel', p)``."""
    adv = advect_multi_3d_plain((1, 2, 3), vel, vel, dt, n_sub=n_sub, window=window)
    return project_3d_resident_plain(adv, iters)


def advect_project_3d_resident(vel, iters: int, dt: float, *, window: int = 1,
                               n_sub: int = 1):
    """Self-advect the float32 ``vel`` in ``n_sub`` substeps with a
    ``window`` of K >= 1 cells and project the result with ``iters``
    sequential Jacobi sweeps, with the K14 kernel: K8's cooperative launch
    without the density phase (obstacle-free, float32).

    CUDA tensors launch ``csrc/full_step.cu``'s ``fs_advect_project`` on
    K8's routes (``fused_step_route``); CPU tensors run
    ``advect_project_3d_resident_plain``.  Returns ``(vel', p)``.
    ``advect_project_3d_resident.launches`` counts launches,
    ``advect_project_launches`` them by route, and at K >= 2
    ``advect_project_3d_resident.votes`` keeps the scratch ``tap_routes``
    reads."""
    n_sub = _check_substeps(n_sub)
    n, sdt = _checked_projection(vel, iters, None)
    window = check_window(window, n)
    if vel.dtype != torch.float32:
        raise TypeError("the fused advect + project kernel takes float32 fields")

    if vel.device.type == "cpu":
        return advect_project_3d_resident_plain(vel, iters, dt, window=window,
                                                n_sub=n_sub)
    if vel.device.type != "cuda":
        raise ValueError(f"unsupported device {vel.device}")

    lib = _build.load_library()
    adv = torch.empty_like(vel)
    vel_out = torch.empty_like(vel)
    p = torch.empty((n, n, n), dtype=vel.dtype, device=vel.device)
    tiles = _solve_tiles_arg(vel, iters, 1, sdt)
    p_a, p_b, rhs = _solve_scratch(n, sdt, vel.device, tiles is not None)
    votes = _votes(window, vel.device)
    with torch.cuda.device(vel.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fs_advect_project(
            vel.data_ptr(), adv.data_ptr(), vel_out.data_ptr(), p.data_ptr(),
            p_a.data_ptr(), _ptr(p_b), _ptr(rhs), n, int(iters),
            substep_dt0(dt, n, n_sub), n_sub, int(window), tiles, _ptr(votes), stream,
        )
    _build.check(lib, err, "advect + project kernel launch")
    advect_project_3d_resident.launches += 1
    advect_project_3d_resident.votes = votes
    advect_project_launches["grid" if tiles is None else "tiled"] += 1
    return vel_out, p


advect_project_3d_resident.launches = 0
advect_project_3d_resident.votes = None


def full_step_blocks(solve_dtype=None, device=None, dtype=torch.float32,
                     window: int = 1, n: int = None, iters: int = 1,
                     sweep_block: int = 1) -> int:
    """The blocks of K8's cooperative grid on ``device`` (the current card
    when None) for fields of ``dtype`` and a ``window``, on the route an
    ``n³`` step with ``iters`` sweeps and ``sweep_block`` takes
    (``fused_step_route``): on the tiled route the tiles (one block of up
    to 512 threads a tile, checked to fit the card at once); on the
    grid-stride route, or with ``n`` None, as many blocks of 256 threads as
    the card holds at once."""
    sdt = solve_torch_dtype(solve_dtype)
    tiles = None if n is None else projection_tiles(n, dtype, iters, sweep_block, sdt,
                                                    device)
    block = 1
    if n is not None and dtype == torch.float32:
        block = composite_block(n, iters, sweep_block)
    lib = _build.load_library()
    with torch.cuda.device(device):
        blocks = lib.fs_full_step_blocks(
            int(sdt == torch.bfloat16), storage_flag(dtype), int(window),
            0 if n is None else int(n), *(tiles or (0, 0, 0)), block)
    if blocks < 0:
        _build.check(lib, -blocks, "full-step grid")
    return blocks
