"""K1 and K11 at a window of K = 1 on tiles (``csrc/advect_tiled.cuh``) on
the CPU: the tile geometry (Python mirrors of the kernel's tiles, staged
region, ``advect_runs`` and ``interior_plane_unwrapped``) and a plain
emulation of the kernel's schedule held bitwise against the twins
``advect_multi_3d_plain`` and ``advect_ext_plain``.

The emulation transliterates the kernel's per-block program: the staged
region of each tile, a plane of it staged once for each field with the
buoyant y component and the emitter applied to each staged value, the z
ring (a run of interior planes inside the slab keeps plane p in slot p % 4;
other runs tag three slots by plane, a new interior plane staging only the
planes no slot holds into slots whose planes it no longer reads), the
two-tap combinations in the kernel's order, the solid cells, the face signs,
the rounding and the scale; and ``advect_substeps``' launches around it
(float32 and the four bfloat16 roles, the mirror after each substep, the
one rounding after it).  Slots start poisoned with NaN, so a tap read from
a slot that was not staged shows.  The kernel must equal the twins bit for
bit on the card as well (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidsim_tpu_torch.config import preset_bench_128, preset_vortex_128
from fluidsim_tpu_torch.kernels.advect import (
    _comb,
    advect_multi_3d_plain,
    advect_route,
    substep_dt0,
)
from fluidsim_tpu_torch.kernels.halo import (
    _mirror_ext,
    _nonborder_solid,
    advect_ext_plain,
    ext_halo,
)
from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask
from fluidsim_tpu_torch.scene.sources import emitter_fold_operand, src_field_add

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "fluidsim_tpu_torch" / "csrc"
BF16 = torch.bfloat16
CFG = preset_bench_128()
DT = CFG.effective_params()[0]

# The K = 1 kernel's tile (csrc/advect_tiled.cuh): the x-cells and y-rows a
# block owns; along z it owns a run of at most ADVECT_MAX_RUN planes that the
# launch picks (advect_runs).
ADVECT_TILE = (32, 16)
ADVECT_MAX_RUN = 16


def advect_runs(tiles_xy: int, nz: int, capacity: int, lead: int = 3,
                max_run: int = ADVECT_MAX_RUN) -> int:
    """The kernel's ``advect_runs``: the number of runs along
    z of ``nz`` planes for ``tiles_xy`` tiles a plane when the card holds
    ``capacity`` blocks at once: of the counts with runs of at most
    ``max_run`` planes, the one that minimises waves × (run length +
    ``lead``), the most runs among equals."""
    best, best_cost = 1, None
    for runs in range(-(-nz // max_run), nz + 1):
        length = -(-nz // runs)
        if -(-nz // length) != runs:
            continue
        cost = -(-(tiles_xy * runs) // capacity) * (length + lead)
        if best_cost is None or cost <= best_cost:
            best, best_cost = runs, cost
    return best


def advect_tile_grid(n: int, nz: int = None, capacity: int = None):
    """The K = 1 kernel's blocks along x, y and z and the run length on an
    ``n²·nz`` slab (``nz`` = n: the whole grid) for a card that holds
    ``capacity`` blocks at once."""
    nz = n if nz is None else nz
    tx, ty = ADVECT_TILE
    gx, gy = -(-n // tx), -(-n // ty)
    runs = advect_runs(gx * gy, nz, capacity)
    return gx, gy, runs, -(-nz // runs)


def advect_tile_stage(n: int, start: int, size: int):
    """``(first, count)`` of the staged columns (or rows) of a tile whose
    ``size`` cells start at ``start``: from the cell before the tile's first
    interior cell (coordinates clamped to [1, n−2]), at most ``size + 2``,
    never past the grid."""
    first = min(max(start, 1), n - 2) - 1
    return first, min(size + 2, n - first)


def interior_plane_unwrapped(z: int, n: int, zoff: int = 0) -> int:
    """The interior plane whose value slab plane ``z`` takes, before the wrap
    into a slab of ``nz`` planes (``% nz``): its inward neighbour at a global
    z wall, else ``z``."""
    zg = z + zoff
    return z + 1 if zg == 0 else (z - 1 if zg == n - 1 else z)


TX, TY = ADVECT_TILE
# Blocks an H100 holds at once: 132 SMs times 2, 3 or 4 blocks (the K = 1
# instantiations' registers allow 2 to 4).
CAPACITIES = (264, 396, 528)


def test_tile_constants_are_the_kernels():
    src = (CSRC / "advect_tiled.cuh").read_text()
    assert re.search(rf"kAdvectTileX = {TX};", src)
    assert re.search(rf"kAdvectTileY = {TY};", src)
    assert re.search(rf"kAdvectMaxRun = {ADVECT_MAX_RUN};", src)
    assert re.search(r"kStageX = kAdvectTileX \+ 2;", src)
    assert re.search(r"kStageY = kAdvectTileY \+ 2;", src)
    # advect_runs' cost, as the Python mirror computes it, with K = 1's lead.
    assert "const long long cost = waves * (len + lead);" in src
    assert re.search(r"int advect_runs\(int tiles_xy, int nz, int capacity, int lead = 3,\s+"
                     r"int max_run = kAdvectMaxRun\)", src)


@pytest.mark.parametrize("window,n_fields,route", [
    (1, 3, "tiled"), (2, 3, "window"), (3, 3, "window"), (4, 3, "window"), (6, 3, "window"),
    (7, 3, "cell"), (1, 1, "tiled"), (5, 1, "window"), (11, 1, "window"), (12, 1, "cell")])
def test_route_by_window(window, n_fields, route):
    assert advect_route(window, n_fields) == route


# -- the geometry -------------------------------------------------------------------


def blocks(n, nz, tile=ADVECT_TILE, run=None):
    """Each block's output box ``(x0, x1, y0, y1, z0, z1)`` for ``tile`` and
    runs of ``run`` planes (None: the kernel's choice at 396 blocks)."""
    tx, ty = tile
    if run is None:
        run = advect_tile_grid(n, nz, 396)[3]
    grid = (-(-n // tx), -(-n // ty), -(-nz // run))
    for bz in range(grid[2]):
        for by in range(grid[1]):
            for bx in range(grid[0]):
                yield (bx * tx, min(bx * tx + tx, n), by * ty, min(by * ty + ty, n),
                       bz * run, min(bz * run + run, nz))


def wrap(z, nz):
    return z + nz if z < 0 else (z - nz if z >= nz else z)


# (n, nz, zoff): whole grids, and slabs touching the low wall, the high wall,
# both, neither, and a wall on a slab's first and last planes.
GEOMETRY = [(3, 3, 0), (5, 5, 0), (17, 17, 0), (33, 33, 0),
            (17, 9, -2), (17, 9, 10), (9, 13, -2), (33, 12, 8), (17, 5, 0), (17, 5, 12),
            (5, 3, -2), (5, 3, 4)]
# The kernel's tile, and a small one that puts several tiles along every axis
# of the emulation's grids.
SMALL = (8, 4)


@pytest.mark.parametrize("run", [None, 1, 5, 1000], ids=["chosen", "1", "5", "all"])
@pytest.mark.parametrize("tile", [ADVECT_TILE, SMALL], ids=["kernel", "small"])
@pytest.mark.parametrize("n,nz,zoff", GEOMETRY)
def test_tiles_cover_every_cell_once_and_taps_stay_staged(n, nz, zoff, tile, run):
    tx, ty = tile
    count = np.zeros((nz, n, n), dtype=np.int32)
    for x0, x1, y0, y1, z0, z1 in blocks(n, nz, tile, run):
        count[z0:z1, y0:y1, x0:x1] += 1
        sx0, sw = advect_tile_stage(n, x0, tx)
        sy0, sh = advect_tile_stage(n, y0, ty)
        assert 0 <= sx0 and sx0 + sw <= n and sw <= tx + 2
        assert 0 <= sy0 and sy0 + sh <= n and sh <= ty + 2
        for x in range(x0, x1):
            cx = min(max(x, 1), n - 2)
            assert sx0 <= cx - 1 and cx + 1 < sx0 + sw
        for y in range(y0, y1):
            cy = min(max(y, 1), n - 2)
            assert sy0 <= cy - 1 and cy + 1 < sy0 + sh
        # Along a run the unwrapped interior planes never fall, so each plane
        # is staged once, and the three a plane reads lie in distinct slots.
        prev = None
        for z in range(z0, z1):
            cu = interior_plane_unwrapped(z, n, zoff)
            assert prev is None or cu >= prev
            prev = cu
            assert len({(cu + d) % 4 for d in (-1, 0, 1)}) == 3
            assert all(0 <= wrap(cu + d, nz) < nz for d in (-1, 0, 1))
    assert (count == 1).all()


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("n,nz", [(3, 3), (37, 37), (128, 128), (256, 256), (512, 512),
                                  (512, 68), (512, 72), (130, 36)])
def test_runs_cover_the_slab_in_fewest_costly_waves(n, nz, capacity):
    gx, gy, runs, run = advect_tile_grid(n, nz, capacity)
    assert -(-nz // run) == runs and run * (runs - 1) < nz <= run * runs
    assert run <= ADVECT_MAX_RUN

    def cost(r):
        return -(-(gx * gy * r) // capacity) * (-(-nz // r) + 3)
    assert all(cost(runs) <= cost(r) for r in range(-(-nz // ADVECT_MAX_RUN), nz + 1))


def test_tiles_at_128():
    # 32 tiles a plane: 8, 12, 16 runs fill one wave of 264, 396, 528 blocks.
    assert [advect_tile_grid(128, None, c) for c in CAPACITIES] == [
        (4, 8, 8, 16), (4, 8, 12, 11), (4, 8, 16, 8)]
    assert advect_tile_grid(512, 68, 396) == (16, 32, 5, 14)
    assert advect_runs(512, 512, 528) == 32
    assert advect_tile_stage(128, 0, TX) == (0, 34)
    assert advect_tile_stage(128, 96, TX) == (95, 33)
    assert advect_tile_stage(33, 32, TX) == (30, 3)


# -- the kernel's schedule -------------------------------------------------------------


def emitter_add(v, e, z, ys, xs):
    """csrc/advect.cuh's emitter_add on the block (ys, xs) of plane z:
    outside the ball's box the value is returned as it is."""
    px, py, pz, strength, r = (e[i] for i in range(5))
    dx = xs.to(torch.float32)[None, :] - px
    dy = ys.to(torch.float32)[:, None] - py
    dz = torch.tensor(float(z), dtype=torch.float32) - pz
    reach = r + 1.0
    skip = (dx.abs() > reach) | (dy.abs() > reach) | (dz.abs() > reach)
    d = torch.sqrt((dx * dx + dy * dy) + dz * dz)
    falloff = torch.where(d <= r, 1.0 - d / r, 0.0)
    return torch.where(skip, v, v + strength * falloff)


def buoyant_vy(vy, rho, bp):
    dt, b, amb, grav = bp
    accel = b * (rho - amb) - grav * rho
    return vy + dt * accel


def frac(c, v, dt0, n):
    t = c - dt0 * v
    t = torch.where(t < 0.5, 0.5, t)
    t = torch.where(t > n - 1.5, n - 1.5, t)
    t = torch.minimum(torch.maximum(t, c - 1.0), c + 1.0)
    return t - c


def tiled_substep(src, vel, n, zoff, bs, dt0, out_dtype, *, dens=None, bp=None,
                  buoy_taps=False, e=None, src_on=None, mask=None, scale=1.0,
                  tile=ADVECT_TILE, run=None):
    """One launch of advect_tiled_kernel on the (F, nz, n, n) slab ``src``;
    ``dens``/``bp`` the buoyancy (BUOY_VEL; ``buoy_taps`` for the taps),
    ``e`` the emitter on the density (``src_on`` "density") or on the fields
    ("fields"); runs of ``run`` planes (None: the kernel's choice)."""
    f32 = torch.float32
    n_fields, nz = src.shape[0], src.shape[1]
    tx, ty = tile
    out = torch.full((n_fields, nz, n, n), float("nan"), dtype=out_dtype)
    for x0, x1, y0, y1, z0, z1 in blocks(n, nz, tile, run):
        sx0, sw = advect_tile_stage(n, x0, tx)
        sy0, sh = advect_tile_stage(n, y0, ty)
        xs, ys = torch.arange(x0, x1), torch.arange(y0, y1)
        cx, cy = xs.clamp(1, n - 2), ys.clamp(1, n - 2)
        lx, ly = cx - sx0, cy - sy0
        gys, gxs = torch.arange(sy0, sy0 + sh), torch.arange(sx0, sx0 + sw)
        ring = [torch.full((n_fields, ty + 2, tx + 2), float("nan")) for _ in range(4)]

        def stage(s, p):
            """Plane p's staged values into slot s."""
            g = src[:, p, sy0:sy0 + sh, sx0:sx0 + sw].to(f32)
            rows = []
            for c in range(n_fields):
                gc = g[c]
                if src_on == "fields":
                    gc = emitter_add(gc, e, zoff + p, gys, gxs)
                if buoy_taps and c == 1:
                    rho = dens[p, sy0:sy0 + sh, sx0:sx0 + sw]
                    if src_on == "density":
                        rho = emitter_add(rho, e, zoff + p, gys, gxs)
                    gc = buoyant_vy(gc, rho, bp)
                rows.append(gc)
            ring[s][:, :sh, :sw] = torch.stack(rows)

        # Each plane once, into slot p % 4 of its unwrapped index p: a new
        # interior plane cu stages planes max(hi + 1, cu - 1) .. cu + 1.
        hi = prev = None
        v = None
        for z in range(z0, z1):
            cu = interior_plane_unwrapped(z, n, zoff)
            cz = cu % nz
            if cu != prev:
                start = cu - 1 if hi is None else max(hi + 1, cu - 1)
                for p in range(start, cu + 2):
                    stage(p % 4, p % nz)
                hi = cu + 1
                slot = [(cu - 1) % 4, cu % 4, (cu + 1) % 4]
                prev = cu
                vc = vel[:, cz][:, cy][:, :, cx].to(f32)
                vx, vy, vz = vc[0], vc[1], vc[2]
                zg = cz + zoff
                if bp is not None:
                    rho = dens[cz][cy][:, cx]
                    if src_on == "density":
                        rho = emitter_add(rho, e, zg, cy, cx)
                    vy = buoyant_vy(vy, rho, bp)
                fx = frac(cx.to(f32)[None, :], vx, dt0, n)
                fy = frac(cy.to(f32)[:, None], vy, dt0, n)
                fz = frac(torch.tensor(float(zg)), vz, dt0, n)
                w = [(torch.clamp(f, min=0.0), torch.clamp(-f, min=0.0)) for f in (fx, fy, fz)]
                vals = []
                for c in range(n_fields):
                    zc = []
                    for dz in range(3):
                        pl = ring[slot[dz]][c]
                        yc = []
                        for dy in (-1, 0, 1):
                            r = pl[ly + dy]
                            yc.append(_comb(r[:, lx - 1], r[:, lx], r[:, lx + 1], *w[0]))
                        zc.append(_comb(*yc, *w[1]))
                    vals.append(_comb(*zc, *w[2]))
                v = torch.stack(vals)
                if mask is not None:
                    v = torch.where(mask[cz][cy][:, cx], 0.0, v)
            for c, b in enumerate(bs):
                neg = torch.zeros((len(ys), len(xs)), dtype=torch.bool)
                if b == 1:
                    neg = (xs != cx)[None, :].expand_as(neg)
                elif b == 2:
                    neg = (ys != cy)[:, None].expand_as(neg)
                elif b == 3 and z != cz:
                    neg = ~neg
                u = torch.where(neg, -v[c], v[c])
                out[c, z, y0:y1, x0:x1] = (u.to(out_dtype).to(f32) * scale).to(out_dtype)
    return out


def tiled_substeps(bs, fields, vel, n, dt, zoff=0, n_sub=1, *, buoy=None, src=None,
                   src_on=None, mask=None, scale=1.0, tile=ADVECT_TILE, run=None,
                   substep=None, **extra):
    """advect_substeps around ``substep`` (tiled_substep, K = 1's launch,
    unless given; ``extra`` goes to each launch): the substeps between the
    first read and the last write in float32, the mirror of the velocity
    codes after each substep with a mask, and (bfloat16, mirror) the one
    rounding after it."""
    substep = tiled_substep if substep is None else substep
    storage = fields.dtype
    dt0 = substep_dt0(dt, n, n_sub)
    mirror = mask is not None and any(b in (1, 2, 3) for b in bs)
    dens = bp = None
    if buoy is not None:
        dens, b_f, amb, grav = buoy
        bp = tuple(float(np.float32(x)) for x in (dt, b_f, amb, grav))
    writes = None if mask is None else _nonborder_solid(mask, n, zoff)
    cur = fields
    for sub in range(n_sub):
        first, last = sub == 0, sub == n_sub - 1
        to_s = last and not mirror
        cur = substep(cur, vel, n, zoff, bs, dt0, storage if to_s else torch.float32,
                      dens=dens, bp=bp, buoy_taps=buoy is not None and first, e=src,
                      src_on=src_on if (first or src_on == "density") else None,
                      mask=mask, scale=scale if last else 1.0, tile=tile, run=run, **extra)
        if mirror:
            cur = torch.stack([_mirror_ext(cur[c], mask, writes, 3 - b) if b in (1, 2, 3)
                               else cur[c] for c, b in enumerate(bs)])
    return cur.to(storage)


def seeded(n, nz, seed, scale):
    rng = np.random.default_rng(seed)
    vel = torch.from_numpy((rng.standard_normal((3, nz, n, n)) * scale).astype(np.float32))
    dens = torch.from_numpy((np.abs(rng.standard_normal((nz, n, n))) * 10.0)
                            .astype(np.float32))
    return vel, dens


def emitter(n):
    """bench128's emitter descriptor at n³."""
    return emitter_fold_operand(CFG.replace(size=n), torch.zeros(()))


def vortex_mask(n):
    return torch.from_numpy(build_obstacle_mask(preset_vortex_128().replace(size=n)))


def assert_bitwise(got, ref, what):
    assert got.dtype == ref.dtype, what
    assert torch.equal(got, ref), (what, float((got.float() - ref.float()).abs().max()))


# (n, tile, run): the kernel's tile on a grid of one tile and on one of two
# along y, with the kernel's runs (one plane each on these small grids) and
# with runs of 8, and the small tile on a grid of several along every axis.
K1_GRIDS = [(5, ADVECT_TILE, None), (32, ADVECT_TILE, None), (32, ADVECT_TILE, 8),
            (13, SMALL, 5)]


@pytest.mark.parametrize("n_sub", [1, 2, 3])
@pytest.mark.parametrize("n,tile,run", K1_GRIDS, ids=["5", "32", "32-run8", "13-small"])
@pytest.mark.parametrize("case", ["F3", "F1", "buoy", "buoy-src", "F3-mask", "F1-mask"])
def test_schedule_equals_k1_twin(case, n, tile, run, n_sub):
    vel, dens = seeded(n, n, 100 * n + n_sub, 0.3 * n)
    mask = vortex_mask(n) if case.endswith("mask") else None
    buoy = (dens, 0.2, 0.1, 0.05) if case.startswith("buoy") else None
    src = emitter(n) if case == "buoy-src" else None
    bs, f = ((1, 2, 3), vel) if case[:2] in ("F3", "bu") else ((0,), dens[None])
    got = tiled_substeps(bs, f, vel, n, DT, n_sub=n_sub, buoy=buoy, src=src,
                         src_on="density" if src is not None else None, mask=mask, tile=tile,
                         run=run)
    ref = advect_multi_3d_plain(bs, f, vel, DT, buoy=buoy, obst=mask, n_sub=n_sub, src=src)
    assert_bitwise(got, ref, case)


@pytest.mark.parametrize("n_sub", [1, 2, 3])
@pytest.mark.parametrize("case", ["F3", "F1", "F3-mask", "F1-mask"])
def test_schedule_equals_k1_twin_in_bf16(case, n_sub):
    """The four bfloat16 roles: bf16 in and out (one substep), bf16 in and
    float32 out, float32 in and out, float32 in and bf16 out (two and three),
    and with a velocity's mirror every substep to float32 and one rounding."""
    n = 13
    vel, dens = seeded(n, n, 300 + n_sub, 0.3 * n)
    vel, dens = vel.to(BF16), dens.to(BF16)
    mask = vortex_mask(n) if case.endswith("mask") else None
    bs, f = ((1, 2, 3), vel) if case.startswith("F3") else ((0,), dens[None])
    got = tiled_substeps(bs, f, vel, n, DT, n_sub=n_sub, mask=mask, tile=SMALL, run=4)
    ref = advect_multi_3d_plain(bs, f, vel, DT, obst=mask, n_sub=n_sub)
    assert_bitwise(got, ref, case)


@pytest.mark.parametrize("n_sub", [1, 2])
def test_schedule_equals_k2s_density_phase(n_sub):
    """The emitter on the field itself (kSrcFields, K2s's density phase):
    added to the values the first substep stages; then the scale."""
    n = 32
    vel, dens = seeded(n, n, 400 + n_sub, 0.2 * n)
    e = emitter(n)
    scale = float(np.float32(0.999))
    got = tiled_substeps((0,), dens[None], vel, n, DT, n_sub=n_sub, src=e, src_on="fields",
                         scale=scale, run=6)
    ref = advect_multi_3d_plain((0,), src_field_add(dens, e)[None], vel, DT, n_sub=n_sub)
    assert_bitwise(got, ref * scale, "K2s")


# (n, lz, shard): slabs of rank kinds first, middle and last, so that each
# global wall lies inside a slab with zoff != 0, on the small tile.
SLABS = [(12, 3, 0), (12, 4, 1), (13, 3, 4)]


def ext_slab(x, shard, lz, h):
    """Shard ``shard``'s planes with ``h`` neighbour planes each side, read
    wrapped around the grid (the halo exchange's slab)."""
    n = x.shape[-3]
    idx = torch.arange(shard * lz - h, shard * lz + lz + h) % n
    return x[..., idx, :, :].contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("n_sub", [1, 2, 3])
@pytest.mark.parametrize("n,lz,shard", SLABS)
def test_schedule_equals_k11_twin(n, lz, shard, n_sub, masked, dtype):
    vel, dens = seeded(n, n, 500 + n + shard, 0.2 * n)
    vel, dens = vel.to(dtype), dens.to(dtype)
    h = ext_halo(1, n_sub, masked)
    v = ext_slab(vel, shard, lz, h)
    m = ext_slab(vortex_mask(n), shard, lz, h) if masked else None
    zoff = shard * lz - h
    for bs, f in (((1, 2, 3), v), ((0,), ext_slab(dens[None], shard, lz, h))):
        got = tiled_substeps(bs, f, v, n, DT, zoff, n_sub, mask=m, tile=SMALL, run=4)
        ref = advect_ext_plain(bs, f, v, n, DT, zoff, 1, n_sub, m)
        assert_bitwise(got, ref, f"K11 F={len(bs)}")
