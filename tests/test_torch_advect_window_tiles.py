"""K1 and K11 at windows K >= 2 on tiles (``csrc/advect_window.cuh``) on the
CPU: the route's gate and the ring's shared memory against the constants of
the source, the geometry of its tiles, staged regions and z ring, a plain
emulation of the kernel's schedule held bitwise against the twins
``advect_multi_3d_plain`` and ``advect_ext_plain``, and a property test that
the sum of the <= 8 taps the clamp leaves with weight is bitwise the hat sum
``window_sum_3d`` on finite inputs.

The emulation transliterates the kernel's per-block program, with the blocks
taken in a shuffled order: the staged region of each tile (widened by K,
read at wrapped indices), a plane of it staged once for each field with the
buoyant y component and the emitter applied to each staged value, the z
ring of 2K + 2 slots keyed by the unwrapped plane, the vote (a slot's bit:
every value staged into it finite), the 8-tap sum where a cell's 2K + 1
planes voted finite and its displacement is not NaN, else the full hat sum
from the staged planes; then the solid cells, the face signs, the rounding
and the scale, inside ``advect_substeps``' launches (test_torch_advect_tiles'
``tiled_substeps``).  Slots start poisoned with NaN, so a tap read from a
slot that was not staged shows.  The kernel must equal the twins bit for bit
on the card as well (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fluidsim_tpu_torch.kernels.advect import (
    H100_SMEM_OPTIN,
    advect_multi_3d_plain,
    advect_route,
    win_ring_bytes,
)
from fluidsim_tpu_torch.kernels.halo import advect_ext_plain, ext_halo
from fluidsim_tpu_torch.ops.advect import window_sum_3d
from fluidsim_tpu_torch.scene.sources import src_field_add
from test_torch_advect_tiles import (
    BF16,
    DT,
    advect_runs,
    assert_bitwise,
    blocks,
    buoyant_vy,
    emitter,
    emitter_add,
    ext_slab,
    interior_plane_unwrapped,
    seeded,
    tiled_substeps,
    vortex_mask,
)

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "fluidsim_tpu_torch" / "csrc"
SRC = (CSRC / "advect_window.cuh").read_text()

# csrc/advect_window.cuh's tile (one cell a thread), its longest run, and the
# values a thread stages a plane for each field at most.
WIN_TILE = (32, 16)
WIN_MAX_RUN = 64
WIN_SHARE_MAX = {1: 5, 3: 3}
# Tiles that put several tiles along x and y of the emulation's grids.
SMALL, MID = (8, 4), (16, 8)


def win_share(k, tile=WIN_TILE):
    tx, ty = tile
    return -(-((tx + 2 * k) * (ty + 2 * k)) // (tx * ty))


def test_constants_are_the_kernels():
    assert re.search(rf"kWinTileX = {WIN_TILE[0]};", SRC)
    assert re.search(rf"kWinTileY = {WIN_TILE[1]};", SRC)
    assert re.search(rf"kWinMaxRun = {WIN_MAX_RUN};", SRC)
    assert "win_pitch(int k) { return kWinTileX + 2 * k; }" in SRC
    assert "win_rows(int k) { return kWinTileY + 2 * k; }" in SRC
    assert "win_slots(int k) { return 2 * k + 2; }" in SRC
    assert "return n_fields == 1 ? 5 : 3;" in SRC
    assert "return 4LL * win_slots(k) * n_fields * win_pitch(k) * win_rows(k);" in SRC
    assert "win_share(k) <= win_share_max(n_fields) &&" in SRC
    assert "win_ring_bytes(k, n_fields) <= optin;" in SRC
    assert "advect_runs(tiles_xy, a.slab.nz, capacity[k], 2 * k + 1, kWinMaxRun)" in SRC


@pytest.mark.parametrize("n_fields", [1, 3])
def test_gate_and_ring_bytes(n_fields):
    """The ring's bytes from the source's formula, and the route a pure
    function of K, F and the shared memory: tiles where the ring fits (and a
    thread's share its registers), one thread a cell above."""
    tx, ty = WIN_TILE
    for k in range(2, 16):
        ring = 4 * (2 * k + 2) * n_fields * (tx + 2 * k) * (ty + 2 * k)
        assert win_ring_bytes(k, n_fields) == ring
        for smem in (H100_SMEM_OPTIN, 101_376, 49_152):
            fits = ring <= smem and win_share(k) <= WIN_SHARE_MAX[n_fields]
            assert advect_route(k, n_fields, smem) == ("window" if fits else "cell")
    assert advect_route(1, n_fields) == "tiled"
    # The edge on an H100: F = 3 up to K = 6, F = 1 up to K = 11.
    last = {3: 6, 1: 11}[n_fields]
    assert advect_route(last, n_fields) == "window"
    assert advect_route(last + 1, n_fields) == "cell"
    assert win_ring_bytes(4, 3) == 115_200 and win_ring_bytes(5, 3) == 157_248


# -- the geometry -------------------------------------------------------------------


def stage_span(n, start, stop, k):
    """``(first, count)`` of a tile's staged columns (or rows), unwrapped:
    from K before its first interior cell to K past its last."""
    c0 = min(max(start, 1), n - 2)
    c1 = min(max(stop - 1, 1), n - 2)
    return c0 - k, c1 - c0 + 1 + 2 * k


def win_run(n, nz, k, capacity=132, tile=WIN_TILE):
    tx, ty = tile
    runs = advect_runs(-(-n // tx) * -(-n // ty), nz, capacity, 2 * k + 1, WIN_MAX_RUN)
    return -(-nz // runs)


# (n, nz, zoff): whole grids, and slabs touching the low wall, the high wall,
# both and neither, and a wall on a slab's first and last planes.
GEOMETRY = [(5, 5, 0), (11, 11, 0), (33, 33, 0), (17, 11, -2), (17, 13, 6), (11, 13, -4),
            (33, 12, 8), (17, 11, 0), (17, 11, 6)]


@pytest.mark.parametrize("tile", [WIN_TILE, SMALL], ids=["kernel", "small"])
@pytest.mark.parametrize("n,nz,zoff,k", [g + (k,) for g in GEOMETRY for k in (2, 3, 4, 5)
                                         if min(g[:2]) >= 2 * k + 1])
def test_tiles_cover_every_cell_once_and_every_tap_is_staged(n, nz, zoff, k, tile):
    tx, ty = tile
    slots = 2 * k + 2
    count = np.zeros((nz, n, n), dtype=np.int32)
    for run in (None, 1, 4):
        run = win_run(n, nz, k, tile=tile) if run is None else run
        count[:] = 0
        for x0, x1, y0, y1, z0, z1 in blocks(n, nz, tile, run):
            count[z0:z1, y0:y1, x0:x1] += 1
            sx0, sw = stage_span(n, x0, x1, k)
            sy0, sh = stage_span(n, y0, y1, k)
            assert sw <= tx + 2 * k and sh <= ty + 2 * k
            assert -n < sx0 and sx0 + sw <= 2 * n and -n < sy0 and sy0 + sh <= 2 * n
            for x in range(x0, x1):
                cx = min(max(x, 1), n - 2)
                assert sx0 <= cx - k and cx + k < sx0 + sw
            for y in range(y0, y1):
                cy = min(max(y, 1), n - 2)
                assert sy0 <= cy - k and cy + k < sy0 + sh
            # The z ring: each plane staged once, in order; a cell's 2K + 1
            # planes in distinct slots; the first plane a new interior plane
            # stages refills a slot the previous interior plane does not read
            # (each later one comes after a barrier).
            prev = top = None
            for z in range(z0, z1):
                cu = interior_plane_unwrapped(z, n, zoff)
                assert prev is None or cu >= prev
                if cu != prev:
                    first = cu - k if top is None else max(top + 1, cu - k)
                    assert top is None or first == top + 1
                    if prev is not None and first <= cu + k:
                        assert first - slots < prev - k
                    top, prev = cu + k, cu
                assert len({(cu + d) % slots for d in range(-k, k + 1)}) == 2 * k + 1
                assert all(0 <= (cu + d) % nz < nz and -nz <= cu + d < 2 * nz
                           for d in range(-k, k + 1))
        assert (count == 1).all()


# -- the kernel's schedule -------------------------------------------------------------


def frac_win(c, v, dt0, n, k):
    t = c - dt0 * v
    t = torch.where(t < 0.5, 0.5, t)
    t = torch.where(t > n - 1.5, n - 1.5, t)
    t = torch.minimum(torch.maximum(t, c - k), c + k)
    return t - c


def hat(f, d):
    return torch.clamp(1.0 - torch.abs(f - d), min=0.0)


def window_substep(src, vel, n, zoff, bs, dt0, out_dtype, *, dens=None, bp=None,
                   buoy_taps=False, e=None, src_on=None, mask=None, scale=1.0,
                   tile=WIN_TILE, run=None, window=2, order=0):
    """One launch of advect_window_kernel on the (F, nz, n, n) slab ``src``
    with a window of ``window`` cells, the blocks in the order of a
    permutation seeded by ``order``; the folds as tiled_substep's."""
    f32 = torch.float32
    k = window
    n_fields, nz = src.shape[0], src.shape[1]
    tx, ty = tile
    slots = 2 * k + 2
    run = win_run(n, nz, k, tile=tile) if run is None else run
    out = torch.full((n_fields, nz, n, n), float("nan"), dtype=out_dtype)
    boxes = list(blocks(n, nz, tile, run))
    for b in np.random.default_rng(order).permutation(len(boxes)):
        x0, x1, y0, y1, z0, z1 = boxes[b]
        sx0, sw = stage_span(n, x0, x1, k)
        sy0, sh = stage_span(n, y0, y1, k)
        gxs, gys = torch.arange(sx0, sx0 + sw) % n, torch.arange(sy0, sy0 + sh) % n
        xs, ys = torch.arange(x0, x1), torch.arange(y0, y1)
        cx, cy = xs.clamp(1, n - 2), ys.clamp(1, n - 2)
        lx, ly = (cx - sx0)[None, :], (cy - sy0)[:, None]
        ring = torch.full((slots, n_fields, ty + 2 * k, tx + 2 * k), float("nan"))
        bits = [False] * slots

        def stage(p):
            """Plane p's staged values into slot p % slots, and its vote."""
            pz = p % nz
            g = src[:, pz][:, gys][:, :, gxs].to(f32)
            rows = []
            for c in range(n_fields):
                gc = g[c]
                if src_on == "fields":
                    gc = emitter_add(gc, e, zoff + pz, gys, gxs)
                if buoy_taps and c == 1:
                    rho = dens[pz][gys][:, gxs]
                    if src_on == "density":
                        rho = emitter_add(rho, e, zoff + pz, gys, gxs)
                    gc = buoyant_vy(gc, rho, bp)
                rows.append(gc)
            staged = torch.stack(rows)
            ring[p % slots, :, :sh, :sw] = staged
            bits[p % slots] = bool(torch.isfinite(staged).all())

        def interpolate(cu, cz):
            vc = vel[:, cz][:, cy][:, :, cx].to(f32)
            vx, vy, vz = vc[0], vc[1], vc[2]
            zg = cz + zoff
            if bp is not None:
                rho = dens[cz][cy][:, cx]
                if src_on == "density":
                    rho = emitter_add(rho, e, zg, cy, cx)
                vy = buoyant_vy(vy, rho, bp)
            fx = frac_win(cx.to(f32)[None, :], vx, dt0, n, k)
            fy = frac_win(cy.to(f32)[:, None], vy, dt0, n, k)
            fz = frac_win(torch.tensor(float(zg)), vz, dt0, n, k)
            planes_ok = all(bits[(cu + d) % slots] for d in range(-k, k + 1))
            ok = ~(fx.isnan() | fy.isnan() | fz.isnan()) & planes_ok
            # The 8-tap sum (its value where ok; NaN weights elsewhere index 0).
            i = [torch.where(f.isnan(), 0.0, f).floor().clamp(max=k - 1).long()
                 for f in (fx, fy, fz)]
            h = [(hat(f, d), hat(f, d + 1)) for f, d in zip((fx, fy, fz), i)]
            sl = [(cu + i[2] + a) % slots for a in (0, 1)]
            vals = []
            for c in range(n_fields):
                acc = torch.zeros_like(fx)
                for a in (0, 1):
                    for b_ in (0, 1):
                        wzy = h[2][a] * h[1][b_]
                        for d in (0, 1):
                            w = wzy * h[0][d]
                            g = ring[sl[a], c, ly + i[1] + b_, lx + i[0] + d]
                            acc = acc + w * g
                vals.append(acc)
            v8 = torch.stack(vals)
            if bool(ok.all()):
                return v8
            # The full hat sum from the staged planes, every tap.
            full = torch.zeros_like(v8)
            for dz in range(-k, k + 1):
                wz = hat(fz, dz)
                s = (cu + dz) % slots
                for dy in range(-k, k + 1):
                    wzy = wz * hat(fy, dy)
                    for dx in range(-k, k + 1):
                        w = wzy * hat(fx, dx)
                        full = full + w[None] * ring[s][:, ly + dy, lx + dx]
            return torch.where(ok[None], v8, full)

        top = prev = None
        for z in range(z0, z1):
            cu = interior_plane_unwrapped(z, n, zoff)
            cz = cu % nz
            if cu != prev:
                for p in range(cu - k if top is None else max(top + 1, cu - k), cu + k + 1):
                    stage(p)
                top, prev = cu + k, cu
                v = interpolate(cu, cz)
                if mask is not None:
                    v = torch.where(mask[cz][cy][:, cx], 0.0, v)
            for c, b_ in enumerate(bs):
                neg = torch.zeros((len(ys), len(xs)), dtype=torch.bool)
                if b_ == 1:
                    neg = (xs != cx)[None, :].expand_as(neg)
                elif b_ == 2:
                    neg = (ys != cy)[:, None].expand_as(neg)
                elif b_ == 3 and z != cz:
                    neg = ~neg
                u = torch.where(neg, -v[c], v[c])
                out[c, z, y0:y1, x0:x1] = (u.to(out_dtype).to(f32) * scale).to(out_dtype)
    return out


def window_substeps(bs, fields, vel, n, dt, window, zoff=0, n_sub=1, **kw):
    return tiled_substeps(bs, fields, vel, n, dt, zoff, n_sub, substep=window_substep,
                          window=window, order=window + 10 * n_sub, **kw)


def reach(n, nz, seed, window, n_sub=1):
    """Seeded fields whose velocity backtraces about K + 1 cells a substep."""
    return seeded(n, nz, seed, (window + 1) * n_sub / (2.0 * DT * (n - 2)))


def assert_same(got, ref, what):
    """Bitwise but for NaN payloads: NaN in the same cells, equal elsewhere."""
    assert got.dtype == ref.dtype, what
    assert torch.equal(got.isnan(), ref.isnan()), (what, "NaN cells differ")
    assert_bitwise(torch.where(got.isnan(), 0.0, got), torch.where(ref.isnan(), 0.0, ref),
                   what)


# (n, tile, run): the kernel's tile on a grid of one tile, and the small tile
# on a grid of several along every axis, runs of 6.
K1_GRIDS = [(11, WIN_TILE, 6), (13, SMALL, 6)]


@pytest.mark.parametrize("n_sub", [1, 2, 3])
@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("n,tile,run", K1_GRIDS, ids=["11", "13-small"])
@pytest.mark.parametrize("case", ["F3", "F1", "F3-mask", "F1-mask"])
def test_schedule_equals_k1_twin(case, n, tile, run, window, n_sub):
    vel, dens = reach(n, n, 700 * window + n + n_sub, window, n_sub)
    mask = vortex_mask(n) if case.endswith("mask") else None
    bs, f = ((1, 2, 3), vel) if case.startswith("F3") else ((0,), dens[None])
    got = window_substeps(bs, f, vel, n, DT, window, n_sub=n_sub, mask=mask, tile=tile,
                          run=run)
    ref = advect_multi_3d_plain(bs, f, vel, DT, obst=mask, n_sub=n_sub, window=window)
    assert_bitwise(got, ref, case)


@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("case", ["buoy", "buoy-src"])
def test_schedule_equals_k1_twin_with_folds(case, window):
    n = 13
    vel, dens = reach(n, n, 800 + window, window)
    buoy = (dens, 0.2, 0.1, 0.05)
    src = emitter(n) if case == "buoy-src" else None
    for n_sub in (1, 2):
        got = window_substeps((1, 2, 3), vel, vel, n, DT, window, n_sub=n_sub, buoy=buoy,
                              src=src, src_on="density" if src is not None else None,
                              tile=SMALL, run=5)
        ref = advect_multi_3d_plain((1, 2, 3), vel, vel, DT, buoy=buoy, n_sub=n_sub, src=src,
                                    window=window)
        assert_bitwise(got, ref, f"{case} n_sub={n_sub}")


@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("case", ["F3", "F1", "F3-mask", "F1-mask"])
def test_schedule_equals_k1_twin_in_bf16(case, window):
    """The bfloat16 roles (one, two and three substeps), and with a
    velocity's mirror every substep to float32 and one rounding."""
    n = 13
    vel, dens = reach(n, n, 900 + window, window, 2)
    vel, dens = vel.to(BF16), dens.to(BF16)
    mask = vortex_mask(n) if case.endswith("mask") else None
    bs, f = ((1, 2, 3), vel) if case.startswith("F3") else ((0,), dens[None])
    for n_sub in (1, 2, 3):
        got = window_substeps(bs, f, vel, n, DT, window, n_sub=n_sub, mask=mask, tile=MID,
                              run=4)
        ref = advect_multi_3d_plain(bs, f, vel, DT, obst=mask, n_sub=n_sub, window=window)
        assert_bitwise(got, ref, f"{case} n_sub={n_sub}")


@pytest.mark.parametrize("window", [2, 3, 4, 5])
def test_schedule_equals_k2s_density_phase(window):
    """The emitter on the field itself (kSrcFields, K2s's density phase):
    added to the values the first substep stages; then the scale."""
    n = 13
    vel, dens = reach(n, n, 1000 + window, window)
    e = emitter(n)
    scale = float(np.float32(0.999))
    for n_sub in (1, 2):
        got = window_substeps((0,), dens[None], vel, n, DT, window, n_sub=n_sub, src=e,
                              src_on="fields", scale=scale, tile=SMALL, run=3)
        ref = advect_multi_3d_plain((0,), src_field_add(dens, e)[None], vel, DT, n_sub=n_sub,
                                    window=window)
        assert_bitwise(got, ref * scale, f"K2s n_sub={n_sub}")


# (n, lz, shard): slabs of rank kinds first, middle and last, so that each
# global wall lies inside a slab with zoff != 0.
SLABS = [(13, 4, 0), (13, 3, 1), (12, 3, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("n,lz,shard", SLABS)
def test_schedule_equals_k11_twin(n, lz, shard, window, masked, dtype):
    n_sub = 1 if window > 3 else 2
    vel, dens = reach(n, n, 1100 + n + shard + window, window, n_sub)
    vel, dens = vel.to(dtype), dens.to(dtype)
    h = ext_halo(window, n_sub, masked)
    v = ext_slab(vel, shard, lz, h)
    m = ext_slab(vortex_mask(n), shard, lz, h) if masked else None
    zoff = shard * lz - h
    for bs, f in (((1, 2, 3), v), ((0,), ext_slab(dens[None], shard, lz, h))):
        got = window_substeps(bs, f, v, n, DT, window, zoff, n_sub, mask=m, tile=MID, run=5)
        ref = advect_ext_plain(bs, f, v, n, DT, zoff, window, n_sub, m)
        assert_bitwise(got, ref, f"K11 F={len(bs)}")


def plant_taps(f, window):
    """NaN and inf at taps with zero weight for some cells: on the far x, y
    and z walls (read wrapped, past the opposite wall) and K away from a
    still cell (plant_velocity)."""
    f = f.clone()
    n = f.shape[-1]
    c = n // 2
    f[:, c, c - 1, n - 1] = float("inf")
    f[:, c + 1, n - 1, 2] = float("-inf")
    f[:, n - 1, 3, c] = float("nan")
    f[:, c + window, c, c] = float("nan")
    return f


def plant_velocity(vel):
    """A still cell (only its own tap has weight) and a NaN backtrace."""
    vel = vel.clone()
    c = vel.shape[-1] // 2
    vel[:, c, c, c] = 0.0
    vel[0, c - 2, c + 1, c] = float("nan")
    return vel


@pytest.mark.parametrize("window", [2, 4])
@pytest.mark.parametrize("case", ["F1", "F3", "F1 bf16", "K11"])
def test_schedule_with_non_finite_values_equals_twin(case, window):
    """Where a plane voted non-finite or a displacement is NaN the cells take
    the full sum: the twin's NaN and inf cells, and its values elsewhere."""
    n = 13
    vel, dens = reach(n, n, 1200 + window, window)
    if case.endswith("bf16"):
        vel, dens = vel.to(BF16), dens.to(BF16)
    if case == "F3":
        bs, v = (1, 2, 3), plant_velocity(plant_taps(vel, window))
        f = v
    else:
        bs, f, v = (0,), plant_taps(dens[None], window), plant_velocity(vel)
    if case == "K11":
        f, v = f[:, 1:n - 1].contiguous(), v[:, 1:n - 1].contiguous()
        got = window_substeps(bs, f, v, n, DT, window, 1)
        ref = advect_ext_plain(bs, f, v, n, DT, 1, window, 1)
    else:
        got = window_substeps(bs, f, v, n, DT, window)
        ref = advect_multi_3d_plain(bs, f, v, DT, window=window)
    assert bool(ref.isnan().any()) and bool(torch.isfinite(ref).any())
    assert_same(got, ref, case)


# -- the sum of the taps with weight -------------------------------------------------


def eight_tap_sum(fields, vel, dt0, window, z_offset=0):
    """window_sum_3d's value from the <= 8 taps at d = min(floor(f), K - 1)
    and d + 1 on each axis, summed in the hat sum's order."""
    n, nz = fields.shape[-1], fields.shape[1]
    f32 = torch.float32
    k = window
    ar = torch.arange(n, dtype=f32)
    coords = (ar[None, None, :], ar[None, :, None],
              (torch.arange(nz) + z_offset).to(f32)[:, None, None])
    fs = [frac_win(c, vel[a].to(f32), dt0, n, k) for a, c in enumerate(coords)]
    i = [f.floor().clamp(max=k - 1).long() for f in fs]
    h = [(hat(f, d), hat(f, d + 1)) for f, d in zip(fs, i)]
    zz, yy, xx = torch.meshgrid(torch.arange(nz), torch.arange(n), torch.arange(n),
                                indexing="ij")
    out = torch.zeros(fields.shape, dtype=f32)
    for a in (0, 1):
        for b in (0, 1):
            wzy = h[2][a] * h[1][b]
            for d in (0, 1):
                w = wzy * h[0][d]
                g = fields[:, (zz + i[2] + a) % nz, (yy + i[1] + b) % n, (xx + i[0] + d) % n]
                out = out + w[None] * g
    return out


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), window=st.integers(2, 5), extra=st.integers(0, 3),
       slab=st.booleans(), whole=st.booleans(), exponent=st.integers(-30, 30))
def test_eight_taps_are_bitwise_the_hat_sum(seed, window, extra, slab, whole, exponent):
    """On finite fields of any magnitude, with displacements that are whole
    cells (``whole``) or not, on grids and slabs."""
    rng = np.random.default_rng(seed)
    n = 2 * window + 1 + extra
    nz = n - 1 if slab and n - 1 >= 2 * window + 1 else n
    z_offset = int(rng.integers(-2, 3)) if nz != n else 0
    fields = rng.standard_normal((3, nz, n, n)) * 10.0 ** exponent
    dt0 = float(np.float32(rng.uniform(0.1, 3.0)))
    vel = rng.standard_normal((3, nz, n, n)) * (window + 1) / dt0
    if whole:
        vel = np.round(vel * dt0) / dt0
    fields = torch.from_numpy(fields.astype(np.float32))
    vel = torch.from_numpy(vel.astype(np.float32))
    got = eight_tap_sum(fields, vel, dt0, window, z_offset)
    ref = window_sum_3d(fields, vel, dt0, window, z_offset)
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(torch.where(got.isnan(), 0.0, got), torch.where(ref.isnan(), 0.0, ref))
