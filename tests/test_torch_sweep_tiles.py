"""K5's and K4's tile program (``block_tile`` in ``csrc/solve_tiled.cuh``) on
the CPU: its gate (``kernels/resident.tiling`` with a block, ``block_smem``,
``shell_fits``; ``kernels/jacobi.k4_tiles``), and a plain emulation of the
program held bitwise against the twins ``solve_loop_plain`` (K5 in the
projections and in K4) and ``jacobi_3d_resident_plain`` (K4's sweeps).

The emulation transliterates the kernel's per-block program onto flat
tensors laid out as the kernel lays them out: each tile's shared memory is
one byte tensor cut into the regions of ``block_layout`` (the iterate, the
float32 chain buffers, the rhs, the solid bits' stand-in), read through
typed views at the kernel's offsets, so that a float32 solve's iterate
aliases the second chain buffer and a bfloat16 iterate moves into a float32
region as the kernel's casts move it; the face slots are one float32
tensor with the kernel's slot offsets.  Every byte starts as NaN (0xFF), so
a read of a cell nobody wrote shows.  Each stage runs over the tiles in a
new shuffled order, then every tile stores its faces and, in another order,
loads its halo from its neighbours' opposite faces: on the torus at T = 2,
never past a wall at T >= 3, where the emulation also poisons with NaN the
halo the kernel fills from the torus (the rhs and the start) to show it
dead.  The shell's levels live in global scratch, as in the kernel.  It
must equal the twins bit for bit, as the kernel must on the card
(``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidsim_tpu_torch.config import preset_vortex_128
from fluidsim_tpu_torch.kernels.jacobi import (
    block_constants,
    composite_block,
    jacobi_3d_resident_plain,
    k4_tiles,
    solve_coefficients,
    solve_loop_plain,
)
from fluidsim_tpu_torch.kernels.resident import (
    BLOCK_THREADS,
    H100_SMEM_OPTIN,
    H100_SMS,
    INV6,
    block_smem,
    divergence_interior,
    project_3d_resident_plain,
    projection_tiles,
    shell_fits,
    solve_tiles,
    tile_bounds,
    tile_bounds_x,
    tile_extents,
    tile_face_values,
    tiling,
)
from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "fluidsim_tpu_torch" / "csrc"
F32, BF16 = torch.float32, torch.bfloat16


def _r16(v):
    return (v + 15) & ~15


def layout(shape, itemsize, block, masked):
    """``block_layout``: the byte offsets of the program's regions and its
    total, the kernel's formula."""
    mx, my, mz = shape
    hx = (mx + 1) // 2
    cells = (2 * hx + 2) * (my + 2) * (mz + 2)
    pb, wb = _r16((cells + 2) * itemsize), _r16((cells + 2) * 4)
    lay = {"p": 0, "w0": pb}
    lay["w1"] = lay["w0"]
    end = pb + wb
    if block >= 3:
        if itemsize == 4:
            lay["w1"] = 0
        else:
            lay["w1"] = end
            end += wb
    lay["rhs"] = end
    if block == 1:
        end += _r16(2 * hx * my * mz * itemsize)
    lay["bits"] = end
    if masked and block >= 2:
        end += _r16(-(-cells // 32) * 4)
    lay["total"] = end
    return lay


# -- the gate -------------------------------------------------------------------


def test_gate_constants_are_the_kernels():
    src = (CSRC / "solve_tiled.cuh").read_text()
    assert "return (v + 15) & ~static_cast<size_t>(15);" in src
    assert "return ((2 * hx + 2) * (my + 2) * (mz + 2) + 31) / 32;" in src
    assert re.search(r"pb = round16\(pv \* tbytes\), wb = round16\(pv \* 4\);", src)
    assert re.search(r"if \(tb >= 3\) \{\s*if \(tbytes == 4\) \{\s*l\.w1 = l\.p;", src)
    assert "if (tb == 1) end += round16(static_cast<size_t>(2 * s.hx) * s.my * s.mz * tbytes);" \
        in src
    assert "if (mask && tb >= 2) end += round16(static_cast<size_t>(padded_words(" in src
    assert "const int d = 2 * tb - 1;" in src
    assert "const bool torus = tb == 2;" in src
    assert re.search(rf"kBlockThreads = {BLOCK_THREADS};", src)
    # x1/X on chip only where the layout with it fits: the gate's budget is
    # the least layout.
    assert "if (tb >= 2 && x_chip) end += round16(static_cast<size_t>(2 * s.hx) * s.my * s.mz * 4);" \
        in src


@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("block", [2, 3, 4])
@pytest.mark.parametrize("sdt", [BF16, F32], ids=["bf16", "f32"])
def test_budget_at_128(sdt, block, masked):
    # 32 x 16 x 32 tiles on 128 SMs: the iterate and one float32 chain
    # buffer (two for T >= 3 in bfloat16; a float32 iterate is the second),
    # each 34 x 18 x 34 + 2 values rounded to 16 bytes, the mask's bits.
    tiles = solve_tiles(128, sdt, None, block, masked)
    assert tiles == (4, 8, 4)
    cells = 34 * 18 * 34
    p, w = _r16((cells + 2) * sdt.itemsize), _r16((cells + 2) * 4)
    need = p + w + (w if block >= 3 and sdt == BF16 else 0) + (
        _r16(-(-cells // 32) * 4) if masked else 0)
    assert block_smem(128, tiles, sdt.itemsize, block, masked) == need <= H100_SMEM_OPTIN
    assert need == layout(tile_extents(128, tiles), sdt.itemsize, block, masked)["total"]
    # About 125 KB (bf16, T = 2), 166 KB (f32), 208 KB (bf16, T >= 3), and
    # 2,608 bytes of solid bits.
    bits = 2608 if masked else 0
    assert (need - bits) // 1000 == {(BF16, 2): 124, (F32, 2): 166, (BF16, 3): 208,
                                     (BF16, 4): 208, (F32, 3): 166, (F32, 4): 166}[(sdt, block)]


def test_k4_budget_and_routes():
    # K4's sequential sweeps: two float32 copies and the rhs, as the tiled
    # solve's, each region rounded to 16 bytes: 232,032 bytes at 128^3.
    assert block_smem(128, (4, 8, 4), 4, 1) == 2 * _r16(34 * 18 * 34 * 4 + 8) + 32 * 16 * 32 * 4
    assert block_smem(128, (4, 8, 4), 4, 1) == 232_032 <= H100_SMEM_OPTIN
    assert k4_tiles(64, 20) is not None  # plume64 + double_project
    assert k4_tiles(128, 20, masked=True) is not None  # vortex128 + double_project
    assert k4_tiles(128, 60, sweep_block=4) == (4, 8, 4)  # K5 in K4
    assert k4_tiles(176, 20) is None  # more tiles than SMs: one launch a sweep


@pytest.mark.parametrize("n,itemsize,block,masked", [
    (144, 4, 2, False),   # f32 iterate and chain buffer over the opt-in
    (144, 2, 3, False),   # bf16 iterate and two chain buffers over it
    (160, 2, 2, True),    # bf16 with the bits past the bf16 T = 1 edge
    (176, 2, 2, False),   # more tiles than SMs
    (144, 4, 1, False),   # K4's copies and rhs over the opt-in
])
def test_none_where_it_cannot_fit(n, itemsize, block, masked):
    assert tiling(n, itemsize, H100_SMS, H100_SMEM_OPTIN, block, masked, block == 1) is None


def test_shell_needs_the_wall_depth():
    # T = 4 needs 7 planes at each wall: 21 cells in 3 tiles have them,
    # 20 cells in 3 tiles (6, 7, 7) do not; T = 3 needs 5.
    assert shell_fits(21, (3, 3, 3), 4)
    assert not shell_fits(20, (3, 1, 1), 4)
    assert shell_fits(20, (3, 1, 1), 3)
    assert shell_fits(20, (3, 1, 1), 2)
    for n, block in ((16, 4), (20, 4), (21, 4), (32, 3), (48, 4)):
        tiles = solve_tiles(n, F32, None, block)
        assert tiles is not None and shell_fits(n, tiles, block)
        gx, gy, gz = tiles
        for bounds in (tile_bounds_x(n, gx), tile_bounds(n, gy), tile_bounds(n, gz)):
            assert min(bounds[0][1] - bounds[0][0], bounds[-1][1] - bounds[-1][0]) >= 2 * block - 1


def test_projection_route_takes_k5_on_the_tiles():
    assert projection_tiles(128, F32, 60, 4, BF16) == (4, 8, 4)
    assert projection_tiles(128, F32, 20, 2, BF16, None, True) == (4, 8, 4)
    assert projection_tiles(144, F32, 60, 2, F32) is None  # no tiling: per stage
    assert projection_tiles(128, BF16, 60, 4, BF16) == solve_tiles(128, BF16)  # no K5


# -- the emulation ----------------------------------------------------------------


def _clamp(i, n):
    return min(max(i, 1), n - 2)


class Program:
    """The tile program over every tile: its global data (the rhs ``x0``,
    ``x1``, the shell's two levels, the face slots, the flags' order) and
    one ``Tile`` a block."""

    def __init__(self, n, tiles, sdt, block, x0, *, mask=None, start=None, general=False,
                 b=0, a=1.0, inv_c=INV6, iters=1, seed=0, torus=True, poison=True):
        self.n, self.tiles, self.sdt, self.tb = n, tiles, sdt, block
        self.general, self.b, self.a, self.inv_c, self.iters = general, b, a, inv_c, iters
        self.x0 = x0          # the rhs volume (the solve dtype; K4: float32)
        self.mask, self.start = mask, start
        self.torus = torus and block == 2
        self.poison = poison and block >= 3
        aic, aicic, a2, a2ic2, a_t = block_constants(a, inv_c, max(block, 2))
        self.k = dict(a=float(np.float32(a)), ic=inv_c, aic=aic, aicic=aicic, a2=a2,
                      a2ic2=a2ic2, aT=a_t)
        self.x1 = torch.full((n, n, n), float("nan"))
        self.levels = [torch.full((6 * 2 * max(block, 1), n, n), float("nan")) for _ in range(2)]
        self.faces = torch.full((tile_face_values(n, tiles),), float("nan"))
        self.shape = tile_extents(n, tiles)
        mx, my, mz = self.shape
        self.face = max(my * mz, 2 * ((mx + 1) // 2) * mz, 2 * ((mx + 1) // 2) * my)
        self.face += self.face % 2
        self.ntiles = int(np.prod(tiles))
        self.blocks = [Tile(self, t) for t in range(self.ntiles)]
        self.order = np.random.default_rng(seed)
        self.s = 0

    def each(self, fn):
        for t in self.order.permutation(self.ntiles):
            fn(self.blocks[t])

    def trade(self, region_of, dtype):
        """The face trade of every tile's buffer at byte offset
        ``region_of(tile)`` (typed ``dtype``): stores, then (another order)
        halo loads."""
        self.s += 1
        self.each(lambda t: t.store_faces(region_of(t), dtype, self.s & 1))
        self.each(lambda t: t.load_halo(region_of(t), dtype, self.s & 1))

    def run(self):
        tb, blocks = self.tb, self.blocks
        self.each(lambda t: t.phase1())
        if tb == 2:
            self.each(lambda t: t.x1_delta())
        elif tb >= 3:
            gin, gout = "w0", "w1"
            pw = np.float32(1.0)
            for q in range(1, tb):
                pw = np.float32(pw * np.float32(self.a))
                self.each(lambda t: t.g_stage(q, float(pw), gin, gout))
                if q <= tb - 2:
                    self.trade(lambda t: t.lay[gout], F32)
                gin, gout = gout, gin
        self.each(lambda t: t.load_start())
        nblocks = self.iters // tb if tb >= 2 else 0
        left = self.iters % tb if tb >= 2 else self.iters
        stages, stage = nblocks * tb + left, 0

        def after(region_of, dtype):
            nonlocal stage
            stage += 1
            if stage < stages:
                self.trade(region_of, dtype)

        for _ in range(nblocks):
            if tb == 2:
                self.each(lambda t: t.u_stage())
                after(lambda t: t.lay["w0"], F32)
                self.each(lambda t: t.delta_stage())
                after(lambda t: t.p_at, self.sdt)
                continue
            hin = None
            for q in range(tb):
                hout = "w0" if q % 2 == 0 else "w1"
                if q <= tb - 2:
                    self.each(lambda t: t.chain_stage(q, hin, hout))
                    self.each(lambda t: t.shell(q + 1))
                    after(lambda t: t.lay[hout], F32)
                    hin = hout
                    continue
                self.each(lambda t: t.shell(tb))
                self.each(lambda t: t.final_stage(hin))
                after(lambda t: t.p_at, self.sdt)
        for _ in range(left):
            self.each(lambda t: t.sweep())
            after(lambda t: t.p_at, self.sdt)
        out = torch.empty((self.n,) * 3, dtype=self.sdt)
        for t in blocks:
            t.store(out)
        return out


class Tile:
    """One block: its box, its shared memory as bytes (NaN), typed views."""

    def __init__(self, prog, b):
        self.g, self.b = prog, b
        n, (gx, gy, gz) = prog.n, prog.tiles
        self.bx, self.by, self.bz = b % gx, (b // gx) % gy, b // (gx * gy)
        self.ox, x1 = tile_bounds_x(n, gx)[self.bx]
        self.oy, y1 = tile_bounds(n, gy)[self.by]
        self.oz, z1 = tile_bounds(n, gz)[self.bz]
        self.tx, self.ty, self.tz = x1 - self.ox, y1 - self.oy, z1 - self.oz
        mx, my, mz = prog.shape
        self.hx = (mx + 1) // 2
        self.my, self.mz = my, mz
        self.px = 2 * self.hx + 2
        self.pplane = self.px * (my + 2)
        self.lay = layout(prog.shape, prog.sdt.itemsize, prog.tb, prog.mask is not None)
        self.smem = torch.full((self.lay["total"] + 16,), 0xFF, dtype=torch.uint8)
        self.p_at = self.lay["p"]
        torus = prog.torus
        nb = [(self.bx > 0, b - 1, b + gx - 1), (self.bx < gx - 1, b + 1, b - (gx - 1)),
              (self.by > 0, b - gx, b + (gy - 1) * gx),
              (self.by < gy - 1, b + gx, b - (gy - 1) * gx),
              (self.bz > 0, b - gx * gy, b + (gz - 1) * gx * gy),
              (self.bz < gz - 1, b + gx * gy, b - (gz - 1) * gx * gy)]
        self.nb = [inner if ok else (wrapped if torus else -1) for ok, inner, wrapped in nb]
        # Coefficients of the padded tile (the kernel's solid bits; past a
        # wall the torus's).
        zz, yy, xx = np.meshgrid(np.arange(mz + 2) - 1, np.arange(my + 2) - 1,
                                 np.arange(self.px) - 1, indexing="ij")
        self.gz = torch.from_numpy((self.oz + zz) % n)
        self.gy = torch.from_numpy((self.oy + yy) % n)
        self.gx = torch.from_numpy((self.ox + xx) % n)
        ic = prog.k["ic"]
        if prog.mask is None:
            self.coef = torch.full(self.gz.shape, ic)
        else:
            self.coef = torch.where(prog.mask[self.gz, self.gy, self.gx], 0.0, ic)
        self.own = (slice(1, self.tz + 1), slice(1, self.ty + 1), slice(1, self.tx + 1))
        # The rows a clamped stage computes: each row's y clamped.
        self.ry = torch.tensor([_clamp(self.oy + y, n) - self.oy for y in range(self.ty)])
        self.faces_index()

    # -- the shared memory as the kernel addresses it --

    def flat(self, off, dtype):
        """The typed buffer at byte offset ``off``: index ``i`` is the
        kernel's ``buf[i - 2]``."""
        nbytes = (2 + self.pplane * (self.mz + 2)) * dtype.itemsize
        return self.smem[off:off + nbytes].view(dtype)

    def v3(self, off, dtype):
        """The padded copy at ``off`` as (z + 1, y + 1, x + 1)."""
        return self.flat(off, dtype)[1:1 + self.pplane * (self.mz + 2)].view(
            self.mz + 2, self.my + 2, self.px)

    def cells(self, v):
        return v[self.own]

    def halo_cells(self):
        """The halo's six faces (not its edges): (index tuple into the
        padded copy, past a wall or not)."""
        n = self.g.n
        tx, ty, tz = self.tx, self.ty, self.tz
        out = []
        for axis, lo in ((2, True), (2, False), (1, True), (1, False), (0, True), (0, False)):
            idx = [slice(1, tz + 1), slice(1, ty + 1), slice(1, tx + 1)]
            ext = (tz, ty, tx)[axis]
            idx[axis] = 0 if lo else ext + 1
            o = (self.oz, self.oy, self.ox)[axis]
            past = (o == 0) if lo else (o + ext == n)
            out.append((tuple(idx), past))
        return out

    # -- the trade --

    def faces_index(self):
        """Per face f: the padded-copy cells whose values it publishes, the
        halo cells it fills, and their offsets in a slot (pairs along x, as
        the kernel moves them: a partial pair's second value too)."""
        tx, ty, tz = self.tx, self.ty, self.tz
        row, mz = 2 * self.hx, self.mz
        xs = torch.arange(tx + (tx & 1))
        js, ys = torch.arange(tz), torch.arange(ty)
        self.fidx = []
        for f in range(6):
            if f < 2:
                j, y = torch.meshgrid(js, ys, indexing="ij")
                pos = y * mz + j
                xin = 0 if f == 0 else tx - 1
                xout = -1 if f == 0 else tx
                inner = (j + 1, y + 1, torch.full_like(j, xin + 1))
                outer = (j + 1, y + 1, torch.full_like(j, xout + 1))
            elif f < 4:
                j, x = torch.meshgrid(js, xs, indexing="ij")
                pos = j * row + x
                yin = 0 if f == 2 else ty - 1
                yout = -1 if f == 2 else ty
                inner = (j + 1, torch.full_like(j, yin + 1), x + 1)
                outer = (j + 1, torch.full_like(j, yout + 1), x + 1)
            else:
                y, x = torch.meshgrid(ys, xs, indexing="ij")
                pos = y * row + x
                zin = 0 if f == 4 else tz - 1
                zout = -1 if f == 4 else tz
                inner = (torch.full_like(y, zin + 1), y + 1, x + 1)
                outer = (torch.full_like(y, zout + 1), y + 1, x + 1)
            self.fidx.append((pos.reshape(-1), tuple(i.reshape(-1) for i in inner),
                              tuple(i.reshape(-1) for i in outer)))

    def slot(self, parity, tile, f, dtype):
        base = ((parity * self.g.ntiles + tile) * 6 + f) * self.g.face
        view = self.g.faces.view(dtype) if dtype != F32 else self.g.faces
        scale = 4 // dtype.itemsize
        return view, base * scale

    def store_faces(self, off, dtype, parity):
        v = self.v3(off, dtype)
        for f in range(6):
            if self.nb[f] < 0:
                continue
            pos, inner, _ = self.fidx[f]
            view, base = self.slot(parity, self.b, f, dtype)
            view[base + pos] = v[inner]

    def load_halo(self, off, dtype, parity):
        v = self.v3(off, dtype)
        for f in range(6):
            if self.nb[f] < 0:
                continue
            pos, _, outer = self.fidx[f]
            view, base = self.slot(parity, self.nb[f], f ^ 1, dtype)
            v[outer] = view[base + pos]

    # -- the stages --

    def nbr(self, v, op=False, rows=None):
        """N at the tile's cells of padded float32 values ``v`` (each operand
        times the coefficient where ``op``), at the rows ``rows`` (clamped
        stages) or the cells' own."""
        if op:
            v = v * self.coef
        tz, ty, tx = self.tz, self.ty, self.tx
        r = torch.arange(1, ty + 1) if rows is None else rows + 1
        zc = v[1:tz + 1]
        xp = zc[:, r, 2:tx + 2]
        xm = zc[:, r, 0:tx]
        yp = zc[:, r + 1, 1:tx + 1]
        ym = zc[:, r - 1, 1:tx + 1]
        zp = v[2:tz + 2][:, r, 1:tx + 1]
        zm = v[0:tz][:, r, 1:tx + 1]
        return ((xp + xm) + (yp + ym)) + (zp + zm)

    def at_rows(self, v):
        """Padded values at the clamped rows of the tile's cells."""
        return v[1:self.tz + 1][:, self.ry + 1, 1:self.tx + 1]

    def gidx(self, rows=False):
        """The global (z, y, x) of the tile's cells (rows: clamped)."""
        z = torch.arange(self.oz, self.oz + self.tz)[:, None, None]
        y = (self.oy + (self.ry if rows else torch.arange(self.ty)))[None, :, None]
        x = torch.arange(self.ox, self.ox + self.tx)[None, None, :]
        return z.expand(self.tz, self.ty, self.tx), y.expand(self.tz, self.ty, self.tx), \
            x.expand(self.tz, self.ty, self.tx)

    def walls(self, v, sign_x=1.0, sign_z=1.0):
        """The x and z wall cells take their column's value at 1 or n - 2."""
        n = self.g.n
        if self.ox == 0:
            v[:, :, 0] = (v[:, :, 1].float() * sign_x).to(v.dtype)
        if self.ox + self.tx == n:
            v[:, :, -1] = (v[:, :, -2].float() * sign_x).to(v.dtype)
        if self.oz == 0:
            v[0] = (v[1].float() * sign_z).to(v.dtype)
        if self.oz + self.tz == n:
            v[-1] = (v[-2].float() * sign_z).to(v.dtype)
        return v

    def x0_cells(self):
        z, y, x = self.gidx()
        return self.g.x0[z, y, x].float()

    def phase1(self):
        g, tb = self.g, self.g.tb
        if tb >= 2:
            w = self.v3(self.lay["w0"], F32)
            x0 = g.x0[self.gz, self.gy, self.gx].float()
            if not g.general:
                # The projection's rhs is zero past the walls (not inside).
                inside = lambda c, o, e: (((c + o) >= 1) & ((c + o) <= g.n - 2))
                zz = torch.arange(self.mz + 2)[:, None, None] - 1
                yy = torch.arange(self.my + 2)[None, :, None] - 1
                xx = torch.arange(self.px)[None, None, :] - 1
                ok = inside(zz, self.oz, 0) & inside(yy, self.oy, 0) & inside(xx, self.ox, 0)
                x0 = torch.where(ok, x0, 0.0)
            vals = x0 * self.coef if tb >= 3 else x0
            w[self.own] = vals[self.own]
            for idx, past in self.halo_cells():
                w[idx] = float("nan") if (past and g.poison) else vals[idx]
        if tb == 1:
            z, y, x = self.gidx(rows=True)
            rhs = self.smem[self.lay["rhs"]:self.lay["rhs"] + 2 * self.hx * self.my * self.mz
                            * 4].view(F32).view(self.mz, self.my, 2 * self.hx)
            rhs[:self.tz, :self.ty, :self.tx] = g.x0[z, y, x].float()

    def x1_delta(self):
        g, k = self.g, self.g.k
        w = self.v3(self.lay["w0"], F32)
        nb = self.nbr(w, op=g.mask is not None)
        x0 = self.cells(w)
        c = self.cells(self.coef)
        if g.mask is not None:
            x1 = c * x0 + (k["a"] * c) * nb
        else:
            x1 = k["ic"] * x0 + k["aicic"] * nb
        z, y, x = self.gidx()
        g.x1[z, y, x] = x1

    def g_stage(self, q, pw, gin, gout):
        g = self.g
        win, wout = self.v3(self.lay[gin], F32), self.v3(self.lay[gout], F32)
        gv = self.cells(self.coef) * self.nbr(win)
        wout[self.own] = gv
        z, y, x = self.gidx()
        g.x1[z, y, x] = (self.cells(win) if q == 1 else g.x1[z, y, x]) + pw * gv

    def load_start(self):
        g = self.g
        pv = self.v3(self.p_at, g.sdt)
        if g.general:
            vals = g.start[self.gz, self.gy, self.gx].to(g.sdt)
            pv[self.own] = vals[self.own]
            for idx, past in self.halo_cells():
                pv[idx] = float("nan") if (past and g.poison) else vals[idx]
        else:
            self.flat(self.p_at, g.sdt).fill_(0.0)
            if g.poison:
                for idx, past in self.halo_cells():
                    if past:
                        pv[idx] = float("nan")

    def u_stage(self):
        p = self.v3(self.p_at, self.g.sdt).float()
        self.v3(self.lay["w0"], F32)[self.own] = self.nbr(p)

    def delta_stage(self):
        g, k, n = self.g, self.g.k, self.g.n
        masked = g.mask is not None
        w = self.v3(self.lay["w0"], F32)
        nb = self.nbr(w, op=masked, rows=self.ry)
        z, y, x = self.gidx(rows=True)
        cc = self.at_rows(self.coef)
        x1 = g.x1[z, y, x]
        out = x1 + (k["a2"] * cc) * nb if masked else x1 + k["a2ic2"] * nb
        v = out.to(g.sdt)
        u = self.at_rows(w)
        x0 = g.x0[z, y, x].float()
        raw_c = (x0 + k["a"] * u) * cc
        mul = k["a"] * cc if masked else torch.full_like(cc, k["aic"])
        coords = (z, y, x)
        for axis in range(3):
            for jj, wall in ((1, 0), (n - 2, n - 1)):
                sel = coords[axis] == jj
                if not bool(sel.any()):
                    continue
                q = [z, y, x]
                q[axis] = torch.full_like(z, wall)
                # The wall cell in the tile's padded coordinates.
                lz, ly, lx = q[0] - self.oz + 1, q[1] - self.oy + 1, q[2] - self.ox + 1
                raw_w = (g.x0[q[0], q[1], q[2]].float() + k["a"] * w[lz, ly, lx]) \
                    * self.coef[lz, ly, lx]
                corr = (v.float() + mul * (raw_c - raw_w)).to(g.sdt)
                v = torch.where(sel, corr, v)
        self.v3(self.p_at, g.sdt)[self.own] = self.walls(v)

    def chain_stage(self, q, hin, hout):
        g = self.g
        if q == 0:
            h = self.nbr(self.v3(self.p_at, g.sdt).float())
        else:
            h = self.nbr(self.v3(self.lay[hin], F32), op=True)
        self.v3(self.lay[hout], F32)[self.own] = h

    def shell(self, level):
        g, n, tb = self.g, self.g.n, self.g.tb
        prev, cur = g.levels[(level - 1) % 2], g.levels[level % 2]
        depth = 2 * tb - 1 - level
        p = self.v3(self.p_at, g.sdt)
        k = g.k
        for side in range(6):
            axis, lo = side // 2, side % 2 == 0
            t = (self.bz, self.by, self.bx)[axis]
            gcount = (g.tiles[2], g.tiles[1], g.tiles[0])[axis]
            if t != (0 if lo else gcount - 1):
                continue
            u0, tu = (self.oy, self.ty) if axis == 0 else (self.oz, self.tz)
            v0, tv = (self.oy, self.ty) if axis == 2 else (self.ox, self.tx)
            base = side * 2 * tb
            u_axis = 1 if axis == 0 else 0
            j, u, v = torch.meshgrid(torch.arange(1, depth + 1), torch.arange(u0, u0 + tu),
                                     torch.arange(v0, v0 + tv), indexing="ij")
            cu, cv = u.clamp(1, n - 2), v.clamp(1, n - 2)

            def cell(jj, uu, vv):
                pl = jj if lo else n - 1 - jj
                if axis == 0:
                    return pl, uu, vv
                if axis == 1:
                    return uu, pl, vv
                return uu, vv, pl

            def at(jj, uu, vv):
                if level == 1:
                    zg, yg, xg = cell(jj, uu, vv)
                    return p[zg - self.oz + 1, yg - self.oy + 1, xg - self.ox + 1].float()
                return prev[base + torch.where(jj == 0, 1, jj), uu, vv]

            def pair(ax):
                if ax == axis:
                    return (at(j + 1, cu, cv) + at(j - 1, cu, cv) if lo
                            else at(j - 1, cu, cv) + at(j + 1, cu, cv))
                if ax == u_axis:
                    return at(j, cu + 1, cv) + at(j, cu - 1, cv)
                return at(j, cu, cv + 1) + at(j, cu, cv - 1)

            nbr = (pair(2) + pair(1)) + pair(0)
            zg, yg, xg = cell(j, cu, cv)
            coef = self.coef[zg - self.oz + 1, yg - self.oy + 1, xg - self.ox + 1]
            cur[base + j, u, v] = (g.x0[zg, yg, xg].float() + k["a"] * nbr) * coef

    def final_stage(self, hin):
        g, n, tb = self.g, self.g.n, self.g.tb
        h = self.nbr(self.v3(self.lay[hin], F32), op=True, rows=self.ry)
        z, y, x = self.gidx(rows=True)
        v = g.x1[z, y, x] + g.k["aT"] * (self.at_rows(self.coef) * h)
        last = g.levels[tb % 2]
        for axis in (0, 1, 2):  # the kernel's last match wins: x, then y, then z
            cc = (z, y, x)[axis]
            u, vv = (y if axis == 0 else z), (y if axis == 2 else x)
            for lo in (False, True):
                sel = (cc <= tb - 1) if lo else (cc >= n - tb)
                j = cc if lo else n - 1 - cc
                side = 2 * axis + (0 if lo else 1)
                idx = (side * 2 * tb + j.clamp(0, 2 * tb - 1), u, vv)
                v = torch.where(sel, last[idx], v)
        v = self.walls(v.to(g.sdt))
        # p' into the buffer h_{T-2} is not in (a float32 solve's W1 is P).
        dst = self.lay["w0"] if (g.sdt == F32 and self.lay[hin] == self.p_at) else self.p_at
        self.v3(dst, g.sdt)[self.own] = v
        if dst != self.p_at:
            self.lay = dict(self.lay, w0=self.p_at, w1=dst)
            self.p_at = dst

    def sweep(self):
        g, n = self.g, self.g.n
        sdt = g.sdt
        p = self.v3(self.p_at, sdt).float()
        tz, tx = self.tz, self.tx
        r = self.ry + 1
        zc = p[1:tz + 1]
        own = zc[:, r, 1:tx + 1]
        xp = zc[:, r, 2:tx + 2].clone()
        xm = zc[:, r, 0:tx].clone()
        if g.general and g.mask is None:
            face = -own if g.b == 1 else own
            gx = torch.arange(self.ox, self.ox + tx)
            xp = torch.where(gx == n - 2, face, xp)
            xm = torch.where(gx == 1, face, xm)
        nbr = ((xp + xm) + (zc[:, r + 1, 1:tx + 1] + zc[:, r - 1, 1:tx + 1])) + (
            p[2:tz + 2][:, r, 1:tx + 1] + p[0:tz][:, r, 1:tx + 1])
        z, y, x = self.gidx(rows=True)
        if g.tb == 1:
            rhs = self.smem[self.lay["rhs"]:self.lay["rhs"] + 2 * self.hx * self.my * self.mz
                            * 4].view(F32).view(self.mz, self.my, 2 * self.hx)
            r0 = rhs[:tz, :self.ty, :tx]
        else:
            r0 = g.x0[z, y, x].float()
        rr = r0 + (nbr if g.a == 1.0 else np.float32(g.a).item() * nbr)
        if g.general and g.mask is not None:
            m = g.mask[z, y, x].float()
            xi = g.start[z, y, x]
            keep = g.mask[z, y, x] | ~torch.isfinite(xi)
            fz = torch.where(keep, m * xi, torch.where(torch.signbit(xi), -0.0, 0.0))
            u = rr * ((1.0 - m) * g.inv_c) + fz
        elif g.mask is not None:
            u = rr * self.at_rows(self.coef)
        else:
            u = rr * g.inv_c
        gy = self.oy + torch.arange(self.ty)
        yneg = (g.b == 2) & (gy != self.oy + self.ry)
        u = torch.where(yneg[None, :, None], -u, u)
        v = self.walls(u.to(sdt), -1.0 if g.b == 1 else 1.0, -1.0 if g.b == 3 else 1.0)
        other = self.lay["w0"]
        self.v3(other, sdt)[self.own] = v
        self.lay = dict(self.lay, w0=self.p_at)
        self.p_at = other

    def store(self, out):
        v = self.cells(self.v3(self.p_at, self.g.sdt))
        out[self.oz:self.oz + self.tz, self.oy:self.oy + self.ty,
            self.ox:self.ox + self.tx] = v


def bitwise(got, ref):
    """Equal bit for bit (a zero's sign too)."""
    ints = {F32: torch.int32, BF16: torch.int16}[got.dtype]
    return got.dtype == ref.dtype and torch.equal(got.view(ints), ref.view(ints))


def vortex_mask(n):
    return torch.from_numpy(build_obstacle_mask(preset_vortex_128().replace(size=n)))


def projection_case(n, sdt, masked, seed):
    """The projection's rhs (the divergence rounded to the solve dtype, zero
    on the faces), its mask and the twin's coefficient volume."""
    rng = np.random.default_rng(seed)
    vel = torch.from_numpy((rng.standard_normal((3, n, n, n)) * 5.0).astype(np.float32))
    obst = vortex_mask(n) if masked else None
    rhs = torch.nn.functional.pad(divergence_interior(vel).to(sdt), (1, 1, 1, 1, 1, 1))
    coef = None if obst is None else (1.0 - obst.float()) * INV6
    return vel, rhs, obst, coef


CASES = [
    # (n, tiling or None for the gate's): the gate's, g = 1 along y and x
    # with the least wall depth at T = 4 (7 planes), a tile alone on the
    # torus (1, 1, 1) at T = 2, ragged tiles.
    (16, None), (21, (3, 1, 3)), (20, (1, 2, 4)), (29, (2, 3, 2)),
]


@pytest.mark.parametrize("n,tiles", CASES, ids=[f"{n}-{t}" for n, t in CASES])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("sdt", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("block", [2, 3, 4])
def test_projection_emulation_is_the_twin(block, sdt, masked, n, tiles):
    """K5 in K2/K3/K8: ``iters`` = 2T + 1 (a sweep left over) and 3T."""
    if composite_block(n, 3 * block, block) != block:
        pytest.skip(f"T = {block} needs n >= 4T")  # never: every case has n >= 16
    tiles = tiles or solve_tiles(n, sdt, None, block, masked)
    if not shell_fits(n, tiles, block):
        tiles = solve_tiles(n, sdt, None, block, masked)
    _, rhs, obst, coef = projection_case(n, sdt, masked, n + block)
    for iters in (2 * block + 1, 3 * block):
        ref = solve_loop_plain(rhs, torch.zeros((n,) * 3, dtype=sdt), b=0, a=1.0,
                               inv_c=INV6, iters=iters, coef=coef, block=block)
        got = Program(n, tiles, sdt, block, rhs, mask=obst, iters=iters,
                      seed=iters + n).run()
        assert bitwise(got, ref), float((got.float() - ref.float()).abs().max())


def test_projection_equals_the_k3_twin():
    """The emulated solve is K3's twin's pressure: the twin at sweep_block."""
    n, sdt = 24, BF16
    vel, rhs, obst, _ = projection_case(n, sdt, True, 7)
    _, p = project_3d_resident_plain(vel, 9, obst, "bfloat16", sweep_block=4)
    got = Program(n, solve_tiles(n, sdt, None, 4, True), sdt, 4, rhs, mask=obst, iters=9).run()
    assert bitwise(got.float(), p.float())


def test_t2_needs_the_torus():
    """Without the torus trade (the halo past a wall never filled) T = 2
    leaves its twin: the wrapped reads enter the corrections."""
    n, sdt = 16, F32
    _, rhs, _, _ = projection_case(n, sdt, False, 3)
    ref = solve_loop_plain(rhs, torch.zeros((n,) * 3), b=0, a=1.0, inv_c=INV6, iters=4, block=2)
    got = Program(n, (2, 2, 2), sdt, 2, rhs, iters=4, torus=False).run()
    assert not torch.equal(got, ref)


def k4_inputs(n, seed, break_faces=True):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32))
    x0 = torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32))
    if not break_faces:
        from fluidsim_tpu_torch.ops.boundary import set_bnd_3d
        x = set_bnd_3d(0, x)
    return x, x0


@pytest.mark.parametrize("n,tiles", [(16, None), (21, (3, 1, 3)), (29, (2, 3, 2))])
@pytest.mark.parametrize("block", [2, 3, 4])
def test_k5_in_k4_emulation_is_the_twin(block, n, tiles):
    """K4 without a mask in blocks of T (b = 0, a != 1): its start x is read
    as given, faces and all, and over the torus at T = 2."""
    a, c = 0.13, 1.0 + 6 * 0.13
    x, x0 = k4_inputs(n, 40 + n + block)
    tiles = tiles or k4_tiles(n, 3 * block, block)
    a32, inv_c = solve_coefficients(a, c)
    for iters in (2 * block + 1, 3 * block):
        ref = jacobi_3d_resident_plain(0, x, x0, a, c, iters, sweep_block=block)
        got = Program(n, tiles, F32, block, x0, start=x, general=True, a=a32, inv_c=inv_c,
                      iters=iters, seed=iters).run()
        assert bitwise(got, ref), float((got - ref).abs().max())


@pytest.mark.parametrize("iters", [1, 20, 21])
@pytest.mark.parametrize("case", ["b0", "b1", "b2", "b3", "b0-a1", "mask", "mask-a"])
@pytest.mark.parametrize("n,tiles", [(16, None), (29, (2, 3, 2))])
def test_k4_emulation_is_the_twin(n, tiles, case, iters):
    """K4's sequential sweeps: b = 0..3 with a != 1 from a start whose faces
    break the face rule, a = 1, and the mask's frozen start, with a box of
    negative zeros in the start and the rhs (the frozen term's sign)."""
    b = int(case[1]) if case.startswith("b") else 0
    a, c = (1.0, 6.0) if case in ("b0-a1", "mask") else (0.13, 1.0 + 6 * 0.13)
    x, x0 = k4_inputs(n, 60 + n + iters)
    obst = None
    if case.startswith("mask"):
        obst = vortex_mask(n)
        x[2:7, 2:7, 2:7] = -0.0
        x0[2:7, 2:7, 2:7] = -0.0
    tiles = tiles or k4_tiles(n, iters, 1, b, obst is not None)
    a32, inv_c = solve_coefficients(a, c)
    ref = jacobi_3d_resident_plain(b, x, x0, a, c, iters, obst=obst)
    got = Program(n, tiles, F32, 1, x0, mask=obst, start=x, general=True, b=b, a=a32,
                  inv_c=inv_c, iters=iters, seed=iters).run()
    assert bitwise(got, ref), float((got - ref).abs().max())
