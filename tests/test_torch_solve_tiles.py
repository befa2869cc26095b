"""The tiled Jacobi solve of K2 and K3 (``csrc/solve_tiled.cuh``) on the
CPU: its gate (``kernels/resident.tiling`` / ``solve_tiles``), and a plain
emulation of the kernel's schedule held bitwise against the twin's solve.

The emulation below transliterates the kernel's per-block program onto flat
tensors laid out as the kernel lays out its shared memory and its global
face buffer: each tile's two padded copies of the iterate, the z march over
the column its coordinates clamp to, the z wall copies, the faces stored
into the slots of their parity and the halos loaded from the neighbours'
opposite faces, at the kernel's offsets.
The tiles run in a new shuffled order every sweep, once to compute and once
to load their halos (as blocks that wait only on their face neighbours
may).  It must equal ``project_3d_resident_plain``'s final iterate bit for
bit, as the kernel must on the card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidsim_tpu_torch.config import preset_vortex_128
from fluidsim_tpu_torch.kernels.resident import (
    H100_SMEM_OPTIN,
    H100_SMS,
    INV6,
    TILE_FLAG_STRIDE,
    TILE_MAX_ROW,
    TILE_MAX_Z,
    TILE_THREADS,
    divergence_interior,
    project_3d_resident_plain,
    solve_tiles,
    tile_bounds,
    tile_bounds_x,
    tile_extents,
    tile_face_values,
    tile_smem,
    tiling,
)
from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "fluidsim_tpu_torch" / "csrc"


def test_gate_constants_are_the_kernels():
    src = (CSRC / "solve_tiled.cuh").read_text()
    assert re.search(rf"kTileThreads = {TILE_THREADS};", src)
    assert re.search(rf"kTileMaxRow = {TILE_MAX_ROW};", src)
    assert re.search(rf"kFlagStride = {TILE_FLAG_STRIDE};", src)
    assert re.search(rf"kTileMaxZ = {TILE_MAX_Z};", src)


@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n", [8, 16, 31, 48, 64, 97, 100, 128])
def test_tiles_cover_the_grid_once(n, sdt):
    tiles = solve_tiles(n, sdt)
    assert tiles is not None
    assert int(np.prod(tiles)) <= H100_SMS
    count = np.zeros((n, n, n), dtype=np.int32)
    for z0, z1 in tile_bounds(n, tiles[2]):
        for y0, y1 in tile_bounds(n, tiles[1]):
            for x0, x1 in tile_bounds_x(n, tiles[0]):
                assert min(x1 - x0, y1 - y0, z1 - z0) >= 3
                assert max(x1 - x0, y1 - y0) <= TILE_MAX_ROW and z1 - z0 <= TILE_MAX_Z
                assert (x1 - x0 + 1) // 2 * (y1 - y0) <= TILE_THREADS
                count[z0:z1, y0:y1, x0:x1] += 1
    assert (count == 1).all()
    assert tile_smem(n, tiles, sdt.itemsize) <= H100_SMEM_OPTIN


@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_budget_at_128(sdt):
    # One 32 x 16 x 32 tile on each of 128 SMs: two padded copies and the
    # rhs.  The mask takes no shared memory (a bit a cell, in registers):
    # masked or not, the budget is this, 232,024 bytes in float32.
    tiles = solve_tiles(128, sdt)
    assert tiles == (4, 8, 4)
    assert tile_extents(128, tiles) == (32, 16, 32)
    need = (2 + 2 * (34 * 18 * 34 + 2) + 32 * 16 * 32) * sdt.itemsize
    assert tile_smem(128, tiles, sdt.itemsize) == need <= H100_SMEM_OPTIN
    assert tile_face_values(128, tiles) == 2 * 6 * 128 * 32 * 32


@pytest.mark.parametrize("n,itemsize,sms,optin", [
    (2, 4, H100_SMS, H100_SMEM_OPTIN),     # no tile of 3 cells
    (176, 2, H100_SMS, H100_SMEM_OPTIN),   # more than a tile an SM
    (144, 4, H100_SMS, H100_SMEM_OPTIN),   # f32 copies over the opt-in
    (256, 4, H100_SMS, H100_SMEM_OPTIN),   # K3 with a mask at 256^3
    (128, 4, H100_SMS, 100_000),           # f32 copies over the opt-in
    (64, 2, 4, H100_SMEM_OPTIN),           # too few SMs
])
def test_none_where_it_cannot_fit(n, itemsize, sms, optin):
    assert tiling(n, itemsize, sms, optin) is None


# -- the kernel's schedule ------------------------------------------------------


def _clamp(i, n):
    return min(max(i, 1), n - 2)


class Tile:
    """One block's state: its box, its padded copies of the iterate (flat,
    the kernel's shared-memory layout: rows of ``2·hx + 2`` values, cell
    ``x`` at ``x``, 2 values of slack before the copy) and its rhs and
    coefficients at the row each cell reads."""

    def __init__(self, b, tiles, n, shape, rhs, coef, sdt):
        gx, gy, gz = tiles
        self.b = b
        self.bx, self.by, self.bz = b % gx, (b // gx) % gy, b // (gx * gy)
        self.x0, x1 = tile_bounds_x(n, gx)[self.bx]
        self.y0, y1 = tile_bounds(n, gy)[self.by]
        self.z0, z1 = tile_bounds(n, gz)[self.bz]
        self.tx, self.ty, self.tz = x1 - self.x0, y1 - self.y0, z1 - self.z0
        mx, my, mz = shape
        hx = (mx + 1) // 2
        self.px, self.pplane = 2 * hx + 2, (2 * hx + 2) * (my + 2)
        pvol = self.pplane * (mz + 2) + 2
        self.base = 2
        self.src = torch.zeros(pvol + 2, dtype=sdt)
        self.dst = torch.zeros(pvol + 2, dtype=sdt)
        ly, lx = torch.meshgrid(torch.arange(self.ty), torch.arange(self.tx), indexing="ij")
        self.lx, self.ly = lx.reshape(-1), ly.reshape(-1)
        self.own = self.base + (self.ly + 1) * self.px + self.lx
        ry = torch.tensor([_clamp(self.y0 + y, n) - self.y0 for y in range(self.ty)])
        self.col = self.base + (ry[self.ly] + 1) * self.px + self.lx
        gz_ = torch.arange(self.z0, z1)
        gx_ = self.x0 + self.lx
        used = ((gz_ >= 1) & (gz_ <= n - 2))[:, None] & ((gx_ >= 1) & (gx_ <= n - 2))[None, :]
        cy, cx = ry[self.ly] + self.y0, gx_.clamp(0, n - 1)
        self.rhs = torch.where(used, rhs[gz_.clamp(0, n - 1)][:, cy, cx].float(), 0.0)
        self.coef = torch.full_like(self.rhs, INV6) if coef is None else torch.where(
            used, coef[gz_.clamp(0, n - 1)][:, cy, cx], INV6)
        nb = [self.bx > 0 and b - 1, self.bx < gx - 1 and b + 1,
              self.by > 0 and b - gx, self.by < gy - 1 and b + gx,
              self.bz > 0 and b - gx * gy, self.bz < gz - 1 and b + gx * gy]
        self.nb = [v if v is not False else -1 for v in nb]
        self.n = n

    def sweep(self, s, iters, faces, face, sdt):
        """The sweep and, for s < iters, the faces' stores into slot s % 2."""
        pp, px = self.pplane, self.px
        src = self.src.float()
        zm = src[self.col]
        zc = src[pp + self.col]
        rows = []
        for j in range(self.tz):
            c = (j + 1) * pp + self.col
            zp = src[c + pp]
            xs = src[c + 1] + src[c - 1]
            ys = src[c + px] + src[c - px]
            zs = zp + zm
            row = ((self.rhs[j] + ((xs + ys) + zs)) * self.coef[j]).to(sdt).reshape(
                self.ty, self.tx)
            # The x walls: cell 0 takes cell 1's value, cell n - 1 cell n - 2's.
            if self.x0 == 0:
                row[:, 0] = row[:, 1]
            if self.x0 + self.tx == self.n:
                row[:, -1] = row[:, -2]
            rows.append(row.reshape(-1))
            zm, zc = zc, zp
        if self.z0 == 0:
            rows[0] = rows[1]
        if self.z0 + self.tz == self.n:
            rows[-1] = rows[-2]
        for j, row in enumerate(rows):
            self.dst[(j + 1) * pp + self.own] = row
        if s >= iters:
            return
        slot = ((s & 1) * faces.tiles + self.b) * 6 * face
        faces.buf[slot + self.face_at] = self.dst[self.face_inner]

    def load_halo(self, s, faces, face):
        """The halos: neighbour nb[f]'s face f ^ 1 of slot s % 2 into dst."""
        base = (s & 1) * faces.tiles * 6 * face
        self.dst[self.halo_outer] = faces.buf[base + self.halo_from]

    def rows(self, face, shape):
        """Where each published face value sits in dst and in the slots, and
        where each halo value comes from and goes, as index tensors."""
        row, mz = 2 * ((shape[0] + 1) // 2), shape[2]
        tx, ty, tz, pp, px, o = self.tx, self.ty, self.tz, self.pplane, self.px, self.base
        j, y, x = torch.arange(tz)[:, None], torch.arange(ty), torch.arange(tx)
        yrow = o + (j + 1) * pp + (y + 1) * px
        xrow = o + (j + 1) * pp + x
        zrow = o + (y[:, None] + 1) * px + x
        cells = (  # f: (slot offset, face cell in the padded copy, halo cell beyond it)
            (y * mz + j, yrow, yrow - 1),
            (y * mz + j, yrow + tx - 1, yrow + tx),
            (j * row + x, xrow + px, xrow),
            (j * row + x, xrow + ty * px, xrow + (ty + 1) * px),
            (y[:, None] * row + x, zrow + pp, zrow),
            (y[:, None] * row + x, zrow + tz * pp, zrow + (tz + 1) * pp),
        )
        at, inner, outer, frm = [], [], [], []
        for f, (g, ins, out) in enumerate(cells):
            if self.nb[f] < 0:
                continue
            at.append((f * face + g).reshape(-1))
            inner.append(ins.reshape(-1))
            outer.append(out.reshape(-1))
            frm.append(((self.nb[f] * 6 + (f ^ 1)) * face + g).reshape(-1))
        cat = (lambda v: torch.cat(v) if v else torch.zeros(0, dtype=torch.long))
        self.face_at, self.face_inner = cat(at), cat(inner)
        self.halo_outer, self.halo_from = cat(outer), cat(frm)


class Faces:
    def __init__(self, tiles, n, sdt):
        self.tiles = int(np.prod(tiles))
        # Poisoned, so a read of a slot nobody wrote shows.
        self.buf = torch.full((tile_face_values(n, tiles),), float("nan"), dtype=sdt)


def tiled_solve_emulated(rhs, coef, iters, tiles, sdt, seed):
    """The kernel's schedule on the CPU; returns the final iterate (n, n, n)."""
    n = rhs.shape[-1]
    shape = tile_extents(n, tiles)
    faces = Faces(tiles, n, sdt)
    face = faces.buf.numel() // (2 * 6 * faces.tiles)
    blocks = [Tile(b, tiles, n, shape, rhs, coef, sdt) for b in range(int(np.prod(tiles)))]
    for t in blocks:
        t.rows(face, shape)
    order = np.random.default_rng(seed)
    for s in range(1, iters + 1):
        for b in order.permutation(len(blocks)):
            blocks[b].sweep(s, iters, faces, face, sdt)
        if s == iters:
            break
        for b in order.permutation(len(blocks)):
            blocks[b].load_halo(s, faces, face)
        for t in blocks:
            t.src, t.dst = t.dst, t.src
    out = torch.empty((n, n, n), dtype=sdt)
    for t in blocks:
        v = t.dst[(torch.arange(t.tz)[:, None] + 1) * t.pplane + t.own[None, :]]
        out[t.z0:t.z0 + t.tz, t.y0:t.y0 + t.ty, t.x0:t.x0 + t.tx] = v.reshape(t.tz, t.ty, t.tx)
    return out


@pytest.mark.parametrize("tiles", [None, (3, 4, 5)], ids=["gate", "ragged"])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("sdt", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("n", [16, 29, 48])
def test_schedule_emulation_is_the_twin_solve(n, sdt, masked, tiles):
    rng = np.random.default_rng(n)
    vel = torch.from_numpy((rng.standard_normal((3, n, n, n)) * 5.0).astype(np.float32))
    obst = (torch.from_numpy(build_obstacle_mask(preset_vortex_128().replace(size=n)))
            if masked else None)
    if tiles is None:
        tiles = solve_tiles(n, sdt)
    iters = 7
    solve_dtype = "bfloat16" if sdt == torch.bfloat16 else None
    _, p = project_3d_resident_plain(vel, iters, obst, solve_dtype)
    rhs = torch.nn.functional.pad(divergence_interior(vel).to(sdt), (1, 1, 1, 1, 1, 1))
    coef = None if obst is None else (1.0 - obst.float()) * INV6
    got = tiled_solve_emulated(rhs, coef, iters, tiles, sdt, seed=n + iters)
    assert torch.equal(got.float(), p), float((got.float() - p).abs().max())
