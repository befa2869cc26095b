"""The Jacobi round of K6, K10 and K12 (``csrc/jacobi_pass.cuh``) on the CPU:
its geometry, and a plain emulation of the kernel's schedule held bitwise
against the twins ``jacobi_3d_plain``, ``jacobi_ext_plain`` and
``jacobi_ext_rdma_plain``.

The emulation transliterates the kernel's per-block program onto flat
tensors laid out as the kernel lays out its shared memory: the window of
``kWX x kWY`` columns around the block's tile, its z-range (the slab cut
into chunks) from L planes below to L planes above, the rings the input
planes are copied into two to five planes ahead (``round_ahead``), the signed copies written
into a staged plane's wall columns, the levels' planes by step parity, and
the registers each column carries (level t - 1 one plane below, the x0
chain, the mask bits).  A step runs every column in lockstep, as the
block's threads between two barriers; the staged copies land when they
are issued and a level's plane is written as soon as it is computed, so a
slot still read after it is overwritten shows.  The last pass stores the
faces and, for K12, the keep range, the pushes into the neighbours' outputs
and the zeros at a global end, through the kernel's ``put`` rule; every
stored cell is counted, and each output cell must have exactly one writer.
Shared memory and every scratch buffer start as NaN, so a read of a value
nobody wrote shows.  Blocks run in a shuffled order.

The constants are read from the ``.cuh``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidsim_tpu_torch.kernels.halo import (
    NO_WALL,
    jacobi_ext_plain,
    jacobi_ext_rdma_plain,
    rank_walls,
)
from fluidsim_tpu_torch.kernels.jacobi import (
    ROUND_MAX_SWEEPS,
    jacobi_3d_plain,
    round_passes,
    solve_coefficients,
)

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "fluidsim_tpu_torch" / "csrc"
SRC = (CSRC / "jacobi_pass.cuh").read_text()


def const(name):
    m = re.search(rf"\b{name} = (\d+)\b", SRC)
    assert m, name
    return int(m.group(1))


WX, WY, HX = const("kWX"), const("kWY"), const("kHX")
MAX_LEVELS, THREADS_Y = const("kMaxLevels"), const("kThreadsY")
MIN_CHUNK, MIN_BLOCKS = const("kMinChunk"), const("kMinBlocks")
H100_SMS = 132
TILE_X = WX - 2 * HX
PLANE_W = WX * WY
ROWS = WY // THREADS_Y
NAN = float("nan")

# H100: 227 KB of shared memory a block, 228 KB an SM, 1 KB of it reserved
# by each resident block.
SMEM_BLOCK, SMEM_SM, SMEM_RESERVED = 232_448, 233_472, 1024


def round_smem(levels, masked, ahead):
    """x's ring (ahead + 2 planes), x0's (ahead + 1), two planes a level
    below the last, the mask's ring (as x0's)."""
    return (2 * ahead + 3 + 2 * (levels - 1)) * PLANE_W * 4 + ((ahead + 1) * PLANE_W
                                                                if masked else 0)


def round_ahead(levels, masked):
    """The planes a round copies ahead: as many (2 to 5) as leave room for
    kMinBlocks blocks an SM."""
    ahead = 2
    while ahead < 5 and round_smem(levels, masked, ahead + 1) <= (SMEM_SM // MIN_BLOCKS
                                                                  - SMEM_RESERVED):
        ahead += 1
    return ahead


def round_chunk(n, nz, levels, sms=H100_SMS):
    """launch_round's z-range a block: as many chunks as fill the card's
    blocks with the x-y tiles, each of kMinChunk planes or more."""
    tiles = -(-n // TILE_X) * -(-n // (WY - 2 * levels))
    fill, most = sms * MIN_BLOCKS // tiles, nz // MIN_CHUNK
    chunks = 1 if fill < 1 or most < 1 else min(fill, most)
    return -(-nz // chunks)


def clamp(i, n):
    return torch.clamp(i, 1, n - 2)


# -- the geometry -----------------------------------------------------------------


def test_constants_are_the_kernels():
    assert MAX_LEVELS == ROUND_MAX_SWEEPS == 4
    assert re.search(r"kXRing = kAhead \+ 2, kX0Ring = kAhead \+ 1;", SRC)
    assert re.search(r"return \(2 \* ahead \+ 3 \+ 2 \* \(levels - 1\)\) \* kPlaneW \* 4 \+ "
                     r"\(masked \? \(ahead \+ 1\) \* kPlaneW : 0\);", SRC)
    assert re.search(r"kSmemBudget = 233472 / kMinBlocks - 1024;", SRC)
    assert re.search(r"int ahead = 2;\s+while \(ahead < 5 && round_smem\(levels, masked, ahead "
                     r"\+ 1\) <= kSmemBudget\) \+\+ahead;", SRC)
    assert re.search(r"const int fill = sms \* kMinBlocks / tiles, most = q.nz / kMinChunk;\s+"
                     r"const int chunks = fill < 1 \|\| most < 1 \? 1 : \(fill < most \? fill : "
                     r"most\);", SRC)
    assert re.search(r"kThreadsX = kWX, kThreadsY = \d+, kThreads = kThreadsX \* kThreadsY;",
                     SRC)
    assert re.search(r"__launch_bounds__\(kThreads, kMinBlocks\) jacobi_round_kernel", SRC)
    assert WX >= 64 and WY >= 32 and HX >= MAX_LEVELS


def test_windows_load_at_most_1_55_their_tile_at_t4():
    assert WX * WY / (TILE_X * (WY - 2 * 4)) <= 1.55
    # 16-byte rows: every window starts at a multiple of four columns.
    assert TILE_X % 4 == 0 and HX % 4 == 0


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("masked", [False, True])
def test_shared_memory_fits_the_blocks_an_sm(levels, masked):
    """kMinBlocks blocks of kThreads threads an SM (one of 1024: 32 warps,
    the launch bound's 64 registers a thread), each with its rings two or
    more planes deep in the 227 KB a block may take."""
    ahead = round_ahead(levels, masked)
    assert ahead >= 2  # planes copied two or more ahead
    need = round_smem(levels, masked, ahead)
    assert need <= SMEM_BLOCK
    assert MIN_BLOCKS * (need + SMEM_RESERVED) <= SMEM_SM
    assert MIN_BLOCKS * WX * THREADS_Y * 64 <= 65536  # registers


@pytest.mark.parametrize("iters,passes", [(1, 1), (2, 1), (4, 1), (5, 2), (8, 2), (9, 3),
                                          (20, 5)])
def test_passes_a_call(iters, passes):
    assert round_passes(iters) == passes
    # The sweeps spread evenly over the passes (run_rounds).
    levels, remaining = [], iters
    for back in range(passes - 1, -1, -1):
        levels.append((remaining + back) // (back + 1))
        remaining -= levels[-1]
    assert sum(levels) == iters and max(levels) <= MAX_LEVELS
    assert max(levels) - min(levels) <= 1


@pytest.mark.parametrize("n,nz,levels,chunks", [
    (512, 72, 4, 1), (512, 68, 2, 1), (512, 512, 4, 1),  # sharded512's slabs, 512^3
    (256, 256, 4, 3),                                     # multi256: 35 tiles, 3 chunks
    (5, 168, 3, 21), (5, 7, 1, 1), (40, 30, 4, 3),
])
def test_chunks(n, nz, levels, chunks):
    chunk = round_chunk(n, nz, levels)
    assert -(-nz // chunk) == chunks
    assert chunk >= MIN_CHUNK or chunks == 1


# -- the schedule -------------------------------------------------------------------


class Outputs:
    """The global buffers a pass may store into, and a count of the stores
    into each cell."""

    def __init__(self, out, out_lo=None, out_hi=None):
        self.bufs = {"out": out, "lo": out_lo, "hi": out_hi}
        self.count = {k: torch.zeros(v.numel(), dtype=torch.int32)
                      for k, v in self.bufs.items() if v is not None}

    def store(self, name, idx, vals):
        buf = self.bufs[name].view(-1)
        buf[idx] = vals
        self.count[name].index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))


class Pass:
    """A Round (jacobi_pass.cuh) and one launch of it."""

    def __init__(self, x, x0, mask, outs, n, nz, b, a, inv_c, wall_lo, wall_hi, levels,
                 faces, keep=None, h=0, lz=0):
        self.x, self.x0, self.mask = x.reshape(-1), x0.reshape(-1), mask
        self.outs = outs
        self.n, self.nz, self.b, self.a, self.inv_c = n, nz, b, a, inv_c
        self.wall_lo, self.wall_hi, self.L, self.faces = wall_lo, wall_hi, levels, faces
        self.keep_lo, self.keep_hi = keep if keep is not None else (0, nz - 1)
        self.h, self.lz = h, lz
        self.chunk = round_chunk(n, nz, levels)

    def grid(self):
        tile_y = WY - 2 * self.L
        return (-(-self.n // TILE_X), -(-self.n // tile_y), -(-self.nz // self.chunk))

    def put(self, p, idx, vals):
        """The kernel's ``put`` for the cells ``idx`` of plane p."""
        if len(idx) == 0:
            return
        if self.keep_lo <= p <= self.keep_hi:
            self.outs.store("out", idx, vals)
            shift = self.lz * self.n * self.n
            if self.outs.bufs["lo"] is not None and p < self.keep_lo + self.h:
                self.outs.store("lo", idx + shift, vals)
            if self.outs.bufs["hi"] is not None and p > self.keep_hi - self.h:
                self.outs.store("hi", idx - shift, vals)
        elif self.outs.bufs["lo" if p < self.keep_lo else "hi"] is None:
            self.outs.store("out", idx, torch.zeros_like(vals))

    def put_cell(self, p, idx, y, x, v):
        """An interior cell and its signed copies on the x and y walls it
        touches, y before x."""
        n = self.n
        sx = -1.0 if self.b == 1 else 1.0
        sy = -1.0 if self.b == 2 else 1.0
        self.put(p, idx, v)
        for sel, d in ((x == 1, -1), (x == n - 2, 1)):
            self.put(p, idx[sel] + d, sx * v[sel])
        for ysel, dy in ((y == 1, -n), (y == n - 2, n)):
            j, w, xs = idx[ysel] + dy, sy * v[ysel], x[ysel]
            self.put(p, j, w)
            for sel, d in ((xs == 1, -1), (xs == n - 2, 1)):
                self.put(p, j[sel] + d, sx * w[sel])

    def block(self, bx, by, bz):
        n, nz, L = self.n, self.nz, self.L
        plane = n * n
        masked = self.mask is not None
        ahead = round_ahead(L, masked)
        x_ring, x0_ring = ahead + 2, ahead + 1
        gx0 = bx * TILE_X - HX
        gy0 = by * (WY - 2 * L) - L
        zs = bz * self.chunk
        ze = min(zs + self.chunk, nz)
        zlo, zhi = zs - L, ze + L - 1
        sz = -1.0 if self.b == 3 else 1.0

        # Shared memory, as the kernel carves it, uninitialised.
        xs = torch.full((x_ring, PLANE_W), NAN)
        x0s = torch.full((x0_ring, PLANE_W), NAN)
        lv = torch.full((max(L - 1, 1), 2, PLANE_W), NAN)
        ms = torch.full((x0_ring, PLANE_W), 255, dtype=torch.uint8)

        # The window's columns, own index ly * kWX + lx: thread (lx, ly %
        # kThreadsY), row ly // kThreadsY of its kRows.
        ly = torch.arange(WY).repeat_interleave(WX)
        lx = torch.arange(WX).repeat(WY)
        assert ROWS * THREADS_Y == WY
        gy, gx = gy0 + ly, gx0 + lx
        row_in = (gy >= 0) & (gy < n)
        x_in = (gx >= 0) & (gx < n)
        cgx = torch.where(x_in, clamp(gx, n), gx)
        cgy = torch.where(row_in, clamp(gy, n), gy)
        cly = ly + cgy - gy
        own = ly * WX + lx
        at = cly * WX + lx + cgx - gx
        x_wall = cgx != gx
        wall = x_wall | (cgy != gy)
        neg = ((self.b == 1) & x_wall) | ((self.b == 2) & (cgy != gy))
        sgn = torch.where(neg, -1.0, 1.0)
        depth = torch.where(row_in, torch.minimum(cly, WY - 1 - cly), 0)
        x_tile = (lx >= HX) & (lx < WX - HX) & x_in & ~x_wall
        stores = x_tile & ~wall & (ly >= L) & (ly < WY - L) & row_in
        patch = own != at
        # Row k = ly // kThreadsY of its thread: the middle rows compute every
        # level (their reads stay in the plane), the edge rows while valid.
        k = ly // THREADS_Y
        edge = (k == 0) | (k == ROWS - 1)
        assert bool(((at >= WX) & (at < PLANE_W - WX))[~edge].all())

        below = torch.zeros((L, PLANE_W))
        x0c = torch.zeros((L, PLANE_W))  # x0 at planes z - 1 .. z - L
        mbits = torch.zeros((L, PLANE_W), dtype=torch.int64)  # the mask beside it

        def stage(p, slot_x, slot_0):
            in_slab = 0 <= p < nz
            ok = in_slab & row_in & x_in
            g = torch.where(ok, (p if in_slab else 0) * plane + gy * n + gx, 0)
            xs[slot_x] = torch.where(ok, self.x[g], 0.0)
            x0s[slot_0] = torch.where(ok, self.x0[g], 0.0)
            if masked:
                ms[slot_0] = torch.where(ok, self.mask[g], 0).to(torch.uint8)

        for j in range(ahead):
            stage(zlo + j, j, j)
        sx_now = s0_now = 0
        for z in range(zlo, zhi + 1):
            if z + ahead <= zhi:
                stage(z + ahead, (sx_now + ahead) % x_ring, (s0_now + ahead) % x0_ring)
            x_now = xs[sx_now]
            x_prev = xs[(sx_now - 1) % x_ring]
            par = z & 1
            # Level 0: the wall columns' signed copies, then every column reads
            # its clamped column (after the copies: a read of a wall column
            # would see them).
            x_now[own[patch]] = sgn[patch] * x_now[at[patch]]
            fresh = x_now[at]
            x0_new = x0s[s0_now][at]
            m_new = (ms[s0_now][at] != 0).long()
            for t in range(1, L + 1):
                act = ~edge | (t <= depth)
                safe_at = torch.where(act, at, WX + 1)  # skipped: any inner cell
                p = z - t
                if p < 0 or p >= nz:
                    below[t - 1] = torch.where(act, 0.0, below[t - 1])
                    fresh = torch.where(act, 0.0, fresh)
                    continue
                src = x_prev if t == 1 else lv[t - 2, par ^ 1]
                mid = src[safe_at]
                above, under = fresh, below[t - 1]
                if p == self.wall_hi - 1:
                    above = sz * mid
                if p == self.wall_lo + 1:
                    under = sz * mid
                nbr = ((src[safe_at + 1] + src[safe_at - 1])
                       + (src[safe_at + WX] + src[safe_at - WX])) + (above + under)
                coef = self.inv_c
                if masked:
                    coef = torch.where(mbits[t - 1] == 1, 0.0, torch.tensor(self.inv_c))
                u = (x0c[t - 1] + self.a * nbr) * coef
                below[t - 1] = torch.where(act, mid, below[t - 1])
                fresh = torch.where(act, u, fresh)
                if t < L:
                    lv[t - 1, par, own[act]] = (sgn * u)[act]
                elif zs <= p < ze:
                    sel = stores & act
                    i = p * plane + gy[sel] * n + gx[sel]
                    v, ys, xs_ = u[sel], gy[sel], gx[sel]
                    if not self.faces:
                        self.outs.store("out", i, v)
                        continue
                    if p != self.wall_lo and p != self.wall_hi:
                        self.put_cell(p, i, ys, xs_, v)
                    if p == self.wall_lo + 1:
                        self.put_cell(p - 1, i - plane, ys, xs_, sz * v)
                    if p == self.wall_hi - 1:
                        self.put_cell(p + 1, i + plane, ys, xs_, sz * v)
            x0c = torch.cat([x0_new[None], x0c[:-1]])
            mbits = torch.cat([m_new[None], mbits[:-1]])
            sx_now = (sx_now + 1) % x_ring
            s0_now = (s0_now + 1) % x0_ring

    def launch(self, rng):
        gx, gy, gz = self.grid()
        blocks = [(bx, by, bz) for bz in range(gz) for by in range(gy) for bx in range(gx)]
        for k in rng.permutation(len(blocks)):
            self.block(*blocks[k])


def run_rounds(x, x0, mask, out, tmp, spare, n, nz, b, a, c, iters, wall_lo, wall_hi, rng,
               keep=None, h=0, lz=0, out_lo=None, out_hi=None):
    """fs_jacobi / fs_jacobi_ext / fs_jacobi_ext_rdma's passes (run_rounds):
    returns the last pass's Outputs."""
    a32, inv_c = solve_coefficients(a, c)
    passes = round_passes(iters)
    remaining, src = iters, x
    for pass_ in range(passes):
        back = passes - 1 - pass_
        if spare is None:
            dst = out if back % 2 == 0 else tmp
        else:
            dst = out if back == 0 else (tmp if back % 2 == 1 else spare)
        assert dst is not None
        levels = (remaining + back) // (back + 1)
        outs = Outputs(dst, out_lo if back == 0 else None, out_hi if back == 0 else None)
        Pass(src, x0, mask, outs, n, nz, b, a32, inv_c, wall_lo, wall_hi, levels,
             faces=back == 0, keep=keep if back == 0 else None, h=h, lz=lz).launch(rng)
        remaining -= levels
        src = dst
    return outs


def emulate_k6(b, x, x0, a, c, iters, rng):
    n = x.shape[-1]
    out = torch.full_like(x, NAN)
    tmp = torch.full_like(x, NAN) if iters > MAX_LEVELS else None
    outs = run_rounds(x, x0, None, out, tmp, None, n, n, b, a, c, iters, 0, n - 1, rng)
    assert bool((outs.count["out"] == 1).all()), "K6: a cell with no writer or two"
    return out


def emulate_k10(xp, x0, a, c, t, wall_lo, wall_hi, b, mask, rng):
    nz, n = xp.shape[0], xp.shape[-1]
    m = None if mask is None else mask.reshape(-1).to(torch.uint8)
    out = torch.full_like(xp, NAN)
    tmp = torch.full_like(xp, NAN) if t > MAX_LEVELS else None
    outs = run_rounds(xp, x0, m, out, tmp, None, n, nz, b, a, c, t, wall_lo, wall_hi, rng)
    assert bool((outs.count["out"] == 1).all()), "K10: a cell with no writer or two"
    return out


def emulate_k12(xps, x0s, a, c, t, b, masks, rng):
    k = len(xps)
    nz, n = xps[0].shape[0], xps[0].shape[-1]
    lz = nz - 2 * t
    outs = [torch.full_like(x, NAN) for x in xps]
    tmp = torch.full_like(xps[0], NAN) if t > MAX_LEVELS else None
    spare = torch.full_like(xps[0], NAN) if t > 2 * MAX_LEVELS else None
    count = [torch.zeros(x.numel(), dtype=torch.int32) for x in xps]
    for r in range(k):  # stream order
        m = None if masks is None else masks[r].reshape(-1).to(torch.uint8)
        last = run_rounds(xps[r], x0s[r], m, outs[r], tmp, spare, n, nz, b, a, c, t,
                          *rank_walls(r, k, t, lz), rng, keep=(t, t + lz - 1), h=t, lz=lz,
                          out_lo=outs[r - 1] if r > 0 else None,
                          out_hi=outs[r + 1] if r < k - 1 else None)
        count[r] += last.count["out"]
        if r > 0:
            count[r - 1] += last.count["lo"]
        if r < k - 1:
            count[r + 1] += last.count["hi"]
    for r in range(k):
        assert bool((count[r] == 1).all()), f"K12 shard {r}: a cell with no writer or two"
    return outs


def inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x, x0


def sphere(nz, n, seed):
    """A solid ball and a few scattered solid cells: a mask that touches
    walls, chunks and shards."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(np.arange(nz), np.arange(n), np.arange(n), indexing="ij")
    ball = (zz - nz / 2) ** 2 / max(nz / 3, 1) ** 2 + ((yy - n / 2) ** 2 + (xx - n / 3) ** 2) \
        / max(n / 4, 1) ** 2 <= 1.0
    return torch.from_numpy(ball | (rng.random((nz, n, n)) < 0.05))


def assert_bitwise(got, ref, what):
    assert torch.equal(got, ref), (what, float((got - ref).abs().nan_to_num(1e30).max()))


@pytest.mark.parametrize("iters", [1, 2, 3, 4, 5, 9])
@pytest.mark.parametrize("n", [5, 9, 24, 40])
def test_k6_schedule_is_the_twin(n, iters):
    """K6 on the whole grid, b = 0..3 (a = 1, c = 6 and diffusion-like
    coefficients), its input's faces poisoned with NaN: the kernel never
    reads them, as the twin normalises them away."""
    for b, a, c in ((0, 1.0, 6.0), (1, 1.0, 6.0), (2, 0.13, 1.78), (3, 0.13, 1.78)):
        x, x0 = inputs((n, n, n), 100 * n + iters + b)
        ref = jacobi_3d_plain(b, x, x0, a, c, iters)
        poisoned = x.clone()
        for axis in range(3):
            poisoned.select(axis, 0).fill_(NAN)
            poisoned.select(axis, n - 1).fill_(NAN)
        got = emulate_k6(b, poisoned, x0, a, c, iters, np.random.default_rng(n + b))
        assert_bitwise(got, ref, f"K6 n={n} iters={iters} b={b}")


K10_CASES = [
    # n, lz, t, wall kind, b, masked
    (5, 4, 1, "both", 0, False),
    (9, 6, 2, "lo", 1, False),
    (24, 8, 3, "hi", 2, True),
    (40, 10, 4, "none", 3, False),
    (40, 10, 4, "both", 0, True),
    (24, 8, 4, "lo", 3, True),
    (9, 9, 5, "hi", 0, False),
    (5, 150, 4, "both", 2, False),   # 158 planes: two chunks
    (5, 162, 3, "lo", 0, True),      # 168 planes: three chunks
    (9, 2, 2, "none", 1, False),
]


@pytest.mark.parametrize("n,lz,t,walls,b,masked", K10_CASES)
def test_k10_schedule_is_the_twin(n, lz, t, walls, b, masked):
    nz = lz + 2 * t
    x, x0 = inputs((nz, n, n), 7 * n + lz + t + b)
    wall_lo = t if walls in ("both", "lo") else NO_WALL
    wall_hi = t + lz - 1 if walls in ("both", "hi") else NO_WALL
    mask = sphere(nz, n, nz + n) if masked else None
    ref = jacobi_ext_plain(x, x0, 1.0, 6.0, t, wall_lo, wall_hi, b, mask)
    got = emulate_k10(x, x0, 1.0, 6.0, t, wall_lo, wall_hi, b, mask,
                      np.random.default_rng(nz))
    assert_bitwise(got, ref, f"K10 n={n} nz={nz} T={t} {walls} b={b} mask={masked}")


K12_CASES = [
    # n, shards, lz, t, b, masked
    (5, 3, 4, 1, 0, False),
    (9, 2, 6, 2, 3, True),
    (24, 4, 6, 3, 1, False),
    (40, 4, 10, 4, 0, True),
    (24, 2, 5, 4, 2, False),
    (9, 3, 9, 9, 3, False),     # three passes: through tmp and spare
    (5, 2, 90, 4, 0, True),     # 98 planes a slab: two chunks
]


@pytest.mark.parametrize("n,shards,lz,t,b,masked", K12_CASES)
def test_k12_schedule_is_the_twin(n, shards, lz, t, b, masked):
    """One round over every shard in stream order, the neighbours' halos
    written by the folded pushes, each cell of each output written once."""
    nz = lz + 2 * t
    xs, x0s, masks = [], [], [] if masked else None
    for r in range(shards):
        x, x0 = inputs((nz, n, n), 11 * r + n + t)
        xs.append(x)
        x0s.append(x0)
        if masked:
            masks.append(sphere(nz, n, r + n))
    ref = jacobi_ext_rdma_plain(xs, x0s, 1.0, 6.0, t, b, masks)
    got = emulate_k12(xs, x0s, 1.0, 6.0, t, b, masks, np.random.default_rng(shards + t))
    for r in range(shards):
        assert_bitwise(got[r], ref[r], f"K12 shard {r} n={n} T={t} b={b} mask={masked}")
