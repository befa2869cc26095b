"""K9's strips route (``csrc/resident2d.cu``'s ``solve2d_strips_kernel``) on
the CPU: its gate (``kernels/resident2d.solve2d_route``, ``strip_smem``,
``strip_bounds``), and a plain emulation of the kernel's schedule held
bitwise against the twin ``lin_solve_2d_resident_plain``.

The emulation transliterates the per-block program: block r of the cluster
owns a strip of rows and holds two copies of it padded by ``STRIP_HALO`` rows
past each end, and x0 and the mask padded by ``STRIP_MASK_HALO``, loaded
from the inputs (rows that nobody loads stay poisoned: NaN in the copies, a
nonzero byte, solid, in the mask).  A sweep computes the strip's own rows of
the other copy from the padded copy by the kernel's per-cell functions
(``updated``, ``edged``, ``swept``, vectorised over the strip); after the
barrier every block copies the new copy's halo rows from the owner the
kernel names (``((j + 1)·blocks − 1) // n``), own rows only.  Blocks run in a
new shuffled order in each phase.  It must equal the twin bit for bit, as the
kernel must on the card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidsim_tpu_torch.kernels.resident2d import (
    CLUSTER_BLOCKS,
    H100_SMEM_OPTIN,
    STRIP_HALO,
    STRIP_MASK_HALO,
    lin_solve_2d_resident_plain,
    solve2d_route,
    strip_bounds,
    strip_smem,
)

torch.set_num_threads(1)

SRC = (Path(__file__).resolve().parent.parent / "fluidsim_tpu_torch" / "csrc"
       / "resident2d.cu").read_text()


def test_constants_are_the_kernels():
    assert re.search(rf"kHalo = {STRIP_HALO};", SRC)
    assert re.search(rf"kMaskHalo = {STRIP_MASK_HALO};", SRC)
    assert re.search(r"kPortableCluster = 8;", SRC)
    assert re.search(rf"kMaxCluster = {CLUSTER_BLOCKS};", SRC)  # the step's, non-portable
    assert re.search(r"kThreads = 1024;", SRC)
    # One cluster barrier a sweep, and the last one before the final store.
    body = SRC[SRC.index("solve2d_strips_kernel(const float* x"):]
    body = body[:body.index("\n}\n")]
    assert body.count("cluster.sync()") == 1
    assert "for (int it = 0; it < iters; ++it)" in body


@pytest.mark.parametrize("blocks", [1, 2, 3, 5, 8, 13, 16])
@pytest.mark.parametrize("n", [3, 5, 17, 33, 128, 192, 363, 507])
def test_strips_cover_every_row_once(n, blocks):
    count = np.zeros(n, dtype=int)
    for r, (lo, hi) in enumerate(strip_bounds(n, blocks)):
        assert hi - lo <= -(-n // blocks)
        count[lo:hi] += 1
        for j in range(lo, hi):  # the kernel's owner of row j
            assert ((j + 1) * blocks - 1) // n == r
    assert (count == 1).all()


def test_bytes_at_192_and_at_the_gate():
    # scene_a at 192² on 16 blocks: 12-row strips, two copies of 16 padded
    # rows, x0 and the mask of 14; on 8 blocks 24-row strips.
    assert strip_smem(192, 16) == (8 * 16 + 5 * 14) * 192 == 38_016
    assert strip_smem(192, 8) == (8 * 28 + 5 * 26) * 192 == 67_968
    assert solve2d_route(192) == solve2d_route(128) == "strips"
    # The gate's edge on an H100: 32-row strips up to n = 507 at 16 blocks,
    # 46-row ones up to 363 at 8.
    assert strip_smem(507, 16) <= H100_SMEM_OPTIN < strip_smem(508, 16)
    assert solve2d_route(507) == "strips" and solve2d_route(508) == "l2"
    assert strip_smem(363, 8) <= H100_SMEM_OPTIN < strip_smem(364, 8)
    assert solve2d_route(363, 8) == "strips" and solve2d_route(364, 8) == "l2"
    assert solve2d_route(1024) == "l2"
    # One block (chip_smoke.py times it beside the cluster): up to n = 132.
    assert solve2d_route(132, 1) == "strips" and solve2d_route(133, 1) == "l2"
    assert solve2d_route(192, 1) == "l2"


# -- the kernel's schedule ------------------------------------------------------


class Strip:
    """One block: its rows [lo, hi), its padded copies (local row j − lo +
    STRIP_HALO), x0 and the mask (j − lo + STRIP_MASK_HALO)."""

    def __init__(self, r, n, blocks, x, x0, mask):
        self.lo, self.hi = strip_bounds(n, blocks)[r]
        rows = -(-n // blocks)
        self.n = n
        self.copies = [torch.full((rows + 2 * STRIP_HALO, n), float("nan")) for _ in range(2)]
        self.x0 = torch.full((rows + 2 * STRIP_MASK_HALO, n), float("nan"))
        self.mask = torch.full((rows + 2 * STRIP_MASK_HALO, n), -1, dtype=torch.int32)
        first, last = max(self.lo - STRIP_HALO, 0), min(self.hi + STRIP_HALO, n)
        self.copies[0][first - self.lo + STRIP_HALO:last - self.lo + STRIP_HALO] = x[first:last]
        first, last = max(self.lo - STRIP_MASK_HALO, 0), min(self.hi + STRIP_MASK_HALO, n)
        rows_x = slice(first - self.lo + STRIP_MASK_HALO, last - self.lo + STRIP_MASK_HALO)
        self.x0[rows_x] = x0[first:last]
        self.mask[rows_x] = 0 if mask is None else mask[first:last].int()
        self.has_mask = mask is not None

    def halo_rows(self):
        """The grid rows of the iterate past the strip's ends that it holds."""
        n, lo, hi = self.n, self.lo, self.hi
        return [j for j in range(max(lo - STRIP_HALO, 0), lo)] + \
               [j for j in range(hi, min(hi + STRIP_HALO, n))]


class View:
    """The per-cell reads of a sweep on one block's padded copy, at index
    tensors (lanes a where() discards may point anywhere: clamped)."""

    def __init__(self, strip, src):
        self.s, self.src = strip, src

    def _at(self, table, halo, j, i):
        r = (j - self.s.lo + halo).clamp(0, table.shape[0] - 1)
        return table[r, i.clamp(0, self.s.n - 1)]

    def it(self, j, i):
        return self._at(self.src, STRIP_HALO, j, i)

    def x0v(self, j, i):
        return self._at(self.s.x0, STRIP_MASK_HALO, j, i)

    def solid(self, j, i):
        if not self.s.has_mask:
            return torch.zeros(torch.broadcast_shapes(j.shape, i.shape), dtype=torch.bool)
        return self._at(self.s.mask, STRIP_MASK_HALO, j, i) != 0


def updated(f, p, j, i):
    nbr = ((f.it(j, i + 1) + f.it(j, i - 1)) + f.it(j + 1, i)) + f.it(j - 1, i)
    rhs = f.it(j, i) if p["smooth"] else f.x0v(j, i)
    upd = (rhs + p["a"] * nbr) / p["c"]
    held = f.x0v(j, i) if p["smooth"] else f.it(j, i)
    return torch.where(f.solid(j, i), held, upd)


class Updated:
    """``updated`` at every cell of the rows [lo − 1, hi] that a sweep of
    the strip reaches (edges and mirrors one row past it), computed once
    and looked up by ``edged``."""

    def __init__(self, f, p):
        s = f.s
        self.first = max(s.lo - 1, 0)
        rows = torch.arange(self.first, min(s.hi + 1, p["n"]))[:, None]
        self.table = updated(f, p, rows, torch.arange(p["n"])[None, :])

    def __call__(self, j, i):
        r = (j - self.first).clamp(0, self.table.shape[0] - 1)
        return self.table[r, i.clamp(0, self.table.shape[1] - 1)]


def negate_if(neg, v):
    return -v if neg else v


def edged(u, p, j, i):
    n, b = p["n"], p["b"]
    j, i = torch.broadcast_tensors(j, i)
    one, last = torch.full_like(i, 1), torch.full_like(i, n - 2)
    return torch.where(i == 0, negate_if(b == 1, u(j, one)),
           torch.where(i == n - 1, negate_if(b == 1, u(j, last)),
           torch.where(j == 0, negate_if(b == 2, u(one, i)),
           torch.where(j == n - 1, negate_if(b == 2, u(last, i)), u(j, i)))))


def swept(f, p, j, i):
    n, b = p["n"], p["b"]
    u = Updated(f, p)
    j, i = torch.broadcast_tensors(j, i)
    row_wall, col_wall = (j == 0) | (j == n - 1), (i == 0) | (i == n - 1)
    corner = 0.5 * (edged(u, p, j, torch.where(i == 0, 1, n - 2))
                    + edged(u, p, torch.where(j == 0, 1, n - 2), i))
    out = u(j, i)
    if b != 0:
        dj, di = (1, 0) if b == 2 else (0, 1)
        lo_fluid, hi_fluid = ~f.solid(j - dj, i - di), ~f.solid(j + dj, i + di)
        total = (torch.where(lo_fluid, -edged(u, p, j - dj, i - di), 0.0)
                 + torch.where(hi_fluid, -edged(u, p, j + dj, i + di), 0.0))
        count = lo_fluid.float() + hi_fluid.float()
        mirror = torch.where(count > 0, total / count.clamp(min=1.0), 0.0)
        out = torch.where(f.solid(j, i), mirror, out)
    out = torch.where(row_wall | col_wall, edged(u, p, j, i), out)
    return torch.where(row_wall & col_wall, corner, out)


def strips_emulated(b, x, x0, a, c, mask, iters, smooth, blocks, seed, keep=()):
    """The kernel's schedule on the CPU: the result after each sweep count
    in ``keep`` (and after ``iters``), as the kernel stores it."""
    n = x.shape[-1]
    p = {"n": n, "b": b, "a": a, "c": torch.tensor(c, dtype=torch.float32),
         "smooth": smooth}
    strips = [Strip(r, n, blocks, x, x0, mask) for r in range(blocks)]
    order = np.random.default_rng(seed)
    results = {}
    for it in range(iters):
        prev, nxt = it % 2, (it + 1) % 2
        for r in order.permutation(blocks):
            s = strips[r]
            if s.hi == s.lo:
                continue
            j = torch.arange(s.lo, s.hi)[:, None]
            i = torch.arange(n)[None, :]
            vals = swept(View(s, s.copies[prev]), p, j, i)
            s.copies[nxt][STRIP_HALO:STRIP_HALO + s.hi - s.lo] = vals
        # The barrier; then each block copies its halo rows of the new copy
        # from their owners' own rows.
        if it + 1 < iters:
            for r in order.permutation(blocks):
                s = strips[r]
                for j in s.halo_rows():
                    o = ((j + 1) * blocks - 1) // n
                    owner = strips[o]
                    assert owner.lo <= j < owner.hi and o != r
                    s.copies[nxt][j - s.lo + STRIP_HALO] = \
                        owner.copies[nxt][j - owner.lo + STRIP_HALO]
        if it + 1 in keep or it + 1 == iters:
            out = torch.full((n, n), float("nan"))
            for s in strips:
                out[s.lo:s.hi] = s.copies[nxt][STRIP_HALO:STRIP_HALO + s.hi - s.lo]
            results[it + 1] = out
    return results


def inputs(n, masked, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    x0 = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    # A random mask with solid border cells and touching obstacles.
    mask = torch.from_numpy(rng.random((n, n)) < 0.2) if masked else None
    a = float(np.float32(2.5e-3 * (n - 2) ** 2))
    c = float(np.float32(1.0) + np.float32(6.0) * np.float32(a))
    return x, x0, mask, a, c


@pytest.mark.parametrize("smooth", [True, False], ids=["smooth", "fixed-rhs"])
@pytest.mark.parametrize("masked", [False, True], ids=["no-mask", "mask"])
@pytest.mark.parametrize("b", [0, 1, 2])
@pytest.mark.parametrize("n", [5, 17, 33, 128, 192])
def test_schedule_is_the_twin(n, b, masked, smooth):
    x, x0, mask, a, c = inputs(n, masked, 10 * n + b)
    start = x0 if smooth else x
    got = strips_emulated(b, start, x0, a, c, mask, 20, smooth, CLUSTER_BLOCKS,
                          seed=n + b, keep=(1, 2))
    for iters in (1, 2, 20):
        ref = lin_solve_2d_resident_plain(b, start, x0, a, c, mask, iters, smooth)
        assert torch.equal(got[iters], ref), (iters, float((got[iters] - ref).abs().max()))
        assert torch.equal(torch.signbit(got[iters]), torch.signbit(ref)), iters


@pytest.mark.parametrize("blocks", range(1, 17))
def test_schedule_on_every_cluster_size(blocks):
    n = 33
    x, x0, mask, a, c = inputs(n, True, 400 + blocks)
    for b in (1, 2):
        got = strips_emulated(b, x, x0, a, c, mask, 9, False, blocks, seed=blocks)
        ref = lin_solve_2d_resident_plain(b, x, x0, a, c, mask, 9, False)
        assert torch.equal(got[9], ref), (b, float((got[9] - ref).abs().max()))
