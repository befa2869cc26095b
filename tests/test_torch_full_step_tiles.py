"""K8 and K14 on the tiled solve (``csrc/full_step.cuh``'s
``full_step_tiled_kernel``) on the CPU: the route each option and size
takes (``kernels/resident.fused_step_route``), the kernel's grid barriers
read from its source, and a plain emulation of its schedule held bitwise
against the twins ``full_step_3d_plain`` and
``advect_project_3d_resident_plain``.

The emulation runs the kernel's phases on flat tensors named as the
kernel's buffers, each poisoned with NaN before the launch: the
self-advection's substeps, each reading and writing the buffers
``substep_buf`` gives its index; the tiled solve of every tile
(``test_torch_solve_tiles.tiled_solve_emulated``: tiles in a shuffled order,
the face trades through the parity slots) from the divergence of ``adv``;
the gradient from the final iterate in ``pa``; the density's substeps.  A
grid-stride phase writes each cell from the thread the kernel gives it
(``grid.thread_rank()`` of the tiles' blocks; a thread's two cells of a
loop trip, ``advect_pair``, are its own), its blocks in a shuffled order in
two waves, each wave computing from the buffers as the waves before it left
them: a phase that read what it writes would show.  A grid
barrier is the end of a phase.  At a window K >= 2 the emulation votes as
the kernel does (``csrc/full_step.cuh``'s vote): before the first substep on
the inputs (each block on the elements its threads stride over), after each
substep but the last on what its blocks stored; a substep's cells take the
<= 8-tap sum read in place (no wrapped tap: the emulation asserts it) where
every block's vote on its source held and the displacement is not NaN, and
the full (2K+1)³ hat sum elsewhere.  The kernel must equal the twins bit for
bit on the card as well (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fluidsim_tpu_torch.dtypes import scale_in
from fluidsim_tpu_torch.kernels import advect as kadvect
from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_plain, substep_dt0
from fluidsim_tpu_torch.kernels.resident import (
    TILE_THREADS,
    VOTE_COUNTS,
    VOTE_INTS,
    VOTE_MAX_BLOCKS,
    VOTE_SETS,
    advect_project_3d_resident_plain,
    divergence_interior,
    full_step_3d_plain,
    fused_step_route,
    project_gradient,
    projection_tiles,
    solve_torch_dtype,
    tap_routes,
    tile_extents,
)
from fluidsim_tpu_torch.ops.advect import window_sum_3d
from test_torch_advect_window_tiles import assert_same, frac_win, hat
from test_torch_solve_tiles import tiled_solve_emulated

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "fluidsim_tpu_torch" / "csrc"
BF16 = torch.bfloat16
DT, DAMP, DDAMP = 0.1, 0.999, 0.995


def function_body(text: str, head: str) -> str:
    """The braces-balanced body of the function whose definition starts with
    ``head`` in ``text``."""
    start = text.index("{", text.index(head))
    depth = 0
    for i in range(start, len(text)):
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        if depth == 0:
            return text[start:i + 1]
    raise AssertionError(f"unbalanced body of {head}")


def test_tiled_kernel_barriers_are_the_kernels():
    """The tiled kernel's grid barriers are the emulation's phase ends: one
    a self-advection substep, one after the solve, one before the density,
    one between density substeps; none inside the solve, whose block waits
    on its face neighbours' flags only."""
    step = (CSRC / "full_step.cuh").read_text()
    tiled = function_body(step, "    full_step_tiled_kernel(")
    # One block an SM: the tiled solve's 512 threads, or K5's program's 256.
    assert ("__launch_bounds__(BLOCK ? kBlockThreads : kTileThreads, 1)\n"
            "    full_step_tiled_kernel(") in step
    assert tiled.count("grid.sync()") == 2
    # The solve (the tiled solve's program, or K5's with its block) and then
    # one barrier.
    assert re.search(r"solve_tile<T, S, false, true>\(fs_tile_smem, t, blockIdx\.x\);\s*\}\s*"
                     r"grid\.sync\(\);", tiled)
    assert "block_tile<T, S, false, true, false>(fs_tile_smem, kb, blockIdx.x);" in tiled
    advect = function_body(step, "__device__ __forceinline__ void self_advect_phase(")
    assert advect.count("grid.sync()") == 1
    density = function_body(step, "__device__ __forceinline__ void density_phase(")
    assert density.count("if (!last) grid.sync();") == 1
    solve = (CSRC / "solve_tiled.cuh").read_text()
    body = function_body(solve, "__device__ __forceinline__ void solve_tile(")
    assert "grid" not in body.replace("gridDim", "")
    # The zero start covers the two padded copies, not the rhs, which its
    # threads write while others zero.
    assert "i < 2 + 2 * pvol; i += nthreads" in body
    assert "gridDim" not in body  # the slots are indexed by the tile count
    program = function_body(solve, "__device__ __forceinline__ void block_tile(")
    assert "grid.sync" not in program and "this_grid" not in program
    assert "gridDim" not in program
    assert re.search(rf"kTileThreads = {TILE_THREADS};", solve)


@pytest.mark.parametrize("n,iters,solve,dtype,block,route", [
    (128, 60, "bfloat16", torch.float32, 1, "tiled"),     # bench128 + fuse_self_advect
    (128, 60, "bfloat16", BF16, 1, "tiled"),              # bench128 bf16
    (128, 60, None, torch.float32, 1, "tiled"),           # K14, 60 f32 sweeps
    (64, 20, None, torch.float32, 1, "tiled"),            # plume64 + fuse_self_advect
    (160, 60, "bfloat16", torch.float32, 1, "tiled"),     # the bf16 tiling's largest
    (144, 60, None, torch.float32, 1, "grid"),            # f32 copies over the opt-in
    (163, 60, None, torch.float32, 1, "grid"),            # the L2 gate's f32 edge
    (176, 60, "bfloat16", torch.float32, 1, "grid"),      # more tiles than SMs
    (205, 60, "bfloat16", BF16, 1, "grid"),               # the L2 gate's bf16 edge
    (128, 60, "bfloat16", torch.float32, 2, "tiled"),     # K5 at T = 2 on the tiles
    (128, 60, "bfloat16", torch.float32, 4, "tiled"),     # K5 at T = 4 on the tiles
    (128, 60, "bfloat16", BF16, 4, "tiled"),              # K5 blocks float32 fields only
    (144, 60, None, torch.float32, 2, "grid"),            # K5's f32 buffers over the opt-in
    (160, 60, "bfloat16", torch.float32, 4, "grid"),      # K5's bf16 chain over the opt-in
])
def test_route(n, iters, solve, dtype, block, route):
    assert fused_step_route(n, iters, solve, dtype, block) == route
    tiles = projection_tiles(n, dtype, iters, block, solve_torch_dtype(solve))
    assert (tiles is not None) == (route == "tiled")


# -- the kernel's schedule ------------------------------------------------------


def substep_buf(sub, n_sub, wide, inp, out, other, tmp0, tmp1):
    """csrc/full_step.cuh's substep_buf: the buffer substep ``sub`` writes
    (-1: the input, which substep 0 reads)."""
    if sub < 0:
        return inp
    if wide:
        return out if (n_sub - 1 - sub) % 2 == 0 else other
    if sub == n_sub - 1:
        return out
    return tmp0 if sub % 2 == 0 else tmp1


def eight_taps_in_place(fields, vel, dt0, k):
    """csrc/advect.cuh's advect_cell_eight at every cell: the <= 8 taps with
    weight read from ``fields`` at unwrapped indices (asserted inside the
    grid where no displacement is NaN), summed in the hat sum's order; and
    where no displacement is NaN."""
    n = fields.shape[-1]
    ar = torch.arange(n, dtype=torch.float32)
    coords = (ar[None, None, :], ar[None, :, None], ar[:, None, None])
    fs = [frac_win(c, vel[a].float(), dt0, n, k) for a, c in enumerate(coords)]
    ok = ~(fs[0].isnan() | fs[1].isnan() | fs[2].isnan())
    i = [torch.where(ok, f, 0.0).floor().clamp(max=k - 1).long() for f in fs]
    h = [(hat(f, d), hat(f, d + 1)) for f, d in zip(fs, i)]
    grid = torch.meshgrid(torch.arange(n), torch.arange(n), torch.arange(n), indexing="ij")
    taps = [g + d for g, d in zip(grid, (i[2], i[1], i[0]))]
    for t in taps:
        assert bool(((t >= 0) & (t + 1 <= n - 1))[ok].all()), "a tap would wrap"
    taps = [t.clamp(0, n - 2) for t in taps]
    out = torch.zeros(fields.shape, dtype=torch.float32)
    for a in (0, 1):
        for b in (0, 1):
            wzy = h[2][a] * h[1][b]
            for d in (0, 1):
                out = out + (wzy * h[0][d])[None] * fields[:, taps[0] + a, taps[1] + b,
                                                           taps[2] + d]
    return out, ok


def one_substep(bs, fields, vel, dt0, window, eight=False):
    """One substep of the K1 twin in float32 with the backtrace scale
    ``dt0``: the twin's loop body, as the kernel's per-cell body computes
    it; with ``eight`` (K >= 2: the vote on the source held) each cell's sum
    from its <= 8 taps where its displacement is not NaN."""
    def voted_sum(fields, vel, dt0, window):
        full = window_sum_3d(fields, vel, dt0, window)
        if not eight:
            return full
        v8, ok = eight_taps_in_place(fields, vel, dt0, window)
        return torch.where(ok[None], v8, full)

    with mock.patch.object(kadvect, "substep_dt0", lambda *_: dt0), \
            mock.patch.object(kadvect, "window_sum_3d", voted_sum):
        return advect_multi_3d_plain(bs, fields.float(), vel.float(), DT, n_sub=1,
                                     window=window)


class Grid:
    """The tiled kernel's grid-stride phases: ``grid.thread_rank()`` of the
    tiles' blocks (each grown along z to ``TILE_THREADS`` threads), the
    block of every cell, and a shuffled block order in two waves."""

    def __init__(self, n, tiles, rng):
        mx, my, _ = tile_extents(n, tiles)
        hx = (mx + 1) // 2
        self.threads = hx * my * (TILE_THREADS // (hx * my))
        self.blocks = int(np.prod(tiles))
        self.block_of = self.blocks_of(n ** 3).reshape(n, n, n)
        self.rng = rng
        self.n = n

    def blocks_of(self, count):
        """The block of each of ``count`` flat elements a grid-stride loop
        walks (``grid.thread_rank()`` of element i: i mod the grid's
        threads)."""
        return (torch.arange(count) % (self.blocks * self.threads)) // self.threads

    def vote(self, finite):
        """What votes_hold reads after the barrier: every block's vote (the
        AND of ``finite`` over the elements its threads walked: one a cell,
        or the flat elements of the inputs' pass), ANDed."""
        flat = finite.reshape(-1)
        block = self.blocks_of(flat.numel())
        slots = [bool(flat[block == b].all()) for b in range(self.blocks)]
        return all(slots)

    def run(self, buf, name, compute):
        """Write ``compute()`` into ``buf[name]`` cell by cell, the blocks in
        a shuffled order in two waves, each computing from the buffers as
        the waves before it left them; every cell written once."""
        order = self.rng.permutation(self.blocks)
        written = torch.zeros((self.n,) * 3, dtype=torch.int32)
        for wave in np.array_split(order, 2):
            mine = torch.isin(self.block_of, torch.from_numpy(wave))
            vals = compute()
            dst = buf[name]
            dst[(Ellipsis, mine)] = vals[(Ellipsis, mine)].to(dst.dtype)
            written += mine.int()
        assert bool((written == 1).all())


def poisoned(shape, dtype):
    return torch.full(shape, float("nan"), dtype=dtype)


def advect_phase(grid, buf, n_sub, wide, bs, names, vel_name, dt0, window, scale=None,
                 vote=None, votes=None):
    """The substeps of one advection (``names``: in, out, other, tmp0,
    tmp1), each from the buffer of index sub - 1 into that of sub: float32
    between, the last rounded to the storage type (then ``· scale`` in
    it).  At K >= 2 substep 0 reads the inputs' ``vote`` and each later one
    the vote on what the one before stored; ``votes`` gets each substep's."""
    for sub in range(n_sub):
        src = substep_buf(sub - 1, n_sub, wide, *names)
        dst = substep_buf(sub, n_sub, wide, *names)
        last = sub == n_sub - 1
        eight = window >= 2 and vote
        if votes is not None:
            votes.append(eight)

        def compute(src=src, last=last, eight=eight):
            vals = one_substep(bs, buf[src] if len(bs) == 3 else buf[src][None],
                               buf[vel_name], dt0, window, eight)
            vals = vals if len(bs) == 3 else vals[0]
            if last and scale is not None:
                return scale_in(vals.to(buf["vel"].dtype), scale)
            return vals

        assert src != dst
        grid.run(buf, dst, compute)
        stored = torch.isfinite(buf[dst].float())
        vote = grid.vote(stored.all(0) if len(bs) == 3 else stored)


def emulate_step(vel, dens, iters, *, window, n_sub, solve_dtype, damp, dens_damp, seed,
                 votes=None):
    """The tiled kernel's schedule on the CPU (``dens_damp`` None: K14,
    without the density phase); returns (vel', p[, density']).  ``votes``
    gets whether each substep's cells took the 8 taps (K >= 2), the
    self-advection's first."""
    n = vel.shape[-1]
    sdt = solve_torch_dtype(solve_dtype)
    tiles = projection_tiles(n, vel.dtype, iters, 1, sdt)
    assert tiles is not None
    rng = np.random.default_rng(seed)
    grid = Grid(n, tiles, rng)
    sdtype, wide = vel.dtype, vel.dtype == torch.float32
    vol3, vol = (3, n, n, n), (n, n, n)
    buf = {"vel": vel.clone(), "dens": dens.clone(), "adv": poisoned(vol3, sdtype),
           "vel_out": poisoned(vol3, sdtype), "p_out": poisoned(vol, sdtype),
           "dens_out": poisoned(vol, sdtype), "pa": poisoned(vol, sdt),
           "tmp0": poisoned(vol3, torch.float32), "tmp1": poisoned(vol3, torch.float32)}
    dt0 = substep_dt0(DT, n, n_sub)
    # 0. K >= 2: the vote on the inputs, a barrier.
    vel_vote = grid.vote(torch.isfinite(buf["vel"].float()))
    dens_vote = grid.vote(torch.isfinite(buf["dens"].float()))
    # 1. Self-advection into adv, a barrier after each substep.
    advect_phase(grid, buf, n_sub, wide, (1, 2, 3),
                 ("vel", "adv", "vel_out", "tmp0", "tmp1"), "vel", dt0, window,
                 vote=vel_vote, votes=votes)
    # 2-3. Every tile's solve (divergence of adv, the sweeps with the face
    # trades), the final iterate into pa; a barrier.
    rhs = F.pad(divergence_interior(buf["adv"]).to(sdt), (1, 1, 1, 1, 1, 1))
    buf["pa"] = tiled_solve_emulated(rhs, None, iters, tiles, sdt, seed)
    # 4. Gradient, faces, damp (and the pressure's copy); a barrier.
    grid.run(buf, "vel_out", lambda: project_gradient(buf["adv"], buf["pa"].float(), None,
                                                      damp))
    grid.run(buf, "p_out", lambda: buf["pa"].float())
    if dens_damp is None:
        return buf["vel_out"], buf["p_out"]
    # 5. Density into dens_out; float32: the other buffer is adv's first
    # volume, bfloat16: the first volumes of tmp0 and tmp1.
    for name in ("adv", "tmp0", "tmp1"):
        buf[name + "[0]"] = buf[name][0]
    advect_phase(grid, buf, n_sub, wide, (0,),
                 ("dens", "dens_out", "adv[0]", "tmp0[0]", "tmp1[0]"), "vel_out", dt0, window,
                 scale=dens_damp, vote=dens_vote, votes=votes)
    return buf["vel_out"], buf["p_out"], buf["dens_out"]


def seeded(n, seed, dtype, scale=0.3):
    rng = np.random.default_rng(seed)
    vel = torch.from_numpy((rng.standard_normal((3, n, n, n)) * scale).astype(np.float32))
    dens = torch.from_numpy(np.abs(rng.standard_normal((n, n, n)) * 10).astype(np.float32))
    return vel.to(dtype), dens.to(dtype)


def assert_bitwise(got, ref, what):
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype, what
        assert torch.equal(g, r), (what, float((g.float() - r.float()).abs().max()))


# (n, n_sub, window, fields, solve): every n_sub and window at 16^3, both
# field and solve dtypes at 24^3 and 33^3 (odd: the x tiles at n's parity),
# bench128's options at 48^3.
K8_CASES = [
    *[(16, s, k, "f32", "bf16") for s in (1, 2, 3) for k in (1, 2, 3)],
    *[(16, s, 1, "bf16", "f32") for s in (1, 2, 3)],
    *[(24, s, k, f, v) for s, k in ((1, 1), (2, 2)) for f in ("f32", "bf16")
      for v in ("f32", "bf16")],
    (33, 1, 1, "f32", "f32"), (33, 2, 1, "bf16", "bf16"), (33, 3, 3, "f32", "bf16"),
    (48, 1, 1, "f32", "bf16"), (48, 1, 1, "bf16", "bf16"), (48, 2, 1, "f32", "f32"),
]
DTYPES = {"f32": torch.float32, "bf16": BF16}


@pytest.mark.parametrize("n,n_sub,window,fields,solve", K8_CASES)
def test_k8_schedule_is_the_twin(n, n_sub, window, fields, solve):
    dtype = DTYPES[fields]
    vel, dens = seeded(n, 100 * n + 10 * n_sub + window, dtype)
    solve_dtype = "bfloat16" if solve == "bf16" else None
    iters = 5
    got = emulate_step(vel, dens, iters, window=window, n_sub=n_sub, solve_dtype=solve_dtype,
                       damp=DAMP, dens_damp=DDAMP, seed=n + n_sub)
    ref = full_step_3d_plain(vel, dens, iters, DT, window=window, n_sub=n_sub,
                             solve_dtype=solve_dtype, damp=DAMP, dens_damp=DDAMP)
    assert_bitwise(got, ref, "K8")


@pytest.mark.parametrize("n,n_sub,window", [(16, 1, 1), (16, 2, 2), (16, 3, 3), (33, 2, 1),
                                            (48, 1, 1)])
def test_k14_schedule_is_the_twin(n, n_sub, window):
    vel, dens = seeded(n, 7 * n + n_sub, torch.float32)
    got = emulate_step(vel, dens, 6, window=window, n_sub=n_sub, solve_dtype=None, damp=1.0,
                       dens_damp=None, seed=n)
    ref = advect_project_3d_resident_plain(vel, 6, DT, window=window, n_sub=n_sub)
    assert_bitwise(got, ref, "K14")


# -- K >= 2: the vote and the 8 taps ---------------------------------------------


def reaching(n, seed, dtype, window, n_sub):
    """Seeded fields whose velocity backtraces about K + 1 cells a substep,
    so that the clamp to the window fires."""
    return seeded(n, seed, dtype, (window + 1) * n_sub / (2.0 * DT * (n - 2)))


# (fields, solve, n_sub): both dtypes of each at one substep, two substeps
# (the float32 intermediates of bfloat16 fields, the votes on them).
WINDOW_DTYPES = [("f32", "bf16", 1), ("bf16", "bf16", 1), ("f32", "f32", 1),
                 ("bf16", "f32", 1), ("f32", "bf16", 2), ("bf16", "bf16", 2)]


@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("fields,solve,n_sub", WINDOW_DTYPES)
def test_k8_eight_tap_schedule_is_the_twin(fields, solve, n_sub, window):
    """On finite fields every substep's vote holds and every cell takes its
    <= 8 taps: bitwise the twin's (2K+1)³ sums."""
    n = 16
    vel, dens = reaching(n, 40 * window + 7 * n_sub, DTYPES[fields], window, n_sub)
    solve_dtype = "bfloat16" if solve == "bf16" else None
    votes = []
    got = emulate_step(vel, dens, 5, window=window, n_sub=n_sub, solve_dtype=solve_dtype,
                       damp=DAMP, dens_damp=DDAMP, seed=window + n_sub, votes=votes)
    assert votes == [True] * (2 * n_sub)
    ref = full_step_3d_plain(vel, dens, 5, DT, window=window, n_sub=n_sub,
                             solve_dtype=solve_dtype, damp=DAMP, dens_damp=DDAMP)
    assert_bitwise(got, ref, "K8")


def planted(vel, dens, plant, window):
    """``"tap"``: inf in the density at a cell that some cells' windows hold
    at zero weight; ``"source"``: a NaN velocity, in the self-advection's
    source, which the projection carries into the density phase's velocity
    (its substep 0's source stays finite; its result, the intermediate
    substep 1 reads, does not)."""
    vel, dens = vel.clone(), dens.clone()
    c = vel.shape[-1] // 2
    if plant == "tap":
        dens[c, c - 1, c] = float("inf")
    else:
        vel[1, c, c, c] = float("nan")
    return vel, dens


# The votes of the self-advection's two substeps, then the density's.
PLANT_VOTES = {"tap": [True, True, False, False], "source": [False, False, True, False]}


@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("fields", ["f32", "bf16"])
@pytest.mark.parametrize("plant", ["tap", "source"])
def test_k8_schedule_with_non_finite_values_is_the_twin(plant, fields, window):
    """A non-finite value in a substep's source, planted or left by the
    substep before, fails its vote: every cell of that substep takes the
    full sum, and the result is the twin's, NaN and inf included."""
    # Room for finite cells beside the NaN, which each substep's full sum
    # widens by K and each sweep by one.
    n = (16 if window < 4 else 24) if plant == "tap" else (24, 24, 32, 40)[window - 2]
    n_sub, iters = 2, 2
    vel, dens = planted(*reaching(n, 90 + window, DTYPES[fields], window, n_sub), plant,
                        window)
    votes = []
    got = emulate_step(vel, dens, iters, window=window, n_sub=n_sub, solve_dtype="bfloat16",
                       damp=DAMP, dens_damp=DDAMP, seed=window, votes=votes)
    assert votes == PLANT_VOTES[plant]
    ref = full_step_3d_plain(vel, dens, iters, DT, window=window, n_sub=n_sub,
                             solve_dtype="bfloat16", damp=DAMP, dens_damp=DDAMP)
    assert bool(ref[2].isnan().any()) and bool(torch.isfinite(ref[2]).any())
    for g, r, what in zip(got, ref, ("vel", "p", "density")):
        assert_same(g, r, what)


@pytest.mark.parametrize("window", [2, 3, 4, 5])
@pytest.mark.parametrize("n_sub,plant", [(1, None), (2, None), (2, "source")])
def test_k14_eight_tap_schedule_is_the_twin(window, n_sub, plant):
    n = 16
    vel, dens = reaching(n, 50 + window, torch.float32, window, n_sub)
    if plant is not None:
        vel, dens = planted(vel, dens, plant, window)
    votes = []
    got = emulate_step(vel, dens, 6, window=window, n_sub=n_sub, solve_dtype=None, damp=1.0,
                       dens_damp=None, seed=n, votes=votes)
    assert votes == [plant is None] * n_sub
    ref = advect_project_3d_resident_plain(vel, 6, DT, window=window, n_sub=n_sub)
    for g, r, what in zip(got, ref, ("vel", "p")):
        assert_same(g, r, what)


def test_vote_is_the_kernels():
    """The vote's slots and barriers as the emulation takes them: the inputs'
    pass ends in a grid barrier; a substep reads the inputs' slot or the
    other parity's and votes into its own unless it is the last; the
    scratch's size is the wrapper's."""
    step = (CSRC / "full_step.cuh").read_text()
    inputs = function_body(step, "__device__ __forceinline__ void vote_inputs(")
    assert inputs.count("grid.sync()") == 1 and inputs.rstrip("}").rstrip().endswith(
        "grid.sync();")
    assert "vote(a.votes, kVoteVel, finite);" in inputs
    assert "vote(a.votes, kVoteDens, finite);" in inputs
    cells = function_body(step, "__device__ __forceinline__ void substep_cells(")
    assert "const bool eight = votes_hold(a.votes, reads);" in cells
    assert "if (!last) vote(a.votes, writes, finite);" in cells
    for phase, first in (("self_advect_phase", "kVoteVel"), ("density_phase", "kVoteDens")):
        body = function_body(step, f"__device__ __forceinline__ void {phase}(")
        assert (f"sub == 0 ? {first} : kVoteSubstep + ((sub - 1) & 1),\n"
                "                           kVoteSubstep + (sub & 1), cells);") in body
    for route in ("    full_step_kernel(", "    full_step_tiled_kernel("):
        assert ("if constexpr (K != 1) vote_inputs<S, DENS>(a, grid, first, stride);\n"
                "  self_advect_phase<S, K>(a, grid, first, stride);") in function_body(step, route)
    assert re.search(rf"kVoteMaxBlocks = {VOTE_MAX_BLOCKS};", step)
    assert re.search(rf"kVoteCounts = {VOTE_COUNTS};", step)
    assert re.search(rf"kVoteSets = {VOTE_SETS};", step)
    assert "kVoteInts = 1 + (kVoteCounts + kVoteSets) * kVoteMaxBlocks;" in step
    assert VOTE_INTS == 1 + (VOTE_COUNTS + VOTE_SETS) * VOTE_MAX_BLOCKS


def test_tap_routes_reads_the_counts():
    """``tap_routes`` sums the blocks' counts by route (the header's block
    count of them, as unsigned ints), none past them."""
    votes = torch.full((VOTE_INTS,), -7, dtype=torch.int32)
    blocks = 3
    votes[0] = blocks
    counts = torch.tensor([[5, 1], [2, 9], [-1, 0]], dtype=torch.int32)
    votes[1:1 + VOTE_COUNTS * blocks] = counts.reshape(-1)
    assert tap_routes(votes) == {"eight": 5 + 2 + 2 ** 32 - 1, "full": 1 + 9}
