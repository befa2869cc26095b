#!/usr/bin/env python3
"""Where a stage of the tile program of K5 and K4 (csrc/solve_tiled.cuh,
block_tile) spends its time on the card, by phase: a thread's own compute
between trades, the shell's levels (T >= 3), and the trade's four parts
(the barrier before the face stores, the stores, the barrier and release,
the wait for the neighbours' flags, the halo loads and the last barrier);
at T = 2 the compute split into stage A's march (U = N(P)), stage B's
march, its corrections and its walls.

Run from the root of a checkout:  python3 tools/torch_block_phases.py

Builds a copy of fluidsim_tpu_torch/csrc/ (under fluidsim_tpu_torch/_build/)
whose program adds clock64() marks around each phase and writes thread 0's
mean cycles a stage by phase into its tile's spare flag words, then runs K5
in K3 at 128³ (T = 2 and 4, bench128's bf16 solve, 60 sweeps) and K4 at
128³ (20 sequential float32 sweeps) and prints, per case, the mean and the
largest over the blocks, the SM clock nvidia-smi reads, and the
uninstrumented call's time (CUDA events) beside the same call at T = 1.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from torch_solve_phases import cuda_ms, load, smi  # noqa: E402

PHASES = ["compute", "shell", "B1", "stores", "B2+release", "wait", "B3", "loads", "B4",
          "A march", "B march", "B corr", "B walls"]

# (text in block_tile, the same with the marks); MARK(k) adds the cycles
# since the last mark to phase k.
MARKS = [
    ("  int s = 0;  // trades so far: the flag value of the last\n",
     "  int s = 0;  // trades so far: the flag value of the last\n"
     "  double acc[13] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long tt = clock64(), tn;\n"
     "#define MARK(k) tn = clock64(); acc[k] += double(tn - tt); tt = tn;\n"),
    ("    ++s;\n    const int par = s & 1;\n    __syncthreads();\n",
     "    ++s;\n    const int par = s & 1;\n    MARK(0);\n    __syncthreads();\n    MARK(2);\n"),
    ("    __syncthreads();\n    if (tid == 0) store_release(a.flags + b * kFlagStride, s);\n",
     "    MARK(3);\n    __syncthreads();\n"
     "    if (tid == 0) store_release(a.flags + b * kFlagStride, s);\n    MARK(4);\n"),
    ("      load_acquire(a.flags + nb(tid) * kFlagStride);\n    }\n    __syncthreads();\n",
     "      load_acquire(a.flags + nb(tid) * kFlagStride);\n    }\n    MARK(5);\n"
     "    __syncthreads();\n    MARK(6);\n"),
    ("      }\n    }\n    __syncthreads();\n  };\n",
     "      }\n    }\n    MARK(7);\n    __syncthreads();\n    MARK(8);\n  };\n"),
    ("        shell(q + 1);\n", "        MARK(0);\n        shell(q + 1);\n        MARK(1);\n"),
    ("      shell(tb);\n", "      MARK(0);\n      shell(tb);\n      MARK(1);\n"),
    ("            [&](int, int c, const PairSums& p) { st2(wa + c, p.a(), p.b()); });\n"
     "    }\n    next(wa);\n",
     "            [&](int, int c, const PairSums& p) { st2(wa + c, p.a(), p.b()); });\n"
     "    }\n    MARK(9);\n    next(wa);\n"),
    ("    __syncthreads();\n    corrections();\n    __syncthreads();\n    wall_pass(P);\n"
     "    next(P);\n",
     "    MARK(10);\n    __syncthreads();\n    corrections();\n    __syncthreads();\n"
     "    MARK(11);\n    wall_pass(P);\n    MARK(12);\n    next(P);\n"),
    ("  if (active) {\n    for (int j = jlo; j < jhi; ++j) {\n"
     "      const int g = g_own + j * n2, i = (j + 1) * pplane + own;\n",
     "  MARK(0);\n  if (tid == 0) {\n    for (int q = 0; q < 13; ++q) {\n"
     "      a.flags[b * kFlagStride + 1 + q] = __float_as_int(float(acc[q] / s));\n"
     "    }\n  }\n"
     "  if (active) {\n    for (int j = jlo; j < jhi; ++j) {\n"
     "      const int g = g_own + j * n2, i = (j + 1) * pplane + own;\n"),
]


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from fluidsim_tpu_torch.config import preset_vortex_128
    from fluidsim_tpu_torch.kernels import _build, jacobi, resident
    from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(smi("name,power.limit"), flush=True)
    text = (_build.CSRC_DIR / "solve_tiled.cuh").read_text()
    head, program = text.split("__device__ __forceinline__ void block_tile(", 1)
    for plain, marked in MARKS:
        if program.count(plain) != 1:
            raise SystemExit(f"the program no longer has the mark point {plain!r}")
        program = program.replace(plain, marked)
    work = _build.BUILD_DIR / "block_phases"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, work / "csrc")
    (work / "csrc" / "solve_tiled.cuh").write_text(
        head + "__device__ __forceinline__ void block_tile(" + program)
    marked_lib = load(_build, work / "csrc", work / "build")
    plain_lib = _build.load_library()

    n = 128
    rng = np.random.default_rng(3)
    vel = torch.from_numpy((rng.standard_normal((3, n, n, n)) * 5).astype(np.float32)).cuda()
    x = torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32)).cuda()
    obst = torch.from_numpy(build_obstacle_mask(preset_vortex_128())).cuda()
    cases = {
        "K5 T=2 in K3 (bf16 solve, 60 sweeps)": lambda t: resident.project_3d_resident(
            vel, 60, solve_dtype="bfloat16", sweep_block=t),
        "K5 T=4 in K3 (bf16 solve, 60 sweeps)": lambda t: resident.project_3d_resident(
            vel, 60, solve_dtype="bfloat16", sweep_block=t),
        "K4 (20 float32 sweeps, b=1, a=0.13)": lambda t: jacobi.jacobi_3d_resident(
            1, x, x, 0.13, 1.78, 20),
        "K4 with the mask (20 sweeps)": lambda t: jacobi.jacobi_3d_resident(
            0, x, x, 1.0, 6.0, 20, obst=obst),
    }
    blocks = {0: 2, 1: 4, 2: 1, 3: 1}
    seen = []
    real_tiles_arg = resident.tiles_arg

    def spy(*args, **kw):
        arg = real_tiles_arg(*args, **kw)
        seen.append(arg)
        return arg

    for i, (name, fn) in enumerate(cases.items()):
        t = blocks[i]
        ms = cuda_ms(lambda: fn(t), reps=20)
        ms1 = cuda_ms(lambda: fn(1), reps=20) if t > 1 else None
        _build.load_library = lambda: marked_lib
        resident.tiles_arg = spy
        try:
            seen.clear()
            fn(t)
            torch.cuda.synchronize()
        finally:
            _build.load_library = lambda: plain_lib
            resident.tiles_arg = real_tiles_arg
        flags = seen[-1].scratch[0]
        tiles = (seen[-1].gx, seen[-1].gy, seen[-1].gz)
        count = int(np.prod(tiles))
        cyc = flags.reshape(count, resident.TILE_FLAG_STRIDE)[:, 1:1 + len(PHASES)]
        cyc = cyc.contiguous().view(torch.float32).double().cpu()
        print(f"{name}: {ms!r} ms a call" + (f" (T=1 {ms1!r} ms)" if ms1 else "")
              + f", tiles {tiles}; SM clock {smi('clocks.sm')}; cycles a stage by phase, "
              f"thread 0, mean / max over {count} blocks:", flush=True)
        for k, phase in enumerate(PHASES):
            print(f"  {phase:10s} {float(cyc[:, k].mean())!r} / {float(cyc[:, k].max())!r}",
                  flush=True)
        print(f"  total      {float(cyc.sum(1).mean())!r}", flush=True)


if __name__ == "__main__":
    main()
