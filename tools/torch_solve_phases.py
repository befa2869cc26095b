#!/usr/bin/env python3
"""Where a sweep of the tiled Jacobi solve (csrc/solve_tiled.cuh) spends its
time on the card, by phase: compute, the face stores, the flag's release,
the wait for the neighbours, the halo loads and the four block barriers.

Run from the root of a checkout:  python3 tools/torch_solve_phases.py

Builds a copy of fluidsim_tpu_torch/csrc/ (under fluidsim_tpu_torch/_build/)
whose kernel adds clock64() marks around each phase of every sweep and
writes thread 0's mean cycles a sweep by phase into the first values of the
final iterate, then runs K3 at 128³ (60 sweeps, float32 solve and fields,
bench128's tiling) and prints the mean and the largest over the 128 blocks,
the SM clock nvidia-smi reads, and the uninstrumented kernel's time a call
at 60 and at 1 sweep on the same input (CUDA events).  Prints the card's
name and power limit first.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PHASES = ["compute", "B1", "stores", "B2", "release", "wait", "B3", "loads", "B4"]

# (text in the kernel, the same with the marks); MARK(k) adds the cycles
# since the last mark to phase k.
MARKS = [
    ("  for (int s = 1;; ++s) {\n",
     "  double acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};\n  long long tt = 0, tn;\n"
     "#define MARK(k) tn = clock64(); acc[k] += double(tn - tt); tt = tn;\n"
     "  for (int s = 1;; ++s) {\n    tt = clock64();\n"),
    ("    if (s == a.iters) break;\n    __syncthreads();\n    // The tile's new faces",
     "    MARK(0);\n    if (s == a.iters) break;\n    __syncthreads();\n    MARK(1);\n"
     "    // The tile's new faces"),
    ("    __syncthreads();\n    if (tid == 0) store_release(a.flags + b * kFlagStride, s);\n",
     "    MARK(2);\n    __syncthreads();\n    MARK(3);\n"
     "    if (tid == 0) store_release(a.flags + b * kFlagStride, s);\n    MARK(4);\n"),
    ("      load_acquire(a.flags + nb(tid) * kFlagStride);\n    }\n    __syncthreads();\n",
     "      load_acquire(a.flags + nb(tid) * kFlagStride);\n    }\n    MARK(5);\n"
     "    __syncthreads();\n    MARK(6);\n"),
    ("    __syncthreads();\n    T* t = src;",
     "    MARK(7);\n    __syncthreads();\n    MARK(8);\n    T* t = src;"),
    ("own + 1];\n    }\n  }\n}",
     "own + 1];\n    }\n  }\n  __syncthreads();\n"
     "  if (tid == 0) for (int k = 0; k < 9; ++k) a.p[b * 16 + k] = T(float(acc[k] / a.iters));\n}"),
]


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def cuda_ms(fn, reps: int = 50, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def load(build, csrc: Path, out: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build.build(csrc, out)))
    for name, argtypes in build.SIGNATURES.items():
        getattr(lib, name).argtypes = list(argtypes)
        getattr(lib, name).restype = ctypes.c_int
    lib.fs_error_string.argtypes = [ctypes.c_int]
    lib.fs_error_string.restype = ctypes.c_char_p
    return lib


def main() -> None:
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from fluidsim_tpu_torch.kernels import _build
    from fluidsim_tpu_torch.kernels import resident

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(smi("name,power.limit"), flush=True)
    text = (_build.CSRC_DIR / "solve_tiled.cuh").read_text()
    for plain, marked in MARKS:
        if text.count(plain) != 1:
            raise SystemExit(f"the kernel no longer has the mark point {plain!r}")
        text = text.replace(plain, marked)
    work = _build.BUILD_DIR / "phases"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, work / "csrc")
    (work / "csrc" / "solve_tiled.cuh").write_text(text)
    marked_lib = load(_build, work / "csrc", work / "build")
    plain_lib = _build.load_library()

    n, iters = 128, 60
    rng = np.random.default_rng(3)
    vel = torch.from_numpy((rng.standard_normal((3, n, n, n)) * 5).astype(np.float32)).cuda()
    tiles = resident.solve_tiles(n, torch.float32, vel.device)
    t60 = cuda_ms(lambda: resident.project_3d_resident(vel, iters))
    t1 = cuda_ms(lambda: resident.project_3d_resident(vel, 1))
    print(f"K3 at {n}^3, float32 solve, tiles {tiles}: {t60!r} ms at {iters} sweeps, "
          f"{t1!r} ms at 1: {(t60 - t1) / (iters - 1) * 1e3!r} us a sweep", flush=True)
    _build.load_library = lambda: marked_lib
    try:
        for _ in range(3):
            _, p = resident.project_3d_resident(vel, iters)
        torch.cuda.synchronize()
    finally:
        _build.load_library = lambda: plain_lib
    blocks = int(np.prod(tiles))
    cyc = p.reshape(-1)[:blocks * 16].reshape(blocks, 16)[:, :len(PHASES)].double().cpu()
    print(f"SM clock {smi('clocks.sm')}; cycles a sweep by phase, thread 0, mean / max over "
          f"{blocks} blocks:", flush=True)
    for k, name in enumerate(PHASES):
        print(f"  {name:8s} {float(cyc[:, k].mean())!r} / {float(cyc[:, k].max())!r}", flush=True)
    print(f"  total    {float(cyc.sum(1).mean())!r}", flush=True)


if __name__ == "__main__":
    main()
