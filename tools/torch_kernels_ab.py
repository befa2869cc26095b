#!/usr/bin/env python3
"""Kernel times of the PyTorch port for two or more checkouts, alternated on
one CUDA card: K6 (20 sweeps of the projection's solve at 256³ and 512³),
K1 (bench128's self-advection with the buoyancy folded in), K8
(bench128's whole step in one launch, 60 sweeps), K2 (bench128: 60
bfloat16 sweeps and the density) and K3 (bench128 unfused, 60 bfloat16
sweeps; vortex128, its mask and 20 bfloat16 sweeps; 60 float32 sweeps).

Run from anywhere:  python3 tools/torch_kernels_ab.py ROOT_A ROOT_B [...]

Each ROOT is the root of a checkout that holds ``fluidsim_tpu_torch/``.
The checkouts run in the order A, B, ..., then the reverse (A, B, B, A for
two), each in a fresh Python process that builds that checkout's kernels
and times each kernel with CUDA events over 10 (K6) or 50 (the others) calls
after two warm-up calls, on inputs made from one NumPy seed.  Prints the
card's name and power limit, then one JSON line per process: the
milliseconds a call by kernel.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
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


def child(root: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import fluidsim_tpu_torch
    from fluidsim_tpu_torch.kernels import _build
    from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_kernel
    from fluidsim_tpu_torch.kernels.jacobi import jacobi_3d_kernel
    from fluidsim_tpu_torch.kernels.project import divergence_3d_plain
    from fluidsim_tpu_torch.config import preset_vortex_128
    from fluidsim_tpu_torch.kernels.resident import (
        full_step_3d,
        project_3d_resident,
        project_advect_density_3d,
    )
    from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask

    if Path(fluidsim_tpu_torch.__file__).resolve().parent.parent != Path(root):
        raise SystemExit(f"imported {fluidsim_tpu_torch.__file__}, not from {root}")
    _build.load_library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)

    def field(n, *lead, scale=1.0):
        a = rng.standard_normal(lead + (n, n, n)).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    out = {}
    for n in (256, 512):
        div = divergence_3d_plain(field(n, 3, scale=0.5))
        zero = torch.zeros_like(div)
        out[f"K6 {n}^3"] = cuda_ms(lambda: jacobi_3d_kernel(0, zero, div, 1.0, 6.0, 20), 10)
        del div, zero
    vel, dens = field(128, 3, scale=4.0), field(128).abs() * 20.0
    out["K1 128^3 buoyancy"] = cuda_ms(lambda: advect_multi_3d_kernel(
        (1, 2, 3), vel, vel, 0.0008, buoy=(dens, 1.0, 0.0, 0.0)), 50)
    out["K8 128^3"] = cuda_ms(lambda: full_step_3d(vel, dens, 60, 0.0008, n_sub=1), 50)
    bf16 = "bfloat16"
    out["K2 bench128"] = cuda_ms(lambda: project_advect_density_3d(
        vel, dens, 60, 0.0008, solve_dtype=bf16), 50)
    out["K3 bench128"] = cuda_ms(lambda: project_3d_resident(vel, 60, solve_dtype=bf16), 50)
    out["K3 f32 solve 128^3"] = cuda_ms(lambda: project_3d_resident(vel, 60), 50)
    mask = torch.from_numpy(build_obstacle_mask(preset_vortex_128())).to(dev)
    out["K3 vortex128"] = cuda_ms(lambda: project_3d_resident(
        vel, 20, obst=mask, solve_dtype=bf16), 50)
    print(json.dumps({"root": root, "ms": out}), flush=True)


def main(roots) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)
    order = list(roots) + list(reversed(roots))
    for root in order:
        subprocess.run([sys.executable, __file__, "--child", str(Path(root).resolve())],
                       check=True)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
    elif len(sys.argv) >= 3:
        main(sys.argv[1:])
    else:
        raise SystemExit(__doc__)
