#!/usr/bin/env python3
"""Kernel times of the PyTorch port for two or more checkouts, alternated on
one CUDA card: K6 (20 sweeps of the projection's solve at 256³ and 512³),
K10 (a round on shard 3's slab of sharded512 on 8 shards: (72, 512, 512) at
T = 4, (68, 512, 512) at T = 2), K12 (an 8-shard round of those slabs:
eight launches), K1 (bench128's self-advection with the buoyancy folded in,
and with the emitter on its density; vortex128's three substeps with its
mask, F = 3 and 1, float32 and bfloat16; multi256's two substeps, F = 3 and
1; 512³ with two substeps, F = 3 with the buoyancy and F = 1), K11 (two substeps on one
shard's (F, 68, 512, 512) slab of sharded512 on 8 shards, F = 3 and 1), K8
(the whole step in one launch: 60 float32 sweeps at 128³; bench128's 60
bfloat16 sweeps on float32 and on bfloat16 fields; plume64's K = 3 and 20
float32 sweeps), K2 (bench128: 60 bfloat16 sweeps and the density), K3
(bench128 unfused, 60 bfloat16 sweeps; vortex128, its mask and 20 bfloat16
sweeps; 60 float32 sweeps), K14 (60 float32 sweeps at 128³) and K9 (20
sweeps with scene_a's airfoil at 192² and scene_b's circle at 128², a
smoothing and a fixed-rhs solve), and K1, K2's density phase and K11 at
windows K >= 2 (plume64's K = 3, F = 3 and 1, and K = 4, 5, F = 3; the 64³
gate's K = 2; bench128's K = 2 with the buoyancy and the emitter folded and
K2s's K = 2 density phase; plume64's fused K2 with a K = 3 density phase;
K11 at K = 4, 5 on shard 3's (F, 64 + 4K, 512, 512) slab of sharded512 on 8
shards, two substeps, F = 3 and 1, float32 and bfloat16).

Run from anywhere:  python3 tools/torch_kernels_ab.py [--windowed | --fused-window] ROOT_A ROOT_B [...]
(``--windowed``: the K >= 2 rows alone; ``--fused-window``: K8 and K14 at
every window K = 1..5 alone: K8 on bench128's shape with 60 bfloat16
sweeps, float32 and bfloat16 fields, K14 with 60 float32 sweeps, K8 on
plume64's shape at K = 3, each beside K1 → K2 (K1 → K3) on the same inputs,
by CUDA events and by the profiler's kernel time)

Each ROOT is the root of a checkout that holds ``fluidsim_tpu_torch/``.
The checkouts run in the order A, B, ..., then the reverse (A, B, B, A for
two), each in a fresh Python process that builds that checkout's kernels
and times each kernel with CUDA events over 10 (K6, K12), 200 (K9) or 50
(the others) calls (5 for the 512³ calls) after two warm-up calls, on inputs made from one
NumPy seed.  Prints the card's name and power limit, then one JSON line per
process: the milliseconds a call by kernel.
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


def device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds a call of ``fn()``: the kernels' time from
    ``torch.profiler`` over ``reps`` calls after a warm-up call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            total += evt.self_cuda_time_total if us is None else us
    return total / 1e3 / reps


def fused_window(out, field, dev) -> None:
    """K8 and K14 at windows K = 1..5 beside the launches they fuse."""
    import torch

    from fluidsim_tpu_torch.config import preset_bench_128, preset_plume_64
    from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_kernel
    from fluidsim_tpu_torch.kernels.resident import (
        advect_project_3d_resident,
        full_step_3d,
        project_3d_resident,
        project_advect_density_3d,
    )

    def timed(key, fn, reps):
        out[key] = cuda_ms(fn, reps)
        out[key + " device"] = device_ms(fn, min(reps, 10))

    def k1(vel, dt, k):
        return advect_multi_3d_kernel((1, 2, 3), vel, vel, dt, window=k)

    bdt = preset_bench_128().effective_params()[0]
    bvel, bdens = field(128, 3, scale=40.0), field(128).abs() * 20.0
    bf16 = "bfloat16"
    for k in (1, 2, 3, 4, 5):
        reps = 20 if k < 4 else 5
        for dtype, tag in ((torch.float32, ""), (torch.bfloat16, " bf16 fields")):
            v, d = bvel.to(dtype), bdens.to(dtype)
            timed(f"K8 bench128 K={k}{tag}", lambda: full_step_3d(
                v, d, 60, bdt, window=k, solve_dtype=bf16), reps)
            timed(f"K1 -> K2 bench128 K={k}{tag}", lambda: project_advect_density_3d(
                k1(v, bdt, k), d, 60, bdt, window=k, solve_dtype=bf16), reps)
        timed(f"K14 128^3 K={k}", lambda: advect_project_3d_resident(
            bvel, 60, bdt, window=k), reps)
        timed(f"K1 -> K3 128^3 K={k}", lambda: project_3d_resident(k1(bvel, bdt, k), 60), reps)
    pdt = preset_plume_64().effective_params()[0]
    pvel, pdens = field(64, 3, scale=2.0), field(64).abs() * 20.0
    timed("K8 plume64 K=3", lambda: full_step_3d(pvel, pdens, 20, pdt, window=3), 50)
    timed("K1 -> K2 plume64 K=3", lambda: project_advect_density_3d(
        k1(pvel, pdt, 3), pdens, 20, pdt, window=3), 50)
    torch.cuda.empty_cache()


def child(root: str, windowed_only: bool = False, fused_only: bool = False) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import fluidsim_tpu_torch
    from fluidsim_tpu_torch.kernels import _build
    from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_kernel
    from fluidsim_tpu_torch.kernels.halo import (
        NO_WALL,
        advect_ext_kernel,
        jacobi_ext_kernel,
        jacobi_ext_rdma,
    )
    from fluidsim_tpu_torch.kernels.jacobi import jacobi_3d_kernel
    from fluidsim_tpu_torch.kernels.project import divergence_3d_plain
    from fluidsim_tpu_torch.config import (
        preset_bench_128,
        preset_scene_a,
        preset_scene_b,
        preset_vortex_128,
    )
    from fluidsim_tpu_torch.kernels.resident import (
        advect_project_3d_resident,
        full_step_3d,
        project_3d_resident,
        project_advect_density_3d,
    )
    from fluidsim_tpu_torch.kernels.resident2d import lin_solve_2d_resident
    from fluidsim_tpu_torch.scene.obstacles import build_obstacle_mask
    from fluidsim_tpu_torch.scene.sources import emitter_fold_operand

    if Path(fluidsim_tpu_torch.__file__).resolve().parent.parent != Path(root):
        raise SystemExit(f"imported {fluidsim_tpu_torch.__file__}, not from {root}")
    _build.load_library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)

    def field(n, *lead, scale=1.0):
        a = rng.standard_normal(lead + (n, n, n)).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    out = {}
    if fused_only:
        fused_window(out, field, dev)
        print(json.dumps({"root": root, "ms": out}), flush=True)
        return
    if windowed_only:
        windowed(out, field, dev)
        print(json.dumps({"root": root, "ms": out}), flush=True)
        return
    for n in (256, 512):
        div = divergence_3d_plain(field(n, 3, scale=0.5))
        zero = torch.zeros_like(div)
        out[f"K6 {n}^3"] = cuda_ms(lambda: jacobi_3d_kernel(0, zero, div, 1.0, 6.0, 20), 10)
        if n == 512:
            for t in (4, 2):
                # Every shard's (64 + 2T)-plane slab, zeros past the global ends.
                pad = torch.zeros_like(div[:t])
                ext = [torch.cat([pad, v, pad]).narrow(0, r * 64, 64 + 2 * t).contiguous()
                       for v in (zero + 0.25 * div, div) for r in range(8)]
                xps, x0s = ext[:8], ext[8:]
                nz = xps[0].shape[0]
                out[f"K10 T={t} ({nz}, 512, 512)"] = cuda_ms(lambda: jacobi_ext_kernel(
                    xps[3], x0s[3], 1.0, 6.0, t, NO_WALL, NO_WALL), 50)
                out[f"K12 T={t} an 8-shard round"] = cuda_ms(
                    lambda: jacobi_ext_rdma(xps, x0s, 1.0, 6.0, t), 10)
                del ext, xps, x0s, pad
        del div, zero
    vel, dens = field(128, 3, scale=4.0), field(128).abs() * 20.0
    out["K1 128^3 buoyancy"] = cuda_ms(lambda: advect_multi_3d_kernel(
        (1, 2, 3), vel, vel, 0.0008, buoy=(dens, 1.0, 0.0, 0.0)), 50)
    src = emitter_fold_operand(preset_bench_128(), torch.full((), 0.0008, device=dev))
    out["K1 128^3 buoyancy + src"] = cuda_ms(lambda: advect_multi_3d_kernel(
        (1, 2, 3), vel, vel, 0.0008, buoy=(dens, 1.0, 0.0, 0.0), src=src), 50)
    vmask = torch.from_numpy(build_obstacle_mask(preset_vortex_128())).to(dev)
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, " bf16")):
        v, d = vel.to(dtype), dens.to(dtype)
        out[f"K1 vortex128 F=3{tag}"] = cuda_ms(lambda: advect_multi_3d_kernel(
            (1, 2, 3), v, v, 0.03, obst=vmask, n_sub=3), 50)
        out[f"K1 vortex128 F=1{tag}"] = cuda_ms(lambda: advect_multi_3d_kernel(
            (0,), d[None], v, 0.03, obst=vmask, n_sub=3), 50)
    mvel, mdens = field(256, 3, scale=4.0), field(256).abs() * 20.0
    out["K1 multi256 F=3"] = cuda_ms(lambda: advect_multi_3d_kernel(
        (1, 2, 3), mvel, mvel, 0.02, n_sub=2), 50)
    out["K1 multi256 F=1"] = cuda_ms(lambda: advect_multi_3d_kernel(
        (0,), mdens[None], mvel, 0.02, n_sub=2), 50)
    del mvel, mdens
    svel, sdens = field(512, 3, scale=4.0), field(512).abs() * 20.0
    out["K1 512^3 F=3 buoyancy"] = cuda_ms(lambda: advect_multi_3d_kernel(
        (1, 2, 3), svel, svel, 0.01, buoy=(sdens, 1.0, 0.0, 0.0), n_sub=2), 5)
    out["K1 512^3 F=1"] = cuda_ms(lambda: advect_multi_3d_kernel(
        (0,), sdens[None], svel, 0.01, n_sub=2), 5)
    # Shard 3 of 8: its 64 planes between 2 of each neighbour's (h = K * n_sub).
    ve = svel[:, 190:258].contiguous()
    de = sdens[None, 190:258].contiguous()
    del svel, sdens
    out["K11 F=3 slab"] = cuda_ms(lambda: advect_ext_kernel(
        (1, 2, 3), ve, ve, 512, 0.01, 190, 1, 2), 50)
    out["K11 F=1 slab"] = cuda_ms(lambda: advect_ext_kernel(
        (0,), de, ve, 512, 0.01, 190, 1, 2), 50)
    del ve, de
    out["K8 128^3"] = cuda_ms(lambda: full_step_3d(vel, dens, 60, 0.0008, n_sub=1), 50)
    bf16 = "bfloat16"
    out["K2 bench128"] = cuda_ms(lambda: project_advect_density_3d(
        vel, dens, 60, 0.0008, solve_dtype=bf16), 50)
    out["K3 bench128"] = cuda_ms(lambda: project_3d_resident(vel, 60, solve_dtype=bf16), 50)
    out["K3 f32 solve 128^3"] = cuda_ms(lambda: project_3d_resident(vel, 60), 50)
    out["K3 vortex128"] = cuda_ms(lambda: project_3d_resident(
        vel, 20, obst=vmask, solve_dtype=bf16), 50)
    vb, db = vel.to(torch.bfloat16), dens.to(torch.bfloat16)
    out["K8 bench128"] = cuda_ms(lambda: full_step_3d(vel, dens, 60, 0.0008,
                                                      solve_dtype=bf16), 50)
    out["K8 bench128 bf16 fields"] = cuda_ms(lambda: full_step_3d(vb, db, 60, 0.0008,
                                                                  solve_dtype=bf16), 50)
    pvel, pdens = field(64, 3, scale=0.5), field(64).abs() * 20.0
    out["K8 plume64 K=3"] = cuda_ms(lambda: full_step_3d(pvel, pdens, 20, 0.02, window=3), 50)
    out["K14 128^3"] = cuda_ms(lambda: advect_project_3d_resident(vel, 60, 0.0008), 50)
    windowed(out, field, dev)
    for scene, preset in (("scene_a", preset_scene_a), ("scene_b", preset_scene_b)):
        cfg = preset()
        m = cfg.current_size
        mask = torch.from_numpy(build_obstacle_mask(cfg)).to(dev)
        x = torch.from_numpy(rng.standard_normal((m, m)).astype(np.float32) * 3.0).to(dev)
        div = torch.from_numpy(rng.standard_normal((m, m)).astype(np.float32) * 1e-3).to(dev)
        a = float(np.float32(2.5e-3 * (m - 2) ** 2))
        c = float(np.float32(1.0) + np.float32(6.0) * np.float32(a))
        out[f"K9 {scene} smoothing"] = cuda_ms(lambda: lin_solve_2d_resident(
            1, x, x, a, c, mask, 20, smooth=True), 200)
        out[f"K9 {scene} fixed-rhs"] = cuda_ms(lambda: lin_solve_2d_resident(
            0, torch.zeros_like(div), div, 1.0, 6.0, mask, 20), 200)
    print(json.dumps({"root": root, "ms": out}), flush=True)


def windowed(out, field, dev) -> None:
    """The K >= 2 rows: K1 at 64³ (plume64, the gate) and 128³ (bench128's
    folds), K2 and K2s with a windowed density phase, K11 on sharded512's
    slabs; each by CUDA events and (" device") by the profiler's kernel
    time, which the events exceed where the host's launches are the slower
    (the 64³ rows)."""
    import torch

    from fluidsim_tpu_torch.config import preset_bench_128, preset_plume_64
    from fluidsim_tpu_torch.kernels.advect import advect_multi_3d_kernel
    from fluidsim_tpu_torch.kernels.halo import advect_ext_kernel
    from fluidsim_tpu_torch.kernels.resident import project_advect_density_3d
    from fluidsim_tpu_torch.scene.sources import emitter_fold_operand

    def timed(key, fn, reps, warmup=2):
        out[key] = cuda_ms(fn, reps, warmup)
        out[key + " device"] = device_ms(fn, reps)

    pdt = preset_plume_64().effective_params()[0]
    pvel, pdens = field(64, 3, scale=2.0), field(64).abs() * 20.0
    for k in (2, 3):
        timed(f"K1 64^3 K={k} F=3", lambda: advect_multi_3d_kernel(
            (1, 2, 3), pvel, pvel, pdt, window=k), 50)
        timed(f"K1 64^3 K={k} F=1", lambda: advect_multi_3d_kernel(
            (0,), pdens[None], pvel, pdt, window=k), 50)
    for k in (4, 5):
        timed(f"K1 64^3 K={k} F=3", lambda: advect_multi_3d_kernel(
            (1, 2, 3), pvel, pvel, pdt, window=k), 20)
    timed("K2 plume64 K=3 density phase", lambda: project_advect_density_3d(
        pvel, pdens, 20, pdt, window=3), 50)
    bdt = preset_bench_128().effective_params()[0]
    bvel, bdens = field(128, 3, scale=40.0), field(128).abs() * 20.0
    src = emitter_fold_operand(preset_bench_128(), torch.full((), bdt, device=dev))
    timed("K1 bench128 K=2 buoyancy + src", lambda: advect_multi_3d_kernel(
        (1, 2, 3), bvel, bvel, bdt, buoy=(bdens, 1.0, 0.0, 0.0), src=src, window=2), 20)
    timed("K2s bench128 K=2", lambda: project_advect_density_3d(
        bvel, bdens, 60, bdt, window=2, src=src, solve_dtype="bfloat16"), 20)
    del pvel, pdens, bvel, bdens
    svel, sdens = field(512, 3, scale=4.0), field(512).abs() * 20.0
    for k in (4, 5):
        # Shard 3 of 8: its 64 planes between 2K of each neighbour's.
        h = 2 * k
        ve = svel[:, 192 - h:256 + h].contiguous()
        de = sdens[None, 192 - h:256 + h].contiguous()
        for dtype, tag in ((torch.float32, ""), (torch.bfloat16, " bf16")):
            v, d = ve.to(dtype), de.to(dtype)
            timed(f"K11 K={k} F=3 slab{tag}", lambda: advect_ext_kernel(
                (1, 2, 3), v, v, 512, 0.01, 192 - h, k, 2), 3, warmup=1)
            timed(f"K11 K={k} F=1 slab{tag}", lambda: advect_ext_kernel(
                (0,), d, v, 512, 0.01, 192 - h, k, 2), 3, warmup=1)
        del ve, de, v, d
    del svel, sdens
    torch.cuda.empty_cache()


def main(roots, rows: str) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed",
          flush=True)
    order = list(roots) + list(reversed(roots))
    for root in order:
        subprocess.run([sys.executable, __file__, "--child", rows, str(Path(root).resolve())],
                       check=True)


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        child(sys.argv[3], sys.argv[2] == "windowed", sys.argv[2] == "fused-window")
    elif len(sys.argv) >= 4 and sys.argv[1] == "--windowed":
        main(sys.argv[2:], "windowed")
    elif len(sys.argv) >= 4 and sys.argv[1] == "--fused-window":
        main(sys.argv[2:], "fused-window")
    elif len(sys.argv) >= 3:
        main(sys.argv[1:], "all")
    else:
        raise SystemExit(__doc__)
