"""Command-line entry points (counterpart of ``fluidsim_tpu/cli.py``): the
``bench`` and ``presets`` subcommands.

    python -m fluidsim_tpu_torch.cli bench --preset bench128 --steps 100
    python -m fluidsim_tpu_torch.cli bench --preset sharded512 --mesh 8 \\
        --halo explicit --halo-block-iters 4 --halo-backend pallas --steps 20
    python -m fluidsim_tpu_torch.cli bench --preset sharded512 --mesh 8 \\
        --halo explicit --halo-block-iters 4 --halo-backend rdma --dtype bfloat16
    python -m fluidsim_tpu_torch.cli presets

``bench`` steps on the card unless ``--device cpu`` asks for the CPU.  With
``--mesh N`` it benches the slab-sharded step over an N-shard mesh on the
visible card(s): N shards on one card when one is visible
(``parallel.sharding``; a mesh over distinct cards is not ported).
``--halo-backend pallas`` runs K10 and K11 per shard with ``torch.cat``
exchanges, ``rdma`` K12 and K11 with every exchange in a kernel (K12,
K13); either takes ``--dtype bfloat16`` fields.  ``run``,
``render``, ``save-config`` and ``serve`` (the metrics store, checkpoints
and the viewer) and ``--config`` are not ported.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys


def _build_cfg(args):
    from .config import get_preset

    cfg = get_preset(args.preset)
    if args.size:
        cfg = cfg.replace(size=args.size)
    if args.backend:
        cfg = cfg.replace(kernel_backend=args.backend)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    if args.solve_dtype:
        cfg = cfg.replace(solve_dtype=args.solve_dtype)
    if args.advect_substeps:
        cfg = cfg.replace(advection_scheme="substep", advect_substeps=args.advect_substeps)
    if args.fuse_project_advect:
        cfg = cfg.replace(fuse_project_advect=True)
    if args.fuse_self_advect:
        cfg = cfg.replace(fuse_project_advect=True, fuse_self_advect=True)
    if args.jacobi_sweep_block:
        cfg = cfg.replace(jacobi_sweep_block=args.jacobi_sweep_block)
    return cfg


def _sync(state) -> None:
    """Wait for the step's work: a scalar read from the state."""
    int(state.step)


def _bench_sharded(args):
    """steps/sec of the slab-sharded step over an N-shard mesh (BASELINE
    config 5's measurement path: ``bench --preset sharded512 --mesh 8``).
    The mesh's N entries are the visible card (or ``--device cpu``)
    repeated; every shard has its own slab buffers and launches."""
    import torch

    from .parallel.sharding import make_mesh, shard_state, sharded_step_fn
    from .scene.obstacles import build_obstacle_mask
    from .state import zeros_state
    from .utils.profiling import StepTimer

    cfg = _build_cfg(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device: pass --device cpu for the CPU"}))
        return 1
    mesh = make_mesh([args.device] * args.mesh)
    device = mesh.devices[0]
    obst = build_obstacle_mask(cfg) if cfg.enable_obstacle else None
    state = shard_state(zeros_state(cfg, device, obstacles=obst), mesh)
    per = max(args.substeps, 1)
    step = sharded_step_fn(cfg, mesh, n_substeps=per, halo=args.halo,
                           halo_block_iters=args.halo_block_iters,
                           halo_backend=args.halo_backend)
    state = step(state)  # builds the kernels; warm
    _sync(state)
    timer = StepTimer(device)
    done = 0
    while done < args.steps:
        with timer:
            state = step(state)
        done += per
    _sync(state)
    print(json.dumps({
        "preset": args.preset,
        "grid": list(cfg.grid_shape),
        "mesh": args.mesh,
        "halo": args.halo,
        "halo_backend": args.halo_backend,
        "halo_block_iters": args.halo_block_iters,
        "platform": "gpu" if device.type == "cuda" else device.type,
        "devices": len(set(mesh.devices)),
        **timer.summary(steps_per_sample=per),
    }))
    return 0


def cmd_bench(args):
    if args.mesh:
        return _bench_sharded(args)
    from .engine import Engine
    from .utils.profiling import StepTimer, trace_profile

    eng = Engine(_build_cfg(args), device=args.device)
    per = max(args.substeps, 1)
    eng.step(per, substeps_per_dispatch=per)  # builds the kernels; warm
    _sync(eng.state)
    timer = StepTimer(eng.device)
    ctx = trace_profile(args.profile) if args.profile else contextlib.nullcontext()
    with ctx:
        done = 0
        while done < args.steps:
            with timer:
                eng.step(per, substeps_per_dispatch=per)
            done += per
        _sync(eng.state)
    print(json.dumps({
        "preset": args.preset,
        "grid": list(eng.cfg.grid_shape),
        "profile": args.profile,
        **timer.summary(steps_per_sample=per),
    }))
    return 0


def cmd_presets(args):
    from .config import PRESETS

    for name in sorted(PRESETS):
        cfg = PRESETS[name]()
        print(f"{name:12s} ndim={cfg.ndim} grid={cfg.grid_shape} "
              f"dt={cfg.time_step} jacobi={cfg.jacobi_iters}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="fluidsim_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("bench", help="steady-state steps/sec")
    sp.add_argument("--preset", default="smoke32")
    sp.add_argument("--size", type=int, default=None)
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to step (the card unless the CPU is asked for)")
    sp.add_argument("--backend", choices=("auto", "pallas", "xla"), default=None,
                    help="kernel backend override (xla = the plain path, for A/B "
                    "comparisons; pallas = require the hand kernels)")
    sp.add_argument("--dtype", choices=("float32", "bfloat16"), default=None,
                    help="field storage dtype override")
    sp.add_argument("--solve-dtype", choices=("float32", "bfloat16"), default=None,
                    help="dtype of the resident pressure solve's iterate and rhs")
    sp.add_argument("--advect-substeps", type=int, default=None,
                    help="override the 3D substepped-advection count")
    sp.add_argument("--fuse-project-advect", action="store_true",
                    help="fuse the density advection into the projection kernel (K2)")
    sp.add_argument("--fuse-self-advect", action="store_true",
                    help="the whole step in one kernel (K8; implies "
                    "--fuse-project-advect)")
    sp.add_argument("--jacobi-sweep-block", type=int, default=None, metavar="T",
                    help="sweep blocking (K5) in the resident pressure solve")
    sp.add_argument("--steps", type=int, default=1000)
    sp.add_argument("--substeps", type=int, default=100,
                    help="steps per timed sample")
    sp.add_argument("--profile", default=None,
                    help="write a torch.profiler trace to this directory")
    sp.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="bench the slab-sharded step over an N-shard mesh "
                    "(BASELINE config 5: `bench --preset sharded512 --mesh 8`); "
                    "on one card, N shards on that card")
    sp.add_argument("--halo", choices=("auto", "explicit"), default="auto",
                    help="stencil strategy for --mesh (auto = the unsharded step, "
                    "explicit = per-shard kernels with halo exchanges)")
    sp.add_argument("--halo-backend", choices=("auto", "xla", "pallas", "rdma"),
                    default="auto", help="per-shard compute for --halo explicit "
                    "(pallas = K10/K11 with torch.cat exchanges; rdma = K12/K11 with "
                    "the exchanges in kernels, K12/K13)")
    sp.add_argument("--halo-block-iters", type=int, default=1, metavar="T",
                    help="communication-avoiding exchange cadence for --halo "
                    "explicit (T-deep halos every T sweeps)")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("presets", help="list presets")
    sp.set_defaults(fn=cmd_presets)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
