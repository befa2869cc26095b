"""Command-line entry points (counterpart of ``fluidsim_tpu/cli.py``).

    python -m fluidsim_tpu_torch.cli run --preset plume64 --steps 200 --db runs.db
    python -m fluidsim_tpu_torch.cli render --preset vortex128 --steps 300 --html -o out
    python -m fluidsim_tpu_torch.cli save-config --preset plume64 -o cfg.json
    python -m fluidsim_tpu_torch.cli run --config cfg.json --steps 20 --checkpoint s.npz
    python -m fluidsim_tpu_torch.cli serve --preset scene_a
    python -m fluidsim_tpu_torch.cli bench --preset bench128 --steps 100
    python -m fluidsim_tpu_torch.cli bench --preset sharded512 --mesh 8 \\
        --halo explicit --halo-block-iters 4 --halo-backend rdma --dtype bfloat16
    python -m fluidsim_tpu_torch.cli presets

``run`` steps a simulation, logs its metrics to the SQLite store (``--db``)
and saves a checkpoint (``--checkpoint``); ``render`` writes frames (the 2D
colormap with streamlines, or the 3D raymarch; PNG where Pillow is
installed, else ``.npy``) and with ``--html`` a standalone player;
``save-config`` writes a preset's config as JSON, which ``--config`` reads
back (edit it first to change a field such as ``advect_window``); ``serve``
runs the live viewer in the browser.  ``run``, ``render``, ``serve`` and
``bench`` step on the card unless ``--device cpu`` asks for the CPU; without
a card they print an error and exit non-zero.  With ``--mesh N`` ``bench``
benches the slab-sharded step over an N-shard mesh (``parallel.sharding``)
on D = min(N, visible cards) cards, shard r on card ⌊r·D/N⌋
(``mesh_devices``; N must be a multiple of D, else it prints an error and
exits 1): D = 1 is N shards on one card, D = N one shard a card.  Each
shard runs on a stream of its own.  ``--halo-backend pallas`` runs K10 and
K11 per shard with ``torch.cat`` exchanges, ``rdma`` K12 and K11 with every
exchange in a kernel (K12, K13); either takes ``--dtype bfloat16`` fields.
The JSON line's ``devices`` counts the distinct cards.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np


def _build_cfg(args):
    from .config import get_preset
    from .io.checkpoint import load_config

    cfg = load_config(args.config) if getattr(args, "config", None) else get_preset(args.preset)
    if args.size:
        cfg = cfg.replace(size=args.size)
    if getattr(args, "backend", None):
        cfg = cfg.replace(kernel_backend=args.backend)
    if getattr(args, "dtype", None):
        cfg = cfg.replace(dtype=args.dtype)
    if getattr(args, "solve_dtype", None):
        cfg = cfg.replace(solve_dtype=args.solve_dtype)
    if getattr(args, "advect_substeps", None):
        cfg = cfg.replace(advection_scheme="substep", advect_substeps=args.advect_substeps)
    if getattr(args, "pulse_clock", None):
        cfg = cfg.replace(pulse_clock=args.pulse_clock)
    if getattr(args, "fuse_project_advect", False):
        cfg = cfg.replace(fuse_project_advect=True)
    if getattr(args, "fuse_self_advect", False):
        cfg = cfg.replace(fuse_project_advect=True, fuse_self_advect=True)
    if getattr(args, "jacobi_sweep_block", None):
        cfg = cfg.replace(jacobi_sweep_block=args.jacobi_sweep_block)
    return cfg


def _no_card(args) -> bool:
    """True (after printing the error) when the command is to step on the
    card and there is none: it never falls back to the CPU."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device: pass --device cpu for the CPU"}))
        return True
    return False


def _build_engine(args, store=None):
    from .engine import Engine

    return Engine(_build_cfg(args), device=args.device, store=store,
                  nan_guard=getattr(args, "nan_guard", False))


def _sync(state) -> None:
    """Wait for the step's work: a scalar read from the state."""
    int(state.step)


def mesh_devices(n_shards: int, n_cards: int) -> list:
    """The card of each of ``n_shards`` shards over D = min(N, ``n_cards``)
    cards: shard r on card ⌊r·D/N⌋, so each card holds N/D neighbouring
    shards.  Raises ``ValueError`` unless N is a multiple of D."""
    d = min(n_shards, n_cards)
    if d < 1 or n_shards % d:
        raise ValueError(f"{n_shards} shards do not split evenly over {d} cards "
                         f"({n_cards} visible): pass a --mesh that is a multiple of {d}")
    return [r * d // n_shards for r in range(n_shards)]


def _bench_sharded(args):
    """steps/sec of the slab-sharded step over an N-shard mesh (BASELINE
    config 5's measurement path: ``bench --preset sharded512 --mesh 8``).
    The mesh's N shards lie on the visible cards as ``mesh_devices`` maps
    them (or on ``--device cpu``); the state is a ``ShardedState`` (every
    shard owns its slabs) and every shard has its own launches on its own
    stream."""
    import torch

    from .parallel.sharding import make_mesh, shard_state, sharded_step_fn
    from .scene.obstacles import build_obstacle_mask
    from .state import zeros_state
    from .utils.profiling import StepTimer

    cfg = _build_cfg(args)
    if args.device == "cuda":
        try:
            cards = mesh_devices(args.mesh, torch.cuda.device_count())
        except ValueError as err:
            print(json.dumps({"error": str(err)}))
            return 1
        mesh = make_mesh([torch.device("cuda", i) for i in cards])
    else:
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
    from .utils.profiling import StepTimer, trace_profile

    eng = _build_engine(args)
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


def cmd_run(args):
    from .metrics import MetricsStore
    from .utils.profiling import StepTimer

    store = MetricsStore(args.db) if args.db else None
    try:
        eng = _build_engine(args, store=store)
        timer = StepTimer(eng.device)
        per = max(args.substeps, 1)
        done = 0
        sample_steps = []
        while done < args.steps:
            n = min(per, args.steps - done)
            with timer:
                eng.step(n, substeps_per_dispatch=n)
            sample_steps.append(n)
            done += n
        _sync(eng.state)
        summary = timer.summary(steps_per_sample=sample_steps)
        if args.checkpoint:
            eng.save_checkpoint(args.checkpoint)
    finally:
        if store is not None:
            store.close()
    print(json.dumps({
        "preset": args.preset,
        "grid": list(eng.cfg.grid_shape),
        "steps": int(eng.state.step),
        "run_id": eng.run_id,
        **summary,
    }))
    return 0


def cmd_render(args):
    eng = _build_engine(args)
    os.makedirs(args.outdir, exist_ok=True)
    frames = []
    stride = max(args.render_every, 1)
    for i in range(args.steps // stride):
        eng.step(stride, substeps_per_dispatch=stride)
        frame = _render(eng)
        frames.append(frame)
        _write_frame(frame, os.path.join(args.outdir, f"frame_{i:05d}"))
    html = None
    if args.html:
        from .render.viewer import export_html

        html = export_html(
            frames, os.path.join(args.outdir, "index.html"),
            title=f"{args.preset} ({eng.cfg.current_size}^{eng.cfg.ndim})",
        )
    print(json.dumps({
        "frames": len(frames),
        "outdir": args.outdir,
        "html": html,
        "shape": list(frames[-1].shape) if frames else None,
    }))
    return 0


def _render(eng) -> np.ndarray:
    """The engine's current frame as a host float32 array: the 3D raymarch
    ``(N, N, 3)``, or the 2D colormap ``(N, N, 4)`` with the streamlines
    drawn over it where the config shows them.  Computed on the engine's
    device; the streamlines are rasterized on the host."""
    from .config import ColorMode

    if eng.cfg.ndim == 3:
        from .render.raymarch import render_frame_3d

        return render_frame_3d(eng.state, eng.cfg).cpu().numpy()
    from .render.colormap import render_frame_2d
    from .render.streamlines import compute_streamline_segments, rasterize_streamlines

    frame = render_frame_2d(eng.state.density, eng.state.pressure, eng.state.obstacles,
                            eng.cfg, elapsed_time=float(eng.state.time)).cpu().numpy()
    if eng.cfg.show_streamlines or eng.cfg.color_mode == ColorMode.STREAMLINES:
        segs = compute_streamline_segments(eng.state.velocity[0], eng.state.velocity[1],
                                           eng.state.obstacles, eng.cfg)
        return rasterize_streamlines(segs, eng.cfg, base_frame=frame)
    return frame


def _write_frame(frame, path):
    arr = np.clip(np.asarray(frame, np.float32), 0.0, 1.0)
    try:
        from PIL import Image  # optional
    except ImportError:
        np.save(path + ".npy", arr)
        return
    img = (arr[::-1] * 255).astype(np.uint8)  # grid y-up → image y-down
    Image.fromarray(img, "RGB" if img.shape[-1] == 3 else "RGBA").save(path + ".png")


def cmd_save_config(args):
    from .config import get_preset
    from .io.checkpoint import save_config
    from .metrics import MetricsStore

    cfg = get_preset(args.preset)
    if args.out:
        save_config(args.out, cfg)
    run_id = -1
    if args.db:
        with MetricsStore(args.db) as store:
            run_id = store.save_run_params(cfg)
    print(json.dumps({"preset": args.preset, "out": args.out, "run_id": run_id}))
    return 0


def cmd_serve(args):
    from .metrics import MetricsStore
    from .render.live import LiveServer

    store = MetricsStore(args.db) if args.db else None
    try:
        LiveServer(_build_engine(args, store=store), port=args.port,
                   steps_per_frame=args.steps_per_frame).serve_forever()
    finally:
        if store is not None:
            store.close()
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

    def device(sp):
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to step (the card unless the CPU is asked for)")

    def common(sp, steps=100):
        sp.add_argument("--preset", default="smoke32")
        sp.add_argument("--config", default=None,
                        help="JSON config file (overrides --preset)")
        sp.add_argument("--size", type=int, default=None)
        device(sp)
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
        sp.add_argument("--steps", type=int, default=steps)
        sp.add_argument("--substeps", type=int, default=10,
                        help="steps per dispatch (metrics are read once a dispatch)")

    sp = sub.add_parser("run", help="run a simulation, log metrics")
    common(sp)
    sp.add_argument("--db", default=None, help="SQLite metrics db path")
    sp.add_argument("--checkpoint", default=None, help="save .npz at end")
    sp.add_argument("--nan-guard", action="store_true")
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("bench", help="steady-state steps/sec")
    common(sp)
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
    sp.set_defaults(fn=cmd_bench, substeps=100, steps=1000)

    sp = sub.add_parser("render", help="run + write frames")
    common(sp, steps=100)
    sp.add_argument("--outdir", "-o", default="frames")
    sp.add_argument("--render-every", type=int, default=5)
    sp.add_argument("--html", action="store_true",
                    help="write a standalone HTML player (index.html)")
    sp.add_argument("--nan-guard", action="store_true")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("save-config", help="persist a config (Save button)")
    sp.add_argument("--preset", default="scene_b")
    sp.add_argument("--out", "-o", default=None)
    sp.add_argument("--db", default=None)
    sp.set_defaults(fn=cmd_save_config)

    sp = sub.add_parser("serve", help="live interactive viewer (browser)")
    sp.add_argument("--preset", default="scene_a")
    sp.add_argument("--config", default=None)
    sp.add_argument("--size", type=int, default=None)
    device(sp)
    sp.add_argument("--port", type=int, default=8800)
    sp.add_argument("--steps-per-frame", type=int, default=2)
    sp.add_argument("--db", default=None,
                    help="SQLite store: the viewer's 's' (save config) writes a "
                    "SimulationRuns row here")
    # The interactive viewer defaults to the reference's wall-clock pulse
    # (elapsedTime, FluidSim.cs:394); "sim" gives deterministic pulsing.
    sp.add_argument("--pulse-clock", choices=("sim", "wall"), default="wall")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("presets", help="list presets")
    sp.set_defaults(fn=cmd_presets)

    args = p.parse_args(argv)
    if hasattr(args, "device") and _no_card(args):
        return 1
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
