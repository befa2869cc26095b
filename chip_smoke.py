#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fluidsim_tpu_torch``) on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit code on failure:
  1. require a CUDA device (no CPU fallback) and print the card's name and
     power limit;
  2. build the hand kernels (K1, K2) from ``fluidsim_tpu_torch/csrc``;
  3. hold each kernel against its plain PyTorch twin on the card at 128³
     on bench128-scale inputs made with NumPy from a seed;
  4. step bench128 at 128³ through ``Engine(cfg, device="cuda")`` for
     ``STEPS`` steps with the launch counters reset just before: every
     kernel of the path must have launched, the fields stay finite, the
     emitted mass grows, the plume rises, and the first 10 steps stay
     within the bf16-solve bound of a rollout of the kernels' twins;
  5. time the kernel path and the twin path (steps/s), the p50
     step+raymarch frame, and each kernel beside its twin, with CUDA events
     after warm-up.
The line before last is a JSON object describing each kernel; the last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
STEPS = 200
SEED = 128


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def smooth(n, rng, modes=6):
    """A sum of random low-wavenumber plane waves, unit amplitude."""
    import numpy as np

    ax = np.arange(n, dtype=np.float32)
    out = np.zeros((n, n, n), np.float32)
    for _ in range(modes):
        k = rng.integers(-3, 4, size=3)
        phase = np.float32(rng.uniform(0, 2 * np.pi))
        w = (2 * np.pi / n) * k.astype(np.float32)
        out += np.sin(w[0] * ax[:, None, None] + w[1] * ax[None, :, None]
                      + w[2] * ax[None, None, :] + phase)
    return out / np.float32(np.sqrt(modes))


def worst(got, ref, rtol: float, atol: float):
    """(max abs error, whether |got − ref| ≤ atol + rtol·|ref| everywhere)."""
    import torch

    diff = (got - ref).abs()
    ok = bool(torch.all(diff <= atol + rtol * ref.abs()))
    return float(diff.max()), ok


def main() -> None:
    # -- 1. the card ---------------------------------------------------
    try:
        import numpy as np
        import torch
    except ImportError as exc:
        fail(f"PyTorch and NumPy are needed: {exc}")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke run needs the card")
    if not (ROOT / "fluidsim_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no fluidsim_tpu_torch/)")
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    say(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    say(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # -- 2. build --------------------------------------------------------
    from fluidsim_tpu_torch.config import preset_bench_128
    from fluidsim_tpu_torch.engine import Engine
    from fluidsim_tpu_torch.kernels import _build
    from fluidsim_tpu_torch.kernels.advect import (
        advect_multi_3d_kernel,
        advect_multi_3d_plain,
    )
    from fluidsim_tpu_torch.kernels.resident import (
        project_advect_density_3d,
        project_advect_density_3d_plain,
    )
    from fluidsim_tpu_torch.models.stable3d import PLAIN_TWINS, sink_factor
    from fluidsim_tpu_torch.render.raymarch import render_frame_3d
    from fluidsim_tpu_torch.scene.sources import apply_custom_source

    t0 = time.perf_counter()
    _build.load_library()
    say(f"# build: {time.perf_counter() - t0:.2f} s")
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Function properties" in line or "registers" in line \
                    or "spill" in line or "Compiling entry" in line:
                say(f"# ptxas: {line.strip()}")

    # -- 3. each kernel against its twin at 128³ -------------------------
    cfg = preset_bench_128()
    n = cfg.current_size
    dt = cfg.effective_params()[0]
    damp = sink_factor(dt, cfg.velocity_damping)
    ddamp = sink_factor(dt, cfg.density_dissipation)
    rng = np.random.default_rng(SEED)
    # Plume-scale fields: |v| up to about 10 cells per unit time (a
    # backtrace of up to ~1.3 cells, so the window clamp is exercised) and
    # a positive density.
    vel = torch.from_numpy(np.stack([smooth(n, rng) for _ in range(3)]) * 4.0).to(dev)
    dens = torch.from_numpy(np.maximum(20.0 * (1.0 + smooth(n, rng)), 0.0)).to(dev)
    buoy = (dens, cfg.buoyancy, cfg.ambient_density, cfg.gravity)
    solve = cfg.solve_dtype

    def k1():
        return advect_multi_3d_kernel((1, 2, 3), vel, vel, dt, buoy=buoy)

    def k1_plain():
        return advect_multi_3d_plain((1, 2, 3), vel, vel, dt, buoy=buoy)

    def k2():
        return project_advect_density_3d(vel, dens, cfg.jacobi_iters, dt,
                                         solve_dtype=solve, damp=damp,
                                         dens_damp=ddamp)

    def k2_plain():
        return project_advect_density_3d_plain(vel, dens, cfg.jacobi_iters, dt,
                                               solve_dtype=solve, damp=damp,
                                               dens_damp=ddamp)

    got, ref = k1(), k1_plain()
    torch.cuda.synchronize()
    k1_err, ok = worst(got, ref, 1e-5, 1e-6)
    say(f"# K1 vs twin at {n}^3: max abs err {k1_err!r} "
        f"(bitwise {torch.equal(got, ref)}; bound rtol 1e-5, atol 1e-6)")
    if not ok:
        fail("K1 disagrees with its twin")
    got, ref = k2(), k2_plain()
    torch.cuda.synchronize()
    k2_err = 0.0
    for name, g, r in zip(("velocity", "pressure", "density"), got, ref):
        err, ok = worst(g, r, 0.0, 2e-2 * float(r.abs().max()))
        k2_err = max(k2_err, err)
        say(f"# K2 vs twin at {n}^3 ({name}): max abs err {err!r} "
            f"(bitwise {torch.equal(g, r)}; bound 2e-2 x max|ref|)")
        if not ok or g.shape != r.shape:
            fail(f"K2 {name} disagrees with its twin")

    # -- 4. the main path through Engine -----------------------------------
    eng = Engine(cfg, device="cuda")
    ys = torch.arange(n, dtype=torch.float64, device=dev)[None, :, None]

    def mass_and_com_y(state):
        d = state.density.double()
        m = d.sum()
        return float(m), float((d * ys).sum() / m)

    advect_multi_3d_kernel.launches = 0
    project_advect_density_3d.launches = 0
    eng.step(1)
    mass1, com1 = mass_and_com_y(eng.state)
    eng.step(9)
    at10 = {k: getattr(eng.state, k).clone() for k in ("density", "velocity")}
    eng.step(30)
    mass40, com40 = mass_and_com_y(eng.state)
    eng.step(STEPS - 40)
    torch.cuda.synchronize()
    launches = {"K1": advect_multi_3d_kernel.launches,
                "K2": project_advect_density_3d.launches}
    mass_end, com_end = mass_and_com_y(eng.state)
    say(f"# main path: {STEPS} steps at {n}^3, launches {launches}")
    say(f"# density mass: step 1 {mass1!r}, step 40 {mass40!r}, step {STEPS} {mass_end!r}")
    say(f"# density y centre of mass: step 1 {com1!r}, step 40 {com40!r}, "
        f"step {STEPS} {com_end!r}")
    if min(launches.values()) <= 0:
        fail(f"a kernel of the path never launched: {launches}")
    st = eng.state
    if int(st.step) != STEPS or tuple(st.velocity.shape) != (3, n, n, n) \
            or tuple(st.density.shape) != (n, n, n):
        fail("unexpected state shape or step count")
    for name in ("density", "velocity", "pressure"):
        if not bool(torch.isfinite(getattr(st, name)).all()):
            fail(f"non-finite {name}")
    if not (mass_end > mass40 > mass1 > 0.0):
        fail("density mass does not grow")
    if not com40 > com1:
        fail("the plume does not rise over the first 40 steps")

    twin = Engine(cfg, device="cuda", kernels=PLAIN_TWINS)
    twin.step(10)
    for name, bound in (("density", 1e-5), ("velocity", 1e-3)):
        r = getattr(twin.state, name)
        err = float((at10[name] - r).abs().max())
        scale = float(r.abs().max())
        say(f"# kernel path vs twin path, 10 steps, {name}: max abs diff {err!r} "
            f"(bound {bound} x {scale!r})")
        if err > bound * scale:
            fail(f"kernel path drifts from the twin path in {name}")

    # -- 5. timing -------------------------------------------------------
    say(f"# timing on {card}")
    step_ms = cuda_ms(lambda: eng.step(1), reps=200, warmup=20)
    twin_ms = cuda_ms(lambda: twin.step(1), reps=10, warmup=2)
    say(f"steps/s kernel path: {1e3 / step_ms!r} ({step_ms!r} ms/step) [{card}]")
    say(f"steps/s twin path: {1e3 / twin_ms!r} ({twin_ms!r} ms/step) [{card}]")

    def frame():
        eng.step(1)
        return render_frame_3d(eng.state, cfg).mean()

    chunks = []
    for _ in range(7):
        chunks.append(cuda_ms(frame, reps=50, warmup=0 if chunks else 5))
    p50 = float(np.percentile(chunks, 50))
    say(f"p50 step+raymarch frame: {p50!r} ms (chunks {chunks}) [{card}]")

    t = eng.state.time + dt
    emitter_ms = cuda_ms(lambda: apply_custom_source(
        eng.state.density, eng.state.velocity, cfg, t), reps=50)
    say(f"emitter (plain torch) at {n}^3: {emitter_ms!r} ms [{card}]")
    times = {
        "K1": (cuda_ms(k1, reps=100), cuda_ms(k1_plain, reps=10)),
        "K2": (cuda_ms(k2, reps=50), cuda_ms(k2_plain, reps=3)),
    }
    for name, (ms, plain_ms) in times.items():
        say(f"{name} at {n}^3: kernel {ms!r} ms, twin {plain_ms!r} ms [{card}]")

    report = [
        {"name": "K1 advect_multi_3d_kernel (self-advection, buoyancy folded)",
         "route": "cuda", "source": "fluidsim_tpu_torch/csrc/advect.cu",
         "replaces": "fluidsim_tpu/pallas/advect.py:256",
         "launches": launches["K1"], "max_abs_err": k1_err,
         "ms": times["K1"][0], "plain_ms": times["K1"][1]},
        {"name": "K2 project_advect_density_3d (projection + density advection)",
         "route": "cuda", "source": "fluidsim_tpu_torch/csrc/project_advect.cu",
         "replaces": "fluidsim_tpu/pallas/resident.py:1155",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": times["K2"][0], "plain_ms": times["K2"][1]},
    ]
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
