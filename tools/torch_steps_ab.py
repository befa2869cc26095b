#!/usr/bin/env python3
"""Steps/s and device time a step of the PyTorch port's bench128,
vortex128, multi256 and sharded512 paths (sharded512 unsharded through
``Engine``, on 8 shards of one card through ``sharded_step_fn`` with the
rdma backend at T = 4, and, where more than one card is visible, the same
8 shards over every visible card, ``cli.mesh_devices``'s layout; on 8
shards of one card also with MacCormack at window 1, rdma at T = 4, and
with the FFT projection on ``halo="auto"``) for two or more checkouts,
alternated on the same cards.

Run from anywhere:  python3 tools/torch_steps_ab.py [--paths P1,P2] ROOT_A ROOT_B [...]

Each ROOT is the root of a checkout that holds ``fluidsim_tpu_torch/``;
``--paths`` keeps the named paths only (e.g. ``"sharded512 8 shards rdma"``).
The 8-shard path steps the checkout's own state type (a global state from
``shard_state`` in older checkouts, a ``ShardedState`` of one slab a shard
since the shards own their slabs) and also reports its device time by part
(``fluidsim_tpu_torch/utils/profiling.SHARDED_STEP_PARTS`` of this
checkout: K10/K12, K11, K13, K7e, ``torch.cat``, other copies, and the plain
ops, every other kernel; summed over the cards and over the shards'
streams, which overlap) and the peak device memory of each card over the
timed chunks.
The checkouts run in the order A, B, ..., then the reverse (A, B, B, A for
two), each in a fresh Python process that builds that checkout's kernels,
steps each path after its warm-up steps, and times five chunks of steps
with CUDA events, then takes the device time of more steps by kernel with
``torch.profiler``.  The paths are partly bound by the host, so two
checkouts are compared only within one run of this script.  Prints the card's name and power limit, then one
JSON line per process: for each path the median and the chunks of steps/s,
the device milliseconds per step and its five largest kernels.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

# (path, preset, steps a chunk, warm-up and profiled steps, cards for 8
# shards: None unsharded, 1 one card, 0 every visible card; the config's
# changes and the sharded step's options, where not rdma at T = 4)
PATHS = (("bench128", "preset_bench_128", 200, 20, None),
         ("vortex128", "preset_vortex_128", 50, 20, None),
         ("multi256", "preset_multi_emitter_256", 20, 10, None),
         ("sharded512", "preset_sharded_512", 5, 5, None),
         ("sharded512 8 shards rdma", "preset_sharded_512", 5, 5, 1),
         ("sharded512 8 shards rdma over the cards", "preset_sharded_512", 5, 5, 0),
         ("sharded512 8 shards maccormack", "preset_sharded_512", 3, 2, 1,
          dict(advection_scheme="maccormack", advect_window=1)),
         ("sharded512 8 shards fft", "preset_sharded_512", 2, 2, 1,
          dict(pressure_solver="fft"), dict(halo="auto")))
RDMA_T4 = dict(halo="explicit", halo_block_iters=4, halo_backend="rdma")
CHUNKS = 5


class Sharded:
    """sharded512's step on 8 shards (by default the rdma backend, T = 4) of
    one card (``cards=1``) or of every visible card (``cards=0``, shard r on
    card ⌊r·D/8⌋), with ``Engine``'s ``step`` and ``state``."""

    def __init__(self, cfg, cards: int = 1, options=None):
        import torch

        from fluidsim_tpu_torch.parallel import make_mesh, shard_state, sharded_step_fn
        from fluidsim_tpu_torch.state import zeros_state

        d = cards or min(8, torch.cuda.device_count())
        mesh = make_mesh(["cuda"] * 8 if d == 1 else
                         [torch.device("cuda", r * d // 8) for r in range(8)])
        self._step = sharded_step_fn(cfg, mesh, **(options or RDMA_T4))
        self.state = shard_state(zeros_state(cfg, "cuda"), mesh)
        self.devices = mesh.devices

    def step(self, n: int = 1) -> None:
        for _ in range(n):
            self.state = self._step(self.state)

    def finite(self) -> bool:
        slabs = getattr(self.state, "slabs", None)
        parts = [self.state.density] if slabs is None else [s.density for s in slabs]
        return all(bool(p.isfinite().all()) for p in parts)


def device_ms_per_step(eng, steps: int) -> dict:
    """Device milliseconds per step of ``eng``, by short kernel name and by
    the profiler's whole key."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.step(steps)
        torch.cuda.synchronize()
    out, by_key = {}, {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            ms = evt.self_device_time_total / 1e3 / steps
            name = evt.key.replace("(anonymous namespace)::", "").split("(")[0][:60]
            out[name] = out.get(name, 0.0) + ms
            by_key[evt.key] = by_key.get(evt.key, 0.0) + ms
    return out, by_key


def child(root: str, names) -> None:
    sys.path.insert(0, root)
    import torch

    import fluidsim_tpu_torch
    from fluidsim_tpu_torch import config
    from fluidsim_tpu_torch.engine import Engine

    if Path(fluidsim_tpu_torch.__file__).resolve().parent.parent != Path(root):
        raise SystemExit(f"imported {fluidsim_tpu_torch.__file__}, not from {root}")
    out = {"root": root}
    n_cards = torch.cuda.device_count()
    for name, preset, steps, warmup, cards, *options in PATHS:
        if names and name not in names:
            continue
        if cards == 0 and n_cards < 2:
            out[name] = f"not run: {n_cards} CUDA device visible"
            continue
        sharded = cards is not None
        cfg = getattr(config, preset)().replace(**(options[0] if options else {}))
        eng = (Sharded(cfg, cards, options[1] if len(options) > 1 else None) if sharded
               else Engine(cfg, device="cuda"))
        eng.step(warmup)
        for d in range(n_cards):
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        rates = []
        for _ in range(CHUNKS):
            torch.cuda.synchronize()
            start.record()
            eng.step(steps)
            end.record()
            end.synchronize()
            rates.append(steps * 1e3 / start.elapsed_time(end))
        for d in range(n_cards):
            torch.cuda.synchronize(d)
        peak = [torch.cuda.max_memory_allocated(d) / 1e9 for d in range(n_cards)]
        finite = eng.finite() if sharded else bool(torch.isfinite(eng.state.density).all())
        if not finite:
            raise SystemExit(f"{name}: non-finite density")
        by_kernel, by_key = device_ms_per_step(eng, warmup)
        out[name] = {"steps_per_s_median": statistics.median(rates), "chunks": rates,
                     "device_ms_per_step": sum(by_kernel.values()),
                     "top_kernels_ms": dict(sorted(by_kernel.items(),
                                                   key=lambda kv: -kv[1])[:5])}
        if sharded:
            out[name]["device_ms_by_key"] = by_key
            out[name]["peak_gb"] = peak[0] if cards == 1 else peak
            out[name]["cards"] = len(set(eng.devices))
        del eng
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(sys.argv[2], sys.argv[3].split(",") if len(sys.argv) > 3 else [])
        return
    args = sys.argv[1:]
    paths = ""
    if args[:1] == ["--paths"]:
        paths, args = args[1], args[2:]
    roots = [str(Path(r).resolve()) for r in args]
    if not roots:
        raise SystemExit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: none",
          flush=True)
    # The parts are this checkout's, whichever checkout a child measured.
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from fluidsim_tpu_torch.utils.profiling import sharded_step_part

    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", root]
                              + ([paths] if paths else []), cwd=root, timeout=900,
                              stdout=subprocess.PIPE, text=True)
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                out = json.loads(line)
                for path in out.values():
                    by_key = path.pop("device_ms_by_key", None) if isinstance(path, dict) \
                        else None
                    if by_key is not None:
                        parts = {}
                        for key, ms in by_key.items():
                            part = sharded_step_part(key)
                            parts[part] = parts.get(part, 0.0) + ms
                        path["device_ms_by_part"] = parts
                line = json.dumps(out)
            print(line, flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit code {proc.returncode}")


if __name__ == "__main__":
    main()
