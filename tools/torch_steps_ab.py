#!/usr/bin/env python3
"""Steps/s and device time a step of the PyTorch port's bench128,
vortex128, multi256 and sharded512 paths (sharded512 unsharded through
``Engine`` and on 8 shards of the card through ``sharded_step_fn`` with the
rdma backend at T = 4) for two or more checkouts, alternated on one CUDA
card.

Run from anywhere:  python3 tools/torch_steps_ab.py ROOT_A ROOT_B [...]

Each ROOT is the root of a checkout that holds ``fluidsim_tpu_torch/``.
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

# (path, preset, steps a chunk, warm-up and profiled steps, on 8 shards)
PATHS = (("bench128", "preset_bench_128", 200, 20, False),
         ("vortex128", "preset_vortex_128", 50, 20, False),
         ("multi256", "preset_multi_emitter_256", 20, 10, False),
         ("sharded512", "preset_sharded_512", 5, 5, False),
         ("sharded512 8 shards rdma", "preset_sharded_512", 5, 5, True))
CHUNKS = 5


class Sharded:
    """sharded512's step on 8 shards of the card (the rdma backend, T = 4)
    with ``Engine``'s ``step`` and ``state``."""

    def __init__(self, cfg):
        from fluidsim_tpu_torch.parallel import make_mesh, shard_state, sharded_step_fn
        from fluidsim_tpu_torch.state import zeros_state

        mesh = make_mesh(["cuda"] * 8)
        self._step = sharded_step_fn(cfg, mesh, halo="explicit", halo_block_iters=4,
                                     halo_backend="rdma")
        self.state = shard_state(zeros_state(cfg, "cuda"), mesh)

    def step(self, n: int = 1) -> None:
        for _ in range(n):
            self.state = self._step(self.state)


def device_ms_per_step(eng, steps: int) -> dict:
    """Device milliseconds per step of ``eng``, by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.step(steps)
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            name = evt.key.replace("(anonymous namespace)::", "").split("(")[0][:60]
            out[name] = out.get(name, 0.0) + evt.self_device_time_total / 1e3 / steps
    return out


def child(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import fluidsim_tpu_torch
    from fluidsim_tpu_torch import config
    from fluidsim_tpu_torch.engine import Engine

    if Path(fluidsim_tpu_torch.__file__).resolve().parent.parent != Path(root):
        raise SystemExit(f"imported {fluidsim_tpu_torch.__file__}, not from {root}")
    out = {"root": root}
    for name, preset, steps, warmup, sharded in PATHS:
        cfg = getattr(config, preset)()
        eng = Sharded(cfg) if sharded else Engine(cfg, device="cuda")
        eng.step(warmup)
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
        if not bool(torch.isfinite(eng.state.density).all()):
            raise SystemExit(f"{name}: non-finite density")
        by_kernel = device_ms_per_step(eng, warmup)
        out[name] = {"steps_per_s_median": statistics.median(rates), "chunks": rates,
                     "device_ms_per_step": sum(by_kernel.values()),
                     "top_kernels_ms": dict(sorted(by_kernel.items(),
                                                   key=lambda kv: -kv[1])[:5])}
        del eng
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return
    roots = [str(Path(r).resolve()) for r in sys.argv[1:]]
    if not roots:
        raise SystemExit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: none",
          flush=True)
    for root in roots + roots[::-1]:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", root],
                              cwd=root, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit code {proc.returncode}")


if __name__ == "__main__":
    main()
