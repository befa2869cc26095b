#!/usr/bin/env python3
"""K13's priming call of the sharded solve (``kernels/halo.halo_exchange_rdma``
on sharded512's x and x0 at depth 4, 8 shards of one card) by the kernel's
own device time, beside ``torch.cat`` building the same extended arrays, and
the 8-shard step around it; for one checkout or several, alternated.

Run from the root of a checkout:  python3 tools/torch_k13_priming.py [ROOT ...]

With no ROOT it measures this checkout; with ROOTs each runs in a fresh
process in the order A, B, ..., then the reverse (A, B, B, A for two).
Prints the card's name and power limit, then one JSON line a process with,
for K13 and for ``torch.cat``, milliseconds a shard's share or a call:

* ``device_alone_ms``: ``torch.profiler`` device time of one share with the
  other shards idle: every shard's share issued onto one stream (the
  mesh's ``ShardOrder`` streams replaced by the current stream), so no two
  shares overlap;
* ``device_8_streams_ms``: the same on the mesh's 8 streams, where the
  shares run concurrently (each takes longer beside the others);
* ``union_8_streams_ms``: on the 8 streams, the union of the intervals of a
  call's kernels (the 8 shares, or the 16 cats) in the trace: the time the
  card spends on a call's exchange, where summed durations of overlapping
  kernels are not; ``union_tb_per_s``: a call's bytes (8 shares) over it;
  ``overlap_factor``: summed durations over the union (1: no two of the
  call's kernels overlap);
* ``events_ms``: a whole call over the 8 shards by CUDA events on the
  caller's stream, divided by 8 (the host's marks and waits included);
* ``kernels_a_call``: the kernels of that name a call launched;

and for sharded512's step on the 8 shards at T = 4 (``"rdma"``: K12 rounds
and K13 exchanges; ``"pallas"``: K10 rounds and ``torch.cat`` exchanges):
steps/s (the median of five chunks by CUDA events) and, from a trace of
``STEP_TRACED`` steps, a step's union of the exchange kernels, their summed
durations, the union of the round kernels (``jacobi_round_kernel``) and
the time both run at once.

The bound is the bytes the share moves once at the H100's 3.35 TB/s (every
local plane read, the 2·depth edge planes twice, every output plane
written), as ``chip_smoke.py`` counts it.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHARDS = 8
DEPTH = 4
REPS = 20
STEP_CHUNK = 5
STEP_TRACED = 3
ROUND_KERNEL = "jacobi_round_kernel"


def union_ms(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals (µs) in ms."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_ms(xs, ys) -> float:
    """The time (ms) inside both unions."""
    xs, ys = merged(xs), merged(ys)
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e3


def kernel_intervals(prof, key):
    """The device intervals (µs) of the kernels whose name holds ``key``."""
    from torch.autograd import DeviceType

    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA and key in e.name]


def child(root: Path) -> None:
    sys.path.insert(0, str(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import fluidsim_tpu_torch
    from fluidsim_tpu_torch.config import preset_sharded_512
    from fluidsim_tpu_torch.kernels import _build
    from fluidsim_tpu_torch.kernels.halo import halo_exchange_rdma
    from fluidsim_tpu_torch.parallel import make_mesh, shard_state, sharded_step_fn
    from fluidsim_tpu_torch.parallel.streams import order_of
    from fluidsim_tpu_torch.state import zeros_state

    if Path(fluidsim_tpu_torch.__file__).resolve().parent.parent != root.resolve():
        raise SystemExit(f"imported {fluidsim_tpu_torch.__file__}, not from {root}")
    _build.load_library()
    cfg = preset_sharded_512()
    n = cfg.current_size
    lz = n // SHARDS
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, n, n), device="cuda", generator=g)
    x0 = torch.randn((n, n, n), device="cuda", generator=g)
    by_shard = [[a[None], b[None]] for a, b in zip(torch.chunk(x, SHARDS), torch.chunk(x0, SHARDS))]
    zeros = [torch.zeros((1, DEPTH, n, n), device="cuda") for _ in range(2)]
    order = order_of([s[0] for s in by_shard])
    nbytes = SHARDS * 2 * (2 * lz + 2 * DEPTH) * n * n * 4

    def k13():
        halo_exchange_rdma(by_shard, DEPTH)

    def cat():
        for r in range(SHARDS):
            with order.on(r):
                [torch.cat([by_shard[r - 1][j][:, -DEPTH:] if r > 0 else zeros[j], a,
                            by_shard[r + 1][j][:, :DEPTH] if r < SHARDS - 1 else zeros[j]], 1)
                 for j, a in enumerate(by_shard[r])]

    def scoped_cat():
        with order.scope():
            marks = order.marks()
            for r in range(SHARDS):
                order.wait(r, marks, r - 1, r + 1)
            cat()

    @contextlib.contextmanager
    def one_stream():
        saved = order.streams
        order.streams = (torch.cuda.current_stream(),) * SHARDS
        try:
            yield
        finally:
            order.streams = saved

    def traced(fn, reps):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return prof

    def device_ms(fn, key) -> dict:
        """A shard's share of ``fn()`` (the kernels whose name holds
        ``key``: summed, over REPS calls and the shards) and a call's union."""
        spans = kernel_intervals(traced(fn, REPS), key)
        if not spans:
            raise SystemExit(f"{key}: the profile holds no such kernel")
        summed = sum(b - a for a, b in spans) / 1e3
        union = union_ms(spans) / REPS
        return {"share_ms": summed / (REPS * SHARDS), "union_ms": union,
                "overlap_factor": summed / REPS / union, "launches": len(spans) / REPS}

    def events_ms(fn) -> float:
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS / SHARDS

    out = {"root": str(root)}
    for name, fn, key in (("K13", k13, "exchange_kernel"),
                          ("torch.cat", scoped_cat, "CatArrayBatchedCopy")):
        with one_stream():
            alone = device_ms(fn, key)
        streams = device_ms(fn, key)
        out[name] = {"device_alone_ms": alone["share_ms"],
                     "device_8_streams_ms": streams["share_ms"],
                     "union_8_streams_ms": streams["union_ms"],
                     "union_tb_per_s": nbytes / (streams["union_ms"] * 1e-3) / 1e12,
                     "overlap_factor": streams["overlap_factor"],
                     "events_ms": events_ms(fn), "kernels_a_call": streams["launches"]}
    out["bound_ms"] = nbytes / SHARDS / 3.35e12 * 1e3
    out["shape"] = {"shards": SHARDS, "lz": lz, "n": n, "depth": DEPTH, "arrays": 2}
    del x, x0, by_shard, zeros
    torch.cuda.empty_cache()

    # The 8-shard step at T = 4 on both exchange backends.
    mesh = make_mesh(["cuda"] * SHARDS)
    for backend, exchange in (("rdma", "exchange_kernel"), ("pallas", "CatArrayBatchedCopy")):
        step = sharded_step_fn(cfg, mesh, halo="explicit", halo_block_iters=4,
                               halo_backend=backend)
        state = [shard_state(zeros_state(cfg, "cuda"), mesh)]

        def run(steps, step=step, state=state):
            for _ in range(steps):
                state[0] = step(state[0])

        run(STEP_CHUNK)
        rates = []
        for _ in range(5):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            torch.cuda.synchronize()
            start.record()
            run(STEP_CHUNK)
            end.record()
            end.synchronize()
            rates.append(STEP_CHUNK * 1e3 / start.elapsed_time(end))
        prof = traced(lambda: run(1), STEP_TRACED)
        ex, rounds = kernel_intervals(prof, exchange), kernel_intervals(prof, ROUND_KERNEL)
        out[f"step {backend}"] = {
            "steps_per_s_median": statistics.median(rates), "chunks": rates,
            "exchange_union_ms": union_ms(ex) / STEP_TRACED,
            "exchange_summed_ms": sum(b - a for a, b in ex) / 1e3 / STEP_TRACED,
            "rounds_union_ms": union_ms(rounds) / STEP_TRACED,
            "exchange_beside_rounds_ms": overlap_ms(ex, rounds) / STEP_TRACED}
        del state, step
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--child"]:
        child(Path(sys.argv[2]))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: none",
          flush=True)
    roots = [Path(r).resolve() for r in sys.argv[1:]] or [ROOT]
    order = roots + roots[::-1] if len(roots) > 1 else roots
    for root in order:
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", str(root)],
                       cwd=root, check=True, timeout=1200)


if __name__ == "__main__":
    main()
