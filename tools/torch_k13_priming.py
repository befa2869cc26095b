#!/usr/bin/env python3
"""K13's priming call of the sharded solve (``kernels/halo.halo_exchange_rdma``
on sharded512's x and x0 at depth 4, 8 shards of one card) by the kernel's
own device time, beside ``torch.cat`` building the same extended arrays.

Run from the root of a checkout:  python3 tools/torch_k13_priming.py

Prints the card's name and power limit, then one JSON line with, for K13
and for ``torch.cat``, milliseconds a shard's share:

* ``device_alone_ms``: ``torch.profiler`` device time of one share with the
  other shards idle: every shard's share issued onto one stream (the
  mesh's ``ShardOrder`` streams replaced by the current stream), so no two
  shares overlap;
* ``device_8_streams_ms``: the same on the mesh's 8 streams, where the
  shares run concurrently (each takes longer beside the others);
* ``events_ms``: a whole call over the 8 shards by CUDA events on the
  caller's stream, divided by 8 (the host's marks and waits included);
* ``kernels_a_call``: the kernels of that name a call launched.

The bound is the bytes the share moves once at the H100's 3.35 TB/s (every
local plane read, the 2·depth edge planes twice, every output plane
written), as ``chip_smoke.py`` counts it.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHARDS = 8
DEPTH = 4
REPS = 20


def main() -> None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    sys.path.insert(0, str(ROOT))
    from fluidsim_tpu_torch.config import preset_sharded_512
    from fluidsim_tpu_torch.kernels import _build
    from fluidsim_tpu_torch.kernels.halo import halo_exchange_rdma
    from fluidsim_tpu_torch.parallel.streams import order_of

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    _build.load_library()
    n = preset_sharded_512().current_size
    lz = n // SHARDS
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((n, n, n), device="cuda", generator=g)
    x0 = torch.randn((n, n, n), device="cuda", generator=g)
    by_shard = [[a[None], b[None]] for a, b in zip(torch.chunk(x, SHARDS), torch.chunk(x0, SHARDS))]
    zeros = [torch.zeros((1, DEPTH, n, n), device="cuda") for _ in range(2)]
    order = order_of([s[0] for s in by_shard])

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

    def device_ms(fn, key) -> tuple:
        """Device ms a shard's share of ``fn()``: the kernels whose name
        holds ``key``, summed, over REPS calls and the shards."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        us, count = 0.0, 0
        for evt in prof.key_averages():
            if evt.device_type == DeviceType.CUDA and key in evt.key:
                us += evt.self_device_time_total
                count += evt.count
        if count == 0:
            raise SystemExit(f"{key}: the profile holds no such kernel")
        return us / 1e3 / (REPS * SHARDS), count / REPS

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

    out = {}
    for name, fn, key in (("K13", k13, "exchange_kernel"),
                          ("torch.cat", scoped_cat, "CatArrayBatchedCopy")):
        with one_stream():
            alone, launches = device_ms(fn, key)
        streams, _ = device_ms(fn, key)
        out[name] = {"device_alone_ms": alone, "device_8_streams_ms": streams,
                     "events_ms": events_ms(fn), "kernels_a_call": launches}
    planes = 2 * (2 * lz + 2 * DEPTH)
    out["bound_ms"] = planes * n * n * 4 / 3.35e12 * 1e3
    out["shape"] = {"shards": SHARDS, "lz": lz, "n": n, "depth": DEPTH, "arrays": 2}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
