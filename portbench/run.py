"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program, ``fluidsim_tpu_torch/``.  The run needs as many CUDA cards
as the cell asks for: without them it exits 1 and prints no result.  The
last line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device`` and, traced, ``breakdown``, then
``checks``, each compared number beside its limit, which are also the last
lines of standard error.  The line before it holds the program's launch
counters over the window.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fluidsim_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    bench = harness.load_benchmark()
    chips = int(harness.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 1
    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START, bench)
    found = loaded_forbidden()
    if found:
        print(f"loaded in the benchmark's process: {', '.join(found)}", file=sys.stderr)
        return 1
    line = out["line"]
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["checks"].items()}
    print(json.dumps({"counters": out["counters"]}), flush=True)
    for k, (v, lim) in out["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
