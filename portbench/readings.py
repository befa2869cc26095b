"""The readings the comparison's limits are set from: the numbers compared
in runs of one cell on many seeds, all in one process (the kernel library
loaded once), for the program as the configuration states it or, with
``--control``, for the control: the program with its bfloat16 fields, the
precision below the configuration's float32.  The benchmark's own runs never
run this.

    python3 portbench/readings.py --workload CELL --seeds 1,2,3 --seconds S [--control]

One JSON line a seed: the seed, whether it was the control, ``correct`` and
each compared number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    over = {"dtype": "bfloat16"} if args.control else None
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(args.workload, seed, args.seconds, False, "cuda",
                               program_overrides=over)
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": out["line"]["correct"],
                          "checks": {k: v for k, (v, _) in out["checks"].items()},
                          "steps_per_s": out["line"]["metrics"].get("steps_per_s"),
                          "setup_s": out["line"]["metrics"]["setup_s"]["value"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
