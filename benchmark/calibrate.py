"""Readings of a cell's check over many seeds in one process.

    python3 -m benchmark.calibrate --workload m5-highsr.songs \\
        --seeds 11,12,13 --seconds 3 [--control tf32] [--fault NAME]

For each seed: the run's set-up, a short window (none for a training
control) and the check, as ``benchmark.run`` makes them; one JSON line a
seed with every reading. ``--control tf32`` puts the reference, its convs
in TF32, in the program's place; ``--fault`` plants one of
``faults.py``'s faults in the program. The readings are what a limit is
set from: the largest that sound runs give, the smallest that the control
and the faults give. Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", choices=("tf32",))
    ap.add_argument("--fault")
    args = ap.parse_args(argv)
    from benchmark import faults, harness
    plant = faults.ALL[args.fault] if args.fault else contextlib.nullcontext
    for seed in (int(s) for s in args.seeds.split(",")):
        with plant():
            out, checks = harness.run(args.workload, seed, args.seconds,
                                      control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "correct": out["correct"], "readings": checks,
                          "metrics": out["metrics"]}), flush=True)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
