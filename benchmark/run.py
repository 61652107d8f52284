"""Run one cell of the port's benchmark once, on one CUDA card.

    python3 -m benchmark.run --workload m5-highsr.songs --seed 7 \\
        --seconds 20 --trace 0

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the
correctness check compared, with its limit (also the last lines of
standard error). Exits non-zero without a result line when no card is
found, when the program is missing, when the configuration's network has
no model family (or a training cell's family no training hooks), when a
module of JAX or of the JAX package is loaded, or when the trace and the
launch counters disagree.
Run from the root of a checkout; the kernel library builds there, under
the program's own ``_build/``, on the first run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # any kernel cache the libraries keep stays in the checkout, at a
    # fixed path, so that a second run finds what the first one built
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))

    from benchmark import families, harness, trace
    try:
        out, _ = harness.run(args.workload, args.seed, args.seconds,
                             trace=bool(args.trace))
    except (harness.RunError, trace.MeasurementError,
            families.FamilyError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return e.code
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
