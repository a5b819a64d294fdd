"""Readings that set the limits of a cell's check: for each seed, one short
run of the cell and, on the same sample, the control's readings (the
plain reference computed one precision below the configuration's, in the
program's place). One process for all seeds.

    python3 portbench/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line a seed: the seed, ``compared`` (the program's
readings beside the limits) and ``control``."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(BENCH_DIR.parent))
    import run as entry  # the benchmark's own environment

    entry._environment()
    import torch

    from portbench import harness

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    manifest = harness.load_json(BENCH_DIR.parent / "BENCHMARK.json")
    for seed in args.seeds:
        ctx = harness.make_context(manifest, args.workload, seed, args.seconds, False,
                                   torch.device("cuda", 0), entry.CACHE_DIR)
        try:
            r = harness.run_cell(ctx, control=True)
        finally:
            harness.cleanup(ctx)
        print(json.dumps({"seed": seed, "correct": r["correct"], "attempted": r["attempted"],
                          "metrics": r["metrics"], "compared": r["compared"],
                          "control": r["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
