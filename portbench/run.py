"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, on a machine
with an NVIDIA card. Model files are written once into
``portbench/cache/`` (kept out of git); each run's inputs go to a
temporary directory under ``TMPDIR`` and are removed at its end. The last
line of standard output is the result's JSON object; the last lines of
standard error give each compared number beside its limit."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
CHECKOUT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / "cache"


def _environment() -> None:
    """Kernel and build caches at fixed paths inside the checkout; no
    library loads JAX on its own."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one thread in the numerical libraries' own pools: one process with
    # few threads, so the host-paced loops run steadily
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))

    import torch

    from portbench import harness

    # one intra-op thread: the program's host loops then run steadily
    # (Whisper's decode: 1.3% spread a window against 14-17% with the
    # default pool, NVIDIA H100 machine)
    torch.set_num_threads(1)
    manifest = harness.load_json(CHECKOUT / "BENCHMARK.json")
    workload = {w["name"]: w for w in manifest["workloads"]}.get(args.workload)
    if workload is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        print(f"the cell needs {workload['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    ctx = harness.make_context(manifest, args.workload, args.seed, args.seconds,
                               bool(args.trace), torch.device("cuda", 0), CACHE_DIR)
    try:
        result = harness.run_cell(ctx, t_start=T_START)
    finally:
        harness.cleanup(ctx)
    found = harness.forbidden_loaded()
    if found:
        print(f"modules that no run may load were loaded: {found}", file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    _environment()
    sys.exit(main())
