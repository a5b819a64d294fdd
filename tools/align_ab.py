#!/usr/bin/env python3
"""Time the alignment main paths, and train-mono's phases, of one checkout
on one card.

    python3 tools/align_ab.py ROOT LABEL [WARM_RUNS] [TRAIN_RUNS]

Imports ``chip_smoke.py`` from the checkout at ROOT (a directory holding it
and its ``montreal_forced_aligner_tpu_torch`` package), builds that
checkout's kernels, builds the smoke corpus and SAT-scale model, and runs
``chip_smoke.run_main_path`` for sat-2pass and sat-si with WARM_RUNS warm
runs each (default 5; 0 skips them). With TRAIN_RUNS (default 0), it then
trains ``chip_smoke.py``'s train-mono workload once unmeasured and
TRAIN_RUNS times with the card synchronised at each phase, and keeps each
run's wall and phase seconds. Prints one JSON line: LABEL and, per path,
the warm walls, their median, the synchronised run and its phases, the
fMLLR summary (null for sat-si) and the card's peak memory over the
path's runs.

To compare a change with its parent, unpack the parent with ``git archive``
into a git-ignored directory and run both in one call to the card,
alternating which runs first.
"""

import json
import statistics
import sys
import tempfile
import time
from pathlib import Path


def train_mono_runs(corpus_dir, dict_path, device, runs):
    """train-mono's stage (``chip_smoke.train_mono_phase``'s settings):
    one run to warm up, then ``runs`` synchronised runs."""
    import torch

    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    def run(sync):
        ta = TrainableAligner(
            corpus_dir, dict_path, recipe=[StageConfig("monophone", "mono", 4, 64)],
            batch_size=32, variable_length_topology=False, device=device,
        )
        ta.sync_phases = sync
        t0 = time.perf_counter()
        ta.train()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, dict(ta.phase_seconds)

    run(False)
    walls, phases = zip(*(run(True) for _ in range(runs)))
    return {"synced_walls_s": list(walls), "phases_synced_s": list(phases),
            "median_stats_s": statistics.median(p["stats"] for p in phases)}


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    label = sys.argv[2]
    warm = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    train_runs = int(sys.argv[4]) if len(sys.argv) > 4 else 0
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    from montreal_forced_aligner_tpu_torch.ops import cuda_build

    if Path(chip_smoke.__file__).resolve().parent != root:
        raise RuntimeError(f"imported {chip_smoke.__file__}, not {root}")
    cuda_build.build_all()
    device = torch.device("cuda")
    out = {"root": label}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        model_path, dict_path, words = chip_smoke.build_sat_scale_model(tmp)
        corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 64)
        for adaptation in (True, False) if warm else ():
            torch.cuda.reset_peak_memory_stats()
            report, _aligner, _calls = chip_smoke.run_main_path(
                model_path, dict_path, corpus_dir, tmp / f"tg{adaptation}", device,
                warm_runs=warm, adaptation=adaptation,
            )
            out[report["path"]] = {
                k: report[k] for k in ("warm_walls_s", "warm_median_wall_s",
                                       "synced_wall_s", "phases_synced_s",
                                       "fmllr")
            }
            out[report["path"]]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        if train_runs:
            out["train-mono"] = train_mono_runs(corpus_dir, dict_path, device,
                                                train_runs)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
