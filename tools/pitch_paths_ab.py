#!/usr/bin/env python3
"""Time the pitch-paths phase, and pitch itself, of one checkout on one card.

    python3 tools/pitch_paths_ab.py ROOT LABEL [PITCH_RUNS]

Imports ``chip_smoke.py`` from the checkout at ROOT (a directory holding it
and its ``montreal_forced_aligner_tpu_torch`` package), builds that
checkout's kernels and the SAT-scale model's lexicon, and runs
``chip_smoke.pitch_paths_phase``: the pitch recipe, its align, adapt,
fine-tune and long path on the voiced corpus. It then times
``ops.pitch.compute_pitch_batch`` over that corpus (64 utterances of 2-30
s) in batches of 32, corpus order, PITCH_RUNS times (default 3), the card
synchronised, and aligns the phase's 8-utterance corpus with its pitch
archive at batch size 8 against 1 (this tool's own
``chip_smoke.batch_size_alignment`` on ROOT's package). Prints one JSON
line: LABEL, the phase's wall less its batch-invariance check (which a
checkout without it does not run), each path's wall, the fine-tune's
pitch seconds, the pitch runs' walls and the batch sizes' alignments.

To compare a change with its parent, unpack the parent with ``git archive``
into a git-ignored directory and run both in one call to the card,
alternating which runs first.
"""

import importlib.util
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    label = sys.argv[2]
    pitch_runs = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.ops import pitch as PP

    if Path(chip_smoke.__file__).resolve().parent != root:
        raise RuntimeError(f"imported {chip_smoke.__file__}, not {root}")
    cuda_build.build_all()
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        _model, dict_path, _words = chip_smoke.build_sat_scale_model(tmp)
        t0 = time.perf_counter()
        report = chip_smoke.pitch_paths_phase(dict_path, tmp, device)
        wall = time.perf_counter() - t0
        invariance = report.pop("batch_invariance", None)
        if invariance is not None:
            wall -= invariance["wall_s"]
        waves = Corpus.load(tmp / "pitch_corpus").load_audio_parallel(16000)
        walls = []
        for _ in range(pitch_runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for lo in range(0, len(waves), 32):
                part = waves[lo : lo + 32]
                lens = np.array([len(w) for w in part], np.int32)
                buf = np.zeros((len(part), int(lens.max())), np.float32)
                for r, w in enumerate(part):
                    buf[r, : len(w)] = w
                PP.compute_pitch_batch(buf, lens, device=device)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        # this checkout's comparison, run on ROOT's package
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_here", Path(__file__).resolve().parent.parent / "chip_smoke.py")
        here = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(here)
        by_batch = here.batch_size_alignment(tmp / "pitch_sat.zip", dict_path,
                                             tmp / "pitch_small2", device)
    out = {
        "root": label,
        "phase_wall_s": wall,
        "recipe_wall_s": report["recipe"]["wall_s"],
        "align_wall_s": report["align"]["wall_s"],
        "adapt_card_and_cpu_wall_s": report["adapt"]["card_and_cpu_wall_s"],
        "fine_tune_s": report["fine_tune"]["fine_tune_s"],
        "fine_tune_pitch_s": report["fine_tune"]["pitch_s"],
        "long_path_wall_s": {k: v["wall_s"] for k, v in report["long_path"].items()
                             if isinstance(v, dict)},
        "long_path_against_corpus_path": {
            k: v["against_corpus_path"] for k, v in report["long_path"].items()
            if isinstance(v, dict)},
        "corpus_pitch_walls_s": walls,
        "corpus_pitch_median_s": statistics.median(walls),
        "batch_invariance": invariance,
        "align_batch_8_against_1": by_batch,
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
