#!/usr/bin/env python3
"""How far alignments move with the batching, for one checkout on one card.

    python3 tools/speaker_stats_ab.py ROOT LABEL

Imports ``chip_smoke.py`` from the checkout at ROOT (a directory holding it
and its ``montreal_forced_aligner_tpu_torch`` package), builds that
checkout's kernels, the SAT-scale model and its lexicon, and:

- aligns the tone corpus's 8 utterances of 3-6 s over 2 speakers with the
  SAT-scale model (no pitch) at batch size 8 against 1, two-pass and single
  pass (``chip_smoke.batch_size_alignment``);
- trains ``chip_smoke.PITCH_RECIPE`` on the voiced corpus (64 utterances of
  2-30 s) and aligns the voiced 8 utterances with its archive the same way;
- aligns the voiced 4 utterances of one speaker each through the long path
  (``LONG_UTTERANCE_FRAMES`` lowered to 50, chunks of 128 frames) against
  the corpus path at batch size 32, single and two-pass
  (``chip_smoke.agreement``: frames, boundaries, the largest score
  difference).

These are the inputs of ``chip_smoke.py``'s ``pitch_batch_invariance``
line and of its pitch-paths long path; this tool reads them without the
phases' checks, so a parent and a change compare in one call. Prints one
JSON line.
"""

import json
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    label = sys.argv[2]
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    import montreal_forced_aligner_tpu_torch.online.alignment as online_mod
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.ops import long_viterbi as LV
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    if Path(chip_smoke.__file__).resolve().parent != root:
        raise RuntimeError(f"imported {chip_smoke.__file__}, not {root}")
    cuda_build.build_all()
    device = torch.device("cuda")
    out = {"root": label}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        model_path, dict_path, words = chip_smoke.build_sat_scale_model(tmp)
        small2, _ = chip_smoke.build_corpus(tmp, words, 8, min_s=3.0, max_s=6.0,
                                            seed=2, name="small2", num_speakers=2)
        out["without_pitch"] = chip_smoke.batch_size_alignment(
            model_path, dict_path, small2, device)
        corpus_dir, _ = chip_smoke.build_voiced_corpus(tmp, dict_path, 64, 2.0, 30.0,
                                                       name="pitch_corpus")
        voiced8, _ = chip_smoke.build_voiced_corpus(
            tmp, dict_path, 8, 3.0, 6.0, seed=2, name="pitch_small2", num_speakers=2)
        single, _ = chip_smoke.build_voiced_corpus(
            tmp, dict_path, 4, 2.0, 4.0, seed=7, name="pitch_single", num_speakers=4)
        t0 = time.perf_counter()
        ta = TrainableAligner(
            corpus_dir, dict_path,
            recipe=[StageConfig(n, k, it, g, num_leaves=lv)
                    for n, k, it, g, lv in chip_smoke.PITCH_RECIPE],
            batch_size=32, variable_length_topology=False, use_pitch=True,
            device=device)
        path = tmp / "pitch_sat.zip"
        ta.train().save(path)
        out["pitch_recipe_s"] = time.perf_counter() - t0
        out["with_pitch"] = chip_smoke.batch_size_alignment(path, dict_path, voiced8,
                                                            device)
        long_path = {}
        for key, adaptation in (("single_pass", False), ("two_pass", True)):
            aligner = PretrainedAligner(path, dict_path, AlignerConfig(
                batch_size=32, uses_speaker_adaptation=adaptation), device=device)
            want = aligner.align_corpus(Corpus.load(single))
            limit, chunk = online_mod.LONG_UTTERANCE_FRAMES, LV.CHUNK_FRAMES
            online_mod.LONG_UTTERANCE_FRAMES, LV.CHUNK_FRAMES = 50, 128
            try:
                got = aligner.align_corpus(Corpus.load(single))
            finally:
                online_mod.LONG_UTTERANCE_FRAMES, LV.CHUNK_FRAMES = limit, chunk
            long_path[key] = chip_smoke.agreement(got, want, aligner.frame_shift)
        out["long_path_against_corpus_path"] = long_path
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
