#!/usr/bin/env python3
"""How well a pitch model's per-speaker fMLLR is posed, by corpus.

    python3 tools/pitch_conditioning.py [--device cpu|cuda]

For each case (the stationary-tone corpus of ``chip_smoke.build_corpus``
with and without pitch, and the voiced corpus of
``chip_smoke.build_voiced_corpus`` with pitch), builds 24 utterances of
2-5 s over 8 speakers and 8 utterances of 3-6 s over 2 speakers from a
60-word lexicon, trains the recipe mono -> tri -> LDA -> SAT (2 / 2 / 3 /
3 iterations, 60 leaves, 400 Gaussians) on the first and runs
``MapAdapter`` on the second. Prints one JSON line per case: the standard
deviation of each raw pitch column over the training frames, the largest
row norm of ``lda.mat``, the largest condition number of a row's fMLLR
statistics ``G`` by adapted speaker, and the largest entry of the
transforms. Takes about a minute on the CPU.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
RECIPE = [("monophone", "mono", 2, 200, 0), ("triphone", "tri", 2, 400, 60),
          ("lda", "lda", 3, 400, 60), ("sat", "sat", 3, 400, 60)]


def case(tmp: Path, voiced: bool, use_pitch: bool, device) -> dict:
    import chip_smoke as C
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    _model, dict_path, words = C.build_sat_scale_model(tmp, num_words=60)
    if voiced:
        corpus, _ = C.build_voiced_corpus(tmp, dict_path, 24, 2.0, 5.0)
        adapt, _ = C.build_voiced_corpus(tmp, dict_path, 8, 3.0, 6.0, seed=2,
                                         name="adapt", num_speakers=2)
    else:
        corpus, _ = C.build_corpus(tmp, words, 24, 2.0, 5.0)
        adapt, _ = C.build_corpus(tmp, words, 8, 3.0, 6.0, seed=2, name="adapt",
                                  num_speakers=2)
    ta = TrainableAligner(
        corpus, dict_path,
        recipe=[StageConfig(n, k, it, g, num_leaves=lv) for n, k, it, g, lv in RECIPE],
        batch_size=8, variable_length_topology=False, use_pitch=use_pitch,
        device=device)
    final = ta.train()
    raw = np.concatenate([fb.raw[r, :L].cpu().numpy() for fb in ta.pipeline.batches
                          for r, L in enumerate(fb.frame_lengths)])
    path = tmp / "model.zip"
    final.save(path)
    stats = []
    with C._fmllr_statistics(stats):
        adapter = C._map_adapter(path, dict_path, 8, device)
        adapter.adapt(adapt)
    conds = [max(np.linalg.cond(G[s, d].astype(np.float64)) for d in range(G.shape[1]))
             for _K, G, _beta in stats for s in range(G.shape[0])]
    return {"corpus": "voiced" if voiced else "stationary tones", "pitch": use_pitch,
            "pitch_column_std": [float(x) for x in raw[:, 13:].std(axis=0)],
            "lda_row_norm_max": float(np.linalg.norm(final.lda_mat, axis=1).max()),
            "fmllr_G_cond_max_by_speaker": conds,
            "transforms_max_abs": float(np.abs(adapter.transforms).max())}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cpu")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    device = torch.device(args.device)
    for voiced, use_pitch in ((False, False), (False, True), (True, True)):
        with tempfile.TemporaryDirectory(prefix="pitch_cond_") as d:
            print(json.dumps(case(Path(d), voiced, use_pitch, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
