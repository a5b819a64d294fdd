#!/usr/bin/env python3
"""The pitch archive's ``adapt``, card against CPU, read without the check.

    python3 tools/adapt_card_cpu.py train ROOT OUT_DIR
    python3 tools/adapt_card_cpu.py adapt ROOT OUT_DIR ARCHIVE [--save T.npy | --force T.npy]

Imports ``chip_smoke.py`` from the checkout at ROOT (a directory holding it
and its ``montreal_forced_aligner_tpu_torch`` package) and builds its
kernels. ``train`` trains ``chip_smoke.PITCH_RECIPE`` on the voiced corpus
(64 utterances of 2-30 s) with ROOT's code and saves OUT_DIR/pitch_sat.zip.
``adapt`` runs ``chip_smoke.adapt_card_vs_cpu`` with ROOT's code on the
voiced 8 utterances of 2 speakers and ARCHIVE (from either checkout), its
checks reported instead of raised: the means' difference over the largest
mean (the check's bar is 1e-5), the transforms' difference, and the eight
mean entries that differ most with their Gaussians' occupancies on either
device. ``--save`` keeps the card's transforms (and the CPU's own, in
T.npy.cpu.npy); ``--force`` makes both runs align pass 2 with the
transforms of T.npy, so checkouts compare under one set. Prints one JSON
line.
"""

import json
import sys
import types
from pathlib import Path


def main() -> int:
    mode, root, out = sys.argv[1], Path(sys.argv[2]).resolve(), Path(sys.argv[3])
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke
    import montreal_forced_aligner_tpu_torch.training.adapt as AD
    from montreal_forced_aligner_tpu_torch.ops import cuda_build

    if Path(chip_smoke.__file__).resolve().parent != root:
        raise RuntimeError(f"imported {chip_smoke.__file__}, not {root}")
    cuda_build.build_all()
    device = torch.device("cuda")
    out.mkdir(parents=True, exist_ok=True)
    _model, dict_path, _words = chip_smoke.build_sat_scale_model(out)
    if mode == "train":
        from montreal_forced_aligner_tpu_torch.training.trainer import (
            StageConfig,
            TrainableAligner,
        )

        corpus_dir, _ = chip_smoke.build_voiced_corpus(out, dict_path, 64, 2.0, 30.0,
                                                       name="pitch_corpus")
        ta = TrainableAligner(
            corpus_dir, dict_path,
            recipe=[StageConfig(n, k, it, g, num_leaves=lv)
                    for n, k, it, g, lv in chip_smoke.PITCH_RECIPE],
            batch_size=32, variable_length_topology=False, use_pitch=True,
            device=device)
        ta.train().save(out / "pitch_sat.zip")
        print(json.dumps({"mode": mode, "root": root.name}), flush=True)
        return 0

    archive = sys.argv[4]
    flag, tfile = (sys.argv[5], sys.argv[6]) if len(sys.argv) > 6 else (None, None)
    small2, _ = chip_smoke.build_voiced_corpus(out, dict_path, 8, 3.0, 6.0, seed=2,
                                               name="pitch_small2", num_speakers=2)
    made, kept = [], []
    real_adapter, real_update = chip_smoke._map_adapter, AD.MapAdapter._map_update

    def adapter(*a, **k):
        ad = real_adapter(*a, **k)
        made.append(ad)
        if flag == "--force":
            forced = np.load(tfile)
            estimate = type(ad)._estimate_fmllr

            def est(self, pipeline, gmm):
                estimate(self, pipeline, gmm)
                self.transforms = forced
                return forced

            ad._estimate_fmllr = types.MethodType(est, ad)
        return ad

    def update(self, gmm, acc):
        new = real_update(self, gmm, acc)
        kept.append((acc.occ.copy(), new.get_means().astype(np.float64)))
        return new

    failed = []
    chip_smoke._map_adapter = adapter
    chip_smoke._check = lambda cond, msg: cond or failed.append(msg)
    AD.MapAdapter._map_update = update
    rep = chip_smoke.adapt_card_vs_cpu(archive, dict_path, small2, device, 32)
    if flag == "--save":
        np.save(tfile, made[0].transforms)
        np.save(tfile + ".cpu.npy", made[1].transforms)
    # the final model's update on the card, then on the CPU
    (occ_card, mean_card), _si, (occ_cpu, mean_cpu), _si2 = kept
    fin = np.isfinite(mean_cpu)
    diff = np.where(fin, np.abs(mean_card - mean_cpu), 0.0)
    scale = float(np.abs(mean_cpu[fin]).max())
    top = []
    for flat in np.argsort(diff.ravel())[::-1][:8]:
        p, g, k = (int(i) for i in np.unravel_index(flat, diff.shape))
        top.append({"pdf": p, "gauss": g, "dim": k, "rel": float(diff[p, g, k] / scale),
                    "occ_card": float(occ_card[p, g]), "occ_cpu": float(occ_cpu[p, g])})
    print(json.dumps({"mode": mode, "root": root.name, "archive": archive,
                      "transforms": flag and f"{flag} {Path(tfile).name}",
                      "means_rel_err": rep["means_rel_err"],
                      "transforms_max_abs_diff": rep["transforms_max_abs_diff"],
                      "fmllr_stats_rel_err": rep["fmllr_stats_rel_err"],
                      "checks_failed": failed, "top": top}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
