#!/usr/bin/env python3
"""Time the triphone tree build on the smoke corpus's tree statistics.

    python3 tools/tree_build_time.py [LEAVES ...] [--reference PACKAGE]

Builds ``chip_smoke.py``'s 64-utterance corpus and 200-word dictionary,
trains its monophone stage on the CPU (``TrainableAligner``, 4 iterations,
batch 32, chain topology, as train-mono), accumulates the triphone tree
statistics from that alignment (``TriphoneTrainer._accumulate_tree_stats``),
and times ``auto_questions`` and ``build_tree`` of the port for each leaf
count (default 2000 2500). With ``--reference montreal_forced_aligner_tpu``
it also times that package's ``build_tree`` on the same statistics and
checks that both trees give every event the same leaf. Prints one JSON
line per leaf count.
"""

import argparse
import importlib
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("leaves", nargs="*", type=int, default=[2000, 2500])
    p.add_argument("--reference", default=None,
                   help="package whose training.tree_builder to time beside")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from montreal_forced_aligner_tpu_torch.training import tree_builder as TB
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )
    from montreal_forced_aligner_tpu_torch.training.triphone import TriphoneTrainer

    ref = (importlib.import_module(f"{args.reference}.training.tree_builder")
           if args.reference else None)
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        _model, dict_path, words = chip_smoke.build_sat_scale_model(tmp)
        corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 64)
        t0 = time.perf_counter()
        ta = TrainableAligner(
            corpus_dir, dict_path, recipe=[StageConfig("monophone", "mono", 4, 64)],
            batch_size=32, variable_length_topology=False, device="cpu",
        )
        ta.train()
        mono_s = time.perf_counter() - t0
        mono = ta.trainers["monophone"]
        tri = TriphoneTrainer(ta.lexicon, mono.tm.topo)
        labels = tri._extract_labels(ta.pipeline)
        stats = tri._accumulate_tree_stats(labels, ta.pipeline.feature_dim)
    groups = tri.phone_groups()
    t0 = time.perf_counter()
    questions = TB.auto_questions(stats, groups, tri.cluster_pdf_class)
    questions_s = time.perf_counter() - t0
    for leaves in args.leaves:
        t0 = time.perf_counter()
        tree = TB.build_tree(stats, questions, [TB.Root(set(g)) for g in groups],
                             max_leaves=leaves)
        out = {"max_leaves": leaves, "leaves": tree.num_pdfs,
               "events": len(stats.stats), "questions": len(questions),
               "monophone_cpu_s": mono_s, "auto_questions_s": questions_s,
               "build_tree_s": time.perf_counter() - t0}
        if ref is not None:
            t0 = time.perf_counter()
            rtree = ref.build_tree(stats, questions,
                                   [ref.Root(set(g)) for g in groups],
                                   max_leaves=leaves)
            out["reference_build_tree_s"] = time.perf_counter() - t0
            out["same_tree"] = all(
                tree.compute_pdf([e[k] for k in range(3)], e[-1])
                == rtree.compute_pdf([e[k] for k in range(3)], e[-1])
                for e in (dict(key) for key in stats.stats)
            )
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
