"""Multi-GPU dry run of the product path over ``n`` ranks.

    python -m montreal_forced_aligner_tpu_torch.parallel.dryrun [N] [--device cpu]

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip(n)``:
every rank trains mono -> tri -> SAT on its speakers of a small tone corpus
with the statistics reduced over the ranks (``train --distributed``), then
the trained model aligns the corpus sharded over the ranks (``align
--distributed``, the fMLLR two-pass), the 1 ms fine-tune refines the
boundaries sharded the same way, and MAP adaptation runs the SAT two-pass
and reduces its statistics over the ranks. Ranks run in processes spawned by
``parallel.multihost.run_ranks``: gloo on the CPU, NCCL on cards (one card a
rank) unless ``backend`` (or ``MFA_TPU_TORCH_DIST_BACKEND``) names gloo,
which lets ranks share a card.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


def synth_corpus(tmp, n_utts: int):
    """Tiny tone corpus (two speakers) and its dictionary on disk."""
    from montreal_forced_aligner_tpu_torch.io.wav import write_wave

    sr = 16000
    rng = np.random.RandomState(0)
    corpus_root = Path(tmp) / "corpus"
    texts = ["ab a", "a ab", "ab ab"]
    for u in range(n_utts):
        spk_dir = corpus_root / f"spk{u % 2}"
        spk_dir.mkdir(parents=True, exist_ok=True)
        text = texts[u % len(texts)]
        pieces = []
        freq = {"a": 330.0, "b": 1800.0}
        for tok in ("sil " + text.replace(" ", " sil ") + " sil").split():
            dur = 0.25 if tok == "sil" else 0.35
            n = int(dur * sr)
            t = np.arange(n) / sr
            if tok == "sil":
                x = rng.randn(n) * 10.0
            else:
                x = sum(
                    6000.0 * np.sin(2 * np.pi * freq[c] * t) for c in tok
                ) + rng.randn(n) * 10.0
            pieces.append(np.asarray(x, np.float32))
        write_wave(spk_dir / f"utt{u}.wav", np.concatenate(pieces), sr)
        (spk_dir / f"utt{u}.lab").write_text(text)
    dict_path = Path(tmp) / "dry.dict"
    dict_path.write_text("a\taa\nab\taa bb\n")
    return corpus_root, dict_path


def dryrun_rank(rank: int, world_size: int, corpus_dir, dict_path, out_dir,
                device: str, batch_size: int) -> Dict:
    """One rank of the dry run: returns its summary (the model's shape, its
    utterances, the results' count, its kernel launches, wall seconds)."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.align.fine_tune import (
        fine_tune_alignments,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.parallel.mesh import get_mesh
    from montreal_forced_aligner_tpu_torch.training.adapt import MapAdapter
    from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    mesh = get_mesh(device=device)
    recipe = [
        StageConfig("monophone", "mono", 2, 20),
        StageConfig("triphone", "tri", 2, 32, num_leaves=24),
        StageConfig("sat", "sat", 2, 32, num_leaves=24),
    ]
    ta = TrainableAligner(
        corpus_dir, dict_path, recipe=recipe,
        base_config=TrainerConfig(boost_silence=1.0),
        batch_size=batch_size, variable_length_topology=False,
        mesh=mesh, device=device,
    )
    final = ta.train()
    if final.gmm.num_pdfs <= 0:
        raise RuntimeError("dry run: the trained model has no pdfs")
    # the SAT stage reduced fMLLR statistics over the ranks
    if ta.trainers["sat"].speaker_transforms is None:
        raise RuntimeError("dry run: the SAT stage estimated no transforms")
    model_path = Path(out_dir) / "dry_model.zip"
    if rank == 0:
        final.save(model_path)
    from montreal_forced_aligner_tpu_torch.parallel.multihost import host_barrier

    host_barrier("dryrun_model_saved")
    train_s = time.perf_counter() - t0

    config = AlignerConfig(batch_size=batch_size, distributed=True)
    aligner = PretrainedAligner(model_path, dict_path, config, device=device)
    if aligner.mesh is None:
        raise RuntimeError("dry run: the aligner has no mesh")
    corpus = Corpus.load(corpus_dir)
    results = aligner.align_corpus(corpus)
    if len(results) != corpus.num_utterances:
        raise RuntimeError(f"dry run: {len(results)} of "
                           f"{corpus.num_utterances} utterances aligned")
    for aln in results.values():
        if not aln.phones or not np.isfinite(aln.log_likelihood):
            raise RuntimeError(f"dry run: utterance {aln.utterance_id} "
                               "has no finite alignment")
    tuned = fine_tune_alignments(aligner, corpus, results)
    if len(tuned) != corpus.num_utterances:
        raise RuntimeError("dry run: fine-tune lost utterances")

    adapter = MapAdapter(model_path, dict_path, config=config, device=device)
    if adapter.aligner.mesh is None:
        raise RuntimeError("dry run: the adapter's aligner has no mesh")
    adapted = adapter.adapt(corpus_dir)
    if adapted.gmm.num_pdfs != final.gmm.num_pdfs:
        raise RuntimeError("dry run: adaptation changed the pdf count")
    if adapted.alignment_model is None:
        raise RuntimeError("dry run: adaptation lost the alignment model")
    return {
        "rank": rank,
        "world_size": world_size,
        "device": str(ta.device),
        "utterances": ta.corpus.num_utterances,
        "num_pdfs": int(final.gmm.num_pdfs),
        "num_gauss": int(final.gmm.total_gauss),
        "loglikes": {k: [e["loglike_per_frame"] for e in t.iteration_log]
                     for k, t in ta.trainers.items()},
        "aligned": len(results),
        "shard": list(aligner.last_shard),
        "boundaries": sum(len(a.phones) for a in tuned.values()),
        "adapted_means_sum": float(np.asarray(adapted.gmm.get_means(),
                                              np.float64).sum()),
        "launches": dict(cuda_build.LAUNCHES),
        "train_s": train_s,
        "wall_s": time.perf_counter() - t0,
    }


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     backend: Optional[str] = None, timeout: float = 900.0,
                     threads: int = 0, workdir=None) -> List[Dict]:
    """Run :func:`dryrun_rank` on ``n_devices`` ranks and check that they
    agree: the same model (pdfs, Gaussians, log-likelihoods per iteration,
    adapted means) on every rank, every utterance aligned on every rank,
    each utterance owned by one rank. Returns the ranks' summaries."""
    from montreal_forced_aligner_tpu_torch.parallel.multihost import run_ranks

    with tempfile.TemporaryDirectory(dir=workdir, prefix="dryrun_") as tmp:
        corpus_dir, dict_path = synth_corpus(tmp, n_utts=max(4, n_devices))
        out = run_ranks(
            dryrun_rank, n_devices,
            args=(str(corpus_dir), str(dict_path), tmp, device,
                  max(2, n_devices // 2)),
            backend=backend, device=device, timeout=timeout, threads=threads,
            workdir=workdir,
        )
    first = out[0]
    for s in out[1:]:
        for key in ("num_pdfs", "num_gauss", "loglikes", "aligned",
                    "boundaries", "adapted_means_sum"):
            if s[key] != first[key]:
                raise RuntimeError(f"dry run: rank {s['rank']} {key} "
                                   f"{s[key]} != rank 0's {first[key]}")
    owned = sorted(i for s in out for i in s["shard"])
    if owned != list(range(first["aligned"])):
        raise RuntimeError(f"dry run: the ranks' shards {owned} do not "
                           "partition the corpus")
    return out


def main(argv=None) -> int:  # pragma: no cover - exercised via the CLI
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", nargs="?", type=int, default=None,
                   help="ranks (default: the visible cards, 2 on the CPU)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    args = p.parse_args(argv)
    n = args.n
    if n is None:
        import torch

        n = torch.cuda.device_count() if args.device == "cuda" else 2
    out = dryrun_multichip(n, device=args.device, backend=args.backend)
    print(json.dumps({"dryrun_multichip": n, "ranks": out}))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
