"""Counterpart of ``montreal_forced_aligner_tpu/parity/accuracy.py`` (the
port's aligner, on the card by default: ``--device cpu`` for the CPU).

The BASELINE.md accuracy runner: align a corpus and score it against
reference alignments produced by actual MFA/Kaldi (a directory of
TextGrids), emitting the target metrics as ONE JSON line:

    {"boundary_agreement_10ms": ..., "overlap_error": ...,
     "phone_error_rate": ..., "files": N, "boundaries": M}

Metric definitions are the reference's own (``alignment/base.py:2536-2747``,
``helper.py:671``): Needleman-Wunsch interval alignment of the phone tiers,
mean midpoint-overlap error, ins/del/sub phone error rate, and the
±10 ms (= one frame at frame_shift 10 ms, ``corpus/features.py:600``)
boundary-agreement fraction over matched non-silence boundaries.

Usage (the LibriSpeech dev-clean / ``english_us_arpa`` run of BASELINE.md):

    python -m montreal_forced_aligner_tpu_torch.parity.accuracy \
        CORPUS_DIR DICTIONARY MODEL_ZIP REFERENCE_TEXTGRID_DIR \
        [--batch_size 32] [--silence_phone sil] [--json_path out.json] \
        [--device cuda]

where REFERENCE_TEXTGRID_DIR holds the TextGrids exported by
``mfa align CORPUS_DIR english_us_arpa english_us_arpa REF_DIR`` under the
reference MFA (same relative layout as the corpus; files matched by stem).
See AGREEMENT.md for the full recipe.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, List, Optional


def evaluate_corpus_against_textgrids(
    aligner,
    corpus,
    reference_directory,
    silence_phone: str = "sil",
    custom_mapping: Optional[Dict[str, str]] = None,
) -> dict:
    """Align ``corpus`` with ``aligner`` and score each utterance's phone
    intervals against the reference TextGrid of its file. Returns the
    aggregate metrics dict (see module docstring)."""
    from montreal_forced_aligner_tpu_torch.data import CtmInterval
    from montreal_forced_aligner_tpu_torch.evaluation import (
        align_phones,
        boundary_agreement,
    )
    from montreal_forced_aligner_tpu_torch.io.textgrid import TextGrid

    reference_directory = Path(reference_directory)
    ref_by_stem: Dict[str, Path] = {
        p.stem: p for p in reference_directory.rglob("*.TextGrid")
    }
    results = aligner.align_corpus(corpus)

    def ref_phones(path) -> List[CtmInterval]:
        tg = TextGrid.read(path)
        out: List[CtmInterval] = []
        for name, ivs in tg.tiers.items():
            if "phone" in name.lower():
                out.extend(
                    CtmInterval(iv.begin, iv.end, iv.label.strip())
                    for iv in ivs
                    if iv.label.strip()
                )
        out.sort(key=lambda iv: iv.begin)
        return out

    by_file: Dict[str, List] = {}
    for utt in corpus.utterances:
        if utt.id in results:
            by_file.setdefault(utt.file_name, []).append(utt)

    overlaps, pers = [], []
    agree_w = 0.0
    total_b = 0
    files = 0
    missing = 0
    for file_name, utts in sorted(by_file.items()):
        ref_path = ref_by_stem.get(file_name)
        if ref_path is None:
            missing += 1
            continue
        ref = ref_phones(ref_path)
        test: List[CtmInterval] = []
        for utt in sorted(utts, key=lambda u: u.begin):
            for p in results[utt.id].phones:
                if p.label not in (silence_phone, "sp", "<eps>", ""):
                    test.append(CtmInterval(p.begin, p.end, p.label))
        if not ref or not test:
            continue
        sc, per, _err = align_phones(
            ref, test, silence_phone, custom_mapping=custom_mapping
        )
        ag, nb = boundary_agreement(ref, test, silence_phone)
        if sc is not None:
            overlaps.append(sc)
        pers.append(per)
        agree_w += ag * nb
        total_b += nb
        files += 1
    return {
        "boundary_agreement_10ms": (
            round(agree_w / total_b, 6) if total_b else None
        ),
        "overlap_error": (
            round(sum(overlaps) / len(overlaps), 6) if overlaps else None
        ),
        "phone_error_rate": (
            round(sum(pers) / len(pers), 6) if pers else None
        ),
        "files": files,
        "boundaries": total_b,
        "reference_textgrids_missing": missing,
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("corpus_directory")
    ap.add_argument("dictionary_path")
    ap.add_argument("acoustic_model_path")
    ap.add_argument("reference_directory")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--silence_phone", default="sil")
    ap.add_argument("--custom_mapping_path", default=None,
                    help="Yaml mapping phones across phone sets")
    ap.add_argument("--json_path", default=None,
                    help="Also write the JSON line here")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu)")
    args = ap.parse_args(argv)

    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    custom_mapping = None
    if args.custom_mapping_path:
        import yaml

        with open(args.custom_mapping_path, "r", encoding="utf-8") as f:
            custom_mapping = yaml.safe_load(f)
    aligner = PretrainedAligner(
        args.acoustic_model_path,
        args.dictionary_path,
        AlignerConfig(batch_size=args.batch_size),
        device=args.device,
    )
    corpus = Corpus.load(args.corpus_directory)
    metrics = evaluate_corpus_against_textgrids(
        aligner, corpus, args.reference_directory,
        silence_phone=args.silence_phone, custom_mapping=custom_mapping,
    )
    line = json.dumps(metrics)
    print(line)
    if args.json_path:
        Path(args.json_path).write_text(line + "\n")
    target = metrics.get("boundary_agreement_10ms")
    return 0 if target is not None else 1


if __name__ == "__main__":
    sys.exit(main())
