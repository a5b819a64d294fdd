"""Alignment quality analysis (host numpy), copied from
``montreal_forced_aligner_tpu/align/analysis.py``.

Behavioral spec: reference ``AnalyzeAlignmentsFunction``
(``alignment/multiprocessing.py:865``): per-utterance speech log-likelihood
and per-phone duration z-scores against corpus-wide phone duration
distributions, used to flag likely misalignments; and
``PhoneConfidenceFunction`` (``:1353``): per-interval confidence from the
margin between the aligned pdf's likelihood and the best competing pdf.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch.data import UtteranceAlignment


@dataclass
class PhoneDurationStats:
    mean: Dict[str, float]
    std: Dict[str, float]


def phone_duration_statistics(
    results: Dict[int, UtteranceAlignment], min_count: int = 5
) -> PhoneDurationStats:
    durations: Dict[str, List[float]] = defaultdict(list)
    for aln in results.values():
        for p in aln.phones:
            durations[p.label].append(p.duration)
    mean, std = {}, {}
    for label, ds in durations.items():
        if len(ds) < min_count:
            continue
        arr = np.array(ds)
        mean[label] = float(arr.mean())
        std[label] = float(max(arr.std(), 1e-3))
    return PhoneDurationStats(mean, std)


@dataclass
class UtteranceAnalysis:
    utterance_id: int
    speech_log_likelihood: float
    duration_deviation: float  # max |z| over phones
    phone_z_scores: List[Tuple[str, float]]


def analyze_alignments(
    results: Dict[int, UtteranceAlignment],
    duration_threshold: float = 10.0,
) -> Tuple[Dict[int, UtteranceAnalysis], List[int]]:
    """Returns per-utterance analyses and the ids of flagged utterances
    (those with any phone duration z-score above ``duration_threshold``,
    matching the reference's subset filtering ``corpus/base.py:2526``)."""
    stats = phone_duration_statistics(results)
    analyses = {}
    flagged = []
    for uid, aln in results.items():
        zs = []
        for p in aln.phones:
            if p.label in stats.mean:
                z = (p.duration - stats.mean[p.label]) / stats.std[p.label]
                zs.append((p.label, float(z)))
        max_dev = max((abs(z) for _l, z in zs), default=0.0)
        analyses[uid] = UtteranceAnalysis(
            utterance_id=uid,
            speech_log_likelihood=aln.per_frame_log_likelihood,
            duration_deviation=max_dev,
            phone_z_scores=zs,
        )
        if max_dev > duration_threshold:
            flagged.append(uid)
    return analyses, flagged


def csv_report(
    analyses: Dict[int, UtteranceAnalysis], corpus, path
) -> None:
    """Write the analysis CSV (reference ``alignment/base.py:2580``)."""
    import csv

    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(
            ["utterance", "file", "speaker", "log_likelihood_per_frame",
             "duration_deviation"]
        )
        for uid, a in sorted(analyses.items()):
            utt = corpus.utterances[uid]
            w.writerow(
                [
                    uid,
                    utt.file_name,
                    utt.speaker,
                    f"{a.speech_log_likelihood:.4f}",
                    f"{a.duration_deviation:.2f}",
                ]
            )
