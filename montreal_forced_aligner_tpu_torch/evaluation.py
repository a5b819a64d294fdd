"""Alignment/transcription evaluation utilities.

Clean-room equivalents of the reference's ``helper.py`` scoring functions:
``edit_distance`` (``:392``), ``score_wer`` (``:464``), ``overlap_scoring``
(``:526``), and the Needleman-Wunsch interval alignment ``align_phones``
(``:671``, which the reference delegates to Biopython's ``pairwise2``);
plus the phone-boundary agreement metric used as the accuracy bar
(BASELINE.md: fraction of boundaries within ±10 ms of the reference).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch.data import CtmInterval

GAP = None


def edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    """Levenshtein distance over tokens."""
    m, n = len(ref), len(hyp)
    dp = np.arange(n + 1)
    for i in range(1, m + 1):
        prev_diag = dp[0]
        dp[0] = i
        for j in range(1, n + 1):
            tmp = dp[j]
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev_diag + cost)
            prev_diag = tmp
    return int(dp[n])


def score_wer(ref_words: Sequence[str], hyp_words: Sequence[str]) -> float:
    if not ref_words:
        return 0.0 if not hyp_words else 1.0
    return edit_distance(ref_words, hyp_words) / len(ref_words)


def score_cer(ref: str, hyp: str) -> float:
    ref_c = list(ref.replace(" ", ""))
    hyp_c = list(hyp.replace(" ", ""))
    if not ref_c:
        return 0.0 if not hyp_c else 1.0
    return edit_distance(ref_c, hyp_c) / len(ref_c)


def compare_labels(
    a: str, b: str, silence_phone: str, mapping: Optional[Dict[str, str]] = None
) -> int:
    if a == b:
        return 0
    if a == silence_phone or b == silence_phone:
        return 10
    if mapping is not None:
        am = mapping.get(a, a)
        bm = mapping.get(b, b)
        a_set = set(am) if isinstance(am, (list, set, tuple)) else {am}
        b_set = set(bm) if isinstance(bm, (list, set, tuple)) else {bm}
        if (a_set & b_set) or b in a_set or a in b_set:
            return 0
    a, b = a.lower(), b.lower()
    if a == b:
        return 0
    return 2


def overlap_scoring(
    first: CtmInterval,
    second: CtmInterval,
    silence_phone: str,
    mapping: Optional[Dict[str, str]] = None,
) -> float:
    """-(|b1-b2| + |e1-e2| + label_mismatch_penalty) (reference ``:526``)."""
    begin_diff = abs(first.begin - second.begin)
    end_diff = abs(first.end - second.end)
    label_diff = compare_labels(first.label, second.label, silence_phone, mapping)
    return -(begin_diff + end_diff + label_diff)


def _needleman_wunsch(
    ref: List[CtmInterval],
    test: List[CtmInterval],
    score_func,
    gap_penalty: float = -2.0,
) -> List[Tuple[Optional[CtmInterval], Optional[CtmInterval]]]:
    """Global alignment of two interval sequences; returns aligned pairs with
    None as the gap marker."""
    m, n = len(ref), len(test)
    score = np.zeros((m + 1, n + 1))
    ptr = np.zeros((m + 1, n + 1), dtype=np.int8)  # 0=diag 1=up(del) 2=left(ins)
    score[:, 0] = gap_penalty * np.arange(m + 1)
    score[0, :] = gap_penalty * np.arange(n + 1)
    ptr[1:, 0] = 1
    ptr[0, 1:] = 2
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            diag = score[i - 1, j - 1] + score_func(ref[i - 1], test[j - 1])
            up = score[i - 1, j] + gap_penalty
            left = score[i, j - 1] + gap_penalty
            best = max(diag, up, left)
            score[i, j] = best
            ptr[i, j] = 0 if best == diag else (1 if best == up else 2)
    out = []
    i, j = m, n
    while i > 0 or j > 0:
        p = ptr[i, j]
        if i > 0 and j > 0 and p == 0:
            out.append((ref[i - 1], test[j - 1]))
            i -= 1
            j -= 1
        elif i > 0 and p == 1:
            out.append((ref[i - 1], None))
            i -= 1
        else:
            out.append((None, test[j - 1]))
            j -= 1
    return out[::-1]


def align_phones(
    ref: List[CtmInterval],
    test: List[CtmInterval],
    silence_phone: str = "sil",
    ignored_phones: Optional[set] = None,
    custom_mapping: Optional[Dict[str, str]] = None,
) -> Tuple[Optional[float], float, Counter]:
    """Interval-sequence alignment and scoring (reference ``:671``).

    Returns (mean overlap error, phone error rate, error pair counts).
    """
    ignored = set(ignored_phones or ())
    ignored.add(silence_phone)
    pairs = _needleman_wunsch(
        ref,
        test,
        lambda a, b: overlap_scoring(a, b, silence_phone, custom_mapping),
    )
    overlap_sum, overlap_count = 0.0, 0
    ins = dels = subs = 0
    errors: Counter = Counter()
    for ra, tb in pairs:
        if ra is None:
            if tb.label not in ignored:
                errors[("-", tb.label)] += 1
                ins += 1
        elif tb is None:
            if ra.label not in ignored:
                errors[(ra.label, "-")] += 1
                dels += 1
        else:
            if ra.label in ignored:
                continue
            overlap_sum += (abs(ra.begin - tb.begin) + abs(ra.end - tb.end)) / 2
            overlap_count += 1
            if compare_labels(ra.label, tb.label, silence_phone, custom_mapping) > 0:
                subs += 1
                errors[(ra.label, tb.label)] += 1
    score = overlap_sum / overlap_count if overlap_count else None
    per = (ins + dels + 2 * subs) / max(len(ref), 1)
    return score, per, errors


def boundary_agreement(
    ref: List[CtmInterval],
    test: List[CtmInterval],
    silence_phone: str = "sil",
    tolerance: float = 0.010,
) -> Tuple[float, int]:
    """Fraction of matched non-silence phone boundaries within ``tolerance``
    seconds of the reference (the BASELINE.md target metric).

    Returns (agreement fraction, number of boundaries compared).
    """
    pairs = _needleman_wunsch(
        ref, test, lambda a, b: overlap_scoring(a, b, silence_phone)
    )
    agree = 0
    total = 0
    for ra, tb in pairs:
        if ra is None or tb is None or ra.label == silence_phone:
            continue
        for x, y in ((ra.begin, tb.begin), (ra.end, tb.end)):
            total += 1
            if abs(x - y) <= tolerance + 1e-9:
                agree += 1
    return (agree / total if total else 0.0), total


@dataclass
class AlignmentEvaluation:
    overlap_score: Optional[float]
    phone_error_rate: float
    boundary_agreement: float
    num_boundaries: int
    errors: Counter


def evaluate_against_textgrid(
    test_phones: List[CtmInterval],
    reference_textgrid_path,
    tier_substring: str = "phones",
    silence_phone: str = "sil",
) -> AlignmentEvaluation:
    """Evaluate phone intervals against a reference TextGrid's phone tier
    (reference ``alignment/base.py:2536`` evaluate_alignments)."""
    from montreal_forced_aligner_tpu_torch.io.textgrid import TextGrid

    tg = TextGrid.read(reference_textgrid_path)
    ref_intervals: List[CtmInterval] = []
    for name, ivs in tg.tiers.items():
        if tier_substring in name.lower():
            for iv in ivs:
                if iv.label.strip():
                    ref_intervals.append(
                        CtmInterval(iv.begin, iv.end, iv.label.strip())
                    )
    score, per, errors = align_phones(ref_intervals, test_phones, silence_phone)
    agree, nb = boundary_agreement(ref_intervals, test_phones, silence_phone)
    return AlignmentEvaluation(score, per, agree, nb, errors)
