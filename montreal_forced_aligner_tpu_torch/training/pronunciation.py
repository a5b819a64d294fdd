"""Pronunciation-probability estimation from alignments.

Behavioral spec: reference ``alignment/base.py:937-1270``
(``compute_pronunciation_probabilities``): pronunciation probability =
count / max-count per word (with add-one smoothing over the pronunciation
inventory), silence-following probabilities smoothed with lambda_2 = 2
toward the corpus silence probability, and silence/non-silence *before*
correction factors with lambda_3 = 2 against expected ("bar") counts.
Feeds the ``DictionaryTrainer`` export (reference ``pretrained.py:561``) and
the pronunciation-probability training stage
(``acoustic_modeling/pronunciation_probabilities.py``).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from montreal_forced_aligner_tpu_torch.data import UtteranceAlignment
from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon, Pronunciation

import logging

logger = logging.getLogger("mfa_tpu")

INITIAL_KEY = ("<s>", "")
FINAL_KEY = ("</s>", "")


def format_probability(p: float) -> float:
    return min(max(round(p, 2), 0.01), 1.0)


def format_correction(c: float, positive_only: bool = True) -> float:
    c = round(c, 2)
    if c <= 0 and positive_only:
        return 0.01
    return c


@dataclass
class PronunciationCounter:
    word_pronunciation_counts: Dict[str, Dict[str, int]] = field(
        default_factory=lambda: defaultdict(lambda: defaultdict(int))
    )
    silence_following_counts: Dict[Tuple[str, str], int] = field(
        default_factory=lambda: defaultdict(int)
    )
    non_silence_following_counts: Dict[Tuple[str, str], int] = field(
        default_factory=lambda: defaultdict(int)
    )
    silence_before_counts: Dict[Tuple[str, str], int] = field(
        default_factory=lambda: defaultdict(int)
    )
    non_silence_before_counts: Dict[Tuple[str, str], int] = field(
        default_factory=lambda: defaultdict(int)
    )
    ngram_counts: Dict[Tuple, Dict[str, int]] = field(
        default_factory=lambda: defaultdict(lambda: {"silence": 0, "non_silence": 0})
    )

    def add_utterance(
        self, alignment: UtteranceAlignment, silence_phone: str = "sil"
    ) -> None:
        """Count pronunciations + surrounding silence from one aligned
        utterance (reference ``GeneratePronunciationsFunction``,
        ``alignment/multiprocessing.py:1450``)."""
        words = sorted(alignment.words, key=lambda w: w.begin)
        if not words:
            return
        # silence presence between word intervals from the phone tier
        sil_spans = [
            (p.begin, p.end)
            for p in alignment.phones
            if p.label == silence_phone
        ]

        def silence_between(a_end: float, b_begin: float) -> bool:
            return any(
                s <= a_end + 1e-4 and e >= b_begin - 1e-4 and e - s > 1e-4
                for s, e in sil_spans
            ) or any(a_end - 1e-4 <= s and e <= b_begin + 1e-4 for s, e in sil_spans)

        utt_begin = min(
            [w.begin for w in words] + [p.begin for p in alignment.phones]
        )
        utt_end = max([w.end for w in words] + [p.end for p in alignment.phones])

        keys = []
        for w in words:
            pron = " ".join(p.label for p in w.phones)
            keys.append((w.label, pron))
            self.word_pronunciation_counts[w.label][pron] += 1

        # initial silence
        first_sil = silence_between(utt_begin, words[0].begin) or (
            words[0].begin - utt_begin > 1e-3
        )
        if first_sil:
            self.silence_before_counts[INITIAL_KEY] += 1
            self.silence_before_counts[keys[0]] += 1
        else:
            self.non_silence_before_counts[INITIAL_KEY] += 1
            self.non_silence_before_counts[keys[0]] += 1
        self.ngram_counts[(INITIAL_KEY, keys[0])][
            "silence" if first_sil else "non_silence"
        ] += 1

        for i in range(len(words) - 1):
            sil = silence_between(words[i].end, words[i + 1].begin)
            if sil:
                self.silence_following_counts[keys[i]] += 1
                self.silence_before_counts[keys[i + 1]] += 1
            else:
                self.non_silence_following_counts[keys[i]] += 1
                self.non_silence_before_counts[keys[i + 1]] += 1
            self.ngram_counts[(keys[i], keys[i + 1])][
                "silence" if sil else "non_silence"
            ] += 1

        last_sil = silence_between(words[-1].end, utt_end) or (
            utt_end - words[-1].end > 1e-3
        )
        if last_sil:
            self.silence_following_counts[keys[-1]] += 1
            self.silence_before_counts[FINAL_KEY] += 1
        else:
            self.non_silence_following_counts[keys[-1]] += 1
            self.non_silence_before_counts[FINAL_KEY] += 1
        self.ngram_counts[(keys[-1], FINAL_KEY)][
            "silence" if last_sil else "non_silence"
        ] += 1

    def merge(self, other: "PronunciationCounter") -> None:
        """Add another counter's counts in place (cross-host reduction for
        multi-process training: every host must fold the same global counts
        into its lexicon or subsequent stages compile divergent graphs)."""
        for w, pron_counts in other.word_pronunciation_counts.items():
            for p, c in pron_counts.items():
                self.word_pronunciation_counts[w][p] += c
        for name in (
            "silence_following_counts",
            "non_silence_following_counts",
            "silence_before_counts",
            "non_silence_before_counts",
        ):
            mine = getattr(self, name)
            for k, c in getattr(other, name).items():
                mine[k] += c
        for k, counts in other.ngram_counts.items():
            mine_c = self.ngram_counts[k]
            mine_c["silence"] += counts["silence"]
            mine_c["non_silence"] += counts["non_silence"]

    def to_plain(self) -> dict:
        """Picklable plain-dict snapshot (the defaultdict factories are
        lambdas, which pickle rejects) for cross-host transport."""
        return {
            "word_pronunciation_counts": {
                w: dict(pc) for w, pc in self.word_pronunciation_counts.items()
            },
            "silence_following_counts": dict(self.silence_following_counts),
            "non_silence_following_counts": dict(
                self.non_silence_following_counts
            ),
            "silence_before_counts": dict(self.silence_before_counts),
            "non_silence_before_counts": dict(self.non_silence_before_counts),
            "ngram_counts": {
                k: dict(v) for k, v in self.ngram_counts.items()
            },
        }

    @classmethod
    def from_plain(cls, state: dict) -> "PronunciationCounter":
        out = cls()
        for w, pc in state["word_pronunciation_counts"].items():
            for p, c in pc.items():
                out.word_pronunciation_counts[w][p] = c
        for name in (
            "silence_following_counts",
            "non_silence_following_counts",
            "silence_before_counts",
            "non_silence_before_counts",
        ):
            mine = getattr(out, name)
            for k, c in state[name].items():
                mine[k] = c
        for k, v in state["ngram_counts"].items():
            out.ngram_counts[k].update(v)
        return out


@dataclass
class PronunciationProbabilityResult:
    # (word, pron) -> fields
    pronunciations: Dict[Tuple[str, str], dict]
    silence_probability: float
    initial_silence_probability: float
    final_silence_correction: float
    final_non_silence_correction: float


def compute_pronunciation_probabilities(
    counter: PronunciationCounter,
    lambda_2: float = 2.0,
    lambda_3: float = 2.0,
) -> PronunciationProbabilityResult:
    """The reference's probability/correction formulas
    (``alignment/base.py:1070-1165``)."""
    silence_count = sum(counter.silence_before_counts.values())
    non_silence_count = sum(counter.non_silence_before_counts.values())
    denom = silence_count + non_silence_count
    silence_probability = (
        format_probability(silence_count / denom) if denom > 0 else 0.5
    )

    prons: Dict[Tuple[str, str], dict] = {}
    all_keys = []
    for w, pron_counts in counter.word_pronunciation_counts.items():
        # add-one smoothing across the word's pronunciation inventory
        max_count = max(pron_counts.values()) + 1
        for p, c in pron_counts.items():
            key = (w, p)
            all_keys.append(key)
            prons[key] = {
                "count": c,
                "probability": format_probability((c + 1) / max_count),
            }

    silence_probabilities = {}
    for key in all_keys:
        count = counter.silence_following_counts[key]
        total = count + counter.non_silence_following_counts[key]
        w_p_silence = count + silence_probability * lambda_2
        prob = (
            format_probability(w_p_silence / (total + lambda_2))
            if total + lambda_2 > 0
            else silence_probability
        )
        silence_probabilities[key] = prob
        prons[key]["silence_after_probability"] = prob

    bar_sil = defaultdict(float)
    bar_non_sil = defaultdict(float)
    for (k1, k2), counts in counter.ngram_counts.items():
        sp = silence_probabilities.get(k1, 0.01)
        total = counts["silence"] + counts["non_silence"]
        bar_sil[k2] += total * sp
        bar_non_sil[k2] += total * (1 - sp)

    for key in all_keys:
        prons[key]["silence_before_correction"] = format_correction(
            (counter.silence_before_counts[key] + lambda_3)
            / (bar_sil[key] + lambda_3)
        )
        prons[key]["non_silence_before_correction"] = format_correction(
            (counter.non_silence_before_counts[key] + lambda_3)
            / (bar_non_sil[key] + lambda_3)
        )

    init_sil = counter.silence_before_counts[INITIAL_KEY] + silence_probability * lambda_2
    init_non = (
        counter.non_silence_before_counts[INITIAL_KEY]
        + (1 - silence_probability) * lambda_2
    )
    initial_silence_probability = (
        format_probability(init_sil / (init_sil + init_non))
        if init_sil + init_non > 0
        else 0.5
    )
    final_silence_correction = format_correction(
        (counter.silence_before_counts[FINAL_KEY] + lambda_3)
        / (bar_sil[FINAL_KEY] + lambda_3)
    )
    final_non_silence_correction = format_correction(
        (counter.non_silence_before_counts[FINAL_KEY] + lambda_3)
        / (bar_non_sil[FINAL_KEY] + lambda_3)
    )
    return PronunciationProbabilityResult(
        pronunciations=prons,
        silence_probability=silence_probability,
        initial_silence_probability=initial_silence_probability,
        final_silence_correction=final_silence_correction,
        final_non_silence_correction=final_non_silence_correction,
    )


def apply_probabilities_to_lexicon(
    lexicon: Lexicon, result: PronunciationProbabilityResult
) -> Lexicon:
    """Update a lexicon in place with estimated probabilities (the
    ``DictionaryTrainer`` export path, reference ``pretrained.py:561``)."""
    lexicon.bump_version()
    for word, prons in lexicon.words.items():
        for pron in prons:
            key = (word, " ".join(pron.phones))
            data = result.pronunciations.get(key)
            if data is None:
                continue
            pron.probability = data["probability"]
            pron.silence_after_probability = data["silence_after_probability"]
            pron.silence_before_correction = data["silence_before_correction"]
            pron.non_silence_before_correction = data["non_silence_before_correction"]
    lexicon.silence_probability = result.silence_probability
    lexicon.initial_silence_probability = result.initial_silence_probability
    lexicon.final_silence_correction = result.final_silence_correction
    lexicon.final_non_silence_correction = result.final_non_silence_correction
    return lexicon


def train_g2p_lexicon(
    lexicon,
    counter: PronunciationCounter,
    num_pronunciations: int = 2,
    max_repeats: int = 20,
    order: int = 6,
):
    """``train_g2p`` variant of the pronunciation-probability stage
    (reference ``acoustic_modeling/pronunciation_probabilities.py:160,420``):
    it trains a G2P model, which this port does not have yet."""
    raise NotImplementedError(
        "train_g2p (a G2P model trained on the aligned pronunciations): "
        "ROADMAP.md Queue 1 item 16 (host extras)"
    )
