"""G2P inference: beam search over graphone sequences.

Behavioral spec: reference ``g2p/generator.py:153-321``
(``PhonetisaurusRewriter``: shortest-path over the graphone n-gram FST,
top-k pronunciations). Here: explicit beam search where a hypothesis is
(position in the grapheme string, LM history, accumulated phones, score);
expansions are graphone symbols from the LM vocabulary whose grapheme side
matches the upcoming graphemes.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from montreal_forced_aligner_tpu_torch.g2p.trainer import (
    EPS,
    G2PModel,
    parse_graphone,
)


class G2PGenerator:
    """Generate pronunciations for words (reference entry point: ``mfa g2p``)."""

    def __init__(self, model, beam: int = 32):
        from montreal_forced_aligner_tpu_torch.g2p.openfst_model import (
            OpenFstG2PModel,
        )

        self.model = model
        self.beam = beam
        # reference-format (pynini FST) models carry their own inference;
        # delegate and skip the graphone-LM indexing below
        if isinstance(model, OpenFstG2PModel):
            self.generate = model.generate
            self.generate_pronunciations = model.generate_pronunciations
            self.by_first = {}
            return
        # index graphone symbols by their first grapheme (or epsilon)
        self.by_first: Dict[str, List[Tuple[str, Tuple[str, ...], Tuple[str, ...]]]] = (
            defaultdict(list)
        )
        for (sym,) in model.lm.ngrams[1]:
            if sym in ("<s>", "</s>", "<unk>"):
                continue
            try:
                g, p = parse_graphone(sym)
            except ValueError:
                continue
            key = g[0] if g != (EPS,) else EPS
            self.by_first[key].append((sym, g, p))

    def generate(
        self, word: str, num_pronunciations: int = 1
    ) -> List[Tuple[Tuple[str, ...], float]]:
        """Top-k (phones, log10 score) for a word."""
        graphemes = list(word)
        G = len(graphemes)
        order = self.model.lm.order
        # hypotheses per position: (score, history, phones)
        beams: List[List[Tuple[float, Tuple[str, ...], Tuple[str, ...]]]] = [
            [] for _ in range(G + 1)
        ]
        beams[0] = [(0.0, ("<s>",), ())]
        completed: List[Tuple[float, Tuple[str, ...]]] = []
        for pos in range(G + 1):
            worklist = beams[pos]
            if not worklist:
                continue
            worklist.sort(reverse=True)
            worklist = worklist[: self.beam]
            seen = set()
            processed = 0
            while worklist and processed < self.beam * 4:
                score, hist, phones = worklist.pop(0)
                key = (hist, phones)
                if key in seen:
                    continue
                seen.add(key)
                processed += 1
                if pos == G:
                    end_lp = self.model.lm.log_prob("</s>", hist)
                    completed.append((score + end_lp, phones))
                candidates = []
                if pos < G:
                    candidates = list(self.by_first.get(graphemes[pos], []))
                # epsilon-grapheme expansions (phone insertions) can occur at
                # any position, including after the last grapheme
                candidates += self.by_first.get(EPS, [])
                for sym, g, p in candidates:
                    if g != (EPS,):
                        if pos + len(g) > G or tuple(
                            graphemes[pos : pos + len(g)]
                        ) != g:
                            continue
                        advance = len(g)
                    else:
                        advance = 0
                    lp = self.model.lm.log_prob(sym, hist)
                    new_hist = (hist + (sym,))[-(order - 1) :]
                    new_phones = phones + tuple(
                        ph for ph in p if ph != EPS
                    )
                    if advance == 0 and len(new_phones) > 2 * G + 8:
                        continue  # runaway insertion guard
                    entry = (score + lp, new_hist, new_phones)
                    if advance == 0:
                        worklist.append(entry)
                        worklist.sort(reverse=True)
                        del worklist[self.beam :]
                    else:
                        beams[pos + advance].append(entry)
        completed.sort(reverse=True)
        out = []
        seen_ph = set()
        for score, phones in completed:
            if phones in seen_ph or not phones:
                continue
            seen_ph.add(phones)
            out.append((phones, score))
            if len(out) >= num_pronunciations:
                break
        return out

    def generate_pronunciations(
        self, words: Sequence[str], num_pronunciations: int = 1
    ) -> Dict[str, List[str]]:
        """{word: [pronunciation strings]} (reference corpus generator
        ``g2p/generator.py:475``)."""
        out = {}
        for w in words:
            prons = self.generate(w, num_pronunciations)
            out[w] = [" ".join(p) for p, _s in prons]
        return out


def evaluate_g2p(
    generator: G2PGenerator,
    test_pairs: List[Tuple[str, Sequence[str]]],
    num_pronunciations: int = 1,
) -> dict:
    """Word accuracy + phone error rate (reference ``helper.py:430``
    ``score_g2p``)."""
    from montreal_forced_aligner_tpu_torch.evaluation import edit_distance

    correct = 0
    total_per_num = 0
    total_per_den = 0
    for word, ref_phones in test_pairs:
        hyps = generator.generate(word, num_pronunciations)
        ref = tuple(ref_phones)
        if any(h == ref for h, _s in hyps):
            correct += 1
        best_per = min(
            (edit_distance(list(ref), list(h)) for h, _s in hyps),
            default=len(ref),
        )
        total_per_num += best_per
        total_per_den += len(ref)
    return {
        "word_accuracy": correct / max(len(test_pairs), 1),
        "phone_error_rate": total_per_num / max(total_per_den, 1),
    }
