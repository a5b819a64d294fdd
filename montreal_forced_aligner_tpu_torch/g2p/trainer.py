"""Grapheme-to-phoneme model training.

Behavioral spec: reference ``g2p/phonetisaurus_trainer.py`` (many-to-many
EM alignment of grapheme/phone sequences: ``AlignmentInitWorker`` ``:105``,
``ExpectationWorker`` ``:337``, ``MaximizationWorker`` ``:435``; order-8
n-gram over the aligned graphone symbols ``:675``) — the Phonetisaurus
pipeline, reimplemented self-contained (no pynini/OpenFst dependency):

1. EM over the edit lattice of every (graphemes, phones) pair estimates
   graphone (joint grapheme-chunk/phone-chunk) probabilities; chunk sizes
   up to ``grapheme_order`` x ``phone_order``.
2. Viterbi segmentation turns each entry into a graphone token sequence.
3. A Kneser-Ney n-gram model (our ``language_modeling.ngram``) over those
   sequences is the G2P model.
"""

from __future__ import annotations

import json
import logging
import math
import zipfile
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
    ArpaModel,
    NgramCounter,
    train_ngram_model,
)

logger = logging.getLogger("mfa_tpu")

EPS = "_"  # empty side marker inside graphone symbols
SEP = "}"  # grapheme/phone separator inside a graphone symbol (g}p)
JOIN = "|"  # joins multiple graphemes/phones within one side

NEG_INF = -1.0e30


def _logsumexp(a: float, b: float) -> float:
    if a < b:
        a, b = b, a
    if b == NEG_INF:
        return a
    return a + math.log1p(math.exp(b - a))


@dataclass
class Aligner:
    """Many-to-many EM aligner over grapheme/phone pairs."""

    grapheme_order: int = 2
    phone_order: int = 2
    # reference phonetisaurus defaults: both True
    # (g2p/phonetisaurus_trainer.py:695-698)
    allow_deletions: bool = True  # graphemes mapping to no phone
    allow_insertions: bool = True  # phones with no grapheme
    num_iterations: int = 10

    probs: Dict[Tuple[Tuple[str, ...], Tuple[str, ...]], float] = field(
        default_factory=dict
    )

    def _moves(self, g_len: int, p_len: int):
        for dg in range(0, self.grapheme_order + 1):
            for dp in range(0, self.phone_order + 1):
                if dg == 0 and dp == 0:
                    continue
                if dg == 0 and not self.allow_insertions:
                    continue
                if dp == 0 and not self.allow_deletions:
                    continue
                if dg > 1 and dp > 1:
                    continue  # phonetisaurus: no many-to-many both sides
                yield dg, dp

    def _lattice_pass(self, graphemes, phones, log_probs, accumulate=None):
        """Forward-backward (or Viterbi when accumulate is None ... no —
        always forward-backward; returns total log-likelihood; optionally
        accumulates expected counts into ``accumulate``)."""
        G, P = len(graphemes), len(phones)
        alpha = np.full((G + 1, P + 1), NEG_INF)
        alpha[0, 0] = 0.0
        moves = list(self._moves(G, P))
        for i in range(G + 1):
            for j in range(P + 1):
                if alpha[i, j] == NEG_INF:
                    continue
                for dg, dp in moves:
                    if i + dg > G or j + dp > P:
                        continue
                    key = (
                        tuple(graphemes[i : i + dg]) or (EPS,),
                        tuple(phones[j : j + dp]) or (EPS,),
                    )
                    lp = log_probs.get(key, NEG_INF)
                    if lp == NEG_INF:
                        continue
                    new = alpha[i, j] + lp
                    alpha[i + dg, j + dp] = _logsumexp(
                        alpha[i + dg, j + dp], new
                    )
        total = alpha[G, P]
        if total == NEG_INF or accumulate is None:
            return total
        beta = np.full((G + 1, P + 1), NEG_INF)
        beta[G, P] = 0.0
        for i in range(G, -1, -1):
            for j in range(P, -1, -1):
                for dg, dp in moves:
                    if i + dg > G or j + dp > P:
                        continue
                    if beta[i + dg, j + dp] == NEG_INF:
                        continue
                    key = (
                        tuple(graphemes[i : i + dg]) or (EPS,),
                        tuple(phones[j : j + dp]) or (EPS,),
                    )
                    lp = log_probs.get(key, NEG_INF)
                    if lp == NEG_INF:
                        continue
                    new = beta[i + dg, j + dp] + lp
                    beta[i, j] = _logsumexp(beta[i, j], new)
                    if alpha[i, j] > NEG_INF:
                        post = alpha[i, j] + lp + beta[i + dg, j + dp] - total
                        accumulate[key] += math.exp(min(post, 0.0))
        return total

    def _viterbi_align(self, graphemes, phones, log_probs):
        G, P = len(graphemes), len(phones)
        best = np.full((G + 1, P + 1), NEG_INF)
        back: Dict[Tuple[int, int], Tuple[int, int, tuple]] = {}
        best[0, 0] = 0.0
        moves = list(self._moves(G, P))
        for i in range(G + 1):
            for j in range(P + 1):
                if best[i, j] == NEG_INF:
                    continue
                for dg, dp in moves:
                    if i + dg > G or j + dp > P:
                        continue
                    key = (
                        tuple(graphemes[i : i + dg]) or (EPS,),
                        tuple(phones[j : j + dp]) or (EPS,),
                    )
                    lp = log_probs.get(key, NEG_INF)
                    if lp == NEG_INF:
                        continue
                    if best[i, j] + lp > best[i + dg, j + dp]:
                        best[i + dg, j + dp] = best[i, j] + lp
                        back[(i + dg, j + dp)] = (i, j, key)
        if best[G, P] == NEG_INF:
            return None
        path = []
        cur = (G, P)
        while cur != (0, 0):
            i, j, key = back[cur]
            path.append(key)
            cur = (i, j)
        return path[::-1]

    def train(self, pairs: List[Tuple[List[str], List[str]]]):
        """EM; returns Viterbi graphone sequences per pair."""
        # init: uniform over all co-occurring chunks
        counts: Dict[tuple, float] = defaultdict(float)
        for graphemes, phones in pairs:
            G, P = len(graphemes), len(phones)
            for i in range(G + 1):
                for j in range(P + 1):
                    for dg, dp in self._moves(G, P):
                        if i + dg > G or j + dp > P:
                            continue
                        key = (
                            tuple(graphemes[i : i + dg]) or (EPS,),
                            tuple(phones[j : j + dp]) or (EPS,),
                        )
                        counts[key] += 1.0
        log_probs = self._normalize(counts)
        for it in range(self.num_iterations):
            new_counts: Dict[tuple, float] = defaultdict(float)
            total_ll = 0.0
            aligned_pairs = 0
            for graphemes, phones in pairs:
                ll = self._lattice_pass(
                    graphemes, phones, log_probs, accumulate=new_counts
                )
                if ll > NEG_INF:
                    total_ll += ll
                    aligned_pairs += 1
            log_probs = self._normalize(new_counts)
            logger.info(
                "g2p EM iter %d: loglike %.1f over %d pairs",
                it, total_ll, aligned_pairs,
            )
        self.probs = log_probs
        out = []
        for graphemes, phones in pairs:
            path = self._viterbi_align(graphemes, phones, log_probs)
            out.append(path)
        return out

    @staticmethod
    def _normalize(counts: Dict[tuple, float]) -> Dict[tuple, float]:
        total = sum(counts.values())
        if total <= 0:
            return {}
        return {
            k: math.log(v / total)
            for k, v in counts.items()
            if v / total > 1e-9
        }


def graphone_symbol(key: Tuple[Tuple[str, ...], Tuple[str, ...]]) -> str:
    g, p = key
    return f"{JOIN.join(g)}{SEP}{JOIN.join(p)}"


def parse_graphone(sym: str) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    g, p = sym.split(SEP)
    return tuple(g.split(JOIN)), tuple(p.split(JOIN))


@dataclass
class G2PModel:
    """A trained G2P model: graphone LM + metadata."""

    lm: ArpaModel
    grapheme_order: int
    phone_order: int
    meta: dict = field(default_factory=dict)

    def save(self, path) -> None:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            self.lm.write(tmp / "g2p.arpa")
            with open(tmp / "meta.json", "w") as f:
                json.dump(
                    {
                        "grapheme_order": self.grapheme_order,
                        "phone_order": self.phone_order,
                        **self.meta,
                    },
                    f,
                )
            with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
                zf.write(tmp / "g2p.arpa", "g2p.arpa")
                zf.write(tmp / "meta.json", "meta.json")

    @classmethod
    def load(cls, path):
        import tempfile

        from montreal_forced_aligner_tpu_torch.g2p.openfst_model import (
            OpenFstG2PModel,
            is_reference_g2p_archive,
        )

        if is_reference_g2p_archive(path):
            # reference pynini-built archive (models.py:930): model.fst +
            # symbol tables; inference via the pynini-free OpenFst reader
            return OpenFstG2PModel.load(path)
        with tempfile.TemporaryDirectory() as tmp:
            with zipfile.ZipFile(path) as zf:
                zf.extractall(tmp)
            lm = ArpaModel.read(Path(tmp) / "g2p.arpa")
            with open(Path(tmp) / "meta.json") as f:
                meta = json.load(f)
        return cls(
            lm=lm,
            grapheme_order=meta.pop("grapheme_order", 2),
            phone_order=meta.pop("phone_order", 2),
            meta=meta,
        )


class G2PTrainer:
    """Train a G2P model from a pronunciation dictionary (reference entry
    point: ``mfa train_g2p``)."""

    def __init__(
        self,
        order: int = 8,
        grapheme_order: int = 2,
        phone_order: int = 2,
        num_alignment_iterations: int = 10,
        allow_deletions: bool = True,
        allow_insertions: bool = True,
    ):
        self.order = order
        self.aligner = Aligner(
            grapheme_order=grapheme_order,
            phone_order=phone_order,
            num_iterations=num_alignment_iterations,
            allow_deletions=allow_deletions,
            allow_insertions=allow_insertions,
        )

    def train_from_pairs(
        self, pairs: List[Tuple[str, Sequence[str]]]
    ) -> G2PModel:
        """pairs: [(word, phones)]"""
        data = [(list(word), list(phones)) for word, phones in pairs]
        alignments = self.aligner.train(data)
        counter = NgramCounter(self.order)
        n_ok = 0
        for path in alignments:
            if path is None:
                continue
            counter.add_sentence([graphone_symbol(k) for k in path])
            n_ok += 1
        logger.info("g2p: %d/%d entries aligned", n_ok, len(pairs))
        lm = train_ngram_model(counter)
        return G2PModel(
            lm=lm,
            grapheme_order=self.aligner.grapheme_order,
            phone_order=self.aligner.phone_order,
        )

    def train_from_dictionary(self, dictionary_path) -> G2PModel:
        from montreal_forced_aligner_tpu_torch.dictionary.lexicon import (
            parse_dictionary_file,
        )

        pairs = [
            (word, pron.phones)
            for word, pron in parse_dictionary_file(dictionary_path)
        ]
        return self.train_from_pairs(pairs)
