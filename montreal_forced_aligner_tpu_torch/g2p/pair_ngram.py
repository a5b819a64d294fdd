"""Pair-ngram G2P trainer with random-start EM — the reference's DEFAULT
G2P engine (``PyniniTrainer``, ``g2p/trainer.py:79-880``), as a second,
genuinely distinct engine next to the Phonetisaurus-style trainer
(``g2p/trainer.py`` here; reference ``g2p/phonetisaurus_trainer.py``).

Differences mirroring the two reference engines:

===============  ==============================  =========================
aspect           pair-ngram (this module)        phonetisaurus (trainer.py)
===============  ==============================  =========================
alignment unit   1 grapheme x 1 phone pairs      multi-grapheme / multi-
                 plus insertions & deletions     phone chunks, no ins/del
initialization   N seeded RANDOM starts, best    single uniform-count init
                 total likelihood kept
                 (reference ``RandomStartWorker``
                 ``trainer.py:79``, baumwelch)
EM               Baum-Welch to convergence per   fixed iteration count
                 start (delta threshold)
LM               pair-symbol n-gram (order 8)    graphone n-gram (order 8)
===============  ==============================  =========================

Both produce the shared :class:`~montreal_forced_aligner_tpu_torch.g2p.trainer.
G2PModel` archive (a graphone/pair-symbol ARPA LM), so the shortest-path
generator serves either.
"""

from __future__ import annotations

import logging
import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch.g2p.trainer import (
    EPS,
    NEG_INF,
    Aligner,
    G2PModel,
    graphone_symbol,
)
from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
    NgramCounter,
    train_ngram_model,
)

logger = logging.getLogger("mfa_tpu")


class RandomStartAligner(Aligner):
    """1:1 pair aligner trained by random-start Baum-Welch.

    Matches the reference's pynini/baumwelch pipeline semantics: several
    independently seeded starts, EM until the likelihood gain per pair
    drops below ``em_threshold`` (or ``max_em_iterations``), keep the
    start with the best total likelihood.
    """

    def __init__(
        self,
        num_random_starts: int = 10,
        max_em_iterations: int = 20,
        em_threshold: float = 1e-3,
        seed: int = 1917,  # reference default seed (g2p/trainer.py)
    ):
        super().__init__(
            grapheme_order=1,
            phone_order=1,
            allow_deletions=True,
            allow_insertions=True,
            num_iterations=max_em_iterations,
        )
        self.num_random_starts = num_random_starts
        self.max_em_iterations = max_em_iterations
        self.em_threshold = em_threshold
        self.seed = seed

    def _pair_space(self, pairs) -> List[tuple]:
        keys = set()
        for graphemes, phones in pairs:
            for g in graphemes:
                keys.add(((g,), (EPS,)))
                for p in phones:
                    keys.add(((g,), (p,)))
            for p in phones:
                keys.add(((EPS,), (p,)))
        return sorted(keys)

    def _em_run(self, pairs, log_probs) -> Tuple[Dict[tuple, float], float]:
        """Baum-Welch from the given init; returns (probs, total_ll)."""
        total_ll = NEG_INF
        prev_ll = None
        for it in range(self.max_em_iterations):
            counts: Dict[tuple, float] = defaultdict(float)
            total_ll = 0.0
            n_ok = 0
            for graphemes, phones in pairs:
                ll = self._lattice_pass(
                    graphemes, phones, log_probs, accumulate=counts
                )
                if ll > NEG_INF:
                    total_ll += ll
                    n_ok += 1
            log_probs = self._normalize(counts)
            if prev_ll is not None and n_ok:
                if (total_ll - prev_ll) / max(n_ok, 1) < self.em_threshold:
                    break
            prev_ll = total_ll
        return log_probs, total_ll

    def train(self, pairs):
        space = self._pair_space(pairs)
        rng = np.random.RandomState(self.seed)
        best_probs = None
        best_ll = -math.inf
        for start in range(self.num_random_starts):
            # random init: Dirichlet-ish draw over the co-occurring pair
            # space (the reference seeds baumwelch randomly per start)
            raw = rng.gamma(1.0, 1.0, size=len(space)) + 1e-6
            raw /= raw.sum()
            init = {k: math.log(v) for k, v in zip(space, raw)}
            probs, ll = self._em_run(pairs, init)
            logger.info(
                "pair-ngram random start %d/%d: loglike %.1f%s",
                start + 1, self.num_random_starts, ll,
                " (best)" if ll > best_ll else "",
            )
            if ll > best_ll:
                best_ll = ll
                best_probs = probs
        self.probs = best_probs
        out = []
        for graphemes, phones in pairs:
            out.append(self._viterbi_align(graphemes, phones, best_probs))
        return out


class PairNgramTrainer:
    """Reference-default G2P engine: random-start EM pair alignments +
    pair-symbol n-gram LM (``mfa train_g2p`` without --phonetisaurus)."""

    def __init__(
        self,
        order: int = 8,
        num_random_starts: int = 10,
        max_em_iterations: int = 20,
        seed: int = 1917,
    ):
        self.order = order
        self.aligner = RandomStartAligner(
            num_random_starts=num_random_starts,
            max_em_iterations=max_em_iterations,
            seed=seed,
        )

    def train_from_pairs(
        self, pairs: List[Tuple[str, Sequence[str]]]
    ) -> G2PModel:
        data = [(list(word), list(phones)) for word, phones in pairs]
        alignments = self.aligner.train(data)
        counter = NgramCounter(self.order)
        n_ok = 0
        for path in alignments:
            if path is None:
                continue
            counter.add_sentence([graphone_symbol(k) for k in path])
            n_ok += 1
        logger.info(
            "pair-ngram g2p: %d/%d entries aligned", n_ok, len(pairs)
        )
        lm = train_ngram_model(counter)
        return G2PModel(
            lm=lm,
            grapheme_order=1,
            phone_order=1,
            meta={"engine": "pair_ngram"},
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
