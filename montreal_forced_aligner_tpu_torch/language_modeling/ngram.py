"""N-gram language model training (modified Kneser-Ney) and ARPA I/O.

Replaces the reference's OpenGrm subprocess pipeline
(``language_modeling/multiprocessing.py:93-330``: ``farcompilestrings`` →
``ngramcount`` → ``ngrammake --method=kneser_ney`` → ``ngramshrink``) with a
self-contained implementation: counting, interpolated modified Kneser-Ney
estimation (Chen & Goodman discounts), count-threshold pruning for the
small/medium variants (reference ``MfaLmArpaTrainer``,
``language_modeling/trainer.py:532``), and ARPA read/write compatible with
the reference's ``ArpaNgramModel`` parser (``data.py:1583``).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BOS = "<s>"
EOS = "</s>"
UNK = "<unk>"

LOG10 = math.log(10.0)


class NgramCounter:
    def __init__(self, order: int = 3):
        self.order = order
        # counts[n] maps n-gram tuple -> count (n from 1..order)
        self.counts: List[Dict[Tuple[str, ...], int]] = [
            None
        ] + [defaultdict(int) for _ in range(order)]
        self.num_sentences = 0

    def add_sentence(self, words: Sequence[str]) -> None:
        toks = [BOS] + list(words) + [EOS]
        self.num_sentences += 1
        for n in range(1, self.order + 1):
            for i in range(len(toks) - n + 1):
                gram = tuple(toks[i : i + n])
                if n == 1 and gram == (BOS,):
                    continue  # ARPA convention: <s> has no unigram prob mass
                self.counts[n][gram] += 1
        # <s> still needs a unigram entry for backoff purposes
        self.counts[1][(BOS,)] = self.counts[1].get((BOS,), 0)

    def add_corpus(self, sentences: Iterable[Sequence[str]]) -> None:
        for s in sentences:
            self.add_sentence(s)


@dataclass
class ArpaModel:
    """Backoff n-gram model: per order, {ngram: (log10 prob, log10 backoff)}."""

    order: int
    ngrams: List[Dict[Tuple[str, ...], Tuple[float, float]]]

    @property
    def vocab(self) -> List[str]:
        return sorted(w for (w,) in self.ngrams[1])

    def log_prob(self, word: str, history: Tuple[str, ...] = ()) -> float:
        """Backoff log10 probability p(word | history)."""
        history = tuple(history)[-(self.order - 1) :] if self.order > 1 else ()
        while True:
            gram = history + (word,)
            n = len(gram)
            if n <= self.order and gram in self.ngrams[n]:
                return self.ngrams[n][gram][0]
            if not history:
                # OOV fallback
                if (UNK,) in self.ngrams[1]:
                    return self.ngrams[1][(UNK,)][0]
                return -99.0
            bo = self.ngrams[len(history)].get(history)
            backoff = bo[1] if bo is not None else 0.0
            history = history[1:]
            return backoff + self.log_prob(word, history)

    def sentence_log_prob(self, words: Sequence[str]) -> float:
        toks = [BOS] + list(words) + [EOS]
        total = 0.0
        for i in range(1, len(toks)):
            hist = tuple(toks[max(0, i - self.order + 1) : i])
            total += self.log_prob(toks[i], hist)
        return total

    def perplexity(self, sentences: Iterable[Sequence[str]]) -> float:
        total_lp = 0.0
        total_words = 0
        for s in sentences:
            total_lp += self.sentence_log_prob(s)
            total_words += len(s) + 1  # + </s>
        return 10 ** (-total_lp / max(total_words, 1))

    # -- ARPA serialization --------------------------------------------------
    def write(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("\\data\\\n")
            for n in range(1, self.order + 1):
                f.write(f"ngram {n}={len(self.ngrams[n])}\n")
            for n in range(1, self.order + 1):
                f.write(f"\n\\{n}-grams:\n")
                for gram in sorted(self.ngrams[n]):
                    lp, bo = self.ngrams[n][gram]
                    line = f"{lp:.6f}\t{' '.join(gram)}"
                    if n < self.order and abs(bo) > 1e-9:
                        line += f"\t{bo:.6f}"
                    f.write(line + "\n")
            f.write("\n\\end\\\n")

    @classmethod
    def read(cls, path) -> "ArpaModel":
        ngrams: List[Dict] = [None]
        order = 0
        current_n = 0
        with open(path, "r", encoding="utf-8") as f:
            for raw in f:
                line = raw.strip()
                if not line:
                    continue
                if line.startswith("ngram "):
                    order = max(order, int(line.split("=")[0].split()[1]))
                    while len(ngrams) <= order:
                        ngrams.append({})
                    continue
                if line.startswith("\\") and line.endswith("-grams:"):
                    current_n = int(line[1:].split("-")[0])
                    continue
                if line in ("\\data\\", "\\end\\"):
                    current_n = 0
                    continue
                if current_n:
                    parts = line.split("\t")
                    if len(parts) == 1:
                        parts = line.split()
                        lp = float(parts[0])
                        gram = tuple(parts[1 : 1 + current_n])
                        bo = (
                            float(parts[1 + current_n])
                            if len(parts) > 1 + current_n
                            else 0.0
                        )
                    else:
                        lp = float(parts[0])
                        gram = tuple(parts[1].split())
                        bo = float(parts[2]) if len(parts) > 2 else 0.0
                    ngrams[current_n][gram] = (lp, bo)
        return cls(order=order, ngrams=ngrams)

    def prune_relative_entropy(self, threshold: float) -> "ArpaModel":
        """Stolcke relative-entropy pruning (the reference's
        ``ngramshrink --method=relative_entropy`` used for the small/medium
        LM variants, ``language_modeling/trainer.py:122`` with thresholds
        3e-7 / 1e-7).

        An n-gram (h, w) is dropped when the weighted KL divergence its
        removal introduces is below ``threshold``:

            D = -P(h) * [ p(w|h) * (ln(a'(h) * p(w|h')) - ln p(w|h))
                          + beta(h) * (ln a'(h) - ln a(h)) ]

        where a(h)/a'(h) are the history's backoff weights before/after
        removal, beta(h) the backed-off (unseen) mass, and P(h) the history
        marginal estimated from the model itself (chain rule; a history
        starting with <s> uses p(</s>) for the start token, the standard
        sentence-frequency approximation). Pruning runs highest order first;
        histories of retained higher-order entries are protected, and all
        backoff weights are re-estimated afterwards.
        """
        out: List[Dict[Tuple[str, ...], Tuple[float, float]]] = [None] + [
            dict(self.ngrams[n]) for n in range(1, self.order + 1)
        ]

        def chain_logp(gram: Tuple[str, ...]) -> float:
            """log10 P(gram) via the chain rule on the (unpruned) model."""
            total = 0.0
            for i, w in enumerate(gram):
                if i == 0 and w == BOS:
                    # p(<s>) ~ p(</s>): sentence starts = sentence ends
                    total += self.log_prob(EOS)
                    continue
                total += self.log_prob(w, gram[:i])
            return total

        def seen_masses(n: int, hist, grams) -> Tuple[float, float]:
            """(sum of p(w|h) over seen, sum of p_lower(w|h') over seen)."""
            s_hi = 0.0
            s_lo = 0.0
            for g in grams:
                lp = out[n][g][0]
                if lp > -98:
                    s_hi += 10.0 ** lp
                s_lo += 10.0 ** self.log_prob(g[-1], hist[1:])
            return s_hi, s_lo

        for n in range(self.order, 1, -1):
            protected = set()
            if n < self.order:
                for g in out[n + 1]:
                    protected.add(g[:-1])
            by_hist: Dict[Tuple[str, ...], List[Tuple[str, ...]]] = defaultdict(
                list
            )
            for g in out[n]:
                by_hist[g[:-1]].append(g)
            for hist, grams in by_hist.items():
                P_h = 10.0 ** chain_logp(hist)
                s_hi, s_lo = seen_masses(n, hist, grams)
                num = max(1.0 - s_hi, 1e-12)
                den = max(1.0 - s_lo, 1e-12)
                alpha = num / den
                log_alpha = math.log(alpha)
                for g in grams:
                    if g in protected:
                        continue
                    lp, _bo = out[n][g]
                    if lp <= -98:
                        continue  # context-only entries carry no mass
                    p = 10.0 ** lp
                    p_lo = 10.0 ** self.log_prob(g[-1], hist[1:])
                    num2 = min(num + p, 1.0)
                    den2 = min(den + p_lo, 1.0)
                    alpha2 = max(num2, 1e-12) / max(den2, 1e-12)
                    log_alpha2 = math.log(alpha2)
                    d = -P_h * (
                        p * (log_alpha2 + math.log(max(p_lo, 1e-12)) - math.log(p))
                        + num * (log_alpha2 - log_alpha)
                    )
                    if d < threshold:
                        del out[n][g]

        # re-estimate backoff weights bottom-up over the pruned entry sets,
        # using the PRUNED model's own lower-order (possibly backed-off)
        # probabilities so every history still normalizes exactly
        def pruned_logp(w: str, history: Tuple[str, ...]) -> float:
            history = history[-(self.order - 1):] if self.order > 1 else ()
            while True:
                gram = history + (w,)
                entry = out[len(gram)].get(gram) if len(gram) <= self.order else None
                if entry is not None and entry[0] > -98:
                    return entry[0]
                if not history:
                    if entry is not None:
                        return entry[0]
                    unk = out[1].get((UNK,))
                    return unk[0] if unk is not None else -99.0
                ho = out[len(history)].get(history)
                backoff = ho[1] if ho is not None else 0.0
                return backoff + pruned_logp(w, history[1:])

        for n in range(1, self.order):
            conts: Dict[Tuple[str, ...], List[Tuple[str, ...]]] = defaultdict(
                list
            )
            for g in out[n + 1]:
                conts[g[:-1]].append(g)
            for hist in list(out[n]):
                lp, _old_bo = out[n][hist]
                grams = conts.get(hist)
                if not grams:
                    out[n][hist] = (lp, 0.0)
                    continue
                s_hi = sum(
                    10.0 ** out[n + 1][g][0]
                    for g in grams
                    if out[n + 1][g][0] > -98
                )
                s_lo = sum(
                    10.0 ** pruned_logp(g[-1], hist[1:]) for g in grams
                )
                bo = math.log10(
                    max(1.0 - s_hi, 1e-12) / max(1.0 - s_lo, 1e-12)
                )
                out[n][hist] = (lp, bo)
        return ArpaModel(order=self.order, ngrams=out)

    def prune_by_count(
        self, counter: NgramCounter, min_counts: Dict[int, int]
    ) -> "ArpaModel":
        """Drop higher-order entries with training counts below thresholds
        (the reference's small/medium shrunken models, ``trainer.py:532``)."""
        out = [None] + [dict(self.ngrams[n]) for n in range(1, self.order + 1)]
        for n in range(2, self.order + 1):
            thr = min_counts.get(n, 0)
            if thr <= 1:
                continue
            out[n] = {
                g: v
                for g, v in out[n].items()
                if counter.counts[n].get(g, 0) >= thr
            }
        return ArpaModel(order=self.order, ngrams=out)


def _kn_discounts(counts: Dict[Tuple[str, ...], int]) -> Tuple[float, float, float]:
    """Chen & Goodman modified KN discounts (D1, D2, D3+)."""
    n1 = sum(1 for c in counts.values() if c == 1)
    n2 = sum(1 for c in counts.values() if c == 2)
    n3 = sum(1 for c in counts.values() if c == 3)
    n4 = sum(1 for c in counts.values() if c == 4)
    if n1 == 0 or n2 == 0:
        return 0.5, 1.0, 1.5
    y = n1 / (n1 + 2.0 * n2)
    d1 = max(1e-3, 1.0 - 2.0 * y * n2 / n1)
    d2 = max(1e-3, 2.0 - 3.0 * y * (n3 / n2)) if n2 else 1.0
    d3 = max(1e-3, 3.0 - 4.0 * y * (n4 / n3)) if n3 else 1.5
    return d1, d2, d3


def train_ngram_model(counter: NgramCounter) -> ArpaModel:
    """Interpolated modified Kneser-Ney estimation over accumulated counts."""
    order = counter.order

    # continuation counts for lower orders: N1+(. gram)
    cont_counts: List[Dict[Tuple[str, ...], int]] = [None] + [
        defaultdict(int) for _ in range(order)
    ]
    for n in range(2, order + 1):
        for gram in counter.counts[n]:
            cont_counts[n - 1][gram[1:]] += 1

    def counts_for(n: int) -> Dict[Tuple[str, ...], int]:
        # highest order uses raw counts; lower orders continuation counts,
        # except grams starting with <s> which only occur in context
        if n == order:
            return counter.counts[n]
        merged = dict(cont_counts[n])
        for gram, c in counter.counts[n].items():
            if gram not in merged:
                merged[gram] = c
        return merged

    probs: List[Dict[Tuple[str, ...], float]] = [None] + [
        {} for _ in range(order)
    ]
    backoffs: List[Dict[Tuple[str, ...], float]] = [None] + [
        {} for _ in range(order)
    ]

    # unigram (n=1): continuation distribution with uniform interpolation
    uni = counts_for(1)
    vocab = set(w for (w,) in counter.counts[1]) | {UNK, EOS}
    for w in vocab:
        uni.setdefault((w,), 0)
    d1, d2, d3 = _kn_discounts({g: c for g, c in uni.items() if c > 0})
    total = sum(uni.values())
    V = len(vocab)
    discounted_mass = 0.0
    for g, c in uni.items():
        if c > 0:
            d = d1 if c == 1 else (d2 if c == 2 else d3)
            discounted_mass += d
    gamma = discounted_mass / max(total, 1)
    for g, c in uni.items():
        if c > 0:
            d = d1 if c == 1 else (d2 if c == 2 else d3)
            p = (c - d) / max(total, 1) + gamma / V
        else:
            p = gamma / V
        probs[1][g] = max(p, 1e-10)
    # renormalize (over non-<s> events; <s> is never predicted)
    z = sum(p for g, p in probs[1].items() if g != (BOS,))
    for g in probs[1]:
        if g != (BOS,):
            probs[1][g] /= z

    # higher orders
    for n in range(2, order + 1):
        cc = counts_for(n)
        d1, d2, d3 = _kn_discounts(cc)
        by_hist: Dict[Tuple[str, ...], List[Tuple[Tuple[str, ...], int]]] = (
            defaultdict(list)
        )
        for gram, c in cc.items():
            by_hist[gram[:-1]].append((gram, c))
        for hist, items in by_hist.items():
            total = sum(c for _g, c in items)
            if total == 0:
                continue
            discounted = 0.0
            for _g, c in items:
                d = d1 if c == 1 else (d2 if c == 2 else d3)
                discounted += min(d, c)
            gamma = discounted / total
            backoffs[n - 1][hist] = max(gamma, 1e-10)
            for gram, c in items:
                d = d1 if c == 1 else (d2 if c == 2 else d3)
                lower = probs[n - 1].get(gram[1:], 1e-10)
                p = max(c - d, 0.0) / total + gamma * lower
                probs[n][gram] = max(p, 1e-10)

    # assemble ARPA entries. Backoff weight of a history h (stored on the
    # n-gram h, used for order n+1 predictions) renormalizes the leftover
    # probability mass over unseen continuations:
    #   bo(h) = (1 - sum_seen p_{n+1}(h, w)) / (1 - sum_seen p_n(h', w))
    cont_by_hist: List[Dict[Tuple[str, ...], List[Tuple[str, ...]]]] = [
        None
    ] + [defaultdict(list) for _ in range(order)]
    for n in range(2, order + 1):
        for gram in probs[n]:
            cont_by_hist[n - 1][gram[:-1]].append(gram)

    ngrams: List[Dict[Tuple[str, ...], Tuple[float, float]]] = [None] + [
        {} for _ in range(order)
    ]
    for n in range(1, order + 1):
        for gram, p in probs[n].items():
            lp = math.log10(p) if gram != (BOS,) else -99.0
            bo = 0.0
            if n < order and cont_by_hist[n].get(gram):
                num = 1.0
                den = 1.0
                for g2 in cont_by_hist[n][gram]:
                    num -= probs[n + 1][g2]
                    den -= probs[n].get(g2[1:], 0.0) if n >= 2 else probs[1].get(
                        g2[-1:], 0.0
                    )
                num = max(num, 1e-10)
                den = max(den, 1e-10)
                bo = math.log10(max(num / den, 1e-10))
            ngrams[n][gram] = (lp, bo)
    # histories that appear only as context (e.g. <s>, <s> w) still need
    # entries to carry their backoff weights
    for n in range(1, order):
        for hist, conts in cont_by_hist[n].items():
            if hist in ngrams[n]:
                continue
            num = 1.0
            den = 1.0
            for g2 in conts:
                num -= probs[n + 1][g2]
                den -= probs[n].get(g2[1:], 0.0) if n >= 2 else probs[1].get(
                    g2[-1:], 0.0
                )
            bo = math.log10(max(max(num, 1e-10) / max(den, 1e-10), 1e-10))
            ngrams[n][hist] = (-99.0, bo)
    return ArpaModel(order=order, ngrams=ngrams)


def train_lm_from_texts(
    texts: Iterable[str], order: int = 3
) -> Tuple[ArpaModel, NgramCounter]:
    counter = NgramCounter(order)
    for text in texts:
        counter.add_sentence(text.split())
    return train_ngram_model(counter), counter
