"""ARPA backoff n-gram model <-> binary OpenFst n-gram acceptor.

The reference bundles its phone language model as ``phone_lm.fst`` inside
trained acoustic archives (reference ``models.py:367-379``; produced by
``train_phone_lm``, reference ``transcription/transcriber.py:737-760`` via
OpenGrm ``ngramcount | ngrammake``). This module converts between that
on-disk form and this framework's :class:`ArpaModel` so repo-trained
archives are member-for-member drop-ins and genuine MFA archives'
``phone_lm.fst`` drives ``--use_phone_model`` here.

Layout produced/consumed (the OpenGrm n-gram model convention):

- one state per proper history; the empty history is the unigram state
  and ``(<s>,)`` is the start state
- word arcs ``w`` leave state ``h`` at weight ``-ln P(w | h)`` and enter
  the state of the longest suffix of ``h + (w,)`` that is a history
- backoff is an epsilon arc (label 0) to the next-shorter history at
  weight ``-ln alpha(h)``
- ``</s>`` probabilities are final weights, never arcs
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch.io.openfst import SimpleFst
from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
    BOS,
    EOS,
    LOG10 as LN10,
    ArpaModel,
)

# ARPA's conventional "context only, never predicted" log10 probability
_CONTEXT_ONLY_LP = -99.0


def arpa_to_ngram_fst(
    lm: ArpaModel, symbols: Dict[str, int]
) -> SimpleFst:
    """Compile an :class:`ArpaModel` into an n-gram acceptor over the
    given symbol table (labels are ``symbols[word]``; words absent from
    the table are dropped with their mass left to backoff)."""
    histories = {()}
    for n in range(1, lm.order):
        for gram in lm.ngrams[n]:
            if gram[-1] == EOS:
                continue
            histories.add(gram)
    state_of = {
        h: i
        for i, h in enumerate(sorted(histories, key=lambda t: (len(t), t)))
    }
    num_states = len(state_of)
    arcs: List[List[Tuple[int, int, float, int]]] = [
        [] for _ in range(num_states)
    ]
    finals = np.full(num_states, np.inf, dtype=np.float32)

    def dest_state(hist: Tuple[str, ...], word: str) -> int:
        nxt = (hist + (word,))[-(lm.order - 1):] if lm.order > 1 else ()
        while nxt not in state_of:
            nxt = nxt[1:]
        return state_of[nxt]

    for n in range(1, lm.order + 1):
        for gram, (lp, _bo) in lm.ngrams[n].items():
            hist, word = gram[:-1], gram[-1]
            if hist not in state_of:
                continue
            s = state_of[hist]
            cost = -lp * LN10
            if word == EOS:
                finals[s] = min(finals[s], cost)
                continue
            if word == BOS:
                continue
            label = symbols.get(word)
            if label is None:
                continue
            arcs[s].append((label, label, float(cost), dest_state(hist, word)))
    for n in range(1, lm.order):
        for gram, (_lp, bo) in lm.ngrams[n].items():
            if gram not in state_of or len(gram) == 0:
                continue
            s = state_of[gram]
            shorter = gram[1:]
            while shorter not in state_of:
                shorter = shorter[1:]
            arcs[s].append((0, 0, float(-bo * LN10), state_of[shorter]))

    start_hist = (BOS,) if (BOS,) in state_of else ()
    return SimpleFst(
        start=state_of[start_hist], arcs=arcs, finals=finals,
        arc_type="standard",
    )


def ngram_fst_to_arpa(
    fst: SimpleFst, symbols: Dict[str, int]
) -> ArpaModel:
    """Recover an :class:`ArpaModel` from an n-gram acceptor (the inverse
    of :func:`arpa_to_ngram_fst`, also reads OpenGrm ``ngrammake``
    output). ``symbols`` maps word -> arc label; an embedded input table
    takes precedence (it is exact for the FST's own labels — external
    tables may be position-stripped or partial)."""
    if fst.isymbols:
        symbols = fst.isymbols
    id_to_sym = {int(i): w for w, i in symbols.items()}

    # histories by breadth-first discovery from the shortest contexts:
    # the unigram state (no epsilon arc out) is (), the start state is
    # (<s>,); a state first reached from history h via word w is the
    # history h + (w,). BFS order guarantees every state is discovered
    # through its own (unique, shortest-path) context.
    backoff_of: Dict[int, Tuple[float, int]] = {}
    for s in range(fst.num_states):
        for il, _ol, w, nx in fst.arcs[s]:
            if il == 0:
                backoff_of[s] = (float(w), int(nx))
                break
    unigram_states = [
        s for s in range(fst.num_states) if s not in backoff_of
    ]
    if len(unigram_states) != 1:
        raise ValueError(
            "not an n-gram model FST: expected exactly one state without "
            f"a backoff arc, found {len(unigram_states)}"
        )
    ctx: Dict[int, Tuple[str, ...]] = {unigram_states[0]: ()}
    queue = deque([unigram_states[0]])
    if fst.start != unigram_states[0]:
        ctx[fst.start] = (BOS,)
        queue.append(fst.start)
    order = 1
    while queue:
        s = queue.popleft()
        h = ctx[s]
        for il, _ol, _w, nx in fst.arcs[s]:
            if il == 0 or nx in ctx:
                continue
            word = id_to_sym.get(int(il))
            if word is None:
                raise ValueError(f"arc label {il} missing from symbol table")
            ctx[nx] = h + (word,)
            order = max(order, len(ctx[nx]) + 1)
            queue.append(nx)

    ngrams: List[Dict[Tuple[str, ...], Tuple[float, float]]] = [None] + [
        {} for _ in range(order)
    ]

    def set_lp(gram: Tuple[str, ...], lp: float) -> None:
        old = ngrams[len(gram)].get(gram)
        ngrams[len(gram)][gram] = (lp, old[1] if old else 0.0)

    def set_bo(gram: Tuple[str, ...], bo: float) -> None:
        old = ngrams[len(gram)].get(gram)
        ngrams[len(gram)][gram] = (
            old[0] if old else _CONTEXT_ONLY_LP, bo
        )

    for s in range(fst.num_states):
        h = ctx.get(s)
        if h is None:  # unreachable state
            continue
        for il, _ol, w, nx in fst.arcs[s]:
            if il == 0:
                if h:
                    set_bo(h, -float(w) / LN10)
                continue
            word = id_to_sym[int(il)]
            set_lp(h + (word,), -float(w) / LN10)
        if np.isfinite(fst.finals[s]):
            set_lp(h + (EOS,), -float(fst.finals[s]) / LN10)
    # every context must exist as an entry at its own order (ARPA
    # requirement); <s> conventionally gets the -99 placeholder
    for s, h in ctx.items():
        if h and h not in ngrams[len(h)]:
            ngrams[len(h)][h] = (_CONTEXT_ONLY_LP, 0.0)
    return ArpaModel(order=order, ngrams=ngrams)
