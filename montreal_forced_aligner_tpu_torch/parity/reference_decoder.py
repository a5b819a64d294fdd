"""Independent Kaldi-semantics forced aligner (pure numpy, slow, exact).

This module deliberately re-derives the alignment computation from the
Kaldi/MFA *specification* rather than sharing the production code path, so a
systematic bug in the production graph compiler or DP cannot hide:

- graph construction follows ``compile-train-graphs`` /
  ``TrainingGraphCompiler`` semantics (reference call sites
  ``alignment/multiprocessing.py:537-571``, ``online/alignment.py:77-96``):
  an explicit FST is built as L (optional-silence lexicon acceptor) composed
  with C and H (topology HMMs with Kaldi's self-loop reweighting), keeping
  epsilon arcs — no frontier/template machinery, no shared builder with the
  production compiler (``graph/compiler.py``);
- decoding follows ``gmm-align-compiled`` / ``FasterDecoder`` token passing
  (ProcessEmitting / ProcessNonemitting per frame with beam pruning;
  defaults per ``alignment/mixins.py:68-95``: beam 10, retry_beam 40,
  acoustic_scale 0.1, transition_scale 1.0, self_loop_scale 0.1).

Weight conventions (log-probability / max-plus domain, so scores compare
directly with the production DP):

- non-self-loop transition out of an HMM state with self-loop prob ``p``:
  ``transition_scale * log(p_fwd / (1 - p)) + self_loop_scale * log(1 - p)``
  (Kaldi ``AddTransitionProbs``: graph weights are built on the
  self-loop-free HMM with renormalized forward probs, then ``AddSelfLoops``
  folds ``log(1-p)`` back at ``self_loop_scale``);
- self-loop: ``self_loop_scale * log(p)``;
- pronunciation variant: ``log(probability)`` (0 when unset);
- optional silence: ``log(p_sil)`` / ``log(1 - p_sil)`` branch weights with
  ``initial_silence_probability`` for the leading silence
  (``dictionary/mixins.py:91-194`` defaults 0.5).

Kaldi frame semantics: each frame is consumed by a transition-id arc
*leaving* an HMM state, whose pdf is the source state's pdf — equivalent to
the production formulation (state emits on arrival) frame for frame.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NEG_INF = float("-inf")


def _log(p: float) -> float:
    return math.log(p) if p > 0 else NEG_INF


@dataclass
class _Fst:
    """Explicit FST: arcs are (dst, tid, weight); tid 0 = epsilon
    (non-emitting). State 0 is the start. Final weights in log-prob
    domain (max-plus)."""

    arcs: List[List[Tuple[int, int, float]]] = field(default_factory=list)
    finals: Dict[int, float] = field(default_factory=dict)

    def state(self) -> int:
        self.arcs.append([])
        return len(self.arcs) - 1

    def arc(self, src: int, dst: int, tid: int, w: float) -> None:
        self.arcs[src].append((dst, tid, w))

    def final(self, s: int, w: float) -> None:
        if s not in self.finals or self.finals[s] < w:
            self.finals[s] = w


class ReferenceAligner:
    """Builds utterance FSTs and token-passes features against them.

    ``lexicon`` supplies word→pronunciation lookup and the phone symbol
    table; graph structure and weights are derived here, independently of
    the production compiler."""

    def __init__(
        self,
        transition_model,
        tree,
        lexicon,
        transition_scale: float = 1.0,
        self_loop_scale: float = 0.1,
        acoustic_scale: float = 0.1,
    ):
        self.tm = transition_model
        self.tree = tree
        self.lexicon = lexicon
        self.transition_scale = transition_scale
        self.self_loop_scale = self_loop_scale
        self.acoustic_scale = acoustic_scale

    # ------------------------------------------------------------------ graph
    def _hmm(self, fst: _Fst, window: Tuple[int, ...]) -> Tuple[int, int]:
        """Expand one phone-in-context HMM; returns (entry, exit) states
        (exit is non-emitting: the destination of the topology's
        final-state arcs)."""
        tm, tree = self.tm, self.tree
        phone = window[tree.P]
        entry_states = tm.topo.entry_for_phone(phone)
        n_emit = sum(1 for s in entry_states if s.forward_pdf_class >= 0)
        final_idx = next(
            (j for j, s in enumerate(entry_states) if s.forward_pdf_class < 0),
            None,
        )
        ids = [fst.state() for _ in range(n_emit)]
        exit_state = fst.state()
        ts, sls = self.transition_scale, self.self_loop_scale
        for j in range(n_emit):
            fwd_pdf = tree.compute_pdf(
                list(window), entry_states[j].forward_pdf_class
            )
            slf_pdf = tree.compute_pdf(
                list(window), entry_states[j].self_loop_pdf_class
            )
            tstate = tm.tuple_to_transition_state(phone, j, fwd_pdf, slf_pdf)
            trans = tm.transitions_of_state(tstate)
            p_self = 0.0
            for _tid, dst, logp in trans:
                if dst == j:
                    p_self = math.exp(logp)
            log_1m = _log(1.0 - p_self) if p_self < 1.0 else NEG_INF
            for tid, dst, logp in trans:
                if dst == j:
                    fst.arc(ids[j], ids[j], tid, sls * logp)
                else:
                    w = (
                        ts * (logp - log_1m) + sls * log_1m
                        if p_self > 0
                        else ts * logp
                    )
                    target = exit_state if dst == final_idx else ids[dst]
                    fst.arc(ids[j], target, tid, w)
        return ids[0], exit_state

    def _pron_ids(self, pron) -> List[int]:
        lex = self.lexicon
        if lex.position_dependent:
            return lex.pronunciation_phone_ids(pron.phones)
        return [lex.phone_id(p, None) for p in pron.phones]

    def build_fst(self, tokens: Sequence[str]) -> Tuple[_Fst, List[str]]:
        """L∘C∘H with optional silences and cross-word context.

        The expansion enumerates, per word position, every
        (left context, pronunciation, right context) combination as its own
        fully materialized phone chain: exactly the paths the reference's
        C-composition yields, with no instance sharing or caching — the
        literal composition, traded for size."""
        lex = self.lexicon
        fst = _Fst()
        start = fst.state()  # state 0
        sil = lex.phone_id(lex.silence_phone, None)
        EPS = 0
        N = self.tree.N

        words: List[str] = []
        prons: List[List[Tuple[object, List[int]]]] = []
        for tok in tokens:
            out_word, variants = lex.lookup(tok)
            words.append(out_word)
            prons.append([(p, self._pron_ids(p)) for p in variants])

        def window(l: int, c: int, r: int) -> Tuple[int, ...]:
            return (c,) if N == 1 else (l, c, r)

        def chain(pids: List[int], left: int, right: int) -> Tuple[int, int]:
            entry = None
            prev_exit = None
            for k, ph in enumerate(pids):
                l = pids[k - 1] if k > 0 else left
                r = pids[k + 1] if k < len(pids) - 1 else right
                e, x = self._hmm(fst, window(l, ph, r))
                if entry is None:
                    entry = e
                if prev_exit is not None:
                    fst.arc(prev_exit, e, EPS, 0.0)
                prev_exit = x
            return entry, prev_exit

        p_init = lex.initial_silence_probability
        fsc = getattr(lex, "final_silence_correction", None)
        fnsc = getattr(lex, "final_non_silence_correction", None)
        sil_corr = _log(fsc) if fsc else 0.0
        nonsil_corr = _log(fnsc) if fnsc else 0.0

        if not words:
            e, x = chain([sil], EPS, EPS)
            fst.arc(start, e, EPS, 0.0)
            fst.final(x, 0.0)
            return fst, words

        # junction states between word slots, keyed by
        # (emitted phone = next word's left context, required first phone or
        # None). A path may only continue into a word whose first phone
        # matches the right context its previous instance was built for.
        junctions: Dict[tuple, int] = {(EPS, None): fst.state()}
        fst.arc(start, junctions[(EPS, None)], EPS, _log(1.0 - p_init))
        first_phones = sorted({pids[0] for _p, pids in prons[0]})
        for fp in first_phones:
            e, x = chain([sil], EPS, fp)
            fst.arc(start, e, EPS, _log(p_init))
            j = fst.state()
            fst.arc(x, j, EPS, 0.0)
            junctions[(sil, fp)] = j

        for w_idx in range(len(words)):
            is_last = w_idx == len(words) - 1
            next_first = (
                [EPS]
                if is_last
                else sorted({pids[0] for _p, pids in prons[w_idx + 1]})
            )
            cur_junctions = junctions
            junctions = {}

            def out_junction(key) -> int:
                if key not in junctions:
                    junctions[key] = fst.state()
                return junctions[key]

            for pron, pids in prons[w_idx]:
                prob = pron.probability if pron.probability is not None else 1.0
                pron_w = _log(max(min(prob, 1.0), 1e-5))
                p_sil = (
                    pron.silence_after_probability
                    if getattr(pron, "silence_after_probability", None)
                    is not None
                    else lex.silence_probability
                )
                for (left, allowed), jstate in cur_junctions.items():
                    if allowed is not None and pids[0] != allowed:
                        continue
                    # word followed directly by the next word (no silence):
                    # one instance per distinct next first phone
                    for nf in next_first:
                        e, x = chain(list(pids), left, nf)
                        fst.arc(jstate, e, EPS, pron_w)
                        if is_last:
                            fst.final(x, _log(1.0 - p_sil) + nonsil_corr)
                        else:
                            j = out_junction((pids[-1], nf))
                            fst.arc(x, j, EPS, _log(1.0 - p_sil))
                    # word followed by optional silence: the word instance is
                    # built with silence right context, then one silence
                    # instance per next first phone
                    e, x = chain(list(pids), left, sil)
                    fst.arc(jstate, e, EPS, pron_w)
                    for nf in next_first:
                        se, sx = chain([sil], pids[-1], nf)
                        fst.arc(x, se, EPS, _log(p_sil))
                        if is_last:
                            fst.final(sx, sil_corr)
                        else:
                            j = out_junction((sil, nf))
                            fst.arc(sx, j, EPS, 0.0)

        return fst, words

    # ----------------------------------------------------------------- decode
    def align(
        self,
        loglikes: np.ndarray,  # (T, num_pdfs) per-frame pdf loglikes
        tokens: Sequence[str],
        beam: float = float("inf"),
    ):
        """Token passing (FasterDecoder structure: ProcessEmitting +
        ProcessNonemitting per frame, beam pruning relative to the best
        token). Returns (frame_tids, frame_phones, score) or
        (None, None, -inf) when the beam kills every path."""
        fst, _words = self.build_fst(tokens)
        n = len(fst.arcs)
        src, dst, tid, wgt = [], [], [], []
        for s, lst in enumerate(fst.arcs):
            for d, t, w in lst:
                src.append(s)
                dst.append(d)
                tid.append(t)
                wgt.append(w)
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        tid = np.asarray(tid, np.int64)
        wgt = np.asarray(wgt, np.float64)
        emit = tid > 0
        arc_pdf = np.asarray(self.tm.id2pdf, np.int64)[tid]
        e_src, e_dst, e_w, e_pdf = src[emit], dst[emit], wgt[emit], arc_pdf[emit]
        e_idx = np.flatnonzero(emit)
        n_src, n_dst, n_w = src[~emit], dst[~emit], wgt[~emit]
        n_idx = np.flatnonzero(~emit)

        def process_nonemitting(cost, eps_bp):
            # relax epsilon arcs to a fixed point (the graph's eps arcs are
            # acyclic: chains word-exit -> junction -> word-entry)
            for _ in range(n):
                cand = cost[n_src] + n_w
                if not (cand > cost[n_dst]).any():
                    break
                order = np.argsort(cand, kind="stable")
                np.maximum.at(cost, n_dst, cand)
                hit = cand[order] == cost[n_dst[order]]
                eps_bp[n_dst[order][hit]] = n_idx[order][hit]
            return cost

        T = loglikes.shape[0]
        cost = np.full(n, NEG_INF)
        cost[0] = 0.0
        eps_bp0 = np.full(n, -1, np.int64)
        cost = process_nonemitting(cost, eps_bp0)
        bp_arc = np.zeros((T, n), np.int32)
        eps_bps = []
        eps_flags = []  # per frame: did the state's best token arrive by eps?

        for t in range(T):
            ll = self.acoustic_scale * loglikes[t]
            cand = cost[e_src] + e_w + ll[e_pdf]
            new_cost = np.full(n, NEG_INF)
            bp = np.full(n, -1, np.int64)
            order = np.argsort(cand, kind="stable")
            new_cost[e_dst[order]] = cand[order]
            bp[e_dst[order]] = e_idx[order]
            best = new_cost.max()
            if np.isfinite(best) and np.isfinite(beam):
                bp[new_cost < best - beam] = -1
                new_cost[new_cost < best - beam] = NEG_INF
            emit_cost = new_cost.copy()
            eps_bp = np.full(n, -1, np.int64)
            new_cost = process_nonemitting(new_cost, eps_bp)
            bp_arc[t] = bp
            eps_bps.append(eps_bp.astype(np.int32))
            # an eps move is only on the best path where it strictly
            # improved on the post-emission cost (ties prefer the emission)
            eps_flags.append(new_cost > emit_cost)
            cost = new_cost

        finals = np.full(n, NEG_INF)
        for s, w in fst.finals.items():
            finals[s] = w
        total = cost + finals
        end_state = int(np.argmax(total))
        score = float(total[end_state])
        if not np.isfinite(score):
            return None, None, score

        frame_tids = np.zeros(T, np.int64)
        state = end_state
        for t in range(T - 1, -1, -1):
            via, ebp = eps_flags[t], eps_bps[t]
            guard = 0
            while via[state]:
                a = int(ebp[state])
                assert a >= 0, (t, state)
                state = int(src[a])
                guard += 1
                assert guard <= n, "epsilon backtrace cycle"
            a = int(bp_arc[t][state])
            assert a >= 0, (t, state)
            frame_tids[t] = tid[a]
            state = int(src[a])
        frame_phones = np.array(
            [self.tm.transition_id_to_phone(int(t)) for t in frame_tids]
        )
        return frame_tids, frame_phones, score

    def loglikes_for(self, feats: np.ndarray, gmm) -> np.ndarray:
        """Per-frame per-pdf diagonal-GMM loglikes in float64 (independent
        of the device kernels)."""
        T, _D = feats.shape
        P = gmm.means_invvars.shape[0]
        out = np.full((T, P), NEG_INF)
        miv = gmm.means_invvars.astype(np.float64)
        iv = gmm.inv_vars.astype(np.float64)
        gconsts = gmm.gconsts.astype(np.float64)
        x = feats.astype(np.float64)
        for p in range(P):
            quad = x @ miv[p].T - 0.5 * (x * x) @ iv[p].T + gconsts[p][None, :]
            finite = np.isfinite(quad)
            m = np.max(np.where(finite, quad, -1e300), axis=1)
            out[:, p] = m + np.log(
                np.sum(np.where(finite, np.exp(quad - m[:, None]), 0.0), axis=1)
            )
        return out
