"""Large-vocabulary decoding: a two-level time-synchronous DP, in PyTorch.

Counterpart of ``montreal_forced_aligner_tpu/transcription/lvcsr.py``. The
exact dense decoder (``transcriber.DecodingGraphCompiler``) wires every LM
transition as a graph arc, O(V^2) arcs, which caps it at a few hundred
words. This decoder keeps the LM's backoff structure instead: each frame
runs

1. a band-sparse max-plus step over all word-HMM blocks at once (intra-word
   arcs live in a narrow band of state offsets), and
2. a backoff-LM junction in closed form: per-word exit scores, one global
   backoff maximum, seen-bigram updates through a (V, Kb) gather, and word
   entry: O(S + V*Kb) work a frame instead of O(V^2).

Optional inter-word silence is absorbed into each word block. The DP is
exact over this graph: no beam, nothing pruned. Triphone trees decode with
exact cross-word context (:class:`LvcsrXwGraph`: the junction factored
through context classes); the word-internal build (silence as cross-word
context, ``lvcsr_pm.py``) is the monophone path and the fallback when the
cross-word expansion exceeds the band buckets or the record budget.

Device code is plain PyTorch: loops over frames (and checkpoint chunks) in
place of ``lax.scan``, with the JAX package's chunk and checkpoint
structure, so peak memory is bounded as it is there. Band columns that hold
no arc are skipped in the 1-best band step; they can never win its strict
``>`` (an arc weight of NEG_INF absorbs any finite score), so the result is
the same.

The chain-major 1-best pairs (record-based and checkpointed, with device
and host backtraces) and the record-based cross-word pair are the
reference forms the production routes (position-major, checkpointed
cross-word) are held to; ``Transcriber`` decodes a plain chain-major graph
through the checkpointed chain-major pair.
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.graph.compiler import (
    _GraphBuilder,
    _safe_log,
    batch_graphs,
)
from montreal_forced_aligner_tpu_torch.language_modeling.ngram import ArpaModel
from montreal_forced_aligner_tpu_torch.ops.viterbi import (
    HASH_MASK,
    HASH_MULT,
    NEG_INF,
    band_from_arcs,
    dedup_topk,
)

LN10 = math.log(10.0)

_logger = logging.getLogger("mfa_tpu")


@dataclass
class LvcsrGraph:
    """Host arrays of the chain-major word-internal decoder (one shared
    graph); the substrate of the word-internal K-best junction."""

    words: List[str]
    state_pdf: np.ndarray  # (S,)
    state_word: np.ndarray  # (S,) word index (-1 for inter/initial silence)
    state_phone: np.ndarray  # (S,)
    band: np.ndarray  # (S, D) intra-word arcs
    lb: int = 0
    ub: int = 0
    cross_word_fallback: bool = False
    start: Optional[np.ndarray] = None  # (S,)
    # junction arrays; U = V + 1 sources (words + initial-silence row V)
    exit_idx: Optional[np.ndarray] = None  # (U, E)
    exit_w: Optional[np.ndarray] = None  # (U, E)
    entry_idx: Optional[np.ndarray] = None  # (Ne,) entry state per slot
    entry_word: Optional[np.ndarray] = None  # (Ne,)
    entry_w: Optional[np.ndarray] = None  # (Ne,)
    # LM (all scaled: lm_scale * log10 * LN10)
    p1: Optional[np.ndarray] = None  # (V,) unigram
    bo: Optional[np.ndarray] = None  # (U,) backoff weight of each history
    big_pred: Optional[np.ndarray] = None  # (V, Kb) predecessor source index
    big_w: Optional[np.ndarray] = None  # (V, Kb) seen-bigram log-prob
    eos: Optional[np.ndarray] = None  # (U,) end-of-sentence LM weight

    @property
    def num_states(self) -> int:
        return len(self.state_pdf)

    @property
    def state0_hash(self) -> np.ndarray:
        """Word-sequence hash per start state (word entries hash their
        word; silence starts hash 0)."""
        return np.where(self.state_word >= 0, self.state_word + 1, 0).astype(
            np.uint32
        )

    @property
    def entry_slot_of_state(self) -> np.ndarray:
        """(S,) inverse of ``entry_idx``: each state's entry slot, -1 for
        other states."""
        arr = np.full(self.num_states, -1, np.int32)
        arr[np.asarray(self.entry_idx, np.int64)] = np.arange(
            len(self.entry_idx), dtype=np.int32
        )
        return arr


def graph_tensors(g, names, device) -> Dict[str, torch.Tensor]:
    """The named host arrays of an LVCSR graph on ``device``: integer arrays
    as int64 (index tensors; uint32 hashes keep their values), floats as
    float32, masks as bool; a cross-word graph's band also as
    :class:`SparseBand` (``"sparse_band"``)."""
    out = {}
    for n in names:
        a = np.asarray(getattr(g, n))
        if a.dtype == np.bool_:
            t = torch.from_numpy(a)
        elif np.issubdtype(a.dtype, np.integer):
            t = torch.from_numpy(a.astype(np.int64))
        else:
            t = torch.from_numpy(a.astype(np.float32))
        out[n] = t.to(device)
    if isinstance(g, LvcsrXwGraph):
        out["sparse_band"] = SparseBand(g.band, g.lb, device)
    return out


def _lm_rows(lm: ArpaModel, vocab, scale: float):
    """Scaled LM arrays shared by the junction builders: unigram row,
    per-history backoff and end-of-sentence rows (row V = the <s> history),
    and seen-bigram predecessor lists per word."""
    V = len(vocab)
    word_index = {w: i for i, w in enumerate(vocab)}
    p1 = np.asarray([scale * lm.log_prob(v, ()) for v in vocab], np.float32)
    bo = np.zeros(V + 1, np.float32)
    eos = np.zeros(V + 1, np.float32)
    for u, w in enumerate(list(vocab) + ["<s>"]):
        bo[u] = scale * lm.ngrams[1].get((w,), (0.0, 0.0))[1]
        eos[u] = scale * lm.log_prob("</s>", (w,))
    preds: Dict[int, List[Tuple[int, float]]] = {v: [] for v in range(V)}
    if lm.order >= 2:
        for key, (lp, _b) in lm.ngrams[2].items():
            hist, w = key[0], key[1]
            if w not in word_index:
                continue
            u = word_index.get(hist, V if hist == "<s>" else None)
            if u is None:
                continue
            preds[word_index[w]].append((u, scale * lp))
    return p1, bo, eos, preds


class LvcsrGraphCompiler:
    """Builds the LVCSR decoding graph from a lexicon and a backoff LM."""

    def __init__(self, align_compiler, lexicon, lm: ArpaModel,
                 lm_scale: float = 1.0, word_insertion_penalty: float = 0.0,
                 cross_word: Optional[bool] = None,
                 nominal_frames: Optional[int] = None):
        self.comp = align_compiler
        self.lexicon = lexicon
        self.lm = lm
        self.lm_scale = lm_scale
        self.word_insertion_penalty = word_insertion_penalty
        # exact cross-word context matters only for context-dependent trees
        self.cross_word = (
            align_compiler.tree.N == 3 if cross_word is None else cross_word
        )
        # the corpus's longest utterance in frames, when the caller knows it;
        # the record-budget gates otherwise assume 30 s
        self.nominal_frames = nominal_frames

    def _word_block(self, g: _GraphBuilder, pids, w_idx, p_sil, sil):
        """One pronunciation chain and its optional trailing silence:
        (entry_state, [(exit_state, weight, tid), ...])."""
        comp = self.comp
        entry, chain_exits = comp._expand_pronunciation(
            g, pids, w_idx, boundary_ctx=sil
        )
        exits = [
            (s, w + _safe_log(max(1.0 - p_sil, 1e-5)), tid)
            for s, w, tid in chain_exits
        ]
        splan_entry, sexits = comp._expand_phone_standalone(g, sil, -1)
        for s, w, tid in chain_exits:
            g.add_arc(s, splan_entry, w + _safe_log(max(p_sil, 1e-5)), tid)
        exits.extend(sexits)
        return entry, exits

    def build(self):
        """:class:`LvcsrXwGraph` (cross-word exact) for triphone trees, else
        the position-major :class:`~.lvcsr_pm.LvcsrPmGraph`; falls back to
        the latter when the cross-word expansion exceeds the band buckets
        or the record budget (``cross_word_fallback`` is then True)."""
        if self.cross_word:
            try:
                return self._build_cross_word()
            except ValueError as e:
                _logger.warning(
                    "cross-word LVCSR build fell back to word-internal "
                    "context: %s", e,
                )
                g = self.build_word_internal()
                g.cross_word_fallback = True
                return g
        return self.build_word_internal()

    def build_word_internal(self):
        """Position-major word-internal graph (``lvcsr_pm.py``)."""
        from montreal_forced_aligner_tpu_torch.transcription.lvcsr_pm import (
            build_word_internal_pm,
        )

        return build_word_internal_pm(self)

    def build_word_internal_legacy(self) -> LvcsrGraph:
        """Chain-major word-internal graph: the substrate of the K-best
        junction on monophone trees."""
        lex = self.lexicon
        lm = self.lm
        comp = self.comp
        g = _GraphBuilder()
        sil = lex.phone_id(lex.silence_phone, None)
        vocab = [w for w in lm.vocab if w in lex.words]
        if not vocab:
            raise ValueError("no LM words found in the lexicon")
        V = len(vocab)

        entries: List[Tuple[int, int, float]] = []  # (state, word, weight)
        exits: List[List[Tuple[int, float, int]]] = []
        for w_idx, word in enumerate(vocab):
            wexits: List[Tuple[int, float, int]] = []
            for pron in lex.words[word]:
                if lex.position_dependent:
                    pids = lex.pronunciation_phone_ids(pron.phones)
                else:
                    pids = [lex.phone_id(p, None) for p in pron.phones]
                prob = pron.probability if pron.probability is not None else 1.0
                pron_lp = (
                    math.log(max(min(prob, 1.0), 1e-5))
                    - self.word_insertion_penalty
                )
                p_sil = (
                    pron.silence_after_probability
                    if pron.silence_after_probability is not None
                    else lex.silence_probability
                )
                entry, p_exits = self._word_block(g, pids, w_idx, p_sil, sil)
                entries.append((entry, w_idx, pron_lp))
                wexits.extend(p_exits)
            exits.append(wexits)
        # initial silence = source row V with the <s> LM state
        init_entry, init_exits = comp._expand_phone_standalone(g, sil, -1)
        exits.append(init_exits)

        graph = g.finish(vocab)
        garrs = batch_graphs([graph], state_multiple=1)
        band_out = band_from_arcs(garrs)
        if band_out is None:
            raise ValueError("word-internal arcs exceed band buckets")
        band_np, lb, ub = band_out
        S = graph.num_states

        start = np.full(S, NEG_INF, np.float32)
        start[init_entry] = _safe_log(lex.initial_silence_probability)
        scale = self.lm_scale * LN10
        start_lp = _safe_log(1.0 - lex.initial_silence_probability)
        for st, w_idx, pron_lp in entries:
            lm_lp = scale * lm.log_prob(vocab[w_idx], ("<s>",))
            start[st] = max(start[st], start_lp + lm_lp + pron_lp)

        U = V + 1
        E = max(len(e) for e in exits)
        exit_idx = np.zeros((U, E), np.int32)
        exit_w = np.full((U, E), NEG_INF, np.float32)
        for u, ex in enumerate(exits):
            for j, (s, w, _tid) in enumerate(ex):
                exit_idx[u, j] = s
                exit_w[u, j] = w

        p1, bo, eos, preds = _lm_rows(lm, vocab, scale)
        Kb = max(1, max(len(p) for p in preds.values()))
        big_pred = np.zeros((V, Kb), np.int32)
        big_w = np.full((V, Kb), NEG_INF, np.float32)
        for v, plist in preds.items():
            for k, (u, wgt) in enumerate(plist):
                big_pred[v, k] = u
                big_w[v, k] = wgt

        return LvcsrGraph(
            words=vocab,
            state_pdf=garrs["state_pdf"][0],
            state_word=garrs["state_word"][0],
            state_phone=garrs["state_phone"][0],
            band=band_np[0],
            lb=lb,
            ub=ub,
            start=start,
            exit_idx=exit_idx,
            exit_w=exit_w,
            entry_idx=np.asarray([e[0] for e in entries], np.int32),
            entry_word=np.asarray([e[1] for e in entries], np.int32),
            entry_w=np.asarray([e[2] for e in entries], np.float32),
            p1=p1,
            bo=bo,
            big_pred=big_pred,
            big_w=big_w,
            eos=eos,
        )


# ---------------------------------------------------------------------------
# Emission chunks and budgets
# ---------------------------------------------------------------------------

# frames per emission chunk of the K-best decoders: the pdf->state expansion
# materialises one (TC, B, S) block at a time
_EMIT_TC = 32
# device record budget (read through Transcriber._rec_budget(): batches
# split to fit it, and a cross-word expansion that cannot fit even one row
# falls back to the word-internal graph at build time)
_REC_BUDGET = float(os.environ.get("MFA_TPU_LVCSR_REC_BYTES", 4e9))
# checkpoint spacing of the checkpointed cross-word pair
_XW_TC = 64


def xw_rec_bytes_per_frame_row(
    S: int, Ne: int, Nc: int, P: int, F: int, RG: int
) -> int:
    """Per-(frame, batch-row) bytes of the cross-word per-frame records (bp
    u8 (S) + jwin bool / ent_src i32 / ent_l u8 (Ne) + cell_arg u8 (Nc) +
    BOFarg i16 (P*F) + BO2arg i32 (P*RG)): what one checkpoint chunk of the
    backtrace holds for each of its frames."""
    return S + Ne * 6 + Nc + P * F * 2 + P * RG * 4


def xw_ckpt_bytes_per_row(
    S: int, Ne: int, Nc: int, P_pdf: int, P: int, F: int, RG: int, T: int
) -> int:
    """Device bytes per batch row of the checkpointed cross-word decode at
    utterance length T: float32 alpha checkpoints and the one pre-chunked
    float32 pdf-emission copy (both scale with T), plus one chunk's
    transient records (independent of T). The single source of the build's
    fallback gate and the transcriber's batch split."""
    return (
        (4 * S * T) // _XW_TC
        + 4 * P_pdf * T
        + _XW_TC * xw_rec_bytes_per_frame_row(S, Ne, Nc, P, F, RG)
    )


def _emit_chunker(state_pdf: torch.Tensor):
    """The per-chunk pdf->state emission expander ``(TC, B, P) -> (TC, B,
    S)``: a gather. NaN and -inf pdf values are first clamped to NEG_INF,
    as the JAX package's one-hot product clamps them."""
    idx = state_pdf.long()

    def mat(echunk: torch.Tensor) -> torch.Tensor:
        e = torch.clamp(torch.nan_to_num(echunk, nan=NEG_INF), min=NEG_INF)
        return e.index_select(2, idx)

    return mat


def _chunk_pdf_frames(emit_pdf: torch.Tensor, TC: int):
    """Frames 1..T-1 of (B, T, P) as (NC, TC, B, P) chunks (zero-padded tail
    frames are inert: every decoder freezes past ``frame_lengths``)."""
    B, T, P = emit_pdf.shape
    n_scan = T - 1
    NC = (n_scan + TC - 1) // TC
    pad = NC * TC - n_scan
    ep = torch.nn.functional.pad(emit_pdf[:, 1:], (0, 0, 0, pad))
    ep = ep.reshape(B, NC, TC, P).permute(1, 2, 0, 3).contiguous()
    return ep, NC


def split_emissions(emit_pdf: torch.Tensor, TC: int):
    """Pre-chunk (B, T, P) pdf emissions for the checkpointed decoders:
    ``(e0 (B, P), ep (NC, TC, B, P))``; the caller then drops
    ``emit_pdf``, so one copy stays resident."""
    ep, _NC = _chunk_pdf_frames(emit_pdf, TC)
    return emit_pdf[:, 0].contiguous(), ep


def live_band_columns(band: torch.Tensor, axis: int) -> List[int]:
    """The band columns (offsets) that hold at least one arc."""
    dims = [d for d in range(band.dim()) if d != axis]
    return torch.nonzero(
        torch.amax(band, dim=dims) > NEG_INF / 2
    ).flatten().tolist()


def band_max(ap: torch.Tensor, cols, live, lb: int, ub: int, n: int, axis: int):
    """Band max-plus pass along ``axis`` of a padded ``ap`` (``ub`` before,
    ``lb`` after): (m, bp uint8), the first best offset index winning, as
    the JAX package's running ``c > m`` does."""
    m = None
    bp = None
    for j in live:
        d = j - lb
        c = ap.narrow(axis, ub - d, n) + cols[j]
        if m is None:
            m = torch.full_like(c, NEG_INF)
            bp = torch.zeros(c.shape, dtype=torch.uint8, device=c.device)
        take = c > m
        m = torch.where(take, c, m)
        bp.masked_fill_(take, j)
    if m is None:
        shape = list(ap.shape)
        shape[axis] = n
        m = torch.full(shape, NEG_INF, dtype=ap.dtype, device=ap.device)
        bp = torch.zeros(shape, dtype=torch.uint8, device=ap.device)
    return m, bp


class SparseBand:
    """The band of a (S, D) state graph as incoming-arc lists, for a band
    max whose cost does not grow with D: each state's arcs in ascending
    offset index j, the first ``kh`` of every state gathered in one
    (B, S, kh) block and the rest, for the few states with more, in a
    second block over those states only. Cross-word graphs need D up to 145
    (first phones branch per left context) with about 90 live offsets, but
    most states have two arcs.

    :meth:`max` gives the column loop's result exactly: the same
    ``alpha[src] + w`` sums, ``m = max(NEG_INF, every sum)`` and the
    lowest j reaching it (0 when nothing beats NEG_INF)."""

    def __init__(self, band: np.ndarray, lb: int, device):
        S = band.shape[0]
        # arcs in row-major order: each state's in ascending j
        rows, cols = np.nonzero(band > NEG_INF / 2)
        deg = np.bincount(rows, minlength=S)
        pos = np.arange(rows.size) - (np.cumsum(deg) - deg)[rows]
        src = rows - (cols - lb)
        w = band[rows, cols]
        # kh arcs for every state cover 90% of the states whole
        covered = np.cumsum(np.bincount(deg))
        kh = max(1, int(np.searchsorted(covered, 0.9 * S)))
        tail = np.flatnonzero(deg > kh)
        tail_row = np.full(S, -1)
        tail_row[tail] = np.arange(tail.size)
        kt = max(1, int(deg.max()) - kh)

        def blocks(n, k, keep, r, c):
            """(src, w, j) blocks of n rows and k slots holding the arcs
            ``keep`` at (r, c); empty slots take source 0, weight NEG_INF
            and j 0."""
            out_src = np.zeros((n, k), np.int64)
            out_w = np.full((n, k), NEG_INF, np.float32)
            out_j = np.zeros((n, k), np.int64)
            out_src[r, c], out_w[r, c], out_j[r, c] = src[keep], w[keep], cols[keep]
            return [torch.from_numpy(x).to(device) for x in (out_src, out_w, out_j)]

        head = pos < kh
        self.src_h, self.w_h, self.j_h = blocks(S, kh, head, rows[head], pos[head])
        self.src_t, self.w_t, self.j_t = blocks(
            tail.size, kt, ~head, tail_row[rows[~head]], pos[~head] - kh)
        self.tail = torch.from_numpy(tail).to(device)

    def max(self, alpha_prev: torch.Tensor):
        """(m (B, S), bp (B, S) uint8) of the band step on alpha_prev."""
        B, S = alpha_prev.shape
        c = alpha_prev[:, self.src_h.reshape(-1)].reshape(B, S, -1) + self.w_h
        m, k = torch.max(c, dim=2)  # the first maximum: the lowest j
        j = self.j_h[torch.arange(S, device=c.device)[None, :], k]
        if self.tail.numel():
            ct = alpha_prev[:, self.src_t.reshape(-1)].reshape(
                B, self.tail.numel(), -1) + self.w_t
            mt, kt = torch.max(ct, dim=2)
            jt = self.j_t[torch.arange(self.tail.numel(), device=c.device)[None, :], kt]
            mh = m[:, self.tail]
            # the head holds the lower offsets: it keeps ties
            take = mt > mh
            m[:, self.tail] = torch.where(take, mt, mh)
            j[:, self.tail] = torch.where(take, jt, j[:, self.tail])
        won = m > NEG_INF
        bp = torch.where(won, j, 0).to(torch.uint8)
        return torch.clamp(m, min=NEG_INF), bp


def _active(t, frame_lengths: torch.Tensor, ndim: int) -> torch.Tensor:
    return (t < frame_lengths).reshape((-1,) + (1,) * (ndim - 1))


def _t0(t0: int, device) -> torch.Tensor:
    """A chunk's first frame as a 0-dim tensor (an input of its graph)."""
    return torch.tensor(t0, dtype=torch.int64).to(device)


def run_graphed(cache: dict, key, fn, *args):
    """``fn(*args)``, a tuple of tensors, for one checkpoint chunk of a
    1-best LVCSR decoder. On the card the chunk's few thousand small
    launches are captured once per ``key`` and argument shapes into a CUDA
    graph, which each later call replays after copying its arguments into
    the graph's own; the outputs are copies. ``cache`` is the graph's
    device-tensor dict, whose tensors the captured work reads, so a graph
    lives as long as they do. On the CPU ``fn`` runs as is."""
    if args[0].device.type != "cuda":
        return fn(*args)
    full_key = (key,) + tuple((tuple(a.shape), a.dtype) for a in args)
    graphs = cache.setdefault("_cuda_graphs", {})
    hit = graphs.get(full_key)
    if hit is None:
        static_in = [a.clone() for a in args]
        side = torch.cuda.Stream(device=args[0].device)
        side.wait_stream(torch.cuda.current_stream(args[0].device))
        with torch.cuda.stream(side):
            fn(*static_in)  # warm-up: allocator and library state
        torch.cuda.current_stream(args[0].device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = fn(*static_in)
        hit = graphs[full_key] = (graph, static_in, static_out)
    graph, static_in, static_out = hit
    for dst, src in zip(static_in, args):
        dst.copy_(src)
    graph.replay()
    return tuple(o.clone() for o in static_out)


# ---------------------------------------------------------------------------
# Chain-major word-internal 1-best: the record-based and checkpointed pairs
# ---------------------------------------------------------------------------
# The JAX package's reference decoders for its production routes, on the
# word-internal chain-major graph (``build_word_internal_legacy``): every
# production 1-best route (position-major, checkpointed cross-word) is held
# to them by the tests. The record-based pair keeps per-frame records for
# all T frames; the checkpointed pair keeps one alpha a 32-frame chunk plus
# the junction records and recomputes each chunk's band backpointers from
# its checkpoint in the backtrace. A record's ``ent_src`` (the winning
# seen-bigram index, -1 for the backoff) is int32: the JAX package's int8
# wraps past 127 predecessors.


def _flat_junction(alpha_prev, exit_flat, exit_w, bo, big_pred, big_w, p1,
                   with_args: bool):
    """Backoff-LM junction of the chain-major graph: each word's entry
    score (B, V) and, ``with_args``, the argmax records (ent_src (B, V)
    int32, exit_arg (B, U) uint8, bo_arg (B,) int32)."""
    B = alpha_prev.shape[0]
    U, E = exit_w.shape
    V, Kb = big_pred.shape
    ex = alpha_prev[:, exit_flat].reshape(B, U, E) + exit_w
    exit_u = ex.amax(dim=2)  # (B, U)
    bo_sc = exit_u + bo
    BO = bo_sc.amax(dim=1)
    big = exit_u[:, big_pred.reshape(-1)].reshape(B, V, Kb) + big_w
    big_best = big.amax(dim=2)
    bo_path = BO[:, None] + p1
    ent_v = torch.maximum(bo_path, big_best)  # (B, V)
    if not with_args:
        return ent_v, None
    exit_arg = torch.argmax(ex, dim=2).to(torch.uint8)
    bo_arg = torch.argmax(bo_sc, dim=1).to(torch.int32)
    big_arg = torch.argmax(big, dim=2)
    ent_src = torch.where(bo_path >= big_best, -1, big_arg).to(torch.int32)
    return ent_v, (ent_src, exit_arg, bo_arg)


class _FlatStep:
    """One chain-major forward step, the only copy of the recursion for
    its three uses: ``mode="records"`` returns the full per-frame records
    (the record-based decode), ``"ckpt"`` the junction records only (the
    checkpointed decode), ``"bp_only"`` the packed band backpointers only
    (the checkpointed backtrace's chunk recompute). A packed backpointer
    holds the band offset index in its low 7 bits and sets bit 7 where the
    LM junction won the state."""

    def __init__(self, band, exit_idx, exit_w, bo, big_pred, big_w, p1,
                 entry_word, entry_w, entry_idx, lb, ub, mode: str):
        D = lb + ub + 1
        assert D <= 127, "band width must fit 7 bits of the packed backpointer"
        self.cols = [band[:, j] for j in range(D)]
        self.live = live_band_columns(band, 1)
        self.exit_flat = exit_idx.reshape(-1)
        self.exit_w, self.bo, self.p1 = exit_w, bo, p1
        self.big_pred, self.big_w = big_pred, big_w
        self.entry_word, self.entry_w = entry_word, entry_w
        self.entry_idx = entry_idx
        self.lb, self.ub, self.mode = lb, ub, mode

    def __call__(self, alpha_prev, emit_t, t, frame_lengths):
        S = alpha_prev.shape[1]
        ap = torch.nn.functional.pad(alpha_prev, (self.ub, self.lb),
                                     value=NEG_INF)
        m, bp = band_max(ap, self.cols, self.live, self.lb, self.ub, S, 1)
        ent_v, args = _flat_junction(
            alpha_prev, self.exit_flat, self.exit_w, self.bo, self.big_pred,
            self.big_w, self.p1, self.mode != "bp_only")
        entry_cand = ent_v[:, self.entry_word] + self.entry_w
        m2 = m.index_copy(1, self.entry_idx,
                          torch.maximum(m[:, self.entry_idx], entry_cand))
        alpha_out = torch.where(_active(t, frame_lengths, 2), m2 + emit_t,
                                alpha_prev)
        if self.mode == "ckpt":
            return alpha_out, args
        bp_packed = torch.where(m2 > m, bp | 0x80, bp)
        if self.mode == "bp_only":
            return alpha_out, bp_packed
        return alpha_out, (bp_packed,) + args


def lvcsr_decode_device(emit_pdf, state_pdf, frame_lengths, band, start,
                        exit_idx, exit_w, entry_idx, entry_word, entry_w, p1,
                        bo, big_pred, big_w, lb, ub):
    """Record-based chain-major forward pass on (B, T, P) pdf emissions
    (each frame's (B, S) state emissions gathered per ``_EMIT_TC``-frame
    chunk). Returns (alpha_T (B, S), records stacked over the frames 1..T-1
    plus inert chunk padding: bp_packed (B, S) uint8, ent_src (B, V) int32,
    exit_arg (B, U) uint8, bo_arg (B,) int32)."""
    step = _FlatStep(band, exit_idx, exit_w, bo, big_pred, big_w, p1,
                     entry_word, entry_w, entry_idx, lb, ub, "records")
    alpha0 = start[None] + first_state_emissions(emit_pdf, state_pdf)
    return _scan_chunked(lambda a, e, t: step(a, e, t, frame_lengths), alpha0,
                         emit_pdf, state_pdf)


def _flat_bt_init(alpha_T, exit_idx, exit_w, eos):
    """Final state and score: the best word exit plus its end-of-sentence
    LM weight (shared by the chain-major backtraces)."""
    B = alpha_T.shape[0]
    U, E = exit_idx.shape
    ex = alpha_T[:, exit_idx.reshape(-1)].reshape(B, U, E) + exit_w
    ex_best = ex.amax(dim=2) + eos  # (B, U)
    u0 = torch.argmax(ex_best, dim=1)
    score = ex_best.gather(1, u0[:, None])[:, 0]
    rows = torch.arange(B, device=alpha_T.device)
    e0 = torch.argmax(ex[rows, u0], dim=1)
    return exit_idx[u0, e0], score


def _flat_bstep(frame_lengths, entry_slot_of_state, entry_word, big_pred,
                exit_idx, lb, s, recs, r):
    """One step of the chain-major reverse walk: the state at frame r from
    the state at frame r + 1 and frame r + 1's records, and the word
    entered at r + 1 (-1 for none)."""
    bp_r, ent_r, exarg_r, boarg_r = recs
    rows = torch.arange(s.shape[0], device=s.device)
    t = r + 1
    packed = bp_r[rows, s]
    slot = entry_slot_of_state[s]
    is_junc = ((packed & 0x80) != 0) & (slot >= 0)
    v = entry_word[torch.clamp(slot, min=0)]
    k = ent_r[rows, v].long()
    src_u = torch.where(k < 0, boarg_r.long(), big_pred[v, torch.clamp(k, min=0)])
    s_j = exit_idx[src_u, exarg_r[rows, src_u].long()]
    s_band = s - ((packed & 0x7F).long() - lb)
    active = t < frame_lengths
    s_out = torch.where(active, torch.where(is_junc, s_j, s_band), s)
    word = torch.where(active & is_junc, v, -1)
    return s_out, word


def lvcsr_backtrace_device(alpha_T, recs, frame_lengths, exit_idx, exit_w, eos,
                           entry_word, entry_slot_of_state, big_pred,
                           state_word, lb, T: int = 0):
    """Backtrace of :func:`lvcsr_decode_device` on the device, a reverse
    walk over its records that gathers one state's record a frame: (state
    path (B, T) int32, word entered at each frame (B, T) int32 (-1 = none),
    score (B,)). ``T`` cuts the records' chunk padding."""
    bp_packed, ent_src, exit_arg, bo_arg = recs
    Tp = bp_packed.shape[0] + 1
    T = T or Tp
    s_final, score = _flat_bt_init(alpha_T, exit_idx, exit_w, eos)
    path_prev = torch.empty((Tp - 1, alpha_T.shape[0]), dtype=torch.int64,
                            device=alpha_T.device)
    word_at = torch.empty_like(path_prev)
    s = s_final
    for r in range(Tp - 2, -1, -1):
        s, w = _flat_bstep(frame_lengths, entry_slot_of_state, entry_word,
                           big_pred, exit_idx, lb, s,
                           (bp_packed[r], ent_src[r], exit_arg[r], bo_arg[r]), r)
        path_prev[r], word_at[r] = s, w
    path, word = _bt_outputs(path_prev, word_at, s_final, state_word, T)
    return path, word, score


def lvcsr_decode_ckpt_device(emit_pdf, state_pdf, frame_lengths, band, start,
                             exit_idx, exit_w, entry_idx, entry_word, entry_w,
                             p1, bo, big_pred, big_w, lb, ub, cache=None):
    """Checkpointed chain-major forward pass: the alpha entering each
    ``_EMIT_TC``-frame chunk and the per-frame junction records, not the
    (B, S) band backpointers, so a row's memory has no O(T*S) term.
    Returns (alpha_T (B, S), ckpts (NC, B, S), records (ent_src, exit_arg,
    bo_arg) with leaves (NC, TC, B, ...)). ``cache`` (a graph's
    device-tensor dict) keeps each chunk's CUDA graph on the card."""
    step = _FlatStep(band, exit_idx, exit_w, bo, big_pred, big_w, p1,
                     entry_word, entry_w, entry_idx, lb, ub, "ckpt")
    mat = _emit_chunker(state_pdf)
    ep, NC = _chunk_pdf_frames(emit_pdf, _EMIT_TC)

    def chunk(alpha, echunk, t0, flens):
        e = mat(echunk)
        recs = []
        for i in range(e.shape[0]):
            alpha, rec = step(alpha, e[i], t0 + i, flens)
            recs.append(rec)
        return (alpha,) + tuple(torch.stack(x) for x in zip(*recs))

    alpha = start[None] + first_state_emissions(emit_pdf, state_pdf)
    ckpts = torch.empty((NC,) + tuple(alpha.shape), dtype=torch.float32,
                        device=alpha.device)
    out = []
    for c in range(NC):
        ckpts[c] = alpha
        alpha, *recs = run_graphed(
            {} if cache is None else cache, ("flat_decode", lb, ub), chunk,
            alpha, ep[c], _t0(1 + c * _EMIT_TC, alpha.device), frame_lengths)
        out.append(recs)
    return alpha, ckpts, tuple(torch.stack(x) for x in zip(*out))


def lvcsr_backtrace_ckpt_device(alpha_T, ckpts, recs, emit_pdf, state_pdf,
                                frame_lengths, band, exit_idx, exit_w, eos,
                                entry_idx, entry_word, entry_w, p1, bo,
                                big_pred, big_w, entry_slot_of_state,
                                state_word, lb, ub, T: int, cache=None):
    """Backtrace of :func:`lvcsr_decode_ckpt_device`: chunks last to first,
    each re-running its forward from the stored checkpoint for its packed
    band backpointers (TC frames only), then walking them back with the
    chunk's junction records, decision for decision as
    :func:`lvcsr_backtrace_device`. Returns (state path (B, T) int32, word
    entered at each frame (B, T) int32, score (B,))."""
    fstep = _FlatStep(band, exit_idx, exit_w, bo, big_pred, big_w, p1,
                      entry_word, entry_w, entry_idx, lb, ub, "bp_only")
    mat = _emit_chunker(state_pdf)
    ep, NC = _chunk_pdf_frames(emit_pdf, _EMIT_TC)
    ent_src, exit_arg, bo_arg = recs

    def chunk(ck, echunk, entr, exar, boar, t0, flens, s):
        e = mat(echunk)
        alpha, bps = ck, []
        for i in range(e.shape[0]):
            alpha, bp = fstep(alpha, e[i], t0 + i, flens)
            bps.append(bp)
        states, words = [], []
        for i in range(e.shape[0] - 1, -1, -1):
            s, w = _flat_bstep(flens, entry_slot_of_state, entry_word,
                               big_pred, exit_idx, lb, s,
                               (bps[i], entr[i], exar[i], boar[i]), t0 - 1 + i)
            states.append(s)
            words.append(w)
        return torch.stack(states[::-1]), torch.stack(words[::-1]), s

    B = alpha_T.shape[0]
    s_final, score = _flat_bt_init(alpha_T, exit_idx, exit_w, eos)
    path_prev = torch.empty((NC * _EMIT_TC, B), dtype=torch.int64,
                            device=alpha_T.device)
    word_at = torch.empty_like(path_prev)
    s = s_final
    for c in range(NC - 1, -1, -1):
        sl = slice(c * _EMIT_TC, (c + 1) * _EMIT_TC)
        path_prev[sl], word_at[sl], s = run_graphed(
            {} if cache is None else cache, ("flat_backtrace", lb, ub), chunk,
            ckpts[c], ep[c], ent_src[c], exit_arg[c], bo_arg[c],
            _t0(1 + c * _EMIT_TC, alpha_T.device), frame_lengths, s)
    path, word = _bt_outputs(path_prev, word_at, s_final, state_word, T)
    return path, word, score


def lvcsr_backtrace_host(graph: LvcsrGraph, alpha_T: np.ndarray, recs,
                         frame_lengths: np.ndarray, T: int = 0
                         ) -> List[Tuple[np.ndarray, float, List[Tuple[int, int]]]]:
    """Per-utterance (state path (T,), score, word events) from the
    record-based decode's records fetched to the host: the reference form
    of :func:`lvcsr_backtrace_device`, decision for decision. Word events
    are (frame, word) pairs, one a junction crossing, so consecutive
    repeats of a word stay apart."""
    bp_packed, ent_src, exit_arg, bo_arg = [np.asarray(r) for r in recs]
    B, S = alpha_T.shape
    T = T or bp_packed.shape[0] + 1
    entry_slot = {int(s): i for i, s in enumerate(graph.entry_idx)}
    out = []
    for b in range(B):
        L = int(frame_lengths[b])
        # final: best word exit + eos
        ex = alpha_T[b][graph.exit_idx] + graph.exit_w  # (U, E)
        ex_best = ex.max(axis=1) + graph.eos
        u = int(np.argmax(ex_best))
        score = float(ex_best[u])
        s = int(graph.exit_idx[u, int(np.argmax(ex[u]))])
        path = np.zeros(T, np.int32)
        path[L - 1 :] = s
        events: List[Tuple[int, int]] = []
        for t in range(L - 1, 0, -1):
            r = t - 1  # records index for transition (t-1) -> t
            packed = int(bp_packed[r, b, s])
            if (packed & 0x80) and s in entry_slot:
                slot = entry_slot[s]
                v = int(graph.entry_word[slot])
                events.append((t, v))
                k = int(ent_src[r, b, v])
                src_u = int(bo_arg[r, b]) if k < 0 else int(graph.big_pred[v, k])
                s = int(graph.exit_idx[src_u, int(exit_arg[r, b, src_u])])
            else:
                s = s - ((packed & 0x7F) - graph.lb)
            path[t - 1] = s
        w0 = int(graph.state_word[path[0]])
        if w0 >= 0:
            events.append((0, w0))
        events.reverse()
        out.append((path, score, events))
    return out


# ---------------------------------------------------------------------------
# Cross-word triphone context (context-classed junction)
# ---------------------------------------------------------------------------
# With a triphone tree, the pdfs of a word's first and last phone depend on
# the neighbouring word. Word HMMs are expanded per cross-word context group
# and the junction is factored through context classes:
#
#   exit side   "cells" (word u, presented phone p, right group rg): the best
#               score over u's exit states that assume a next first phone
#               in rg and present p to the next word,
#   entry side  slots (word v, left group, first phone f): entered from any
#               cell with p in the left group and f in rg.


@dataclass
class LvcsrXwGraph:
    """Host arrays of the cross-word (context-exact) junction decoder."""

    words: List[str]
    state_pdf: np.ndarray  # (S,)
    state_word: np.ndarray  # (S,)
    state_phone: np.ndarray  # (S,)
    band: np.ndarray  # (S, D)
    lb: int
    ub: int
    start: np.ndarray  # (S,)
    # cells
    cell_exit_idx: np.ndarray  # (Nc, Em)
    cell_exit_w: np.ndarray  # (Nc, Em)
    bo_cell: np.ndarray  # (Nc,) backoff weight of each cell's history
    cell_seg: np.ndarray  # (Nc,) = p * RG + rg
    rg_mask: np.ndarray  # (RG, F) bool: right group contains first phone f
    num_p: int  # P presented-phone classes
    # entry slots
    entry_state: np.ndarray  # (Ne,)
    entry_word: np.ndarray  # (Ne,)
    entry_w: np.ndarray  # (Ne,) pronunciation log-prob - insertion penalty
    ebo_idx: np.ndarray  # (Ne, Lm) flat p*F + f backoff sources
    ebo_pad: np.ndarray  # (Ne, Lm) 0 / NEG_INF padding
    p1e: np.ndarray  # (Ne,) scaled unigram of the slot's word
    se_cell: np.ndarray  # (Ne, Q) seen-bigram source cell per candidate
    se_w: np.ndarray  # (Ne, Q) scaled bigram log-prob (NEG_INF pad)
    # finals
    fin_state: np.ndarray  # (Nf,)
    fin_w: np.ndarray  # (Nf,) exit weight + scaled eos
    cross_word_fallback: bool = False

    @property
    def num_states(self) -> int:
        return len(self.state_pdf)

    @property
    def state0_hash(self) -> np.ndarray:
        return np.where(self.state_word >= 0, self.state_word + 1, 0).astype(
            np.uint32
        )

    @property
    def entry_slot_of_state(self) -> np.ndarray:
        """(S,) inverse of ``entry_state``."""
        arr = np.full(self.num_states, -1, np.int32)
        arr[np.asarray(self.entry_state, np.int64)] = np.arange(
            len(self.entry_state), dtype=np.int32
        )
        return arr

    def kbest_arrays(self) -> dict:
        """Index tables of the K-best junction (made once): ``seg_cells
        (Nseg, Cs)`` and ``seg_pad``, the cells of each (presented phone,
        right group) backoff segment; ``ebo_seg (Ne, Lsg)`` and
        ``ebo_seg_pad``, each entry slot's compatible backoff segments."""
        if getattr(self, "_kbest", None) is not None:
            return self._kbest
        RG, F = self.rg_mask.shape
        Nseg = self.num_p * RG
        by_seg: Dict[int, List[int]] = {}
        for c, seg in enumerate(self.cell_seg):
            by_seg.setdefault(int(seg), []).append(c)
        Cs = max(1, max((len(v) for v in by_seg.values()), default=1))
        seg_cells = np.zeros((Nseg, Cs), np.int32)
        seg_pad = np.full((Nseg, Cs), NEG_INF, np.float32)
        for seg, cells in by_seg.items():
            for j, c in enumerate(cells):
                seg_cells[seg, j] = c
                seg_pad[seg, j] = 0.0
        ebo_seg_lists: List[List[int]] = []
        for e in range(len(self.entry_state)):
            segs: List[int] = []
            for l in range(self.ebo_idx.shape[1]):
                if self.ebo_pad[e, l] <= NEG_INF / 2:
                    continue
                pf = int(self.ebo_idx[e, l])
                p, f = pf // F, pf % F
                for rg in range(RG):
                    if self.rg_mask[rg, f] and (p * RG + rg) in by_seg:
                        segs.append(p * RG + rg)
            ebo_seg_lists.append(segs)
        Lsg = max(1, max(len(s) for s in ebo_seg_lists))
        ebo_seg = np.zeros((len(ebo_seg_lists), Lsg), np.int32)
        ebo_seg_pad = np.full((len(ebo_seg_lists), Lsg), NEG_INF, np.float32)
        for e, segs in enumerate(ebo_seg_lists):
            for j, sgi in enumerate(segs):
                ebo_seg[e, j] = sgi
                ebo_seg_pad[e, j] = 0.0
        self._kbest = dict(seg_cells=seg_cells, seg_pad=seg_pad,
                           ebo_seg=ebo_seg, ebo_seg_pad=ebo_seg_pad)
        return self._kbest


def _build_cross_word(self) -> LvcsrXwGraph:
    """Cross-word-context LVCSR graph (see the notes above). Bound as
    ``LvcsrGraphCompiler._build_cross_word``."""
    lex, lm, comp = self.lexicon, self.lm, self.comp
    g = _GraphBuilder()
    sil = lex.phone_id(lex.silence_phone, None)
    EPS = 0
    scale = self.lm_scale * LN10
    vocab = [w for w in lm.vocab if w in lex.words]
    if not vocab:
        raise ValueError("no LM words found in the lexicon")
    V = len(vocab)

    prons: List[List[Tuple[List[int], float, float]]] = []
    first_phones, last_phones = set(), set()
    for word in vocab:
        rows = []
        for pron in lex.words[word]:
            if lex.position_dependent:
                pids = lex.pronunciation_phone_ids(pron.phones)
            else:
                pids = [lex.phone_id(p, None) for p in pron.phones]
            prob = pron.probability if pron.probability is not None else 1.0
            pron_lp = (
                math.log(max(min(prob, 1.0), 1e-5))
                - self.word_insertion_penalty
            )
            p_sil = (
                pron.silence_after_probability
                if pron.silence_after_probability is not None
                else lex.silence_probability
            )
            rows.append((pids, pron_lp, p_sil))
            first_phones.add(pids[0])
            last_phones.add(pids[-1])
        prons.append(rows)
    fclasses = sorted(first_phones)
    F = len(fclasses)
    f_index = {p: i for i, p in enumerate(fclasses)}
    pclasses = sorted(last_phones | {sil})
    P = len(pclasses)
    p_index = {p: i for i, p in enumerate(pclasses)}

    # early budget gate, before the expansion: lower bounds of the record
    # sizes (S >= the word-internal state count, Ne >= one slot per
    # pronunciation, Nc >= V, RG >= 1), so a refusal here is always right
    nominal_T = self.nominal_frames or 3000  # default: 30 s at 10 ms
    S_lb, NP = 0, 0
    for rows in prons:
        for pids, _lp, _ps in rows:
            NP += 1
            n = len(pids)
            for k, ph in enumerate(pids):
                l = pids[k - 1] if k > 0 else sil
                r = pids[k + 1] if k < n - 1 else sil
                S_lb += comp._phone_plan(comp._window(l, ph, r))["n_emit"]
    per_row_lb = xw_ckpt_bytes_per_row(S_lb, NP, V, 0, P, F, 1, nominal_T)
    if per_row_lb > _REC_BUDGET:
        raise ValueError(
            f"cross-word expansion too large to decode (pre-expansion "
            f"bound): >= {per_row_lb / 1e9:.1f} GB of checkpoints+records "
            f"per {nominal_T / 100:.0f} s utterance (S >= {S_lb}, entry "
            f"slots >= {NP}) exceeds the {_REC_BUDGET / 1e9:.1f} GB "
            f"budget (MFA_TPU_LVCSR_REC_BYTES)"
        )
    lefts_all = sorted({EPS, sil} | last_phones)
    rights_all = sorted({EPS, sil} | first_phones)
    sil_rights = sorted({EPS} | first_phones)

    rg_sets: Dict[frozenset, int] = {}

    def rg_of(rset) -> int:
        key = frozenset(rset) & first_phones
        if not key:
            return -1
        return rg_sets.setdefault(key, len(rg_sets))

    # (u_row, p_idx, rg) -> [(state, weight)]; u_row V = initial silence <s>
    cell_map: Dict[Tuple[int, int, int], List[Tuple[int, float]]] = {}

    def add_exits(u_row, p_phone, rset, exits, extra_w=0.0):
        rg = rg_of(rset)
        if rg < 0:
            return
        lst = cell_map.setdefault((u_row, p_index[p_phone], rg), [])
        for s, w, _tid in exits:
            lst.append((s, w + extra_w))

    finals: List[Tuple[int, float, int]] = []  # (state, weight, u_row)
    # entry slots: (state, word, f_idx, entry_w, lset)
    entries: List[Tuple[int, int, int, float, frozenset]] = []
    for w_idx in range(V):
        for pids, pron_lp, p_sil in prons[w_idx]:
            skip_lp = _safe_log(max(1.0 - p_sil, 1e-5))
            sil_lp = _safe_log(max(p_sil, 1e-5))
            branches = comp._expand_variant(
                g, pids, w_idx, lefts_all, rights_all, group_lefts=True
            )
            seen_entry = set()
            for br in branches:
                if br["entry"] not in seen_entry:
                    seen_entry.add(br["entry"])
                    entries.append(
                        (br["entry"], w_idx, f_index[pids[0]], pron_lp,
                         br["lset"])
                    )
            sil_groups = comp._expand_single(g, sil, -1, pids[-1], sil_rights)
            # distinct exit groups (n >= 2 branches share their exits object)
            exit_groups = {
                id(br["exits"]): (br["rset"], br["exits"]) for br in branches
            }
            for rset, exits in exit_groups.values():
                add_exits(w_idx, pids[-1], rset, exits, extra_w=skip_lp)
                if EPS in rset:
                    finals.extend((s, w + skip_lp, w_idx) for s, w, _t in exits)
                if sil in rset:
                    for _srs, sentry, _sx in sil_groups:
                        for s, w, tid in exits:
                            g.add_arc(s, sentry, w + sil_lp, tid)
            for srs, _sentry, sexits in sil_groups:
                add_exits(w_idx, sil, srs, sexits)
                if EPS in srs:
                    finals.extend((s, w, w_idx) for s, w, _t in sexits)

    # initial silence (history <s> = row V)
    init_groups = comp._expand_single(g, sil, -1, EPS, sil_rights)
    p_init = lex.initial_silence_probability
    for srs, sentry, sexits in init_groups:
        g.add_start(sentry, _safe_log(p_init))
        add_exits(V, sil, srs, sexits)
        if EPS in srs:
            finals.extend((s, w, V) for s, w, _t in sexits)

    graph = g.finish(vocab)
    garrs = batch_graphs([graph], state_multiple=1)
    band_out = band_from_arcs(garrs)
    if band_out is None:
        raise ValueError("cross-word arcs exceed band buckets")
    band_np, lb, ub = band_out
    S = graph.num_states

    start = np.full(S, NEG_INF, np.float32)
    start[:] = graph.start
    start_lp = _safe_log(1.0 - p_init)
    for st, w_idx, _f, pron_lp, lset in entries:
        if EPS in lset:
            lm_lp = scale * lm.log_prob(vocab[w_idx], ("<s>",))
            start[st] = max(start[st], start_lp + lm_lp + pron_lp)

    p1, bo_row, eos_row, preds = _lm_rows(lm, vocab, scale)

    RG = max(1, len(rg_sets))
    cell_keys = sorted(cell_map)
    Nc = len(cell_keys)
    Em = max(len(v) for v in cell_map.values())
    cell_exit_idx = np.zeros((Nc, Em), np.int32)
    cell_exit_w = np.full((Nc, Em), NEG_INF, np.float32)
    bo_cell = np.zeros(Nc, np.float32)
    cell_seg = np.zeros(Nc, np.int32)
    cell_lookup: Dict[Tuple[int, int, int], int] = {}
    for c, key in enumerate(cell_keys):
        u_row, p_idx, rg = key
        cell_lookup[key] = c
        for j, (s, w) in enumerate(cell_map[key]):
            cell_exit_idx[c, j] = s
            cell_exit_w[c, j] = w
        bo_cell[c] = bo_row[u_row]
        cell_seg[c] = p_idx * RG + rg
    rg_mask = np.zeros((RG, F), bool)
    for key, rg in rg_sets.items():
        for ph in key:
            rg_mask[rg, f_index[ph]] = True

    cells_of: Dict[int, List[int]] = {}
    for key, c in cell_lookup.items():
        cells_of.setdefault(key[0], []).append(c)

    Ne = len(entries)
    entry_state = np.asarray([e[0] for e in entries], np.int32)
    if len(np.unique(entry_state)) != Ne:
        raise ValueError("entry states are not unique")
    entry_word = np.asarray([e[1] for e in entries], np.int32)
    entry_w = np.asarray([e[3] for e in entries], np.float32)
    p1e = p1[entry_word]
    ebo_lists = []
    se_lists: List[List[Tuple[int, float]]] = []
    for st, w_idx, f_idx, _plp, lset in entries:
        # slots whose left group has no junction-presentable class (an
        # EPS-only group) are start-only: no backoff sources, no seen-bigram
        # candidates
        pcl = sorted(p_index[p] for p in lset if p in p_index)
        ebo_lists.append((pcl, f_idx))
        cand: List[Tuple[int, float]] = []
        pset = set(pcl)
        for u, lp in preds[w_idx]:
            for c in cells_of.get(u, []):
                _u, p_idx2, rg = cell_keys[c]
                if p_idx2 in pset and rg_mask[rg, f_idx]:
                    cand.append((c, lp))
        se_lists.append(cand)
    Lm = max(1, max(len(p) for p, _f in ebo_lists))
    ebo_idx = np.zeros((Ne, Lm), np.int32)
    ebo_pad = np.full((Ne, Lm), NEG_INF, np.float32)
    for e, (pcl, f_idx) in enumerate(ebo_lists):
        for j, p_idx2 in enumerate(pcl):
            ebo_idx[e, j] = p_idx2 * F + f_idx
            ebo_pad[e, j] = 0.0
    Q = max(1, max(len(c) for c in se_lists))
    se_cell = np.zeros((Ne, Q), np.int32)
    se_w = np.full((Ne, Q), NEG_INF, np.float32)
    for e, cand in enumerate(se_lists):
        for j, (c, lp) in enumerate(cand):
            se_cell[e, j] = c
            se_w[e, j] = lp

    fin_state = np.asarray([f[0] for f in finals], np.int32)
    fin_w = np.asarray([w + eos_row[u] for _s, w, u in finals], np.float32)

    # the checkpointed decoder's memory per row must fit the budget at the
    # corpus's longest utterance (nominal 30 s when unknown), or the graph
    # falls back to word-internal context instead of running out of memory
    S_xw = len(garrs["state_pdf"][0])
    P_pdf = int(garrs["state_pdf"][0].max()) + 1
    per_row = xw_ckpt_bytes_per_row(S_xw, Ne, Nc, P_pdf, P, F, RG, nominal_T)
    if per_row > _REC_BUDGET:
        raise ValueError(
            f"cross-word expansion too large to decode: "
            f"{per_row / 1e9:.1f} GB of checkpoints+records per "
            f"{nominal_T / 100:.0f} s utterance (S={S_xw}, entry "
            f"slots={Ne}) exceeds the "
            f"{_REC_BUDGET / 1e9:.1f} GB budget (MFA_TPU_LVCSR_REC_BYTES)"
        )

    return LvcsrXwGraph(
        words=vocab,
        state_pdf=garrs["state_pdf"][0],
        state_word=garrs["state_word"][0],
        state_phone=garrs["state_phone"][0],
        band=band_np[0],
        lb=lb,
        ub=ub,
        start=start,
        cell_exit_idx=cell_exit_idx,
        cell_exit_w=cell_exit_w,
        bo_cell=bo_cell,
        cell_seg=cell_seg,
        rg_mask=rg_mask,
        num_p=P,
        entry_state=entry_state,
        entry_word=entry_word,
        entry_w=entry_w,
        ebo_idx=ebo_idx,
        ebo_pad=ebo_pad,
        p1e=p1e,
        se_cell=se_cell,
        se_w=se_w,
        fin_state=fin_state,
        fin_w=fin_w,
    )


LvcsrGraphCompiler._build_cross_word = _build_cross_word

XW_DEVICE_NAMES = (
    "state_pdf", "band", "start", "cell_exit_idx", "cell_exit_w", "bo_cell",
    "cell_seg", "rg_mask", "entry_state", "entry_word", "entry_w", "ebo_idx",
    "ebo_pad", "p1e", "se_cell", "se_w", "fin_state", "fin_w",
    "entry_slot_of_state", "state_word", "state0_hash",
)


class _XwStep:
    """One cross-word forward step, the only copy of the recursion: with
    ``with_args`` (the backtrace's chunk recompute) it also returns the
    per-frame records, without (the checkpointed decode) none."""

    def __init__(self, d, lb, ub, P, with_args):
        self.d, self.lb, self.ub, self.P = d, lb, ub, P
        self.with_args = with_args
        self.band = d["sparse_band"]
        self.exit_flat = d["cell_exit_idx"].reshape(-1)
        self.Nc, self.Em = d["cell_exit_idx"].shape
        self.RG, self.F = d["rg_mask"].shape
        self.Ne = d["entry_state"].shape[0]
        self.iota_c = torch.arange(self.Nc, device=d["band"].device)

    def junction(self, alpha_prev):
        d, P, RG, F, Ne = self.d, self.P, self.RG, self.F, self.Ne
        B = alpha_prev.shape[0]
        exv = alpha_prev[:, self.exit_flat].reshape(B, self.Nc, self.Em)
        exv = exv + d["cell_exit_w"]
        EX = exv.amax(dim=2)  # (B, Nc)
        # backoff: segment max over (p, rg) cells, then a masked max to (P, F)
        BOc = EX + d["bo_cell"]
        seg = d["cell_seg"][None].expand(B, -1)
        BO2 = torch.full((B, P * RG), NEG_INF, device=EX.device).scatter_reduce(
            1, seg, BOc, "amax")
        brf = torch.where(d["rg_mask"][None, None],
                          BO2.reshape(B, P, RG)[:, :, :, None], NEG_INF)
        BOF = brf.amax(dim=2)  # (B, P, F)
        ent_bo_c = BOF.reshape(B, P * F)[:, d["ebo_idx"].reshape(-1)].reshape(
            B, Ne, -1) + d["ebo_pad"]
        ent_bo = ent_bo_c.amax(dim=2) + d["p1e"]
        se = EX[:, d["se_cell"].reshape(-1)].reshape(B, Ne, -1) + d["se_w"]
        ent_seen = se.amax(dim=2)
        ent = torch.maximum(ent_seen, ent_bo) + d["entry_w"]
        if not self.with_args:
            return ent, None
        cell_arg = torch.argmax(exv, dim=2).to(torch.uint8)
        winner = torch.where(BOc >= BO2.gather(1, seg), self.iota_c, -1)
        BO2arg = torch.full((B, P * RG), -1, dtype=torch.int64,
                            device=EX.device).scatter_reduce(1, seg, winner, "amax")
        BOFarg = torch.argmax(brf, dim=2).to(torch.int16)
        ent_l = torch.argmax(ent_bo_c, dim=2).to(torch.uint8)
        ent_q = torch.argmax(se, dim=2)
        ent_src = torch.where(ent_seen >= ent_bo, ent_q, -1).to(torch.int32)
        return ent, (ent_src, ent_l, cell_arg, BOFarg, BO2arg.to(torch.int32))

    def __call__(self, alpha_prev, emit_t, t, frame_lengths):
        m, bp = self.band.max(alpha_prev)
        ent, args = self.junction(alpha_prev)
        es = self.d["entry_state"]
        m_e = m[:, es]
        m2 = m.index_copy(1, es, torch.maximum(m_e, ent))
        alpha_out = torch.where(_active(t, frame_lengths, 2),
                                m2 + emit_t, alpha_prev)
        if not self.with_args:
            return alpha_out, None
        # junction-won flag per entry slot (B, Ne)
        jwin = ent > m_e
        return alpha_out, (bp, jwin) + args


def _xw_steps(d, lb, ub, P):
    """The graph's two cross-word steps (decode, recompute), made once."""
    key = ("xw_steps", lb, ub, P)
    if key not in d:
        d[key] = (_XwStep(d, lb, ub, P, False), _XwStep(d, lb, ub, P, True))
    return d[key]


def lvcsr_xw_decode_ckpt_device(e0, ep, d, frame_lengths, lb, ub, P):
    """Checkpointed cross-word forward pass: stores only the alpha entering
    each ``_XW_TC``-frame chunk. ``e0`` (B, Np) frame 0 and ``ep`` (NC, TC,
    B, Np) chunked frames 1..T-1 from :func:`split_emissions`; ``d`` the
    graph's device tensors (:func:`graph_tensors`). Returns ``(alpha_T (B,
    S), ckpts (NC, B, S))``."""
    mat = _emit_chunker(d["state_pdf"])
    step, _fstep = _xw_steps(d, lb, ub, P)

    def chunk(alpha, echunk, t0, flens):
        e = mat(echunk)
        for i in range(e.shape[0]):
            alpha, _ = step(alpha, e[i], t0 + i, flens)
        return (alpha,)

    NC, TC = ep.shape[0], ep.shape[1]
    alpha = d["start"][None] + mat(e0[None])[0]
    ckpts = torch.empty((NC,) + tuple(alpha.shape), dtype=torch.float32,
                        device=alpha.device)
    for c in range(NC):
        ckpts[c] = alpha
        (alpha,) = run_graphed(d, ("xw_decode", lb, ub, P), chunk, alpha, ep[c],
                               _t0(1 + c * TC, alpha.device), frame_lengths)
    return alpha, ckpts


def _xw_bt_init(alpha_T, fin_state, fin_w):
    """Final state and score: the best final exit plus its </s> weight."""
    fin = alpha_T[:, fin_state] + fin_w  # (B, Kf)
    k0 = torch.argmax(fin, dim=1)
    score = fin.gather(1, k0[:, None])[:, 0]
    return fin_state[k0], score


def _bt_outputs(path_prev, word_at, s_final, state_word, T):
    """(path (B, T), word entered at each frame (B, T), -1 = none) from the
    reverse walk's per-frame states and words (frames 0..Tp-2)."""
    path = torch.cat([path_prev.T, s_final[:, None]], dim=1)
    w0 = state_word[path[:, 0]]
    word0 = torch.where(w0 >= 0, w0, -1)
    word_at_full = torch.cat([word0[:, None], word_at.T], dim=1)
    return path[:, :T].to(torch.int32), word_at_full[:, :T].to(torch.int32)


def _xw_bstep(d, frame_lengths, lb, F, RG, s, recs, r):
    """One step of the cross-word reverse walk: the state at frame r from
    the state at frame r + 1 and frame r + 1's records."""
    bp_r, jwin_r, entsrc_r, entl_r, cellarg_r, bofarg_r, bo2arg_r = recs
    B = s.shape[0]
    rows = torch.arange(B, device=s.device)
    t = r + 1
    bpv = bp_r[rows, s].long()
    slot = d["entry_slot_of_state"][s]
    e = torch.clamp(slot, min=0)
    is_junc = (slot >= 0) & jwin_r[rows, e]
    q = entsrc_r[rows, e].long()
    cell_seen = d["se_cell"][e, torch.clamp(q, min=0)]
    pf = d["ebo_idx"][e, entl_r[rows, e].long()]
    p, f = pf // F, pf % F
    rg = bofarg_r[rows, p, f].long()
    cell_bo = bo2arg_r[rows, p * RG + rg].long()
    cell = torch.clamp(torch.where(q >= 0, cell_seen, cell_bo), min=0)
    s_j = d["cell_exit_idx"][cell, cellarg_r[rows, cell].long()]
    s_band = s - (bpv - lb)
    active = t < frame_lengths
    s_out = torch.where(active & is_junc, s_j, torch.where(active, s_band, s))
    word = torch.where(active & is_junc, d["entry_word"][e], -1)
    return s_out, word


def lvcsr_xw_backtrace_ckpt_device(alpha_T, ckpts, ep, d, frame_lengths,
                                   lb, ub, P, T):
    """Checkpointed cross-word backtrace: chunks last to first, each
    re-running its forward from the stored checkpoint with records (for its
    TC frames only), then walking them back. Returns (state path (B, T)
    int32, word entered at each frame (B, T) int32, score (B,))."""
    mat = _emit_chunker(d["state_pdf"])
    RG, F = d["rg_mask"].shape
    _step, fstep = _xw_steps(d, lb, ub, P)

    def chunk(ck, echunk, t0, flens, s):
        e = mat(echunk)
        alpha, recs = ck, []
        for i in range(e.shape[0]):
            alpha, rec = fstep(alpha, e[i], t0 + i, flens)
            recs.append(rec)
        states, words = [], []
        for i in range(e.shape[0] - 1, -1, -1):
            s, w = _xw_bstep(d, flens, lb, F, RG, s, recs[i], t0 - 1 + i)
            states.append(s)
            words.append(w)
        return torch.stack(states[::-1]), torch.stack(words[::-1]), s

    NC, TC = ep.shape[0], ep.shape[1]
    B = alpha_T.shape[0]
    s_final, score = _xw_bt_init(alpha_T, d["fin_state"], d["fin_w"])
    path_prev = torch.empty((NC * TC, B), dtype=torch.int64, device=alpha_T.device)
    word_at = torch.empty_like(path_prev)
    s = s_final
    for c in range(NC - 1, -1, -1):
        sl = slice(c * TC, (c + 1) * TC)
        path_prev[sl], word_at[sl], s = run_graphed(
            d, ("xw_backtrace", lb, ub, P), chunk, ckpts[c], ep[c],
            _t0(1 + c * TC, alpha_T.device), frame_lengths, s)
    path, word = _bt_outputs(path_prev, word_at, s_final, d["state_word"], T)
    return path, word, score


def lvcsr_xw_decode_device(emit_pdf, d, frame_lengths, lb, ub, P):
    """Record-based cross-word forward pass, the reference form of the
    checkpointed pair: (alpha_T (B, S), per-frame records stacked over the
    frames 1..T-1 plus inert chunk padding: bp (B, S) uint8, jwin (B, Ne)
    bool, ent_src (B, Ne) int32, ent_l (B, Ne) uint8, cell_arg (B, Nc)
    uint8, BOFarg (B, P, F) int16, BO2arg (B, P*RG) int32). ``d`` is the
    graph's device tensors (:func:`graph_tensors`)."""
    _step, fstep = _xw_steps(d, lb, ub, P)
    alpha0 = d["start"][None] + first_state_emissions(emit_pdf, d["state_pdf"])
    return _scan_chunked(lambda a, e, t: fstep(a, e, t, frame_lengths), alpha0,
                         emit_pdf, d["state_pdf"])


def lvcsr_xw_backtrace_device(alpha_T, recs, d, frame_lengths, lb, T: int = 0):
    """Backtrace of :func:`lvcsr_xw_decode_device` on the device, a reverse
    walk over its records with the checkpointed backtrace's step: (state
    path (B, T) int32, word entered at each frame (B, T) int32, score
    (B,))."""
    RG, F = d["rg_mask"].shape
    Tp = recs[0].shape[0] + 1
    T = T or Tp
    s_final, score = _xw_bt_init(alpha_T, d["fin_state"], d["fin_w"])
    path_prev = torch.empty((Tp - 1, alpha_T.shape[0]), dtype=torch.int64,
                            device=alpha_T.device)
    word_at = torch.empty_like(path_prev)
    s = s_final
    for r in range(Tp - 2, -1, -1):
        s, w = _xw_bstep(d, frame_lengths, lb, F, RG, s,
                         tuple(x[r] for x in recs), r)
        path_prev[r], word_at[r] = s, w
    path, word = _bt_outputs(path_prev, word_at, s_final, d["state_word"], T)
    return path, word, score


def lvcsr_xw_backtrace_host(graph: LvcsrXwGraph, alpha_T: np.ndarray, recs,
                            frame_lengths: np.ndarray, T: int = 0
                            ) -> List[Tuple[np.ndarray, float, List[Tuple[int, int]]]]:
    """Per-utterance (state path (T,), score, word events) from the
    record-based cross-word decode's records fetched to the host: the
    reference form of :func:`lvcsr_xw_backtrace_device`."""
    bp_raw, jwin, ent_src, ent_l, cell_arg, BOFarg, BO2arg = [
        np.asarray(r) for r in recs
    ]
    B, S = alpha_T.shape
    T = T or bp_raw.shape[0] + 1
    RG, F = graph.rg_mask.shape
    entry_slot = {int(s): i for i, s in enumerate(graph.entry_state)}
    out = []
    for b in range(B):
        L = int(frame_lengths[b])
        fin = alpha_T[b][graph.fin_state] + graph.fin_w
        k = int(np.argmax(fin))
        score = float(fin[k])
        s = int(graph.fin_state[k])
        path = np.zeros(T, np.int32)
        path[L - 1 :] = s
        events: List[Tuple[int, int]] = []
        for t in range(L - 1, 0, -1):
            r = t - 1
            e = entry_slot.get(s)
            if e is not None and jwin[r, b, e]:
                events.append((t, int(graph.entry_word[e])))
                q = int(ent_src[r, b, e])
                if q >= 0:
                    cell = int(graph.se_cell[e, q])
                else:
                    pf = int(graph.ebo_idx[e, int(ent_l[r, b, e])])
                    p, f = pf // F, pf % F
                    rg = int(BOFarg[r, b, p, f])
                    cell = int(BO2arg[r, b, p * RG + rg])
                s = int(
                    graph.cell_exit_idx[cell, int(cell_arg[r, b, cell])]
                )
            else:
                s = s - (int(bp_raw[r, b, s]) - graph.lb)
            path[t - 1] = s
        w0 = int(graph.state_word[path[0]])
        if w0 >= 0:
            events.append((0, w0))
        events.reverse()
        out.append((path, score, events))
    return out


# ---------------------------------------------------------------------------
# K-best (determinized N-best) junction decoders
# ---------------------------------------------------------------------------
# The K-best-semiring generalisation: alpha carries the top-K partial-path
# scores per state, each with a rolling hash of the word sequence so far;
# every merge (band step, word-exit pool, backoff pool, junction entry)
# drops same-hash candidates, so the K ranks hold K distinct word sequences.
# Records stay on the device for the flat variant's backtrace; the
# cross-word variant's backtrace runs on the host (as in the JAX package).


def _v_hash(h: torch.Tensor, v_plus1: torch.Tensor) -> torch.Tensor:
    return (h * HASH_MULT + v_plus1) & HASH_MASK


def _scan_chunked(step, carry, emit_pdf, state_pdf):
    """Frames 1..T-1 of ``step(carry, emit_t (B, S), t) -> (carry, recs)``,
    pdf emissions expanded to states one ``_EMIT_TC``-frame chunk at a
    time; ``carry`` is made by the caller from frame 0's state emissions
    (``first_state_emissions``). Returns (final carry, records stacked over
    NC*TC frames; the tail padding is inert)."""
    mat = _emit_chunker(state_pdf)
    ep, NC = _chunk_pdf_frames(emit_pdf, _EMIT_TC)
    out = None
    for c in range(NC):
        echunk = mat(ep[c])
        for i in range(_EMIT_TC):
            r = c * _EMIT_TC + i
            carry, recs = step(carry, echunk[i], 1 + r)
            if out is None:
                out = [torch.empty((NC * _EMIT_TC,) + tuple(x.shape),
                                   dtype=x.dtype, device=x.device) for x in recs]
            for o, x in zip(out, recs):
                o[r] = x
    return carry, tuple(out)


def first_state_emissions(emit_pdf, state_pdf):
    """Frame 0's (B, S) state emissions, through the chunker's gather."""
    return _emit_chunker(state_pdf)(emit_pdf[:, :1].transpose(0, 1))[0]


def _kbest_init(start, e0, state0_hash, K):
    B, S = e0.shape
    dev = e0.device
    alpha0 = torch.cat([
        (start[None] + e0)[:, :, None],
        torch.full((B, S, K - 1), NEG_INF, dtype=torch.float32, device=dev),
    ], dim=2)
    hash0 = torch.cat([
        state0_hash[None, :, None].expand(B, S, 1),
        torch.zeros((B, S, K - 1), dtype=torch.int64, device=dev),
    ], dim=2)
    return alpha0, hash0


def _band_candidates(alpha_prev, hist_prev, band, lb, ub):
    """(B, S, D*K) band candidates and their hashes, column-major in j."""
    S = alpha_prev.shape[1]
    ap = torch.nn.functional.pad(alpha_prev, (0, 0, ub, lb), value=NEG_INF)
    hp = torch.nn.functional.pad(hist_prev, (0, 0, ub, lb))
    bvals, bhash = [], []
    for j in range(band.shape[1]):
        d = j - lb
        bvals.append(ap[:, ub - d : ub - d + S] + band[:, j][None, :, None])
        bhash.append(hp[:, ub - d : ub - d + S])
    return bvals, bhash


def lvcsr_nbest_device(
    emit_pdf, state_pdf, frame_lengths, band, start, state0_hash,
    exit_idx, exit_w, entry_idx, entry_word, entry_w, p1, bo, big_pred,
    big_w, lb: int, ub: int, K: int,
):
    """K-best forward pass of the chain-major word-internal junction.
    Returns ``(alpha_T (B, S, K), hist_T (B, S, K), recs)``: per-frame
    ``(cand_sel (B, S, K) int16, ent_sel (B, V, K) int32, bo_sel (B, K)
    int32, exit_sel (B, U, K) int16)``. ``ent_sel`` spans (Kb+1)*K, which
    exceeds int16 for high-fanout LM words, so it stays int32."""
    B = emit_pdf.shape[0]
    S = state_pdf.shape[0]
    U, E = exit_idx.shape
    V, Kb = big_pred.shape
    exit_flat = exit_idx.reshape(-1)
    exit_w_flat = exit_w.reshape(-1)[None, :, None]
    v_plus1 = torch.arange(1, V + 1, device=emit_pdf.device)[None, :, None]

    def junction(alpha_prev, hist_prev):
        exv = (alpha_prev[:, exit_flat] + exit_w_flat).reshape(B, U, E * K)
        exh = hist_prev[:, exit_flat].reshape(B, U, E * K)
        exit_u, exit_h, exit_sel = dedup_topk(exv, exh, K)  # (B, U, K)
        bo_sc = (exit_u + bo[None, :, None]).reshape(B, U * K)
        BO, BO_h, bo_sel = dedup_topk(bo_sc, exit_h.reshape(B, U * K), K)
        bp_flat = big_pred.reshape(-1)
        seen_v = exit_u[:, bp_flat].reshape(B, V, Kb, K) + big_w[None, :, :, None]
        seen_h = exit_h[:, bp_flat].reshape(B, V, Kb, K)
        bo_v = BO[:, None, :] + p1[None, :, None]
        bo_vh = BO_h[:, None, :].expand(B, V, K)
        cand = torch.cat([seen_v.reshape(B, V, Kb * K), bo_v], dim=-1)
        ch = torch.cat([seen_h.reshape(B, V, Kb * K), bo_vh], dim=-1)
        ent_v, ent_hsrc, ent_sel = dedup_topk(cand, ch, K)  # (B, V, K)
        ent_h = _v_hash(ent_hsrc, v_plus1)
        entry_cand = ent_v[:, entry_word] + entry_w[None, :, None]
        entry_h = ent_h[:, entry_word]
        return entry_cand, entry_h, ent_sel, bo_sel, exit_sel

    def step(carry, emit_t, t):
        alpha_prev, hist_prev = carry
        bvals, bhash = _band_candidates(alpha_prev, hist_prev, band, lb, ub)
        entry_cand, entry_h, ent_sel, bo_sel, exit_sel = junction(
            alpha_prev, hist_prev)
        ent_buf = torch.full_like(alpha_prev, NEG_INF)
        ent_buf[:, entry_idx] = entry_cand
        enth_buf = torch.zeros_like(hist_prev)
        enth_buf[:, entry_idx] = entry_h
        cand = torch.cat(bvals + [ent_buf], dim=-1)  # (B, S, (D+1)*K)
        chash = torch.cat(bhash + [enth_buf], dim=-1)
        m, hsel, cand_sel = dedup_topk(cand, chash, K)
        active = _active(t, frame_lengths, 3)
        alpha_out = torch.where(active, m + emit_t[:, :, None], alpha_prev)
        hist_out = torch.where(active, hsel, hist_prev)
        recs = (cand_sel.to(torch.int16), ent_sel.to(torch.int32),
                bo_sel.to(torch.int32), exit_sel.to(torch.int16))
        return (alpha_out, hist_out), recs

    carry = _kbest_init(start, first_state_emissions(emit_pdf, state_pdf),
                        state0_hash, K)
    (alpha_T, hist_T), recs = _scan_chunked(step, carry, emit_pdf, state_pdf)
    return alpha_T, hist_T, recs


def lvcsr_nbest_backtrace_host(
    graph: LvcsrGraph,
    alpha_T: np.ndarray,  # (B, S, K)
    hist_T: np.ndarray,  # (B, S, K)
    recs,
    frame_lengths: np.ndarray,
    nbest: int,
    T: int = 0,
) -> List[List[Tuple[np.ndarray, float, List[Tuple[int, int]]]]]:
    """Per utterance, up to ``nbest`` distinct-word-sequence hypotheses,
    best first: [(state_path (T,), score, word events)]. The reference of
    :func:`lvcsr_nbest_backtrace_device`."""
    cand_sel, ent_sel, bo_sel, exit_sel = [np.asarray(r) for r in recs]
    B, S, K = alpha_T.shape
    T = T or cand_sel.shape[0] + 1
    D = graph.lb + graph.ub + 1
    Kb = graph.big_pred.shape[1]
    entry_slot = {int(s): i for i, s in enumerate(graph.entry_idx)}
    out = []
    for b in range(B):
        L = int(frame_lengths[b])
        ex = (alpha_T[b][graph.exit_idx] + graph.exit_w[:, :, None]
              + graph.eos[:, None, None])
        exh = hist_T[b][graph.exit_idx]
        flat = ex.reshape(-1)
        order = np.argsort(-flat)
        hyps = []
        seen_h = set()
        for p in order:
            if len(hyps) >= nbest or flat[p] <= NEG_INF / 2:
                break
            h = int(exh.reshape(-1)[p])
            if h in seen_h:
                continue
            seen_h.add(h)
            u, e, r = np.unravel_index(int(p), ex.shape)
            hyps.append((float(flat[p]), int(graph.exit_idx[u, e]), int(r)))
        traces = []
        for score, s, r in hyps:
            path = np.zeros(T, np.int32)
            path[L - 1 :] = s
            events: List[Tuple[int, int]] = []
            for t in range(L - 1, 0, -1):
                val = int(cand_sel[t - 1, b, s, r])
                if val < D * K:
                    j, r = val // K, val % K
                    s = s - (j - graph.lb)
                else:
                    er = val - D * K
                    v = int(graph.entry_word[entry_slot[s]])
                    events.append((t, v))
                    val2 = int(ent_sel[t - 1, b, v, er])
                    if val2 < Kb * K:
                        u, r2 = int(graph.big_pred[v, val2 // K]), val2 % K
                    else:
                        flat_bo = int(bo_sel[t - 1, b, val2 - Kb * K])
                        u, r2 = flat_bo // K, flat_bo % K
                    val3 = int(exit_sel[t - 1, b, u, r2])
                    s, r = int(graph.exit_idx[u, val3 // K]), val3 % K
                path[t - 1] = s
            w0 = int(graph.state_word[path[0]])
            if w0 >= 0:
                events.append((0, w0))
            events.reverse()
            traces.append((path, score, events))
        out.append(traces)
    return out


def lvcsr_nbest_final_select_device(alpha_T, hist_T, exit_idx, exit_w, eos,
                                    H: int):
    """Top-H distinct-word-sequence final hypotheses on the device:
    (scores (B, H), NEG_INF padding short rows; s0 (B, H) final state; rk0
    (B, H) rank within that state's K list)."""
    B, _S, K = alpha_T.shape
    U, E = exit_idx.shape
    ex = (alpha_T[:, exit_idx.reshape(-1)].reshape(B, U, E, K)
          + exit_w[None, :, :, None] + eos[None, :, None, None])
    exh = hist_T[:, exit_idx.reshape(-1)].reshape(B, U, E, K)
    vals, _hsel, idx = dedup_topk(ex.reshape(B, U * E * K),
                                  exh.reshape(B, U * E * K), H)
    u = idx // (E * K)
    e = (idx // K) % E
    rk0 = idx % K
    return vals, exit_idx[u, e], rk0


def lvcsr_nbest_backtrace_device(
    s0, rk0, recs, frame_lengths, entry_word, entry_slot_of_state, big_pred,
    exit_idx, state_word, lb: int, ub: int, K: int, T: int = 0,
):
    """K-best backtrace on the device over (B, H) hypotheses: (paths (B, H,
    T) int32, word entered at each frame (B, H, T) int32, -1 = none), each
    decision as :func:`lvcsr_nbest_backtrace_host` takes it."""
    cand_sel, ent_sel, bo_sel, exit_sel = recs
    B, H = s0.shape
    Tp = cand_sel.shape[0] + 1
    T = T or Tp
    D = lb + ub + 1
    Kb = big_pred.shape[1]
    rows = torch.arange(B, device=s0.device)[:, None]
    s, rk = s0, rk0
    path_prev = torch.empty((Tp - 1, B, H), dtype=torch.int64, device=s0.device)
    word_at = torch.empty_like(path_prev)
    for r in range(Tp - 2, -1, -1):
        t = r + 1
        val = cand_sel[r][rows, s, rk].long()
        is_band = val < D * K
        vc = torch.clamp(val, min=0)
        s_band = s - (vc // K - lb)
        rk_band = vc % K
        er = torch.clamp(val - D * K, min=0)
        slot = entry_slot_of_state[s]
        v = entry_word[torch.clamp(slot, min=0)]
        val2 = ent_sel[r][rows, v, er].long()
        seen = val2 < Kb * K
        v2c = torch.clamp(val2, min=0)
        # indices of the branch not taken are clamped into range, as the
        # JAX package's gathers clamp them
        u_seen = big_pred[v, torch.clamp(v2c // K, max=Kb - 1)]
        flat_bo = bo_sel[r][rows, torch.clamp(val2 - Kb * K, 0, K - 1)].long()
        u = torch.where(seen, u_seen, flat_bo // K)
        r2 = torch.where(seen, v2c % K, flat_bo % K)
        val3 = torch.clamp(exit_sel[r][rows, u, r2].long(), min=0)
        s_j = exit_idx[u, torch.clamp(val3 // K, max=exit_idx.shape[1] - 1)]
        rk_j = val3 % K
        active = t < frame_lengths[:, None]
        s = torch.where(active, torch.where(is_band, s_band, s_j), s)
        rk = torch.where(active, torch.where(is_band, rk_band, rk_j), rk)
        path_prev[r] = s
        word_at[r] = torch.where(active & ~is_band, v, -1)
    path = torch.cat([path_prev.permute(1, 2, 0), s0[:, :, None]], dim=2)
    w0 = state_word[path[:, :, 0]]
    word0 = torch.where(w0 >= 0, w0, -1)
    word_at_full = torch.cat([word0[:, :, None], word_at.permute(1, 2, 0)], dim=2)
    return path[:, :, :T].to(torch.int32), word_at_full[:, :, :T].to(torch.int32)


def lvcsr_xw_nbest_device(
    emit_pdf, state_pdf, frame_lengths, band, start, state0_hash,
    cell_exit_idx, cell_exit_w, bo_cell, seg_cells, seg_pad, entry_state,
    entry_word, entry_w, p1e, se_cell, se_w, ebo_seg, ebo_seg_pad,
    lb: int, ub: int, K: int,
):
    """K-best forward pass of the cross-word junction. Returns
    ``(alpha_T (B, S, K), hist_T (B, S, K), recs)``: per-frame ``(cand_sel
    int16, ent_sel int32, bo2_sel int32, exit_sel int32)``."""
    B = emit_pdf.shape[0]
    S = state_pdf.shape[0]
    Nc, Em = cell_exit_idx.shape
    Nseg, Cs = seg_cells.shape
    Ne, Q = se_cell.shape
    Lsg = ebo_seg.shape[1]
    exit_flat = cell_exit_idx.reshape(-1)
    v_plus1 = (entry_word + 1)[None, :, None]

    def junction(alpha_prev, hist_prev):
        exv = (alpha_prev[:, exit_flat].reshape(B, Nc, Em, K)
               + cell_exit_w[None, :, :, None]).reshape(B, Nc, Em * K)
        exh = hist_prev[:, exit_flat].reshape(B, Nc, Em * K)
        EXc, EXh, exit_sel = dedup_topk(exv, exh, K)  # (B, Nc, K)
        BOc = EXc + bo_cell[None, :, None]
        sc = seg_cells.reshape(-1)
        sg = (BOc[:, sc].reshape(B, Nseg, Cs, K)
              + seg_pad[None, :, :, None]).reshape(B, Nseg, Cs * K)
        sgh = EXh[:, sc].reshape(B, Nseg, Cs * K)
        BO2v, BO2h, bo2_sel = dedup_topk(sg, sgh, K)  # (B, Nseg, K)
        seen = (EXc[:, se_cell.reshape(-1)].reshape(B, Ne, Q, K)
                + se_w[None, :, :, None]).reshape(B, Ne, Q * K)
        seen_h = EXh[:, se_cell.reshape(-1)].reshape(B, Ne, Q * K)
        bo_c = (BO2v[:, ebo_seg.reshape(-1)].reshape(B, Ne, Lsg, K)
                + ebo_seg_pad[None, :, :, None]
                + p1e[None, :, None, None]).reshape(B, Ne, Lsg * K)
        bo_h = BO2h[:, ebo_seg.reshape(-1)].reshape(B, Ne, Lsg * K)
        cand = torch.cat([seen, bo_c], dim=-1)
        ch = torch.cat([seen_h, bo_h], dim=-1)
        entv, enth_src, ent_sel = dedup_topk(cand, ch, K)  # (B, Ne, K)
        entv = entv + entry_w[None, :, None]
        return entv, _v_hash(enth_src, v_plus1), ent_sel, bo2_sel, exit_sel

    def step(carry, emit_t, t):
        alpha_prev, hist_prev = carry
        bvals, bhash = _band_candidates(alpha_prev, hist_prev, band, lb, ub)
        entv, enth, ent_sel, bo2_sel, exit_sel = junction(alpha_prev, hist_prev)
        ent_buf = torch.full_like(alpha_prev, NEG_INF)
        ent_buf[:, entry_state] = entv
        enth_buf = torch.zeros_like(hist_prev)
        enth_buf[:, entry_state] = enth
        cand = torch.cat(bvals + [ent_buf], dim=-1)
        chash = torch.cat(bhash + [enth_buf], dim=-1)
        m, hsel, cand_sel = dedup_topk(cand, chash, K)
        active = _active(t, frame_lengths, 3)
        alpha_out = torch.where(active, m + emit_t[:, :, None], alpha_prev)
        hist_out = torch.where(active, hsel, hist_prev)
        recs = (cand_sel.to(torch.int16), ent_sel.to(torch.int32),
                bo2_sel.to(torch.int32), exit_sel.to(torch.int32))
        return (alpha_out, hist_out), recs

    carry = _kbest_init(start, first_state_emissions(emit_pdf, state_pdf),
                        state0_hash, K)
    (alpha_T, hist_T), recs = _scan_chunked(step, carry, emit_pdf, state_pdf)
    return alpha_T, hist_T, recs


def lvcsr_xw_nbest_backtrace_host(
    graph: LvcsrXwGraph,
    alpha_T: np.ndarray,  # (B, S, K)
    hist_T: np.ndarray,
    recs,
    frame_lengths: np.ndarray,
    nbest: int,
    T: int = 0,
) -> List[List[Tuple[np.ndarray, float, List[Tuple[int, int]]]]]:
    """Per utterance, hypotheses [(state_path, score, word events)], best
    first: the cross-word counterpart of :func:`lvcsr_nbest_backtrace_host`."""
    cand_sel, ent_sel, bo2_sel, exit_sel = [np.asarray(r) for r in recs]
    B, S, K = alpha_T.shape
    T = T or cand_sel.shape[0] + 1
    D = graph.lb + graph.ub + 1
    ka = graph.kbest_arrays()
    seg_cells, ebo_seg = ka["seg_cells"], ka["ebo_seg"]
    Q = graph.se_cell.shape[1]
    entry_slot = {int(s): i for i, s in enumerate(graph.entry_state)}
    out = []
    for b in range(B):
        L = int(frame_lengths[b])
        fin = alpha_T[b][graph.fin_state] + graph.fin_w[:, None]  # (Nf, K)
        finh = hist_T[b][graph.fin_state]
        flat = fin.reshape(-1)
        order = np.argsort(-flat)
        hyps = []
        seen_h = set()
        for p in order:
            if len(hyps) >= nbest or flat[p] <= NEG_INF / 2:
                break
            h = int(finh.reshape(-1)[p])
            if h in seen_h:
                continue
            seen_h.add(h)
            f_idx, r = int(p) // K, int(p) % K
            hyps.append((float(flat[p]), int(graph.fin_state[f_idx]), r))
        traces = []
        for score, s, r in hyps:
            path = np.zeros(T, np.int32)
            path[L - 1 :] = s
            events: List[Tuple[int, int]] = []
            for t in range(L - 1, 0, -1):
                rr = t - 1
                val = int(cand_sel[rr, b, s, r])
                if val < D * K:
                    j, r = val // K, val % K
                    s = s - (j - graph.lb)
                else:
                    er = val - D * K
                    e = entry_slot[s]
                    events.append((t, int(graph.entry_word[e])))
                    v2 = int(ent_sel[rr, b, e, er])
                    if v2 < Q * K:
                        cell = int(graph.se_cell[e, v2 // K])
                        r2 = v2 % K
                    else:
                        l, r2 = (v2 - Q * K) // K, (v2 - Q * K) % K
                        seg = int(ebo_seg[e, l])
                        v4 = int(bo2_sel[rr, b, seg, r2])
                        cell = int(seg_cells[seg, v4 // K])
                        r2 = v4 % K
                    v3 = int(exit_sel[rr, b, cell, r2])
                    s = int(graph.cell_exit_idx[cell, v3 // K])
                    r = v3 % K
                path[t - 1] = s
            w0 = int(graph.state_word[path[0]])
            if w0 >= 0:
                events.append((0, w0))
            events.reverse()
            traces.append((path, score, events))
        out.append(traces)
    return out
