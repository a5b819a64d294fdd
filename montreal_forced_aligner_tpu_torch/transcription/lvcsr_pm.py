"""Position-major LVCSR layout: the word-internal decoder's production
geometry, in PyTorch.

Counterpart of ``montreal_forced_aligner_tpu/transcription/lvcsr_pm.py``.
Every (word, pronunciation) becomes one chain c, its phone HMM states
followed by the trailing optional-silence states, and state (p, c) lives
at flat index ``p * C + c``. So entry states are the contiguous row p = 0
(the junction entry is a dense maximum on ``alpha[:, 0, :]``), intra-chain
arcs are shifts along the position axis, and word exits are a masked max
over positions. Cells past a chain's length are dead: NEG_INF start,
incoming and exit weights.

Decode is checkpointed: it stores only the alpha entering each ``_PM_TC``
chunk, and the backtrace re-runs each chunk's forward to regenerate its
records chunk-locally.

The junction's winning seen-bigram index (``ent_src``) is int32. The JAX
package stores it as int8, which wraps once a chain has more than 127
seen-bigram predecessors (Kb > 127) and then backtraces into the wrong
word at the right score; the port does not copy that.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.graph.compiler import _safe_log
from montreal_forced_aligner_tpu_torch.ops.viterbi import NEG_INF
from montreal_forced_aligner_tpu_torch.transcription.lvcsr import (
    LN10,
    _active,
    _bt_outputs,
    _emit_chunker,
    _lm_rows,
    _t0,
    band_max,
    live_band_columns,
    run_graphed,
)

# frames per emission chunk and checkpoint spacing
_PM_TC = 64

# cap on the position-band width (backpointers are u8 offset indices)
_MAX_DP = 32

PM_DEVICE_NAMES = (
    "state_pdf", "band", "start", "exit_w_grid", "bo_c", "pred_c", "pred_w",
    "p1_c", "entry_w_c", "eos_c", "chain_word", "state_word",
)


@dataclass
class LvcsrPmGraph:
    """Host arrays of the position-major word-internal decoder. C chains
    (one per (word, pronunciation) and one initial-silence chain, padded to
    a multiple of 128), Pmax positions; flat state id = p * C + c."""

    words: List[str]
    Pmax: int
    C: int  # padded chain count; chains >= n_chains are dead
    n_chains: int
    n_real_states: int  # live cells
    lbp: int  # position-band limits: offsets d in [-lbp, ubp]
    ubp: int
    state_pdf: np.ndarray  # (Pmax*C,) row-major over (p, c); dead = 0
    state_word: np.ndarray  # (Pmax*C,) word idx; -1 silence/dead
    state_phone: np.ndarray  # (Pmax*C,) phone id; -1 dead
    band: np.ndarray  # (Dp, Pmax, C) arc weight into (p, c) from (p-d, c)
    start: np.ndarray  # (Pmax, C)
    exit_w_grid: np.ndarray  # (Pmax, C) word-exit weight (NEG_INF non-exit)
    chain_word: np.ndarray  # (C,) word of chain; -1 for init-silence/dead
    bo_c: np.ndarray  # (C,) scaled backoff weight of the chain's history
    p1_c: np.ndarray  # (C,) scaled unigram of the chain's word
    entry_w_c: np.ndarray  # (C,) pron log-prob - insertion penalty
    eos_c: np.ndarray  # (C,) scaled </s> weight of the chain's history
    pred_c: np.ndarray  # (C, Kb) seen-bigram predecessor chain ids
    pred_w: np.ndarray  # (C, Kb) scaled bigram log-prob (NEG_INF pad)
    cross_word_fallback: bool = False

    @property
    def num_states(self) -> int:
        return self.n_real_states


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class _ChainBuilder:
    """One position-major chain: states appended in position order."""

    def __init__(self):
        self.pdf: List[int] = []
        self.phone: List[int] = []
        self.word: List[int] = []
        self.arcs: List[Tuple[int, int, float]] = []  # (src_pos, dst_pos, w)
        self.exits: List[Tuple[int, float]] = []  # (pos, word-exit weight)

    def add_plan(self, plan: dict, phone: int, word: int,
                 prev_exits: List[Tuple[int, float]], link_w: float = 0.0):
        """Append one phone plan; wire ``prev_exits`` into its entry with
        ``link_w`` added. Returns this plan's exits as (pos, w)."""
        off = len(self.pdf)
        n = plan["n_emit"]
        self.pdf.extend(plan["pdfs"])
        self.phone.extend([phone] * n)
        self.word.extend([word] * n)
        for src, dst, w, _tid in plan["internal"]:
            self.arcs.append((off + src, off + dst, w))
        for pos, w in prev_exits:
            self.arcs.append((pos, off, w + link_w))
        return [(off + src, w) for src, w, _tid in plan["exits"]]


def build_word_internal_pm(compiler) -> LvcsrPmGraph:
    """Position-major build of the word-internal LVCSR graph (the same
    phone plans, optional-silence absorption and LM rows as the chain-major
    build; only the numbering and junction factorisation differ).
    ``compiler`` is the :class:`~.lvcsr.LvcsrGraphCompiler`."""
    lex = compiler.lexicon
    lm = compiler.lm
    comp = compiler.comp
    sil = lex.phone_id(lex.silence_phone, None)
    sil_plan = comp._phone_plan(comp._window(0, sil, 0))
    vocab = [w for w in lm.vocab if w in lex.words]
    if not vocab:
        raise ValueError("no LM words found in the lexicon")
    V = len(vocab)
    scale = compiler.lm_scale * LN10

    chains: List[_ChainBuilder] = []
    chain_word_l: List[int] = []
    chain_row_l: List[int] = []  # LM-history row: word idx, or V for <s>
    entry_w_l: List[float] = []
    start_l: List[float] = []  # start score at position 0
    start_lp = _safe_log(1.0 - lex.initial_silence_probability)

    for w_idx, word in enumerate(vocab):
        for pron in lex.words[word]:
            if lex.position_dependent:
                pids = lex.pronunciation_phone_ids(pron.phones)
            else:
                pids = [lex.phone_id(p, None) for p in pron.phones]
            prob = pron.probability if pron.probability is not None else 1.0
            pron_lp = (
                math.log(max(min(prob, 1.0), 1e-5))
                - compiler.word_insertion_penalty
            )
            p_sil = (
                pron.silence_after_probability
                if pron.silence_after_probability is not None
                else lex.silence_probability
            )
            cb = _ChainBuilder()
            prev_exits: List[Tuple[int, float]] = []
            n = len(pids)
            for k, phone in enumerate(pids):
                l = pids[k - 1] if k > 0 else sil
                r = pids[k + 1] if k < n - 1 else sil
                plan = comp._phone_plan(comp._window(l, phone, r))
                prev_exits = cb.add_plan(plan, phone, w_idx, prev_exits)
            skip_lp = _safe_log(max(1.0 - p_sil, 1e-5))
            sil_lp = _safe_log(max(p_sil, 1e-5))
            # chain exits skip the optional silence; the silence block is
            # appended to the chain and its exits are word exits too
            cb.exits.extend((pos, w + skip_lp) for pos, w in prev_exits)
            s_exits = cb.add_plan(sil_plan, sil, -1, prev_exits, sil_lp)
            cb.exits.extend(s_exits)
            chains.append(cb)
            chain_word_l.append(w_idx)
            chain_row_l.append(w_idx)
            entry_w_l.append(pron_lp)
            start_l.append(
                start_lp + scale * lm.log_prob(word, ("<s>",)) + pron_lp
            )

    # initial silence = its own chain with the <s> history row; only the
    # start vector enters it
    cb = _ChainBuilder()
    cb.exits.extend(cb.add_plan(sil_plan, sil, -1, []))
    chains.append(cb)
    chain_word_l.append(-1)
    chain_row_l.append(V)
    entry_w_l.append(NEG_INF)
    start_l.append(_safe_log(lex.initial_silence_probability))

    n_chains = len(chains)
    C = _round_up(n_chains, 128)
    Pmax = _round_up(max(len(c.pdf) for c in chains), 8)

    dmin = min((dst - src for c in chains for src, dst, _w in c.arcs),
               default=0)
    dmax = max((dst - src for c in chains for src, dst, _w in c.arcs),
               default=0)
    lbp, ubp = max(0, -dmin), max(0, dmax)
    Dp = lbp + ubp + 1
    if Dp > _MAX_DP:
        raise ValueError(
            f"position band too wide ({Dp} offsets; topology arcs span "
            f"[{dmin}, {dmax}])"
        )

    state_pdf = np.zeros((Pmax, C), np.int32)
    state_word = np.full((Pmax, C), -1, np.int32)
    state_phone = np.full((Pmax, C), -1, np.int32)
    band = np.full((Dp, Pmax, C), NEG_INF, np.float32)
    start = np.full((Pmax, C), NEG_INF, np.float32)
    exit_w_grid = np.full((Pmax, C), NEG_INF, np.float32)
    for c, cb in enumerate(chains):
        L = len(cb.pdf)
        state_pdf[:L, c] = cb.pdf
        state_word[:L, c] = cb.word
        state_phone[:L, c] = cb.phone
        for src, dst, w in cb.arcs:
            j = dst - src + lbp
            band[j, dst, c] = max(band[j, dst, c], w)
        for pos, w in cb.exits:
            exit_w_grid[pos, c] = max(exit_w_grid[pos, c], w)
        start[0, c] = start_l[c]

    p1, bo_row, eos_row, preds = _lm_rows(lm, vocab, scale)
    chain_word = np.full(C, -1, np.int32)
    chain_word[:n_chains] = chain_word_l
    bo_c = np.zeros(C, np.float32)
    eos_c = np.full(C, NEG_INF, np.float32)
    p1_c = np.zeros(C, np.float32)
    entry_w_c = np.full(C, NEG_INF, np.float32)
    for c in range(n_chains):
        row = chain_row_l[c]
        bo_c[c] = bo_row[row]
        eos_c[c] = eos_row[row]
        entry_w_c[c] = entry_w_l[c]
        if chain_word_l[c] >= 0:
            p1_c[c] = p1[chain_word_l[c]]

    chains_of_row: Dict[int, List[int]] = {}
    for c in range(n_chains):
        chains_of_row.setdefault(chain_row_l[c], []).append(c)
    pred_lists: List[List[Tuple[int, float]]] = []
    for c in range(n_chains):
        w_idx = chain_word_l[c]
        cand: List[Tuple[int, float]] = []
        if w_idx >= 0:
            for u, wgt in preds[w_idx]:
                for cu in chains_of_row.get(u, []):
                    cand.append((cu, wgt))
        pred_lists.append(cand)
    Kb = max(1, max((len(p) for p in pred_lists), default=1))
    pred_c = np.zeros((C, Kb), np.int32)
    pred_w = np.full((C, Kb), NEG_INF, np.float32)
    for c, cand in enumerate(pred_lists):
        for k, (cu, wgt) in enumerate(cand):
            pred_c[c, k] = cu
            pred_w[c, k] = wgt

    return LvcsrPmGraph(
        words=vocab,
        Pmax=Pmax,
        C=C,
        n_chains=n_chains,
        n_real_states=int(sum(len(c.pdf) for c in chains)),
        lbp=lbp,
        ubp=ubp,
        state_pdf=state_pdf.reshape(-1),
        state_word=state_word.reshape(-1),
        state_phone=state_phone.reshape(-1),
        band=band,
        start=start,
        exit_w_grid=exit_w_grid,
        chain_word=chain_word,
        bo_c=bo_c,
        p1_c=p1_c,
        entry_w_c=entry_w_c,
        eos_c=eos_c,
        pred_c=pred_c,
        pred_w=pred_w,
    )


def _pm_junction(alpha_prev, d, with_args: bool):
    """Per-chain backoff-LM junction over alpha_prev (B, Pmax, C): exits
    pooled by a masked max over positions, one backoff maximum, the
    seen-bigram gather. Winner indices are the first maximum."""
    B, Pmax, C = alpha_prev.shape
    pred_c = d["pred_c"]
    Kb = pred_c.shape[1]
    exv = alpha_prev + d["exit_w_grid"][None]
    exit_c = exv.amax(dim=1)  # (B, C)
    bo_sc = exit_c + d["bo_c"]
    BO = bo_sc.amax(dim=1)  # (B,)
    big = exit_c[:, pred_c.reshape(-1)].reshape(B, C, Kb) + d["pred_w"]
    big_best = big.amax(dim=2)
    bo_path = BO[:, None] + d["p1_c"]
    ent = torch.maximum(bo_path, big_best) + d["entry_w_c"]  # (B, C)
    if not with_args:
        return ent, None
    exit_arg = torch.argmax(exv, dim=1).to(torch.uint8)
    bo_arg = torch.argmax(bo_sc, dim=1)
    big_arg = torch.argmax(big, dim=2)
    ent_src = torch.where(bo_path >= big_best, -1, big_arg).to(torch.int32)
    return ent, (ent_src, exit_arg, bo_arg)


class _PmStep:
    """One position-major forward step, the only copy of the recursion:
    with ``with_args`` (the backtrace's chunk recompute) it returns the
    per-frame records (band backpointers, the junction-won bitmap and the
    junction winners), without (the decode) none."""

    def __init__(self, d, lbp, ubp, with_args):
        self.d, self.lbp, self.ubp = d, lbp, ubp
        self.with_args = with_args
        band = d["band"]
        self.cols = [band[j] for j in range(band.shape[0])]
        self.live = live_band_columns(band, 0)

    def __call__(self, alpha_prev, emit_t, t, frame_lengths):
        B, Pmax, C = alpha_prev.shape
        ap = torch.nn.functional.pad(alpha_prev, (0, 0, self.ubp, self.lbp),
                                     value=NEG_INF)
        m, bp = band_max(ap, self.cols, self.live, self.lbp, self.ubp, Pmax, 1)
        ent, args = _pm_junction(alpha_prev, self.d, self.with_args)
        m2 = torch.cat([torch.maximum(m[:, :1, :], ent[:, None, :]), m[:, 1:]],
                       dim=1)
        alpha_out = torch.where(_active(t, frame_lengths, 3),
                                m2 + emit_t.reshape(B, Pmax, C), alpha_prev)
        if not self.with_args:
            return alpha_out, None
        jwin = ent > m[:, 0, :]  # (B, C): the junction won the p = 0 cell
        return alpha_out, (bp, jwin) + args


def _pm_steps(d, lbp, ubp):
    """The graph's two position-major steps (decode, recompute), made once."""
    key = ("pm_steps", lbp, ubp)
    if key not in d:
        d[key] = (_PmStep(d, lbp, ubp, False), _PmStep(d, lbp, ubp, True))
    return d[key]


def lvcsr_pm_decode_ckpt_device(e0, ep, d, frame_lengths, lbp, ubp):
    """Checkpointed position-major forward pass: only the alpha entering
    each ``_PM_TC``-frame chunk is kept. ``e0`` (B, P) frame 0 and ``ep``
    (NC, TC, B, P) from :func:`~.lvcsr.split_emissions`; ``d`` the graph's
    device tensors (``PM_DEVICE_NAMES``). Returns ``(alpha_T (B, Pmax, C),
    ckpts (NC, B, Pmax, C))``."""
    Pmax, C = d["start"].shape
    mat = _emit_chunker(d["state_pdf"])
    step, _fstep = _pm_steps(d, lbp, ubp)

    def chunk(alpha, echunk, t0, flens):
        e = mat(echunk)
        for i in range(e.shape[0]):
            alpha, _ = step(alpha, e[i], t0 + i, flens)
        return (alpha,)

    NC, TC = ep.shape[0], ep.shape[1]
    B = e0.shape[0]
    alpha = d["start"][None] + mat(e0[None])[0].reshape(B, Pmax, C)
    ckpts = torch.empty((NC, B, Pmax, C), dtype=torch.float32,
                        device=alpha.device)
    for c in range(NC):
        ckpts[c] = alpha
        (alpha,) = run_graphed(d, ("pm_decode", lbp, ubp), chunk, alpha, ep[c],
                               _t0(1 + c * TC, alpha.device), frame_lengths)
    return alpha, ckpts


def _pm_bt_init(alpha_T, exit_w_grid, eos_c):
    """Final state and score: the best word exit plus its </s> weight."""
    B, Pmax, C = alpha_T.shape
    fin = alpha_T + exit_w_grid[None] + eos_c[None, None, :]
    flat = fin.reshape(B, Pmax * C)
    s_final = torch.argmax(flat, dim=1)
    return s_final, flat.gather(1, s_final[:, None])[:, 0]


def _pm_bstep(d, frame_lengths, lbp, C, s, recs, r):
    """One step of the reverse walk: the state at frame r from the state
    at frame r + 1 and frame r + 1's records."""
    bp_r, jwin_r, ent_r, exarg_r, boarg_r = recs
    rows = torch.arange(s.shape[0], device=s.device)
    t = r + 1
    pos = s // C
    chain = s % C
    bpv = bp_r[rows, pos, chain].long()
    is_junc = jwin_r[rows, chain] & (pos == 0)
    k = ent_r[rows, chain].long()
    src_chain = torch.where(k < 0, boarg_r,
                            d["pred_c"][chain, torch.clamp(k, min=0)])
    src_pos = exarg_r[rows, src_chain].long()
    s_j = src_pos * C + src_chain
    s_band = s - (bpv - lbp) * C
    active = t < frame_lengths
    s_out = torch.where(active & is_junc, s_j, torch.where(active, s_band, s))
    word = torch.where(active & is_junc, d["chain_word"][chain], -1)
    return s_out, word


def lvcsr_pm_backtrace_ckpt_device(alpha_T, ckpts, ep, d, frame_lengths,
                                   lbp, ubp, T):
    """Checkpointed position-major backtrace: chunks last to first, each
    re-running its forward from the checkpoint with records, then walking
    them back. Returns (state path (B, T) int32 of flat p*C+c ids, word
    entered at each frame (B, T) int32, -1 = none, score (B,))."""
    B, Pmax, C = alpha_T.shape
    mat = _emit_chunker(d["state_pdf"])
    _step, fstep = _pm_steps(d, lbp, ubp)

    def chunk(ck, echunk, t0, flens, s):
        e = mat(echunk)
        alpha, recs = ck, []
        for i in range(e.shape[0]):
            alpha, rec = fstep(alpha, e[i], t0 + i, flens)
            recs.append(rec)
        states, words = [], []
        for i in range(e.shape[0] - 1, -1, -1):
            s, w = _pm_bstep(d, flens, lbp, C, s, recs[i], t0 - 1 + i)
            states.append(s)
            words.append(w)
        return torch.stack(states[::-1]), torch.stack(words[::-1]), s

    NC, TC = ep.shape[0], ep.shape[1]
    s_final, score = _pm_bt_init(alpha_T, d["exit_w_grid"], d["eos_c"])
    path_prev = torch.empty((NC * TC, B), dtype=torch.int64, device=alpha_T.device)
    word_at = torch.empty_like(path_prev)
    s = s_final
    for c in range(NC - 1, -1, -1):
        sl = slice(c * TC, (c + 1) * TC)
        path_prev[sl], word_at[sl], s = run_graphed(
            d, ("pm_backtrace", lbp, ubp), chunk, ckpts[c], ep[c],
            _t0(1 + c * TC, alpha_T.device), frame_lengths, s)
    path, word = _bt_outputs(path_prev, word_at, s_final, d["state_word"], T)
    return path, word, score
