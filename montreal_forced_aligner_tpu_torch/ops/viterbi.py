"""Batched exact Viterbi forced alignment.

Counterpart of ``montreal_forced_aligner_tpu/ops/viterbi.py`` for the
alignment path. Forced-alignment graphs are small, so the DP is exact over
every graph state of a whole batch of utterances:

    alpha[0, s]  = start[s] + scale * emit[0, s]
    alpha[t, s]  = max_{s'} ( alpha[t-1, s'] + W[s', s] ) + scale * emit[t, s]
    best         = argmax_s alpha[T-1, s] + final[s]

Graphs whose arc offsets fit a band bucket run the band-sparse recursion
(:func:`viterbi_align_batch_band`: kernels K1 and K2 of
``ops/cuda_viterbi.py`` on the card, their plain versions on the CPU);
others run the dense max-plus recursion (:func:`viterbi_align_batch`, plain
torch). Padded frames (t >= frame_lengths[b]) hold a frozen copy of the
state, so scores and paths are exact for each utterance's true length.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.ops.cuda_viterbi import (
    BAND_BUCKETS,
    band_backtrace,
    band_forward,
)

NEG_INF = -1.0e30


class BatchedGraph(NamedTuple):
    """Device representation of a batch of alignment graphs (padded).

    S = max states, K = max incoming arcs per state. The fields the device
    programs read are tensors; the label fields stay host numpy arrays.
    """

    in_src: torch.Tensor  # (B, S, K) int32: source state of k-th incoming arc
    in_weight: torch.Tensor  # (B, S, K) float32: arc weight (NEG_INF padding)
    in_tid: np.ndarray  # (B, S, K) int32: transition-id per incoming arc
    start: torch.Tensor  # (B, S) float32: initial scores (NEG_INF if not start)
    final: torch.Tensor  # (B, S) float32: final weights (NEG_INF if not final)
    final_tid: np.ndarray  # (B, S) int32: exit transition-id per final state
    state_pdf: torch.Tensor  # (B, S) int32: pdf-id emitted by each state
    state_phone: np.ndarray  # (B, S) int32: phone id of each state
    state_word: np.ndarray  # (B, S) int32: transcript word index (-1 = silence)
    state_hmm_pos: np.ndarray  # (B, S) int32: hmm-state index within phone
    state_tstate: np.ndarray  # (B, S) int32: transition-state
    state_instance: np.ndarray  # (B, S) int32: phone-instance index
    num_states: torch.Tensor  # (B,) int32

    @property
    def batch_size(self):
        return self.in_src.shape[0]


def densify_transitions(graph: BatchedGraph) -> torch.Tensor:
    """(B, S, S) max-plus transition matrix W[b, s_prev, s] from the sparse
    incoming-arc lists (parallel arcs collapse to their best weight)."""
    B, S, K = graph.in_src.shape
    dev = graph.in_src.device
    b_idx = torch.arange(B, device=dev)[:, None, None]
    dst_idx = torch.arange(S, device=dev)[None, :, None]
    flat = (b_idx * S + graph.in_src.long()) * S + dst_idx  # (B, S, K)
    W = torch.full((B * S * S,), NEG_INF, dtype=torch.float32, device=dev)
    W.scatter_reduce_(0, flat.reshape(-1), graph.in_weight.reshape(-1), "amax")
    return W.reshape(B, S, S)


def _best_final(alpha_T: torch.Tensor, final: torch.Tensor):
    final_scores = alpha_T + final
    best_state = torch.argmax(final_scores, dim=1)  # first maximum
    best_score = torch.gather(final_scores, 1, best_state[:, None])[:, 0]
    return best_state.to(torch.int32), best_score


def viterbi_align_batch(
    emit: torch.Tensor,  # (B, T, S) emission log-likelihoods per graph state
    frame_lengths: torch.Tensor,  # (B,)
    graph: BatchedGraph,
    acoustic_scale: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense max-plus Viterbi: (state_path (B, T) int32, best_score (B,))."""
    B, T, S = emit.shape
    emit = acoustic_scale * emit
    W = densify_transitions(graph)  # (B, S_prev, S)
    flens = frame_lengths[:, None]
    alpha = graph.start + emit[:, 0, :]
    backptrs = torch.zeros((T, B, S), dtype=torch.int32, device=emit.device)
    for t in range(1, T):
        cand = alpha[:, :, None] + W  # (B, S_prev, S)
        # argmax returns the first maximum, as jnp.argmax does
        bp = torch.argmax(cand, dim=1)
        m = torch.gather(cand, 1, bp[:, None, :])[:, 0, :]
        alpha = torch.where(t < flens, m + emit[:, t, :], alpha)
        backptrs[t] = bp
    state, best_score = _best_final(alpha, graph.final)
    state = state.to(torch.int64)
    rows = torch.arange(B, device=emit.device)
    fl = frame_lengths.to(torch.int64)
    states = torch.empty((B, T), dtype=torch.int32, device=emit.device)
    for t in range(T - 1, 0, -1):
        states[:, t] = state.to(torch.int32)
        prev = backptrs[t, rows, state].long()
        state = torch.where(t < fl, prev, state)
    states[:, 0] = state.to(torch.int32)
    return states, best_score


def extract_frame_labels_host(graph_arrays: dict, state_path: np.ndarray):
    """Host-side (numpy) mapping of a state path to per-frame labels
    (phone, word, instance, transition-state)."""
    b = np.arange(state_path.shape[0])[:, None]
    return (
        graph_arrays["state_phone"][b, state_path],
        graph_arrays["state_word"][b, state_path],
        graph_arrays["state_instance"][b, state_path],
        graph_arrays["state_tstate"][b, state_path],
    )


def frame_tids_host(
    graph_arrays: dict, state_path: np.ndarray, frame_lengths: np.ndarray
) -> np.ndarray:
    """Per-frame transition-ids (Kaldi convention: frame t consumes the arc
    leaving state_path[t]) recovered on host from the sparse arc lists."""
    in_src = graph_arrays["in_src"]  # (B, S, K)
    in_tid = graph_arrays["in_tid"]
    final_tid = graph_arrays["final_tid"]
    B, T = state_path.shape
    out = np.zeros((B, T), dtype=np.int32)
    for b in range(B):
        L = int(frame_lengths[b])
        if L <= 0:
            continue
        cur = state_path[b, 1:L]  # states at frames 1..L-1
        prev = state_path[b, : L - 1]
        srcs = in_src[b, cur]  # (L-1, K)
        match = srcs == prev[:, None]
        k = np.argmax(match, axis=1)
        out[b, : L - 1] = in_tid[b, cur, k]
        out[b, L - 1] = final_tid[b, state_path[b, L - 1]]
    return out


# ---------------------------------------------------------------------------
# Band-sparse Viterbi
# ---------------------------------------------------------------------------
# Storing transitions as a (B, S, D) band over offsets d in [-LB, UB] turns
# the O(S^2) dense max-plus step into O(S*D); the buckets (BAND_BUCKETS, in
# ops/cuda_viterbi.py) are those K1 is compiled for. Graphs whose offsets
# exceed the largest bucket run the dense recursion.


def band_limits_for(graphs_offsets_min: int, graphs_offsets_max: int):
    """Smallest band bucket covering [min_offset, max_offset], else None."""
    for lb, ub in BAND_BUCKETS:
        if -lb <= graphs_offsets_min and graphs_offsets_max <= ub:
            return lb, ub
    return None


def band_limits_from_arcs(garrs: dict):
    """Host-side band-eligibility check: smallest (lb, ub) bucket covering
    every real arc's state offset, or None."""
    in_src = garrs["in_src"]
    in_weight = garrs["in_weight"]
    _B, S, _K = in_src.shape
    d = np.arange(S)[None, :, None] - in_src  # (B, S, K)
    real = in_weight > NEG_INF / 2
    if not real.any():
        return None
    return band_limits_for(int(d[real].min()), int(d[real].max()))


def densify_band(graph: BatchedGraph, lb: int, ub: int) -> torch.Tensor:
    """(B, S, D) band weights from the sparse incoming-arc lists, on the
    graph's device (max over parallel arcs). Callers must have validated
    the bucket with :func:`band_limits_from_arcs`: offsets of real arcs are
    in [-lb, ub]; padding arcs (NEG_INF weight) may fall anywhere — their
    clipped slot is a no-op for the running max."""
    B, S, K = graph.in_src.shape
    D = lb + ub + 1
    dev = graph.in_src.device
    s_idx = torch.arange(S, device=dev)[None, :, None]
    j = torch.clamp(s_idx - graph.in_src.long() + lb, 0, D - 1)
    b_idx = torch.arange(B, device=dev)[:, None, None]
    flat = (b_idx * S + s_idx) * D + j  # (B, S, K)
    band = torch.full((B * S * D,), NEG_INF, dtype=torch.float32, device=dev)
    band.scatter_reduce_(0, flat.reshape(-1), graph.in_weight.reshape(-1), "amax")
    return band.reshape(B, S, D)


def viterbi_align_batch_band(
    emit: torch.Tensor,  # (B, T, S)
    frame_lengths: torch.Tensor,  # (B,) int32
    band: torch.Tensor,  # (B, S, D) weights; column j = offset j - lb
    start: torch.Tensor,  # (B, S)
    final: torch.Tensor,  # (B, S)
    lb: int,
    ub: int,
    acoustic_scale: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Band-sparse exact Viterbi; same semantics as viterbi_align_batch.
    Forward K1, then the best final state, then backtrace K2."""
    alpha_T, bp = band_forward(
        emit, frame_lengths, band, start, lb, ub, acoustic_scale
    )
    best_state, best_score = _best_final(alpha_T, final)
    states = band_backtrace(bp, frame_lengths, best_state, lb)
    return states, best_score


def band_from_arcs(garrs: dict):
    """Host (numpy) band weights, or None if any arc falls outside the
    largest band bucket: (band (B, S, D), lb, ub). Eligibility is
    :func:`band_limits_from_arcs`, as on the device path."""
    limits = band_limits_from_arcs(garrs)
    if limits is None:
        return None
    lb, ub = limits
    in_src = garrs["in_src"]
    in_weight = garrs["in_weight"]
    B, S, K = in_src.shape
    d = np.arange(S)[None, :, None] - in_src  # (B, S, K)
    real = in_weight > NEG_INF / 2
    D = lb + ub + 1
    band = np.full((B, S, D), NEG_INF, dtype=np.float32)
    j = np.clip(d + lb, 0, D - 1)
    b_idx, s_idx, _ = np.indices(in_src.shape)
    np.maximum.at(band, (b_idx[real], s_idx[real], j[real]), in_weight[real])
    return band, lb, ub


# ---------------------------------------------------------------------------
# K-best Viterbi (N-best decoding)
# ---------------------------------------------------------------------------
# alpha carries the top-K partial-path scores per state; each step merges the
# incoming arcs' candidate lists. With per-arc word events a rolling hash of
# the emitted word sequence rides along each (state, rank) and same-hash
# candidates are dropped at every merge, so the K ranks hold K distinct word
# sequences (the dense analogue of lattice determinization).
#
# Two details keep the results equal to the JAX package's:
# - ties: ``jax.lax.top_k`` puts the lower index first among equal values;
#   :func:`topk_lower_first` gets that order from a stable descending sort
#   (``torch.topk`` promises no order among ties), and +0 above -0;
# - hashes are uint32 arithmetic modulo 2^32; they ride in int64 tensors,
#   masked with ``HASH_MASK`` after every multiply-add.

HASH_MULT = 1000003
HASH_MASK = 0xFFFFFFFF


def topk_lower_first(x: torch.Tensor, k: int):
    """(values, indices) of the k largest float32 values along the last
    axis in ``jax.lax.top_k``'s order: descending in IEEE total order (+0
    before -0) and the lower index first among equal values. One stable
    sort of an int32 key that orders as the floats do."""
    bits = x.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    _keys, idx = torch.sort(key, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return x.gather(-1, idx), idx


def hash_push(h: torch.Tensor, ev: torch.Tensor) -> torch.Tensor:
    """``h * HASH_MULT + ev`` modulo 2^32 (int64 carriers of uint32)."""
    return (h * HASH_MULT + ev) & HASH_MASK


def _pad_last(x: torch.Tensor, n: int, value) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, n), value=value)


def dedup_topk(scores: torch.Tensor, hashes: torch.Tensor, K: int):
    """Exact top-K-distinct-hashes along the last axis: groups of K
    candidates merged pairwise, each merge deduplicating its full 2K pool
    (the top-K distinct of a union is the top-K distinct of each side's
    top-K distinct). Returns ``(vals, hsel, idx)``; ``idx`` (int64) indexes
    the input last axis. Inputs are padded to a multiple of K with NEG_INF
    scores and hash 0 (pads can only displace other pads)."""
    C = scores.shape[-1]
    if C <= K:
        scores = _pad_last(scores, 2 * K - C, NEG_INF)
        hashes = _pad_last(hashes, 2 * K - C, 0)
        C = 2 * K
    rem = (-C) % K
    if rem:
        scores = _pad_last(scores, rem, NEG_INF)
        hashes = _pad_last(hashes, rem, 0)
        C += rem
    lead = scores.shape[:-1]
    G = C // K
    vals = scores.reshape(*lead, G, K)
    hs = hashes.reshape(*lead, G, K)
    idx = torch.arange(C, device=scores.device).reshape(G, K).expand(vals.shape)
    earlier2 = torch.tril(torch.ones((2 * K, 2 * K), dtype=torch.bool,
                                     device=scores.device), diagonal=-1)
    while G > 1:
        H = G // 2
        m_v = torch.cat([vals[..., :H, :], vals[..., H : 2 * H, :]], dim=-1)
        m_h = torch.cat([hs[..., :H, :], hs[..., H : 2 * H, :]], dim=-1)
        m_i = torch.cat([idx[..., :H, :], idx[..., H : 2 * H, :]], dim=-1)
        sv, order = topk_lower_first(m_v, 2 * K)
        sh = m_h.gather(-1, order)
        si = m_i.gather(-1, order)
        dup = ((sh[..., :, None] == sh[..., None, :]) & earlier2).any(dim=-1)
        sv = torch.where(dup, torch.full_like(sv, NEG_INF), sv)
        kv, sel = topk_lower_first(sv, K)
        kh = sh.gather(-1, sel)
        ki = si.gather(-1, sel)
        if G % 2:  # the odd group goes on to the next round
            kv = torch.cat([kv, vals[..., -1:, :]], dim=-2)
            kh = torch.cat([kh, hs[..., -1:, :]], dim=-2)
            ki = torch.cat([ki, idx[..., -1:, :]], dim=-2)
        vals, hs, idx = kv, kh, ki
        G = kv.shape[-2]
    return vals[..., 0, :], hs[..., 0, :], idx[..., 0, :]


def viterbi_nbest_device(
    emit: torch.Tensor,  # (B, T, S)
    frame_lengths: torch.Tensor,  # (B,)
    graph: BatchedGraph,
    acoustic_scale: float = 0.1,
    K: int = 8,
    word_event: torch.Tensor = None,  # (B, S, Kin) int, 0 = none
    state0_hash: torch.Tensor = None,  # (B, S) int64 (uint32 values)
):
    """Device half of K-best Viterbi: ``(final_scores (B, S, K), backptrs
    (T-1, B, S, K) int32)``; a backpointer is ``arc_slot * K +
    predecessor_rank`` into the destination state's incoming-arc list.
    With ``word_event``/``state0_hash`` (:func:`nbest_word_events`) the
    ranks are deduplicated by word-sequence hash."""
    B, T, S = emit.shape
    Kin = graph.in_src.shape[2]
    dev = emit.device
    emit = acoustic_scale * emit
    src = graph.in_src.long().reshape(B, S * Kin)[:, :, None].expand(-1, -1, K)
    w = graph.in_weight[:, :, :, None]  # (B, S, Kin, 1)
    dedup = word_event is not None
    C = Kin * K

    def gather_prev(x):
        return x.gather(1, src).reshape(B, S, Kin, K)

    if dedup:
        ev = word_event.to(dev, torch.int64)[:, :, :, None]
    alpha = torch.cat([
        (graph.start + emit[:, 0, :])[:, :, None],
        torch.full((B, S, K - 1), NEG_INF, dtype=torch.float32, device=dev),
    ], dim=2)
    if state0_hash is None:
        hsh = torch.zeros((B, S, K), dtype=torch.int64, device=dev)
    else:
        hsh = state0_hash.to(dev, torch.int64)[:, :, None].expand(B, S, K)
    backptrs = torch.empty((max(T - 1, 0), B, S, K), dtype=torch.int32, device=dev)
    for t in range(1, T):
        cand = (gather_prev(alpha) + w).reshape(B, S, C)
        if not dedup:
            vals, idx = topk_lower_first(cand, K)
        else:
            hp = gather_prev(hsh)
            ch = torch.where(ev > 0, hash_push(hp, ev), hp).reshape(B, S, C)
            vals, hash_new, idx = dedup_topk(cand, ch, K)
        active = (t < frame_lengths)[:, None, None]
        alpha = torch.where(active, vals + emit[:, t, :, None], alpha)
        if dedup:
            hsh = torch.where(active, hash_new, hsh)
        backptrs[t - 1] = idx.to(torch.int32)
    return alpha + graph.final[:, :, None], backptrs


def nbest_word_events(garrs: dict):
    """Per-arc word events for determinized N-best decoding: the graph's
    ``in_event`` arcs when it has them (they fire on a repeat of a word
    with no silence between), else an arc emits its destination's word when
    it crosses into a new word instance. Returns ``(word_event (B, S, Kin)
    int32, word index + 1 or 0; state0_hash (B, S) uint32, the hash after
    the word begun at frame 0)``."""
    in_src = garrs["in_src"]
    word = garrs["state_word"]
    if "in_event" in garrs:
        event = np.where(
            garrs["in_event"] >= 0, garrs["in_event"] + 1, 0
        ).astype(np.int32)
    else:
        inst = garrs["state_instance"]
        b = np.arange(in_src.shape[0])[:, None, None]
        src_inst = inst[b, in_src]  # (B, S, Kin)
        crosses = src_inst != inst[:, :, None]
        event = np.where(
            crosses & (word[:, :, None] >= 0), word[:, :, None] + 1, 0
        ).astype(np.int32)
    state0_hash = np.where(word >= 0, word + 1, 0).astype(np.uint32)
    return event, state0_hash


def nbest_backtrace_host(
    garrs: dict,
    final_scores: np.ndarray,  # (B, S, K)
    backptrs: np.ndarray,  # (T-1, B, S, K) int
    frame_lengths: np.ndarray,
    K: int,
):
    """Host backtrace of the K-best scan: (paths (B, K, T) int32, scores
    (B, K), events (B, K, T) int32). Ranks beyond the finite-score paths
    carry NEG_INF scores and copies of the best path. ``events[t]`` is the
    word begun by the arc taken into frame t (-1 = none), from the graph's
    arc events when it has them."""
    in_src = garrs["in_src"]
    in_event = garrs.get("in_event")
    T = backptrs.shape[0] + 1
    B, S, _ = final_scores.shape
    paths = np.zeros((B, K, T), dtype=np.int32)
    scores = np.full((B, K), NEG_INF, dtype=np.float32)
    events = np.full((B, K, T), -1, dtype=np.int32)
    state_word = garrs["state_word"]
    for b in range(B):
        L = int(frame_lengths[b])
        flat = final_scores[b].reshape(-1)  # (S*K,)
        order = np.argsort(-flat)[:K]
        for rank, p in enumerate(order):
            s, r = int(p) // K, int(p) % K
            sc = flat[p]
            if sc <= NEG_INF / 2 and rank > 0:
                paths[b, rank] = paths[b, 0]
                events[b, rank] = events[b, 0]
                continue
            scores[b, rank] = sc
            paths[b, rank, L - 1 :] = s
            for t in range(L - 1, 0, -1):
                idx = int(backptrs[t - 1, b, s, r])
                j, r = idx // K, idx % K
                if in_event is not None:
                    events[b, rank, t] = in_event[b, s, j]
                s = int(in_src[b, s, j])
                paths[b, rank, t - 1] = s
            events[b, rank, 0] = int(state_word[b, paths[b, rank, 0]])
        if L < T:
            paths[b, :, L:] = paths[b, :, L - 1 : L]
    return paths, scores, events
