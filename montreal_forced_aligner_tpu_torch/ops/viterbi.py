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
