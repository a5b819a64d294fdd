"""Exact Viterbi for very long utterances via checkpointed chunks.

Counterpart of ``montreal_forced_aligner_tpu/ops/long_viterbi.py``. The
batch path stores backpointers and emissions for every frame, O(T*S) each;
an utterance of an hour against a graph of tens of thousands of states does
not fit the card. The checkpoint/recompute scheme keeps single-utterance
alignment exact at any length:

1. a forward sweep over chunks of frames keeps only the alpha vector at
   each chunk boundary (no backpointers kept);
2. a backward sweep recomputes each chunk from its checkpoint, now with
   backpointers, and walks back through it from the state the later chunk
   handed down.

Graphs whose arc offsets fit a band bucket run each chunk through the
kernels: K3 (or the all-pdf path) for the chunk's emissions, K1 with the
checkpoint as ``start`` and K2 from a given state. For chunk c > 0, K1 gets
frames [lo - 1, hi) with emission row 0 set to 0 and ``start`` = the alpha
of frame lo - 1, so its frame 0 computes start + scale * 0 = start exactly
and every later frame is the whole-utterance run's, bit for bit. Other
graphs run the dense max-plus recurrence (:func:`viterbi_align_long_plain`,
the reference's algorithm), as the batch path's dense fallback does.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.graph.compiler import ship_graph_to_device
from montreal_forced_aligner_tpu_torch.ops.cuda_emission import state_loglikes
from montreal_forced_aligner_tpu_torch.ops.cuda_viterbi import (
    band_backtrace,
    band_forward,
)
from montreal_forced_aligner_tpu_torch.ops.gmm_loglikes import (
    gmm_loglikes,
    select_state_emissions,
)
from montreal_forced_aligner_tpu_torch.ops.viterbi import (
    BatchedGraph,
    _best_final,
    band_limits_from_arcs,
    densify_band,
    densify_transitions,
)
from montreal_forced_aligner_tpu_torch.params import GmmParams

# frames per chunk: a chunk's emissions and backpointers are all that the
# sweeps hold of the utterance (5 bytes a state-frame: 0.45 GB at 22k states)
CHUNK_FRAMES = 4096


class LongGraph(NamedTuple):
    """One utterance's graph on the device, as the sweeps read it."""

    graph: BatchedGraph  # B = 1
    band_limits: Optional[Tuple[int, int]]  # (lb, ub), or None: dense
    band: Optional[torch.Tensor]  # (1, S, lb + ub + 1)


def prepare_long_graph(garrs_single: dict, device) -> LongGraph:
    """Ship ``batch_graphs([graph])`` arrays and densify the band once."""
    graph = ship_graph_to_device(garrs_single, device)
    limits = band_limits_from_arcs(garrs_single)
    band = None if limits is None else densify_band(graph, *limits)
    return LongGraph(graph, limits, band)


def chunk_emissions(
    feats: torch.Tensor,  # (T, D)
    lo: int,
    hi: int,
    state_pdf: torch.Tensor,  # (1, S) int32
    gmm: GmmParams,
    use_emission_kernel: bool,
    lead_row: bool,
) -> torch.Tensor:
    """(1, n, S) unscaled emissions of frames [lo, hi), with, when
    ``lead_row``, one more row in front (frame lo - 1) set to 0."""
    f = feats[lo - 1 if lead_row else lo : hi][None].contiguous()
    if use_emission_kernel:
        emit = state_loglikes(f, state_pdf, gmm.rows, gmm.rows_split)
    else:
        emit = select_state_emissions(gmm_loglikes(f, gmm.W, gmm.gconsts), state_pdf)
    if lead_row:
        emit[:, 0] = 0.0
    return emit


def _bounds(T: int, chunk: int) -> List[Tuple[int, int]]:
    return [(lo, min(T, lo + chunk)) for lo in range(0, T, chunk)]


def long_forward_sweep(
    feats: torch.Tensor,
    lg: LongGraph,
    gmm: GmmParams,
    acoustic_scale: float,
    chunk: int,
    use_emission_kernel: bool,
):
    """Band graphs: K1 over every chunk in turn, keeping only the alpha
    before each chunk. Returns (checkpoints, best final state (1,) int32,
    its score (1,)), all on the device."""
    lb, ub = lg.band_limits
    g = lg.graph
    alpha = g.start
    checkpoints = []
    for c, (lo, hi) in enumerate(_bounds(feats.shape[0], chunk)):
        checkpoints.append(alpha)
        emit = chunk_emissions(feats, lo, hi, g.state_pdf, gmm,
                               use_emission_kernel, lead_row=c > 0)
        n = torch.tensor([emit.shape[1]], dtype=torch.int32, device=feats.device)
        alpha, _bp = band_forward(emit, n, lg.band, alpha, lb, ub, acoustic_scale)
    best_state, score = _best_final(alpha, g.final)
    return checkpoints, best_state, score


def long_backward_sweep(
    feats: torch.Tensor,
    lg: LongGraph,
    gmm: GmmParams,
    acoustic_scale: float,
    chunk: int,
    use_emission_kernel: bool,
    checkpoints,
    best_state: torch.Tensor,
) -> torch.Tensor:
    """Band graphs: each chunk, last first, through K1 again from its
    checkpoint, then K2 from the state the later chunk handed down.
    Returns the state path (T,) int32 on the device."""
    lb, ub = lg.band_limits
    g = lg.graph
    T = feats.shape[0]
    path = torch.empty((T,), dtype=torch.int32, device=feats.device)
    state = best_state
    for c in range(len(checkpoints) - 1, -1, -1):
        lo, hi = c * chunk, min(T, (c + 1) * chunk)
        emit = chunk_emissions(feats, lo, hi, g.state_pdf, gmm,
                               use_emission_kernel, lead_row=c > 0)
        n = torch.tensor([emit.shape[1]], dtype=torch.int32, device=feats.device)
        _a, bp = band_forward(emit, n, lg.band, checkpoints[c], lb, ub,
                              acoustic_scale)
        states = band_backtrace(bp, n, state, lb)[0]
        if c == 0:
            path[:hi] = states
        else:
            path[lo:hi] = states[1:]
            state = states[:1].contiguous()  # frame lo - 1: the earlier chunk's end
    return path


def viterbi_align_long(
    feats: torch.Tensor,  # (T, D) final features on the device
    garrs_single: dict,  # batch_graphs([graph]) arrays (B = 1)
    gmm: GmmParams,
    acoustic_scale: float = 0.1,
    chunk: Optional[int] = None,
    use_emission_kernel: bool = False,
) -> Tuple[np.ndarray, float]:
    """Exact (state_path (T,) int32, score) for one long utterance: the
    batch path's result on the same graph, computed in chunks of ``chunk``
    frames (default :data:`CHUNK_FRAMES`). Band graphs run the kernels;
    others the dense recurrence."""
    chunk = chunk or CHUNK_FRAMES
    lg = prepare_long_graph(garrs_single, feats.device)
    if lg.band_limits is None:
        return viterbi_align_long_plain(feats, garrs_single, gmm, acoustic_scale,
                                        chunk, use_emission_kernel)
    checkpoints, best_state, score = long_forward_sweep(
        feats, lg, gmm, acoustic_scale, chunk, use_emission_kernel
    )
    path = long_backward_sweep(feats, lg, gmm, acoustic_scale, chunk,
                               use_emission_kernel, checkpoints, best_state)
    return path.cpu().numpy(), float(score.cpu()[0])


# ---------------------------------------------------------------------------
# plain version: the reference's dense max-plus recurrence
# ---------------------------------------------------------------------------


def _dense_forward(alpha, emit, Wt, first: int):
    """Max-plus recursion over a chunk's scaled emissions (n, S) from
    ``alpha``; rows before ``first`` leave alpha untouched. Returns the
    final alpha and the backpointers (n, S) int32 (row j: the argmax
    predecessor for the step into row j; the first maximum wins)."""
    n, S = emit.shape
    bps = torch.zeros((n, S), dtype=torch.int32, device=emit.device)
    for j in range(first, n):
        cand = alpha[:, None] + Wt
        bp = torch.argmax(cand, dim=0)
        alpha = torch.gather(cand, 0, bp[None])[0] + emit[j]
        bps[j] = bp.to(torch.int32)
    return alpha, bps


def viterbi_align_long_plain(
    feats: torch.Tensor,
    garrs_single: dict,
    gmm: GmmParams,
    acoustic_scale: float = 0.1,
    chunk: Optional[int] = None,
    use_emission_kernel: bool = False,
) -> Tuple[np.ndarray, float]:
    """The reference's ``viterbi_align_long`` in plain PyTorch: the dense
    (S, S) max-plus matrix, a forward sweep keeping the boundary alphas,
    and a backward sweep recomputing each chunk with backpointers. Frame 0
    is folded into chunk 0's checkpoint (alpha0 = start + emit[0])."""
    chunk = chunk or CHUNK_FRAMES
    T = feats.shape[0]
    graph = ship_graph_to_device(garrs_single, feats.device)
    Wt = densify_transitions(graph)[0]
    start = graph.start[0]
    state_pdf = graph.state_pdf

    def emit_of(lo, hi):
        return acoustic_scale * chunk_emissions(
            feats, lo, hi, state_pdf, gmm, use_emission_kernel, lead_row=False
        )[0]

    bounds = _bounds(T, chunk)
    checkpoints = []
    alpha = None
    for c, (lo, hi) in enumerate(bounds):
        emit = emit_of(lo, hi)
        if c == 0:
            alpha = start + emit[0]
        checkpoints.append(alpha)
        alpha, _ = _dense_forward(alpha, emit, Wt, first=1 if c == 0 else 0)
    final_scores = (alpha + graph.final[0]).cpu().numpy()
    s = int(np.argmax(final_scores))
    score = float(final_scores[s])

    # bps[j] is the argmax predecessor for the step into frame lo + j; row
    # 0 carries the step across the chunk boundary
    path = np.zeros(T, dtype=np.int32)
    for c in range(len(bounds) - 1, -1, -1):
        lo, hi = bounds[c]
        _a, bps = _dense_forward(checkpoints[c], emit_of(lo, hi), Wt,
                                 first=1 if c == 0 else 0)
        bps = bps.cpu().numpy()
        path[hi - 1] = s
        for t in range(hi - 1, lo, -1):
            s = int(bps[t - lo, s])
            path[t - 1] = s
        if c > 0:
            s = int(bps[0, s])
    return path, score
