"""Band-sparse Viterbi forward (K1) and backtrace (K2): CUDA kernels and
their plain PyTorch versions.

Counterpart of ``montreal_forced_aligner_tpu/ops/pallas_viterbi.py``. The
kernels are in ``csrc/band_viterbi.cu`` (its header says what bounds them
and how they are laid out). The plain versions are the JAX scan branch of
``viterbi_align_batch_band`` (``ops/viterbi.py:262-305`` there) written as
torch loops.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from montreal_forced_aligner_tpu_torch.ops import cuda_build

NEG_INF = -1.0e30

# The (lb, ub) band buckets: alignment-graph arcs have small state offsets
# (self-loops 0, forward 1-3, silence skips and pronunciation-variant joins
# up to a few dozen). K1 is compiled for each of them.
BAND_BUCKETS = [
    (1, 4),
    (2, 8),
    (2, 12),
    (4, 16),
    (8, 32),
    (16, 64),
    (16, 128),
]

# band_forward's modes that read the band as (B, D, S) from global memory,
# and the one that keeps alpha in a global scratch row (csrc/band_viterbi.cu
# band_forward_plan)
_BAND_L2, _ALL_GLOBAL = 2, 3

# band_backtrace's layouts (csrc/band_viterbi.cu), which follow from S and
# the row size: whole frame rows staged in shared memory, or a window of
# each row, whose misses read bp from device memory
BT_ROWS, BT_WINDOW = 0, 1
# shared memory a block may use on sm_90 (227 KB)
MAX_SMEM = 232448
# BT_FRAMES, BT_STAGES and BT_MAX_ROW of csrc/band_viterbi.cu; its launcher
# refuses shared bytes other than its own ring's, so these cannot drift
_BT_FRAMES, _BT_STAGES, _BT_MAX_ROW = 32, 4, 512


class BacktracePlan(NamedTuple):
    """How band_backtrace lays out a launch (see csrc/band_viterbi.cu). The
    launcher takes row_bytes and smem_bytes; the rest describes them."""

    mode: int  # BT_ROWS or BT_WINDOW
    frames: int  # frames a chunk
    stages: int  # chunks in the ring
    row_bytes: int  # a staged frame row, a power of two
    smem_bytes: int  # dynamic shared memory: the ring and one row to align it


def band_backtrace_plan(S: int) -> BacktracePlan:
    """The launch plan for a graph of ``S`` states. A staged row holds up to
    row_bytes - 16 states: the copy takes the aligned 16-byte blocks that
    cover them, wherever the frame row starts. Rows grow by powers of two to
    512 bytes; larger graphs stage a 496-state window of each frame."""
    row = 32
    while row < min(-(-S // 16) * 16 + 16, _BT_MAX_ROW):
        row *= 2
    mode = BT_ROWS if S <= row - 16 else BT_WINDOW
    return BacktracePlan(mode, _BT_FRAMES, _BT_STAGES, row,
                         (_BT_STAGES * _BT_FRAMES + 1) * row)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def band_forward_plain(
    emit: torch.Tensor,  # (B, T, S) float32
    frame_lengths: torch.Tensor,  # (B,) int32
    band: torch.Tensor,  # (B, S, D) float32; column j = offset j - lb
    start: torch.Tensor,  # (B, S) float32
    lb: int,
    ub: int,
    acoustic_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (alpha_T (B, S) float32, bp (T, B, S) uint8) where bp[t]
    holds the offset slot taken into frame t (bp[0] is 0)."""
    B, T, S = emit.shape
    D = lb + ub + 1
    emit = acoustic_scale * emit
    band_cols = [band[:, :, j] for j in range(D)]
    bp = torch.zeros((T, B, S), dtype=torch.uint8, device=emit.device)
    flens = frame_lengths[:, None]
    alpha = start + emit[:, 0, :]
    for t in range(1, T):
        # alpha[s - d] = ap[s - d + ub]
        ap = F.pad(alpha, (ub, lb), value=NEG_INF)
        m = torch.full_like(alpha, NEG_INF)
        arg = torch.zeros((B, S), dtype=torch.uint8, device=emit.device)
        for j in range(D):
            d = j - lb
            c = ap[:, ub - d : ub - d + S] + band_cols[j]
            take = c > m
            m = torch.where(take, c, m)
            arg = torch.where(take, j, arg).to(torch.uint8)
        alpha = torch.where(t < flens, m + emit[:, t, :], alpha)
        bp[t] = arg
    return alpha, bp


def band_backtrace_plain(
    bp: torch.Tensor,  # (T, B, S) uint8
    frame_lengths: torch.Tensor,  # (B,) int32
    best_state: torch.Tensor,  # (B,) int32
    lb: int,
) -> torch.Tensor:
    """States (B, T) int32: the reverse walk from ``best_state``. A state
    outside [0, S) reads slot 0, as the TPU kernel's one-hot select does
    (real paths never leave that range; unreachable ones can)."""
    T, B, S = bp.shape
    rows = torch.arange(B, device=bp.device)
    state = best_state.to(torch.int64)
    flens = frame_lengths.to(torch.int64)
    states = torch.empty((B, T), dtype=torch.int32, device=bp.device)
    for t in range(T - 1, 0, -1):
        states[:, t] = state.to(torch.int32)
        inside = (state >= 0) & (state < S)
        j = bp[t, rows, state.clamp(0, S - 1)].to(torch.int64)
        j = torch.where(inside, j, 0)
        state = torch.where(t < flens, state - (j - lb), state)
    states[:, 0] = state.to(torch.int32)
    return states


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.band_forward.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i,
                                 ctypes.c_float, p]
    lib.band_forward.restype = i
    lib.band_forward_plan.argtypes = [i, i, i] + [ctypes.POINTER(i)] * 3
    lib.band_forward_plan.restype = ctypes.c_size_t
    lib.band_backtrace.argtypes = [p, p, p, p] + [i] * 5 + [ctypes.c_size_t, p]
    lib.band_backtrace.restype = i


def _lib():
    return cuda_build.load_library("band_viterbi", _declare)


def band_forward(
    emit: torch.Tensor,
    frame_lengths: torch.Tensor,
    band: torch.Tensor,
    start: torch.Tensor,
    lb: int,
    ub: int,
    acoustic_scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (alpha_T (B, S), bp (T, B, S) uint8). Same arguments as
    :func:`band_forward_plain`. On the card, backpointer rows t = 0 and
    t >= frame_lengths[b] are left unwritten (the backtrace never reads
    them)."""
    if emit.device.type == "cpu":
        return band_forward_plain(
            emit, frame_lengths, band, start, lb, ub, acoustic_scale
        )
    if emit.device.type != "cuda":
        raise ValueError(f"band_forward: device {emit.device}")
    B, T, S = emit.shape
    D = lb + ub + 1
    if (lb, ub) not in BAND_BUCKETS or T < 1:
        raise ValueError(f"band_forward: lb={lb} ub={ub} T={T}")
    cuda_build.check_inputs("band_forward", emit.device, (
        ("emit", emit, torch.float32, (B, T, S)),
        ("band", band, torch.float32, (B, S, D)),
        ("start", start, torch.float32, (B, S)),
        ("frame_lengths", frame_lengths, torch.int32, (B,)),
    ))
    alpha_T = torch.empty((B, S), dtype=torch.float32, device=emit.device)
    bp = torch.empty((T, B, S), dtype=torch.uint8, device=emit.device)
    if B == 0 or S == 0:
        return alpha_T, bp
    lib = _lib()
    threads, mode, spt = (ctypes.c_int(0) for _ in range(3))
    lib.band_forward_plan(S, lb, ub, *(ctypes.byref(x) for x in
                                       (threads, mode, spt)))
    scratch = None
    if mode.value == _ALL_GLOBAL:
        scratch = torch.empty((B, 2, ub + S + lb), dtype=torch.float32,
                              device=emit.device)
    if mode.value in (_BAND_L2, _ALL_GLOBAL):
        # read from L2 by neighbouring threads: (B, D, S)
        band = band.permute(0, 2, 1).contiguous()
    stream = torch.cuda.current_stream(emit.device).cuda_stream
    err = lib.band_forward(
        emit.data_ptr(), band.data_ptr(), start.data_ptr(),
        frame_lengths.data_ptr(), alpha_T.data_ptr(), bp.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        B, T, S, lb, ub, float(acoustic_scale), stream,
    )
    cuda_build.check(err, "band_forward")
    cuda_build.LAUNCHES["band_forward"] += 1
    return alpha_T, bp


def band_backtrace(
    bp: torch.Tensor,
    frame_lengths: torch.Tensor,
    best_state: torch.Tensor,
    lb: int,
) -> torch.Tensor:
    """K2: states (B, T) int32. Same arguments as
    :func:`band_backtrace_plain`."""
    if bp.device.type == "cpu":
        return band_backtrace_plain(bp, frame_lengths, best_state, lb)
    if bp.device.type != "cuda":
        raise ValueError(f"band_backtrace: device {bp.device}")
    T, B, S = bp.shape
    if not (T >= 1 and lb >= 0):
        raise ValueError(f"band_backtrace: T={T} lb={lb}")
    cuda_build.check_inputs("band_backtrace", bp.device, (
        ("bp", bp, torch.uint8, (T, B, S)),
        ("frame_lengths", frame_lengths, torch.int32, (B,)),
        ("best_state", best_state, torch.int32, (B,)),
    ))
    states = torch.empty((B, T), dtype=torch.int32, device=bp.device)
    if B == 0 or S == 0:
        return states
    lib = _lib()
    plan = band_backtrace_plan(S)
    stream = torch.cuda.current_stream(bp.device).cuda_stream
    err = lib.band_backtrace(
        bp.data_ptr(), frame_lengths.data_ptr(), best_state.data_ptr(),
        states.data_ptr(), B, T, S, lb, plan.row_bytes, plan.smem_bytes, stream,
    )
    cuda_build.check(err, "band_backtrace")
    cuda_build.LAUNCHES["band_backtrace"] += 1
    return states
