"""Feature post-processing: deltas, splicing, linear transforms.

Counterpart of ``montreal_forced_aligner_tpu/ops/feats.py`` for the
alignment path and the i-vector features (``sliding_cmn``). All functions
take (B, T, D) tensors plus (B,) frame counts and are safe on padded
frames.
"""

from __future__ import annotations

import numpy as np
import torch


def delta_window_scales(order: int = 2, window: int = 2):
    """Kaldi delta coefficients: per order, the previous order's scales
    convolved with [-w..w]/sum(j^2). Returns a list of 1-D float32 arrays."""
    scales = [np.array([1.0])]
    norm = sum(j * j for j in range(-window, window + 1))
    kernel = np.arange(-window, window + 1, dtype=np.float64) / norm
    for _ in range(order):
        scales.append(np.convolve(scales[-1], kernel))
    return [s.astype(np.float32) for s in scales]


def frame_mask(frame_lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(B, T) bool: frame t is inside utterance b."""
    t = torch.arange(T, device=frame_lengths.device)
    return t[None, :] < frame_lengths[:, None]


def host_ints(x) -> list:
    """A (B,) tensor or array of integers as a host list (a device tensor
    is copied, and waits for the card: the pipelines pass host arrays)."""
    if isinstance(x, torch.Tensor):
        return x.tolist()
    return np.asarray(x).tolist()


def frame_sums(x: torch.Tensor, frame_lengths: torch.Tensor) -> torch.Tensor:
    """Per-utterance float64 sums of (B, T, ...) rows over their valid
    frames: (B, ...).

    Each row's sum is a function of its own frames alone, whatever the
    batch size, the padded length T or the rows beside it: padded frames
    become exact zeros, the frame axis is zero-padded to a power of two and
    its halves are added elementwise until one frame is left. The pairing
    is fixed by the row's own frames (a longer padding only adds zero
    halves, exactly), and no library reduction picks its order from the
    tensor's shape."""
    B, T = x.shape[:2]
    mask = frame_mask(frame_lengths, T).reshape((B, T) + (1,) * (x.dim() - 2))
    y = torch.where(mask, x, torch.zeros((), dtype=x.dtype, device=x.device))
    y = y.to(torch.float64)
    n = 1 << max(T - 1, 0).bit_length()
    if n > T:
        y = torch.cat([y, y.new_zeros((B, n - T) + tuple(y.shape[2:]))], dim=1)
    while y.shape[1] > 1:
        h = y.shape[1] // 2
        y = y[:, :h] + y[:, h:]
    return y[:, 0]


def add_to_speakers(
    totals: torch.Tensor,  # (N, ...) float64
    rows: torch.Tensor,  # (B, ...) one utterance's statistic a row
    speaker_ids,  # (B,) host ints: each row's speaker
) -> torch.Tensor:
    """Add each utterance's row to its speaker's total, in place, one
    utterance at a time in row order. The pipelines add batches that are
    consecutive slices of the corpus order (the stable length order), so a
    speaker's total is the same sequence of float64 adds of its utterances
    whatever the batch size, the ranks or the path; the Kaldi tools sum a
    speaker's statistics utterance by utterance in double too
    (``compute-cmvn-stats``, ``FmllrDiagGmmAccs``). One add a row on the
    totals' device; nothing waits for the card. Returns ``totals``."""
    rows = rows.to(device=totals.device, dtype=totals.dtype)
    for r, s in enumerate(host_ints(speaker_ids)):
        totals[s] += rows[r]
    return totals


def cmvn_means(spk_sum: torch.Tensor, spk_count: torch.Tensor) -> torch.Tensor:
    """Per-speaker CMVN means (N, D) in float32 from float64 totals: the
    division in float64, then one rounding."""
    count = torch.clamp(spk_count.to(torch.float64), min=1.0)[:, None]
    return (spk_sum / count).to(torch.float32)


def accumulate_cmvn_stats(
    feats: torch.Tensor,  # (B, T, D)
    frame_lengths: torch.Tensor,  # (B,)
    speaker_ids: torch.Tensor,  # (B,) dense speaker index
    num_speakers: int,
):
    """Per-speaker (sum (N, D), sum of squares (N, D), count (N,)) over the
    valid frames, in float64: the segment reduce of the reference's
    per-speaker ``CmvnComputer`` (``acoustic_corpus.py:1315``), each
    utterance's :func:`frame_sums` added to its speaker's total in row
    order (:func:`add_to_speakers`)."""
    D = feats.shape[2]
    dev = feats.device
    f64 = dict(dtype=torch.float64, device=dev)
    sums = frame_sums(torch.cat([feats, feats * feats], dim=-1), frame_lengths)
    totals = add_to_speakers(torch.zeros((num_speakers, 2 * D), **f64), sums,
                             speaker_ids)
    count = add_to_speakers(torch.zeros(num_speakers, **f64),
                            frame_lengths.to(torch.float64), speaker_ids)
    return totals[:, :D], totals[:, D:], count


def apply_cmvn(
    feats: torch.Tensor,  # (B, T, D)
    speaker_ids: torch.Tensor,  # (B,)
    spk_sum: torch.Tensor,  # (N, D)
    spk_sumsq: torch.Tensor,  # (N, D)
    spk_count: torch.Tensor,  # (N,)
    norm_vars: bool = False,
) -> torch.Tensor:
    """Per-speaker cepstral mean (and optionally variance) normalization
    (Kaldi ``apply-cmvn`` defaults: mean only); the statistics in float64,
    the features in their own type."""
    count = torch.clamp(spk_count.to(torch.float64), min=1.0)[:, None]
    mean = spk_sum.to(torch.float64) / count  # (N, D)
    ids = speaker_ids.long()
    out = feats - mean.to(feats.dtype)[ids][:, None, :]
    if norm_vars:
        var = torch.clamp(spk_sumsq.to(torch.float64) / count - mean**2, min=1e-10)
        out = out * torch.rsqrt(var).to(feats.dtype)[ids][:, None, :]
    return out


def edge_fill(feats: torch.Tensor, frame_lengths: torch.Tensor) -> torch.Tensor:
    """Replace frames past each utterance's true length with its last valid
    frame, so static shifted views implement Kaldi's clamp-to-[0, T_true-1]
    edge handling without per-utterance gathers."""
    B, T, D = feats.shape
    last_idx = torch.clamp(frame_lengths.long() - 1, min=0)
    last = torch.gather(feats, 1, last_idx[:, None, None].expand(B, 1, D))
    mask = frame_mask(frame_lengths, T)[..., None]
    return torch.where(mask, feats, last)


def _shift_edge(x: torch.Tensor, j: int) -> torch.Tensor:
    """Static shift along axis 1 with edge replication."""
    if j == 0:
        return x
    if j > 0:
        tail = x[:, -1:].expand(-1, j, -1)
        return torch.cat([x[:, j:], tail], dim=1)
    head = x[:, :1].expand(-1, -j, -1)
    return torch.cat([head, x[:, :j]], dim=1)


def compute_deltas(
    feats: torch.Tensor,  # (B, T, D)
    frame_lengths: torch.Tensor,  # (B,)
    order: int = 2,
    window: int = 2,
) -> torch.Tensor:
    """Append delta features (Kaldi ``add-deltas``: precomputed convolution
    kernels applied with frame-index clamping to [0, T_true-1]).
    Output (B, T, D*(order+1))."""
    scales = delta_window_scales(order, window)
    filled = edge_fill(feats, frame_lengths)
    outs = [feats]
    for o in range(1, order + 1):
        s = scales[o]
        half = (len(s) - 1) // 2
        acc = torch.zeros_like(feats)
        for j in range(-half, half + 1):
            w = float(s[j + half])
            if w == 0.0:
                continue
            acc = acc + w * _shift_edge(filled, j)
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def splice_frames(
    feats: torch.Tensor,
    frame_lengths: torch.Tensor,
    left: int = 3,
    right: int = 3,
) -> torch.Tensor:
    """Splice +-context frames (Kaldi ``splice-feats``: clamped at edges).
    Output (B, T, D*(left+1+right))."""
    filled = edge_fill(feats, frame_lengths)
    pieces = [_shift_edge(filled, j) for j in range(-left, right + 1)]
    return torch.cat(pieces, dim=-1)


def sliding_cmn(
    feats: torch.Tensor,  # (B, T, D)
    frame_lengths: torch.Tensor,  # (B,)
    cmn_window: int = 300,
    min_window: int = 100,
    center: bool = True,
    normalize_variance: bool = False,
) -> torch.Tensor:
    """Kaldi ``apply-cmvn-sliding`` (``SlidingWindowCmnInternal``,
    feat/feature-functions.cc): per-frame mean over a ``cmn_window``-frame
    window, centred when ``center`` (the i-vector recipe's setting).

    The window is shifted, not shrunk, at utterance edges, so it is shorter
    than ``cmn_window`` only when the utterance is; with ``center=False``
    the leading frames use at least ``min_window`` frames of context.
    Prefix sums over (B, T) in float64, as Kaldi's window sums are double
    (the JAX package sums in float32: a parallel float32 scan on the card
    and a sequential one on the CPU differ by about 1e-3 at T = 3,000 for a
    c0 of about 60); padded frames pass through untouched."""
    B, T, D = feats.shape
    dev = feats.device
    n = frame_lengths.to(device=dev, dtype=torch.int64)[:, None]  # (B, 1)
    t = torch.arange(T, device=dev)[None, :]  # (1, T)
    if center:
        start = t - cmn_window // 2
        end = start + cmn_window
    else:
        start = t - cmn_window
        end = t + 1
    # shift right if the window starts before the utterance
    shift = torch.clamp(-start, min=0)
    start = start + shift
    end = end + shift
    if not center:
        end = torch.clamp(t + 1, min=min_window)
    # shift left if the window ends past the utterance
    over = torch.clamp(end - n, min=0)
    start = torch.clamp(start - over, min=0)
    end = torch.minimum(end, n)
    mask = frame_mask(n[:, 0], T)[..., None]
    x = torch.where(mask, feats, torch.zeros((), dtype=feats.dtype, device=dev))
    x = x.to(torch.float64)

    def window_sums(v):
        csum = torch.cat([torch.zeros_like(v[:, :1]), torch.cumsum(v, dim=1)], 1)
        return (torch.gather(csum, 1, end[..., None].expand(B, T, D))
                - torch.gather(csum, 1, start[..., None].expand(B, T, D)))

    wn = torch.clamp((end - start).to(torch.float64), min=1.0)[..., None]
    mean = window_sums(x) / wn  # (B, T, D)
    out = x - mean
    if normalize_variance:
        var = torch.clamp(window_sums(x * x) / wn - mean * mean, min=1e-10)
        out = out * torch.rsqrt(var)
    return torch.where(mask, out.to(feats.dtype), feats)


def apply_transform(feats: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Apply an affine/linear transform (LDA): rows of ``transform`` are
    output dims; if it has D+1 columns the last is an offset (Kaldi
    ``transform-feats`` semantics)."""
    D = feats.shape[-1]
    _out_dim, in_dim = transform.shape
    out = torch.matmul(feats, transform[:, :D].T)
    if in_dim == D + 1:
        out = out + transform[:, D]
    return out


def apply_per_speaker_transform(
    feats: torch.Tensor,  # (B, T, D)
    speaker_ids: torch.Tensor,  # (B,)
    transforms: torch.Tensor,  # (S, E, D+1) per-speaker fMLLR transforms
) -> torch.Tensor:
    """Each row's features through its speaker's affine transform: (B, T, E)
    in float32 (a batched product, TF32 off, then the offset column)."""
    trans = transforms[speaker_ids.long()]  # (B, E, D+1)
    D = feats.shape[-1]
    out = torch.bmm(feats, trans[:, :, :D].transpose(1, 2))
    return out + trans[:, None, :, D]


def silence_pdf_mask(sil_pdfs, num_pdfs: int) -> np.ndarray:
    """(P,) float32 mask: 1.0 at silence pdfs (for :func:`nonsilence_weight`)."""
    mask = np.zeros(num_pdfs, np.float32)
    mask[np.asarray(sil_pdfs, np.int64)] = 1.0
    return mask


def nonsilence_weight(frame_pdf: torch.Tensor, sil_mask: torch.Tensor) -> torch.Tensor:
    """1.0 on non-silence frames, 0.0 on silence (fMLLR silence_weight=0,
    reference ``corpus/features.py:608``): a gather over the (P,) silence
    mask on the device, so per-frame pdfs never go to the host."""
    return 1.0 - sil_mask[frame_pdf.long()]
