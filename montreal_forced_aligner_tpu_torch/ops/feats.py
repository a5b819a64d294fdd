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


def speaker_sums(x: torch.Tensor, speaker_ids: torch.Tensor, num_speakers: int):
    """Per-speaker sums of (B, ...) rows, by one product with the (N, B)
    speaker indicator in a fixed order (no float atomics): (N, ...)."""
    onehot = (torch.arange(num_speakers, device=x.device)[:, None]
              == speaker_ids.long()[None, :]).to(x.dtype)
    return (onehot @ x.reshape(x.shape[0], -1)).reshape((num_speakers,) + x.shape[1:])


def accumulate_cmvn_stats(
    feats: torch.Tensor,  # (B, T, D)
    frame_lengths: torch.Tensor,  # (B,)
    speaker_ids: torch.Tensor,  # (B,) dense speaker index
    num_speakers: int,
):
    """Per-speaker (sum (N, D), sum of squares (N, D), count (N,)) over the
    valid frames: the segment reduce of the reference's per-speaker
    ``CmvnComputer`` (``acoustic_corpus.py:1315``), summed over rows in a
    fixed order."""
    mask = frame_mask(frame_lengths, feats.shape[1])[..., None]
    masked = torch.where(mask, feats, 0.0)
    per_utt_sum = masked.sum(dim=1)  # (B, D)
    per_utt_sumsq = (masked * masked).sum(dim=1)
    counts = frame_lengths.to(feats.dtype)
    return (
        speaker_sums(per_utt_sum, speaker_ids, num_speakers),
        speaker_sums(per_utt_sumsq, speaker_ids, num_speakers),
        speaker_sums(counts, speaker_ids, num_speakers),
    )


def apply_cmvn(
    feats: torch.Tensor,  # (B, T, D)
    speaker_ids: torch.Tensor,  # (B,)
    spk_sum: torch.Tensor,  # (N, D)
    spk_sumsq: torch.Tensor,  # (N, D)
    spk_count: torch.Tensor,  # (N,)
    norm_vars: bool = False,
) -> torch.Tensor:
    """Per-speaker cepstral mean (and optionally variance) normalization
    (Kaldi ``apply-cmvn`` defaults: mean only)."""
    count = torch.clamp(spk_count, min=1.0)[:, None]
    mean = spk_sum / count  # (N, D)
    ids = speaker_ids.long()
    out = feats - mean[ids][:, None, :]
    if norm_vars:
        var = torch.clamp(spk_sumsq / count - mean**2, min=1e-10)
        out = out * torch.rsqrt(var)[ids][:, None, :]
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
