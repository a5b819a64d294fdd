"""Feature post-processing: deltas, splicing, linear transforms.

Counterpart of ``montreal_forced_aligner_tpu/ops/feats.py`` for the
alignment path. All functions take (B, T, D) tensors plus (B,) frame counts
and are safe on padded frames.
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
