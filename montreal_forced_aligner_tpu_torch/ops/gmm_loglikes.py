"""Batched diagonal-GMM log-likelihood evaluation (all pdfs).

Counterpart of ``montreal_forced_aligner_tpu/ops/gmm_loglikes.py``:

    ll[pdf, g](x) = gconst[pdf, g] + m_iv[pdf, g] . x - 0.5 * iv[pdf, g] . x^2
                  = gconst + [x ; x^2] . W[:, pdf, g]

This is the emission path of small models (P·G below the threshold of the
state-emission kernel, ``ops/cuda_emission.py``); its large product is a
plain float32 ``torch.matmul``.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30


def gmm_loglikes(
    feats: torch.Tensor,  # (B, T, D)
    W: torch.Tensor,  # (2D, P*G) from DiagGmmSet.flatten_for_device
    gconsts: torch.Tensor,  # (P, G) with -inf padding
) -> torch.Tensor:
    """Log-likelihood of every pdf for every frame: (B, T, P)."""
    P, G = gconsts.shape
    xx = torch.cat([feats, feats * feats], dim=-1)  # (B, T, 2D)
    quad = torch.matmul(xx, W)
    quad = quad.reshape(*quad.shape[:-1], P, G) + gconsts
    return torch.logsumexp(quad, dim=-1)


def select_state_emissions(ll: torch.Tensor, state_pdf: torch.Tensor) -> torch.Tensor:
    """Exact graph-state emission selection
    ``emit[b, t, s] = ll[b, t, state_pdf[b, s]]`` as a plain gather.

    ``ll``: (B, T, P); ``state_pdf``: (B, S). Returns (B, T, S)."""
    B, T, _P = ll.shape
    S = state_pdf.shape[1]
    idx = state_pdf.long()[:, None, :].expand(B, T, S)
    return torch.gather(ll, 2, idx)
