"""Batched diagonal-GMM log-likelihood evaluation (all pdfs).

Counterpart of ``montreal_forced_aligner_tpu/ops/gmm_loglikes.py``:

    ll[pdf, g](x) = gconst[pdf, g] + m_iv[pdf, g] . x - 0.5 * iv[pdf, g] . x^2
                  = gconst + [x ; x^2] . W[:, pdf, g]

This is the emission path of small models (P·G below the threshold of the
state-emission kernel, ``ops/cuda_emission.py``); its large product is a
plain float32 ``torch.matmul`` on fixed-shape tiles of frames.
"""

from __future__ import annotations

import torch

from montreal_forced_aligner_tpu_torch.ops.tiles import map_row_blocks

NEG_INF = -1.0e30

# bytes of a tile's (frames, P*G) float32 Gaussian log-likelihoods, and its
# most frames
TILE_BYTES = 64 << 20
MAX_TILE_FRAMES = 8192


def gmm_loglikes(
    feats: torch.Tensor,  # (B, T, D)
    W: torch.Tensor,  # (2D, P*G) from DiagGmmSet.flatten_for_device
    gconsts: torch.Tensor,  # (P, G) with -inf padding
) -> torch.Tensor:
    """Log-likelihood of every pdf for every frame: (B, T, P). The product
    and the ``logsumexp`` run on tiles of frames (``ops.tiles``) whose
    (frames, P*G) block stays within ``TILE_BYTES``, at one shape for a
    model whatever the batch."""
    P, G = gconsts.shape
    tile_frames = min(MAX_TILE_FRAMES, TILE_BYTES // (P * G * 4))

    def tile(blocks, _rows):
        x = blocks.reshape(-1, blocks.shape[-1])
        xx = torch.cat([x, x * x], dim=-1)  # (C, 2D)
        quad = torch.matmul(xx, W).reshape(-1, P, G) + gconsts
        return torch.logsumexp(quad, dim=-1).reshape(blocks.shape[:2] + (P,))

    return map_row_blocks(tile, feats, tile_frames)


def select_state_emissions(ll: torch.Tensor, state_pdf: torch.Tensor) -> torch.Tensor:
    """Exact graph-state emission selection
    ``emit[b, t, s] = ll[b, t, state_pdf[b, s]]`` as a plain gather.

    ``ll``: (B, T, P); ``state_pdf``: (B, S). Returns (B, T, S)."""
    B, T, _P = ll.shape
    S = state_pdf.shape[1]
    idx = state_pdf.long()[:, None, :].expand(B, T, S)
    return torch.gather(ll, 2, idx)


def gmm_state_loglikes(
    feats: torch.Tensor,  # (B, T, D)
    state_miv: torch.Tensor,  # (B, S, G, D) means*invvars gathered per graph state
    state_iv: torch.Tensor,  # (B, S, G, D) invvars
    state_gconst: torch.Tensor,  # (B, S, G) with -inf padding
) -> torch.Tensor:
    """Per-graph-state emission log-likelihoods from gathered parameters:
    (B, T, S). The JAX package's gathered form of the state emissions;
    the port's alignment path runs kernel K3 (``ops/cuda_emission.py``)
    on packed rows instead."""
    xx = torch.cat([feats, feats * feats], dim=-1)  # (B, T, 2D)
    Wg = torch.cat([state_miv, -0.5 * state_iv], dim=-1)  # (B, S, G, 2D)
    B, S, G, D2 = Wg.shape
    quad = torch.matmul(xx, Wg.reshape(B, S * G, D2).transpose(1, 2))
    quad = quad.reshape(B, -1, S, G) + state_gconst[:, None, :, :]
    return torch.logsumexp(quad, dim=-1)


def gather_state_params(gmm_weights_arrays, state_pdf: torch.Tensor):
    """Per-state GMM parameters for :func:`gmm_state_loglikes`.

    gmm_weights_arrays: (means_invvars (P,G,D), inv_vars (P,G,D), gconsts (P,G))
    state_pdf: (B, S) pdf-id per graph state (padding states may use 0).
    """
    miv, iv, gconst = gmm_weights_arrays
    idx = state_pdf.long()
    return miv[idx], iv[idx], gconst[idx]
