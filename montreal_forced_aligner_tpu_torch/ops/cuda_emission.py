"""Graph-state GMM emission log-likelihoods on demand (K3): CUDA kernel,
its plain PyTorch version, and the parameter-row layout.

Counterpart of ``montreal_forced_aligner_tpu/ops/pallas_emission.py``:

    emit[b, t, s] = logsumexp_g ([x, x^2, 1, 0...] . rows[state_pdf[b, s], g])

with gconst folded into each row. Only the pdfs of each batch's graph
states are evaluated, instead of all P pdfs of the model. The kernel is in
``csrc/state_emission.cu`` (its header says what bounds it and how it is
laid out).

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.ops import cuda_build

NEG_INF = -1.0e30


def pack_rows(means_invvars, inv_vars, gconsts) -> np.ndarray:
    """(P, G, D2p) float32 parameter rows ``[miv, -0.5*iv, gconst, 0...]``
    per Gaussian, D2p = 2D + 2 rounded up to a multiple of 4 (16-byte rows).
    Padded Gaussians carry gconst = NEG_INF so they vanish in logsumexp."""
    P, G, D = means_invvars.shape
    d2p = ((2 * D + 2 + 3) // 4) * 4
    out = np.zeros((P, G, d2p), dtype=np.float32)
    out[:, :, :D] = means_invvars
    out[:, :, D : 2 * D] = -0.5 * inv_vars
    out[:, :, 2 * D] = np.maximum(gconsts, NEG_INF)
    return out


def quad_features(feats: torch.Tensor, d2p: int) -> torch.Tensor:
    """(B, T, d2p) rows ``[x, x^2, 1, 0...]`` matching :func:`pack_rows`."""
    B, T, D = feats.shape
    ones = torch.ones((B, T, 1), dtype=feats.dtype, device=feats.device)
    zeros = torch.zeros((B, T, d2p - 2 * D - 1), dtype=feats.dtype,
                        device=feats.device)
    return torch.cat([feats, feats * feats, ones, zeros], dim=-1)


def state_loglikes_plain(
    feats: torch.Tensor,  # (B, T, D) float32
    state_pdf: torch.Tensor,  # (B, S) int32
    rows: torch.Tensor,  # (P, G, D2p) float32 from pack_rows
) -> torch.Tensor:
    """emit (B, T, S). A loop over Gaussians with the kernel's streaming
    logsumexp, so the largest intermediate is (B, T, S)."""
    _P, G, d2p = rows.shape
    xx = quad_features(feats, d2p)  # (B, T, D2p)
    state_rows = rows[state_pdf.long()]  # (B, S, G, D2p)
    m = None
    ssum = None
    for g in range(G):
        q = torch.matmul(xx, state_rows[:, :, g, :].transpose(1, 2))  # (B, T, S)
        if m is None:
            m = torch.full_like(q, NEG_INF)
            ssum = torch.zeros_like(q)
        m_new = torch.maximum(m, q)
        ssum = ssum * torch.exp(m - m_new) + torch.exp(q - m_new)
        m = m_new
    return m + torch.log(ssum)


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.state_emission.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.state_emission.restype = i


def _lib():
    return cuda_build.load_library("state_emission", _declare)


def state_loglikes(
    feats: torch.Tensor,
    state_pdf: torch.Tensor,
    rows: torch.Tensor,
) -> torch.Tensor:
    """K3: emit (B, T, S) float32. Same arguments as
    :func:`state_loglikes_plain`."""
    if feats.device.type == "cpu":
        return state_loglikes_plain(feats, state_pdf, rows)
    if feats.device.type != "cuda":
        raise ValueError(f"state_loglikes: device {feats.device}")
    B, T, D = feats.shape
    S = state_pdf.shape[1]
    P, G, d2p = rows.shape
    cuda_build.check_inputs("state_loglikes", feats.device, (
        ("feats", feats, torch.float32, (B, T, D)),
        ("state_pdf", state_pdf, torch.int32, (B, S)),
        ("rows", rows, torch.float32, (P, G, d2p)),
    ))
    if d2p < 2 * D + 1 or d2p % 4:
        raise ValueError(f"state_loglikes: rows of {d2p} for feature dim {D}")
    out = torch.empty((B, T, S), dtype=torch.float32, device=feats.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = lib.state_emission(
        feats.data_ptr(), state_pdf.data_ptr(), rows.data_ptr(),
        out.data_ptr(), B, T, S, D, G, d2p, stream,
    )
    cuda_build.check(err, "state_loglikes")
    cuda_build.LAUNCHES["state_emission"] += 1
    return out
