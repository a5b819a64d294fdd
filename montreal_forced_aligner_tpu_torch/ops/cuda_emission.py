"""Graph-state GMM emission log-likelihoods on demand (K3): CUDA kernel,
its plain PyTorch version, and the parameter-row layout.

Counterpart of ``montreal_forced_aligner_tpu/ops/pallas_emission.py``:

    emit[b, t, s] = logsumexp_g ([x, x^2, 1, 0...] . rows[state_pdf[b, s], g])

with gconst folded into each row. Only the pdfs of each batch's graph
states are evaluated, instead of all P pdfs of the model. The kernel is in
``csrc/state_emission.cu`` (its header says what bounds it and how it is
laid out): it multiplies on the tensor cores in 3xTF32, from the rows split
once at model load by :func:`split_rows`.

A wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.ops import cuda_build

NEG_INF = -1.0e30


def pack_rows(means_invvars, inv_vars, gconsts) -> np.ndarray:
    """(P, G, D2p) float32 parameter rows ``[miv, -0.5*iv, gconst, 0...]``
    per Gaussian, D2p = 2D + 2 rounded up to a multiple of 8 (the depth of
    one tensor-core step). Padded Gaussians carry gconst = NEG_INF so they
    vanish in logsumexp."""
    P, G, D = means_invvars.shape
    d2p = ((2 * D + 2 + 7) // 8) * 8
    out = np.zeros((P, G, d2p), dtype=np.float32)
    out[:, :, :D] = means_invvars
    out[:, :, D : 2 * D] = -0.5 * inv_vars
    out[:, :, 2 * D] = np.maximum(gconsts, NEG_INF)
    return out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10-bit mantissa), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds: the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi); hi*b_hi + hi*b_lo +
    lo*b_hi keeps about the float32 product's error (3xTF32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def split_rows(rows: torch.Tensor) -> torch.Tensor:
    """(P, G, 2*D2p) float32: :func:`pack_rows` rows split into TF32 hi and
    lo parts, in the kernel's B-fragment order. For each 8-deep k-step k0
    and lane column c in 0..3 the 4 values are ``[hi(k0+c), hi(k0+c+4),
    lo(k0+c), lo(k0+c+4)]``, so one 16-byte load gives a lane both its
    operands in both parts. Made once, at model load."""
    P, G, d2p = rows.shape
    if d2p % 8:
        raise ValueError(f"split_rows: rows of {d2p}, not a multiple of 8")
    hi, lo = (p.reshape(P, G, d2p // 8, 2, 4) for p in tf32_split(rows))
    out = torch.stack(
        [hi[..., 0, :], hi[..., 1, :], lo[..., 0, :], lo[..., 1, :]], dim=-1
    )  # (P, G, d2p // 8, 4, 4)
    return out.reshape(P, G, 2 * d2p).contiguous()


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
    rows_split: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K3: emit (B, T, S) float32. Same arguments as
    :func:`state_loglikes_plain`, and ``rows_split``, ``split_rows(rows)``,
    which the kernel reads (made here when not given; the aligner passes the
    one made at model load)."""
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
    if d2p < 2 * D + 1 or d2p % 8:
        raise ValueError(f"state_loglikes: rows of {d2p} for feature dim {D}")
    if rows_split is None:
        rows_split = split_rows(rows)
    cuda_build.check_inputs("state_loglikes", feats.device, (
        ("rows_split", rows_split, torch.float32, (P, G, 2 * d2p)),
    ))
    if rows_split.data_ptr() % 16:
        raise ValueError("state_loglikes: rows_split is not 16-byte aligned")
    out = torch.empty((B, T, S), dtype=torch.float32, device=feats.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    err = lib.state_emission(
        feats.data_ptr(), state_pdf.data_ptr(), rows_split.data_ptr(),
        out.data_ptr(), B, T, S, D, G, d2p, stream,
    )
    cuda_build.check(err, "state_loglikes")
    cuda_build.LAUNCHES["state_emission"] += 1
    return out


def pack_rows_device(miv: torch.Tensor, iv: torch.Tensor,
                     gconsts: torch.Tensor) -> torch.Tensor:
    """:func:`pack_rows` on the tensors' own device, for a model that
    changes every training iteration: the same (P, G, D2p) float32 rows, bit
    for bit."""
    P, G, D = miv.shape
    d2p = ((2 * D + 2 + 7) // 8) * 8
    out = torch.zeros((P, G, d2p), dtype=torch.float32, device=miv.device)
    out[:, :, :D] = miv
    out[:, :, D : 2 * D] = -0.5 * iv
    out[:, :, 2 * D] = torch.clamp(gconsts, min=NEG_INF)
    return out
