"""fMLLR (CMLLR) speaker adaptation: statistics on the device, the row-sweep
solve on the host.

Counterpart of the fMLLR half of ``montreal_forced_aligner_tpu/ops/
transforms.py`` (LDA and MLLT wait for training). Per speaker s:

    K[s]    = sum gamma * invvar * mu x+^T          (S, D, D+1)
    G[s, d] = sum gamma * invvar[d] * x+ x+^T        (S, D, D+1, D+1)
    beta[s] = sum gamma

with gamma each Gaussian's posterior within the frame's aligned pdf, times
the frame's weight, and x+ = [x, 1]. The statistics gather each frame's pdf
parameters (the reference selects them with a one-hot product over all
pdfs, exact at ``Precision.HIGHEST``, so a gather gives the same numbers)
in chunks of frames, and reduce per utterance with batched products and per
speaker with ``index_add_``. The solver is the native row sweep of
``native/fmllr_solve.cc`` in float64; :func:`_solve_fmllr_batched_numpy` is
its plain version.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.ops import cuda_build

# bytes of one gathered (frames, G, D) float32 tensor per chunk; a chunk
# keeps three alive at once
_GATHER_CHUNK_BYTES = 64 << 20
# bytes of the (B, frames, D*(D+1)) weighted rows behind each G product
_G_CHUNK_BYTES = 64 << 20


def accumulate_fmllr_stats(
    feats: torch.Tensor,  # (B, T, D)
    frame_lengths: torch.Tensor,  # (B,)
    frame_pdf: torch.Tensor,  # (B, T) int
    speaker_idx: torch.Tensor,  # (B,) int
    frame_weight: torch.Tensor,  # (B, T) per-frame weights (silence weighting)
    means: torch.Tensor,  # (P, G, D)
    inv_vars: torch.Tensor,  # (P, G, D)
    gconsts: torch.Tensor,  # (P, G), -inf padding
    miv: torch.Tensor,  # (P, G, D) means * inv_vars
    num_speakers: int,
):
    """Per-speaker fMLLR sufficient statistics (Kaldi ``gmm-est-fmllr``):
    (K (S, D, D+1), G (S, D, D+1, D+1), beta (S,)) in float32 on the
    features' device. Padded frames take pdf 0 and a zero posterior."""
    B, T, D = feats.shape
    _P, NG, _ = means.shape
    E = D + 1
    N = B * T
    dev = feats.device
    mask = (torch.arange(T, device=dev)[None, :] < frame_lengths[:, None]).reshape(-1)
    pdf = torch.where(mask, frame_pdf.reshape(-1).long(), 0)
    x = feats.reshape(N, D)
    fw = torch.where(mask, frame_weight.reshape(-1), 0.0)
    gc_all = torch.clamp(gconsts, min=-1.0e30)

    # frame-level sums over each frame's Gaussians, in chunks of frames so
    # at most three gathered (chunk, G, D) tensors are alive
    w_mu_iv = torch.empty((N, D), dtype=torch.float32, device=dev)
    w_iv = torch.empty((N, D), dtype=torch.float32, device=dev)
    gamma = torch.empty((N,), dtype=torch.float32, device=dev)
    step = max(1, _GATHER_CHUNK_BYTES // (NG * D * 4))
    for n0 in range(0, N, step):
        sl = slice(n0, min(N, n0 + step))
        p = pdf[sl]
        xc = x[sl]
        iv = inv_vars[p]  # (c, G, D)
        quad = (
            torch.bmm(miv[p], xc[:, :, None])[..., 0]
            - 0.5 * torch.bmm(iv, (xc * xc)[:, :, None])[..., 0]
            + gc_all[p]
        )  # (c, G)
        ll = torch.logsumexp(quad, dim=-1, keepdim=True)
        post = torch.where(mask[sl, None], torch.exp(quad - ll), 0.0)
        post = post * fw[sl, None]
        mu_iv = means[p] * iv
        w_mu_iv[sl] = torch.bmm(post[:, None, :], mu_iv)[:, 0]
        w_iv[sl] = torch.bmm(post[:, None, :], iv)[:, 0]
        gamma[sl] = post.sum(dim=1)
        del iv, mu_iv

    # per-utterance reductions (each utterance has one speaker), then per
    # speaker with index_add_
    xp = torch.cat([feats, torch.ones((B, T, 1), dtype=feats.dtype, device=dev)], 2)
    w_mu_iv = w_mu_iv.reshape(B, T, D)
    w_iv = w_iv.reshape(B, T, D)
    spk = speaker_idx.long()
    beta = torch.zeros((num_speakers,), dtype=torch.float32, device=dev)
    beta.index_add_(0, spk, gamma.reshape(B, T).sum(dim=1))
    K_utt = torch.bmm(w_mu_iv.transpose(1, 2), xp)  # (B, D, E)
    G_utt = torch.zeros((B, D * E, E), dtype=torch.float32, device=dev)
    t_step = max(1, _G_CHUNK_BYTES // (B * D * E * 4))
    for t0 in range(0, T, t_step):
        ts = slice(t0, min(T, t0 + t_step))
        z = (w_iv[:, ts, :, None] * xp[:, ts, None, :]).reshape(B, -1, D * E)
        G_utt += torch.bmm(z.transpose(1, 2), xp[:, ts])
    K = torch.zeros((num_speakers, D, E), dtype=torch.float32, device=dev)
    K.index_add_(0, spk, K_utt)
    G = torch.zeros((num_speakers, D, E, E), dtype=torch.float32, device=dev)
    G.index_add_(0, spk, G_utt.reshape(B, D, E, E))
    return K, G, beta


class FmllrEstimate(NamedTuple):
    """One two-pass run's host statistics (float64) and transforms."""

    K: np.ndarray  # (S, D, D+1)
    G: np.ndarray  # (S, D, D+1, D+1)
    beta: np.ndarray  # (S,)
    transforms: np.ndarray  # (S, D, D+1) float32; identity under min_count


def stats_to_host(K: torch.Tensor, G: torch.Tensor, beta: torch.Tensor):
    """The device's float32 sums as float64 numpy arrays for the solve, in
    one device-to-host copy."""
    flat = torch.cat([K.reshape(-1), G.reshape(-1), beta.reshape(-1)]).cpu()
    flat = flat.numpy().astype(np.float64)
    nk, ng = K.numel(), G.numel()
    return (flat[:nk].reshape(K.shape), flat[nk : nk + ng].reshape(G.shape),
            flat[nk + ng :].reshape(beta.shape))


def _declare(lib) -> None:
    lib.fmllr_solve_batched.restype = ctypes.c_int
    lib.fmllr_solve_batched.argtypes = [
        ctypes.c_void_p,  # K
        ctypes.c_void_p,  # G
        ctypes.c_void_p,  # beta
        ctypes.c_void_p,  # W (in/out)
        ctypes.c_longlong,  # S
        ctypes.c_longlong,  # D
        ctypes.c_int,  # num_iters
        ctypes.c_int,  # num_threads
    ]


def solve_fmllr_batched(
    K: np.ndarray,  # (S, D, D+1)
    G_mats: np.ndarray,  # (S, D, D+1, D+1)
    beta: np.ndarray,  # (S,)
    num_iters: int = 40,
) -> np.ndarray:
    """(S, D, D+1) float32 transforms from the native C++ row sweep (1600
    sequential row steps per solve at D = 40, threaded over speakers), in
    float64. Its library is built with g++ at first use; a failed build
    raises."""
    S, D, E = K.shape
    if G_mats.shape != (S, D, E, E) or np.shape(beta) != (S,) or E != D + 1:
        raise ValueError(
            f"fmllr solve: K {K.shape}, G {G_mats.shape}, beta {np.shape(beta)}"
        )
    lib = cuda_build.load_library("fmllr_solve", _declare)
    K64 = np.ascontiguousarray(K, np.float64)
    G64 = np.ascontiguousarray(G_mats, np.float64)
    b64 = np.ascontiguousarray(beta, np.float64)
    W = np.ascontiguousarray(
        np.tile(np.hstack([np.eye(D), np.zeros((D, 1))]), (S, 1, 1)), np.float64
    )
    threads = min(int(S), max(os.cpu_count() or 1, 1), 16)
    rc = lib.fmllr_solve_batched(
        K64.ctypes.data_as(ctypes.c_void_p),
        G64.ctypes.data_as(ctypes.c_void_p),
        b64.ctypes.data_as(ctypes.c_void_p),
        W.ctypes.data_as(ctypes.c_void_p),
        S, D, int(num_iters), threads,
    )
    if rc != 0:
        raise RuntimeError(f"fmllr_solve_batched returned {rc}")
    return W.astype(np.float32)


def _solve_fmllr_batched_numpy(
    K: np.ndarray,  # (S, D, D+1)
    G_mats: np.ndarray,  # (S, D, D+1, D+1)
    beta: np.ndarray,  # (S,)
    num_iters: int = 40,
) -> np.ndarray:
    """Plain version of the native solve: the row-wise fMLLR solve for S
    speakers in lockstep (Kaldi ``FmllrOptions`` defaults), vectorized over
    the speaker axis.

    The cofactor row needs det(A) and A^-1 of the current transform each
    row step; those are maintained by Sherman-Morrison rank-1 updates
    (row d is the only row that changed) with an exact batched recompute at
    the top of every sweep to cap drift. Returns (S, D, D+1) float32.
    """
    S, D, E = K.shape
    K = np.ascontiguousarray(K, np.float64)
    G_mats = np.ascontiguousarray(G_mats, np.float64)
    beta = np.asarray(beta, np.float64)
    W = np.tile(np.hstack([np.eye(D), np.zeros((D, 1))]), (S, 1, 1))
    inv_G = np.linalg.inv(G_mats + 1e-6 * np.eye(E))  # (S, D, E, E), batched
    for _sweep in range(num_iters):
        W_before = W.copy()
        A = W[:, :, :D]
        invA = np.linalg.inv(A)  # (S, D, D) exact per sweep
        detA = np.linalg.det(A)  # (S,)
        for d in range(D):
            # cofactor row d of A: cof = inv(A)^T * det(A)
            c = np.zeros((S, E))
            c[:, :D] = invA[:, :, d] * detA[:, None]
            iGd = inv_G[:, d]  # (S, E, E)
            cG = np.einsum("se,sef->sf", c, iGd)
            a = np.einsum("se,se->s", cG, c)
            b = np.einsum("se,se->s", cG, K[:, d])
            disc = b * b + 4.0 * a * beta
            ok = (a > 0) & (disc >= 0)
            safe_a = np.where(ok, a, 1.0)
            sq = np.sqrt(np.maximum(disc, 0.0))
            alpha1 = (-b + sq) / (2.0 * safe_a)
            alpha2 = (-b - sq) / (2.0 * safe_a)

            def row(alpha):
                return np.einsum("se,sef->sf", K[:, d] + alpha[:, None] * c, iGd)

            def objf(w):
                lin = np.maximum(np.abs(np.einsum("se,se->s", w, c)), 1e-20)
                return (
                    beta * np.log(lin)
                    - 0.5 * np.einsum("se,sef,sf->s", w, G_mats[:, d], w)
                    + np.einsum("se,se->s", w, K[:, d])
                )

            w1, w2 = row(alpha1), row(alpha2)
            w_new = np.where((objf(w1) >= objf(w2))[:, None], w1, w2)
            old = W[:, d].copy()
            W[:, d] = np.where(ok[:, None], w_new, old)
            # Sherman-Morrison update of invA/detA for the changed row:
            # A_new = A + e_d delta^T  (delta = new - old, first D cols)
            delta = (W[:, d] - old)[:, :D]  # (S, D); zero where not ok
            factor = 1.0 + np.einsum("sd,sd->s", delta, invA[:, :, d])
            degenerate = np.abs(factor) < 1e-12
            safe_f = np.where(degenerate, 1.0, factor)
            colv = invA[:, :, d].copy()  # (S, D) = A^-1 e_d
            rowv = np.einsum("sd,sde->se", delta, invA)  # (S, D)
            invA = invA - colv[:, :, None] * rowv[:, None, :] / safe_f[:, None, None]
            detA = detA * factor
            if degenerate.any():
                # exact recompute for degenerate speakers
                idx = np.nonzero(degenerate)[0]
                invA[idx] = np.linalg.inv(W[idx][:, :, :D])
                detA[idx] = np.linalg.det(W[idx][:, :, :D])
        # converged sweeps change nothing further (the row objective is
        # concave per row; Kaldi iterates a fixed 40 sweeps — stopping once
        # the update stalls below tolerance yields the same transform)
        if np.max(np.abs(W - W_before)) < 1e-7 * (1.0 + np.max(np.abs(W))):
            break
    return W.astype(np.float32)


def estimate_speaker_fmllr(
    K: np.ndarray,  # (S, D, D+1)
    G_mats: np.ndarray,  # (S, D, D+1, D+1)
    beta: np.ndarray,  # (S,)
    min_count: float = 500.0,
) -> np.ndarray:
    """Per-speaker transforms (identity when under min_count): (S, D, D+1)
    float32."""
    S, D, E = K.shape
    out = np.tile(np.hstack([np.eye(D), np.zeros((D, 1))]), (S, 1, 1)).astype(
        np.float32
    )
    valid = np.asarray(beta, np.float64) >= min_count
    if valid.any():
        idx = np.nonzero(valid)[0]
        # chunk the speaker axis: the solve holds float64 (chunk, D, E, E)
        # inverses (~5.5 MB/speaker at D=40)
        for lo in range(0, len(idx), 64):
            sub = idx[lo : lo + 64]
            out[sub] = solve_fmllr_batched(K[sub], G_mats[sub], beta[sub])
    return out
