"""Feature-space transform estimation: LDA, MLLT (STC) and fMLLR (CMLLR),
statistics on the device, the small solves on the host.

Counterpart of ``montreal_forced_aligner_tpu/ops/transforms.py``.

LDA: per-class frame counts and sums, by the fixed-order segmented sums of
``ops/stats.py``, and the total second moment as one product.

MLLT: for each dimension d, G[d] = sum gamma * invvar[d] * (x - mu)(x - mu)^T
over each frame's aligned pdf's Gaussians, and beta = sum gamma.

fMLLR, per speaker s:

    K[s]    = sum gamma * invvar * mu x+^T          (S, D, D+1)
    G[s, d] = sum gamma * invvar[d] * x+ x+^T        (S, D, D+1, D+1)
    beta[s] = sum gamma

with gamma each Gaussian's posterior within the frame's aligned pdf, times
the frame's weight, and x+ = [x, 1].

The statistics gather each frame's pdf parameters (the reference selects
them with a one-hot product over all pdfs, exact at ``Precision.HIGHEST``,
so a gather gives the same numbers) one utterance at a time, reduce over
its frames in float64, and add each utterance to its speaker's float64
total in corpus order: every sum has a fixed order that the batching does
not change, so the statistics are the same from run to run and from one
batch size, path or rank count to another. The fMLLR solver is the native
row sweep of ``native/fmllr_solve.cc`` in float64;
:func:`_solve_fmllr_batched_numpy` is its plain version. LDA's eigenproblem and MLLT's row sweep are numpy, as in
the reference.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.ops import cuda_build
from montreal_forced_aligner_tpu_torch.ops.feats import add_to_speakers, host_ints
from montreal_forced_aligner_tpu_torch.ops.stats import (
    frame_layout,
    segment_moments,
)

# bytes of one gathered (frames, G, D) float32 tensor per chunk of frames
# (MLLT: of its (frames*G, D*D) outer products)
_GATHER_CHUNK_BYTES = 64 << 20
# bytes of one utterance's float64 (frames, D + 1 + D*(D+1)) block of the
# product over frames (4,990 frames a block at D = 40)
_G_CHUNK_BYTES = 64 << 20


# ---------------------------------------------------------------------------
# LDA
# ---------------------------------------------------------------------------
def accumulate_lda_stats(
    feats: torch.Tensor,  # (B, T, D) spliced features
    frame_lengths: torch.Tensor,
    frame_class: torch.Tensor,  # (B, T) class (pdf) per frame
    num_classes: int,
):
    """Returns (class_counts (C,), class_sums (C, D), total_second (D, D))."""
    B, T, D = feats.shape
    N = B * T
    mask = (torch.arange(T, device=feats.device)[None, :]
            < frame_lengths[:, None]).reshape(-1)
    x = torch.where(mask[:, None], feats.reshape(N, D), 0.0)
    layout = frame_layout(frame_class, frame_lengths, num_classes)
    counts, sums, _sumsq = segment_moments(x, layout)
    second = x.T @ x
    return counts, sums, second


def estimate_lda(
    class_counts: np.ndarray,  # (C,)
    class_sums: np.ndarray,  # (C, D)
    total_second: np.ndarray,  # (D, D)
    target_dim: int = 40,
    within_floor: float = 1e-6,
) -> np.ndarray:
    """LDA transform (target_dim, D): rows diagonalize between-class scatter
    with unit within-class covariance (Kaldi ``est-lda`` semantics)."""
    import scipy.linalg

    counts = np.maximum(class_counts, 0.0)
    total = counts.sum()
    mean = class_sums.sum(axis=0) / total
    with np.errstate(divide="ignore", invalid="ignore"):
        class_means = class_sums / np.maximum(counts, 1e-10)[:, None]
    between = (
        np.einsum("c,cd,ce->de", counts, class_means, class_means) / total
        - np.outer(mean, mean)
    )
    total_covar = total_second / total - np.outer(mean, mean)
    within = total_covar - between
    within = (within + within.T) / 2
    # Kaldi ``LdaEstimate::Estimate`` adds 1e-3 of the mean variance to the
    # diagonal of a within-class covariance that is not positive definite,
    # as a column constant over the data makes it (the pitch of a
    # stationary tone: normalized log-pitch and delta-pitch are 0). The
    # statistics are float32 sums, so "singular" is an eigenvalue under
    # 1e-7 of the mean variance; a tiny floor would scale such a direction
    # by up to 1e3 and leave the fMLLR solve after it ill-conditioned
    mean_var = np.trace(within) / len(mean)
    if np.linalg.eigvalsh(within)[0] <= 1e-7 * mean_var:
        within = within + 1e-3 * mean_var * np.eye(len(mean))
    else:
        within = within + within_floor * np.eye(len(mean))
    between = (between + between.T) / 2
    eigvals, eigvecs = scipy.linalg.eigh(between, within)
    order = np.argsort(eigvals)[::-1][:target_dim]
    M = eigvecs[:, order].T  # rows: generalized eigvecs, v' W v = 1 already
    return M.astype(np.float32)


# ---------------------------------------------------------------------------
# MLLT (semi-tied covariance)
# ---------------------------------------------------------------------------
def accumulate_mllt_stats(
    feats: torch.Tensor,  # (B, T, D) current (LDA-space) features
    frame_lengths: torch.Tensor,
    frame_pdf: torch.Tensor,  # (B, T)
    means: torch.Tensor,  # (P, G, D) gaussian means
    inv_vars: torch.Tensor,  # (P, G, D)
    gconsts: torch.Tensor,  # (P, G)
    miv: torch.Tensor,  # (P, G, D) means*invvars (for posteriors)
):
    """MLLT stats: G[d] = sum_frames sum_g gamma * invvar[g, d] *
    (x - mu_g)(x - mu_g)^T and beta = total posterior mass. Returns
    ((D, D, D), scalar)."""
    B, T, D = feats.shape
    _P, NG, _ = means.shape
    N = B * T
    dev = feats.device
    mask = (torch.arange(T, device=dev)[None, :] < frame_lengths[:, None]).reshape(-1)
    pdf = torch.where(mask, frame_pdf.reshape(-1).long(), 0)
    x = feats.reshape(N, D)
    gc_all = torch.clamp(gconsts, min=-1.0e30)
    G_mats = torch.zeros((D, D * D), dtype=torch.float32, device=dev)
    beta = torch.zeros((), dtype=torch.float32, device=dev)
    # the (frames*G, D*D) outer products dominate a chunk's memory
    step = max(1, _GATHER_CHUNK_BYTES // (NG * D * D * 4))
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
        diff = (xc[:, None, :] - means[p]).reshape(-1, D)  # (c*G, D)
        w = (post[:, :, None] * iv).reshape(-1, D)  # (c*G, D)
        outer = (diff[:, :, None] * diff[:, None, :]).reshape(-1, D * D)
        G_mats += w.T @ outer
        beta += post.sum()
    return G_mats.reshape(D, D, D), beta


def solve_mllt(G_mats: np.ndarray, beta: float, num_iters: int = 10) -> np.ndarray:
    """Row-wise MLLT update (Kaldi ``est-mllt``): maximize
    beta * log|det M| - 0.5 * sum_d m_d G_d m_d^T."""
    D = G_mats.shape[0]
    M = np.eye(D)
    for _ in range(num_iters):
        for d in range(D):
            inv_Gd = np.linalg.inv(G_mats[d] / beta + 1e-8 * np.eye(D))
            cof = np.linalg.inv(M).T * np.linalg.det(M)
            c = cof[d]
            denom = c @ inv_Gd @ c
            M[d] = c @ inv_Gd / np.sqrt(max(denom, 1e-20))
    return M.astype(np.float32)


# ---------------------------------------------------------------------------
# fMLLR (CMLLR)
# ---------------------------------------------------------------------------
def utterance_fmllr_stats(
    feats: torch.Tensor,  # (B, T, D)
    frame_lengths,  # (B,) host ints (or a tensor)
    frame_pdf: torch.Tensor,  # (B, T) int
    frame_weight: torch.Tensor,  # (B, T) per-frame weights (silence weighting)
    means: torch.Tensor,  # (P, G, D)
    inv_vars: torch.Tensor,  # (P, G, D)
    gconsts: torch.Tensor,  # (P, G), -inf padding
    miv: torch.Tensor,  # (P, G, D) means * inv_vars
):
    """Each utterance's fMLLR statistics in float64: (K (B, D, D+1), G (B,
    D, D+1, D+1), beta (B,)).

    An utterance's statistics are a function of its own frames alone,
    whatever the batch size, the padded length or the rows beside it: every
    product and reduction runs on tensors of the utterance's own n frames,
    made anew (the same shapes and the same alignment wherever it is
    batched, so every library call takes the same order). Per frame, in
    float32 as the features: the posteriors over the pdf's Gaussians and
    their weighted sums w_mu_iv, w_iv and gamma. Over frames, in float64:
    one product of [w_mu_iv | gamma | w_iv (x) x+] with x+ for each block
    of frames counted from the first, the blocks added in order (x+'s last
    column of ones makes the gamma column's last entry beta)."""
    B, T, D = feats.shape
    _P, NG, _ = means.shape
    E = D + 1
    F = D + 1 + D * E  # rows of an utterance's statistics: K, beta, G
    dev = feats.device
    lengths = host_ints(frame_lengths)
    gc_all = torch.clamp(gconsts, min=-1.0e30)
    out = torch.zeros((B, F, E), dtype=torch.float64, device=dev)
    # frames of one utterance per gathered (frames, G, D) float32 tensor,
    # and per float64 (frames, F) block of the product over frames
    step = max(1, _GATHER_CHUNK_BYTES // (NG * D * 4))
    t_step = max(1, _G_CHUNK_BYTES // (F * 8))
    for b, n in enumerate(lengths):
        if n <= 0:
            continue
        x = feats[b, :n].clone()
        pdf = frame_pdf[b, :n].long()
        fw = frame_weight[b, :n]
        rows = torch.empty((n, 2 * D + 1), dtype=torch.float32, device=dev)
        for n0 in range(0, n, step):
            sl = slice(n0, min(n, n0 + step))
            p = pdf[sl]
            xc = x[sl]
            iv = inv_vars[p]  # (c, G, D)
            quad = (
                torch.bmm(miv[p], xc[:, :, None])[..., 0]
                - 0.5 * torch.bmm(iv, (xc * xc)[:, :, None])[..., 0]
                + gc_all[p]
            )  # (c, G)
            ll = torch.logsumexp(quad, dim=-1, keepdim=True)
            post = torch.exp(quad - ll) * fw[sl, None]
            rows[sl, :D] = torch.bmm(post[:, None, :], means[p] * iv)[:, 0]
            rows[sl, D : 2 * D] = torch.bmm(post[:, None, :], iv)[:, 0]
            rows[sl, 2 * D] = post.sum(dim=1)
            del iv
        rows = rows.to(torch.float64)
        xp = torch.cat([x, torch.ones((n, 1), dtype=x.dtype, device=dev)], 1)
        xp = xp.to(torch.float64)
        for t0 in range(0, n, t_step):
            ts = slice(t0, min(n, t0 + t_step))
            z = (rows[ts, D : 2 * D, None] * xp[ts, None, :]).reshape(-1, D * E)
            left = torch.cat([rows[ts, :D], rows[ts, 2 * D :], z], dim=1)  # (t, F)
            out[b] += left.T @ xp[ts]
    return (out[:, :D], out[:, D + 1 :].reshape(B, D, E, E), out[:, D, D])


def zero_fmllr_totals(num_speakers: int, D: int, device):
    """Per-speaker float64 (K, G, beta) totals at zero on ``device``."""
    f64 = dict(dtype=torch.float64, device=device)
    return (torch.zeros((num_speakers, D, D + 1), **f64),
            torch.zeros((num_speakers, D, D + 1, D + 1), **f64),
            torch.zeros((num_speakers,), **f64))


def accumulate_fmllr_stats(
    feats: torch.Tensor,  # (B, T, D)
    frame_lengths,  # (B,) host ints (or a tensor)
    frame_pdf: torch.Tensor,  # (B, T) int
    speaker_idx,  # (B,) host ints (or a tensor)
    frame_weight: torch.Tensor,  # (B, T) per-frame weights (silence weighting)
    means: torch.Tensor,  # (P, G, D)
    inv_vars: torch.Tensor,  # (P, G, D)
    gconsts: torch.Tensor,  # (P, G), -inf padding
    miv: torch.Tensor,  # (P, G, D) means * inv_vars
    num_speakers: int,
    totals=None,
):
    """Per-speaker fMLLR sufficient statistics (Kaldi ``gmm-est-fmllr``):
    (K (S, D, D+1), G (S, D, D+1, D+1), beta (S,)) in float64 on the
    features' device: each utterance's :func:`utterance_fmllr_stats` added
    to its speaker's total in row order (``ops.feats.add_to_speakers``).
    With ``totals`` (an earlier return value) this batch's utterances are
    added to it in place, so a corpus's batches in corpus order give each
    speaker the same sum whatever the batch size. Pass host arrays for the
    lengths and speakers: nothing then waits for the card."""
    D = feats.shape[2]
    rows = utterance_fmllr_stats(feats, frame_lengths, frame_pdf, frame_weight,
                                 means, inv_vars, gconsts, miv)
    if totals is None:
        totals = zero_fmllr_totals(num_speakers, D, feats.device)
    for total, row in zip(totals, rows):
        add_to_speakers(total, row, speaker_idx)
    return tuple(totals)


class FmllrEstimate(NamedTuple):
    """One two-pass run's host statistics (float64) and transforms."""

    K: np.ndarray  # (S, D, D+1)
    G: np.ndarray  # (S, D, D+1, D+1)
    beta: np.ndarray  # (S,)
    transforms: np.ndarray  # (S, D, D+1) float32; identity under min_count


def stats_to_host(K: torch.Tensor, G: torch.Tensor, beta: torch.Tensor):
    """The device's float64 totals as numpy arrays for the solve, in one
    device-to-host copy."""
    flat = torch.cat([K.reshape(-1), G.reshape(-1), beta.reshape(-1)])
    flat = flat.to(torch.float64).cpu().numpy()
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


def solve_fmllr(
    K: np.ndarray,  # (D, D+1)
    G_mats: np.ndarray,  # (D, D+1, D+1)
    beta: float,
    num_iters: int = 40,
    min_count: float = 500.0,
) -> Optional[np.ndarray]:
    """Row-wise full fMLLR solve for one speaker (Kaldi ``FmllrOptions``
    defaults), in float64 numpy: (D, D+1) float32, or None under
    ``min_count`` frames. The corpus paths solve many speakers at once
    (:func:`solve_fmllr_batched`); this is the one-speaker form of the same
    row sweeps, recomputing the cofactor row from scratch each step."""
    if beta < min_count:
        return None
    D = K.shape[0]
    E = D + 1
    W = np.hstack([np.eye(D), np.zeros((D, 1))])  # init = identity
    inv_G = [np.linalg.inv(G_mats[d] + 1e-6 * np.eye(E)) for d in range(D)]
    for _ in range(num_iters):
        for d in range(D):
            A = W[:, :D]
            cof = np.linalg.inv(A).T * np.linalg.det(A)
            c = np.concatenate([cof[d], [0.0]])  # extended cofactor row
            cG = c @ inv_G[d]
            a = cG @ c  # quadratic coefficient
            b = cG @ K[d]
            # the row's optimum scales the cofactor direction by a root of
            # alpha^2 * a + alpha * b - beta = 0
            disc = b * b + 4 * a * beta
            if a <= 0 or disc < 0:
                continue
            alpha1 = (-b + np.sqrt(disc)) / (2 * a)
            alpha2 = (-b - np.sqrt(disc)) / (2 * a)

            def objf(alpha):
                w = (K[d] + alpha * c) @ inv_G[d]
                lin = np.abs(w @ c)
                return beta * np.log(max(lin, 1e-20)) - 0.5 * w @ G_mats[d] @ w + w @ K[d]

            alpha = alpha1 if objf(alpha1) >= objf(alpha2) else alpha2
            W[d] = (K[d] + alpha * c) @ inv_G[d]
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
