"""i-vector extractor (total-variability T-matrix) training and extraction.

Counterpart of ``montreal_forced_aligner_tpu/ivector/extractor.py``
(behavioural spec: reference ``ivector/trainer.py:390-633``,
``IvectorTrainer``: 192-dim extractor, 10 EM iterations,
gaussian_min_count 100, and ``corpus/features.py:956-1016``,
``ExtractIvectorsFunction``). Model:

    supervector mean of component c for utterance u:  m_c + T_c w_u,
    w_u ~ N(0, I_R)

E-step per utterance (batched products on the device):
    L_u     = I + sum_c gamma_uc T_c^T Sigma_c^-1 T_c
    w_hat_u = L_u^-1 sum_c T_c^T Sigma_c^-1 (X_uc - gamma_uc m_c)
M-step per component (float64 solves on the host):
    T_c = (sum_u (X_uc - gamma_uc m_c) w_hat_u^T)
          (sum_u gamma_uc (L_u^-1 + w_hat_u w_hat_u^T))^-1

The statistics, the E-step and the accumulators run in float64 on the
device, as Kaldi's ``IvectorExtractorStats`` are double, where the JAX
package's run in float32 (the TPU has no float64); see ``ivector/ubm.py``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.ivector.ubm import DiagUbm
from montreal_forced_aligner_tpu_torch.device import resolve_device
from montreal_forced_aligner_tpu_torch.tracing import PhaseClock
from montreal_forced_aligner_tpu_torch.training.base import (
    StreamingTreeSum,
    fetch_all,
)

logger = logging.getLogger("mfa_tpu")


@dataclass
class IvectorExtractor:
    ubm: DiagUbm
    T: np.ndarray  # (C, D, R)
    # PLDA trained on speaker-labelled i-vectors, bundled like the
    # reference's extractor archive (``IvectorExtractorModel``,
    # ``models.py:814``; PldaTrainer stage ``ivector/trainer.py:634``)
    plda: "Optional[object]" = None
    # reference-archive extras (``ivector/kaldi_model.py``): full-covariance
    # Sigma^-1 from a Kaldi final.ie (the E-step uses it when present; None
    # = diagonal from the UBM), the Kaldi prior offset, an optional
    # ivector_lda.mat and the archive meta
    sigma_inv: Optional[np.ndarray] = None  # (C, D, D)
    prior_offset: float = 100.0
    lda: Optional[np.ndarray] = None
    meta: Optional[dict] = None
    # Kaldi-form models (an imported final.ie) keep all ivector_dim columns
    # of M in T, the UBM mean folded into column 0 as prior_offset *
    # M[:, :, 0]; extraction centres by that. None = native model, centred
    # by ubm.means.
    center_means: Optional[np.ndarray] = None  # (C, D)

    @property
    def ivector_dim(self) -> int:
        return self.T.shape[2]

    def save_reference(self, path, meta: Optional[dict] = None):
        """Reference ``IvectorExtractorModel`` zip (Kaldi-binary
        final.ie/final.dubm/plda; reference ``models.py:814-929``)."""
        from montreal_forced_aligner_tpu_torch.ivector.kaldi_model import (
            save_reference_archive,
        )

        return save_reference_archive(self, path, meta=meta)

    def save(self, path) -> None:
        """``.ivector``/``.zip`` paths get the reference archive form (a
        drop-in for reference tooling); other paths the compact npz,
        written at exactly ``path``."""
        if Path(path).suffix.lower() in (".ivector", ".zip"):
            self.save_reference(path)
            return
        arrays = dict(
            weights=self.ubm.weights,
            means=self.ubm.means,
            variances=self.ubm.variances,
            T=self.T,
        )
        if self.plda is not None:
            arrays.update(
                plda_mean=self.plda.mean,
                plda_transform=self.plda.transform,
                plda_psi=self.plda.psi,
            )
        with open(path, "wb") as f:
            np.savez_compressed(f, **arrays)

    @classmethod
    def load(cls, path) -> "IvectorExtractor":
        from montreal_forced_aligner_tpu_torch.ivector.kaldi_model import (
            is_reference_archive,
            load_reference_archive,
        )

        if is_reference_archive(path):
            return load_reference_archive(path)
        z = np.load(path)
        plda = None
        if "plda_mean" in z:
            from montreal_forced_aligner_tpu_torch.ivector.plda import Plda

            plda = Plda(
                mean=z["plda_mean"],
                transform=z["plda_transform"],
                psi=z["plda_psi"],
            )
        return cls(
            ubm=DiagUbm(z["weights"], z["means"], z["variances"]),
            T=z["T"],
            plda=plda,
        )


def _utterance_stats(feats, mask, W, gconst, means):
    """Zeroth and centred first-order UBM statistics per utterance, in
    float64.

    feats (B, T, D), mask (B, T); returns gamma (B, C), Xc (B, C, D)."""
    feats = feats.to(torch.float64)
    B, T, D = feats.shape
    x = feats.reshape(B * T, D)
    xx = torch.cat([x, x * x], dim=1)
    ll = xx @ W + gconst[None, :]
    norm = torch.logsumexp(ll, dim=1)
    post = torch.exp(ll - norm[:, None]) * mask.reshape(-1, 1).to(ll.dtype)
    post = post.reshape(B, T, -1)
    gamma = post.sum(dim=1)  # (B, C)
    X = torch.bmm(post.transpose(1, 2), feats)  # (B, C, D)
    Xc = X - gamma[:, :, None] * means[None, :, :]
    return gamma, Xc


def _estep(gamma, Xc, T_sig, TT_sig):
    """Posterior i-vector mean and covariance per utterance.

    T_sig  (C, D, R) = Sigma_c^-1 T_c
    TT_sig (C, R, R) = T_c^T Sigma_c^-1 T_c
    Returns (w_hat (B, R), Linv (B, R, R)). The Cholesky factor is taken
    without its error check (which would wait for the device on every
    call): L = I + sum gamma TT^T is positive definite by construction."""
    B, C = gamma.shape
    R = T_sig.shape[2]
    eye = torch.eye(R, dtype=gamma.dtype, device=gamma.device)
    L = eye[None] + (gamma @ TT_sig.reshape(C, R * R)).reshape(B, R, R)
    rhs = Xc.reshape(B, -1) @ T_sig.reshape(-1, R)  # (B, R)
    chol, _info = torch.linalg.cholesky_ex(L, check_errors=False)
    w_hat = torch.cholesky_solve(rhs[:, :, None], chol)[:, :, 0]
    Linv = torch.cholesky_solve(eye.expand(B, R, R), chol)
    return w_hat, Linv


def _mstep_accumulate(gamma, Xc, w_hat, Linv):
    """Per-batch M-step accumulators:
    A_c = sum_u Xc_u w_u^T                  (C, D, R)
    B_c = sum_u gamma_uc (Linv_u + w w^T)   (C, R, R)"""
    B, C, D = Xc.shape
    R = w_hat.shape[1]
    ww = Linv + w_hat[:, :, None] * w_hat[:, None, :]
    A = (Xc.reshape(B, C * D).T @ w_hat).reshape(C, D, R)
    Bm = (gamma.T @ ww.reshape(B, R * R)).reshape(C, R, R)
    return A, Bm


def _prep_T(ubm: DiagUbm, T: np.ndarray, device, sigma_inv: np.ndarray = None):
    """(T_sig, TT_sig) float64 on ``device``, computed on the host.
    ``sigma_inv`` (C, D, D): full-covariance Sigma^-1 from a Kaldi final.ie
    (``ivector/kaldi_model.py``); None = the UBM's diagonal."""
    if sigma_inv is not None:
        T_sig = np.matmul(sigma_inv, T)
    else:
        inv_var = 1.0 / np.maximum(ubm.variances, 1e-8)  # (C, D)
        T_sig = T * inv_var[:, :, None]
    # a batched BLAS product, where the JAX package's np.einsum loops in C:
    # at C = 256, D = 39, R = 192 this call takes 0.14 s against 1.57 s on
    # an 8-core Intel Xeon, once an EM iteration
    TT_sig = np.matmul(np.swapaxes(T, 1, 2).astype(np.float64), T_sig)
    return (
        torch.from_numpy(np.ascontiguousarray(T_sig, np.float64)).to(device),
        torch.from_numpy(np.ascontiguousarray(TT_sig, np.float64)).to(device),
    )


def _batch_mask(feats, lens):
    Tmax = feats.shape[1]
    lens_t = torch.as_tensor(np.asarray(lens), device=feats.device)
    return torch.arange(Tmax, device=feats.device)[None, :] < lens_t[:, None]


def train_ivector_extractor(
    feature_batches,
    ubm: DiagUbm,
    ivector_dim: int = 192,
    num_iterations: int = 10,
    gaussian_min_count: float = 100.0,
    seed: int = 0,
    device="cuda",
    clock: Optional[PhaseClock] = None,
) -> IvectorExtractor:
    """EM training of the T-matrix over utterance batches
    [(feats (B, T, D) on ``device``, lens (B,))]. ``clock`` charges the
    statistics to "stats" and the iterations to "em"."""
    dev = resolve_device(device)
    clock = clock or PhaseClock(dev)
    rng = np.random.RandomState(seed)
    C, D = ubm.means.shape
    R = ivector_dim
    T = (rng.randn(C, D, R) * 0.1).astype(np.float32)
    W, gconst = ubm.device_params(dev)
    means = torch.from_numpy(np.asarray(ubm.means, np.float64)).to(dev)

    with clock("stats"):
        # per-utterance UBM statistics, once (they do not change)
        stats = [
            _utterance_stats(feats.to(dev), _batch_mask(feats.to(dev), lens), W,
                             gconst, means)
            for feats, lens in feature_batches
        ]
        # component occupancy is iteration-independent: one (C,) fetch a batch
        total_gamma = np.zeros(C)
        for gamma, _Xc in stats:
            total_gamma += gamma.sum(dim=0).cpu().numpy()
    with clock("em"):
        T = _em_iterations(stats, total_gamma, ubm, T, num_iterations,
                           gaussian_min_count, dev)
    return IvectorExtractor(ubm=ubm, T=T)


def _em_iterations(stats, total_gamma, ubm, T, num_iterations,
                   gaussian_min_count, dev):
    """The T-matrix's EM iterations: E-step and accumulators on ``dev``,
    the per-component solves in float64 on the host."""
    C, _D, R = T.shape
    for it in range(num_iterations):
        T_sig, TT_sig = _prep_T(ubm, T, dev)
        # the accumulators stay on the device across batches (the (C, R, R)
        # one alone is 37.7 MB at C = 256, R = 192); one fetch an iteration
        acc = StreamingTreeSum()
        for gamma, Xc in stats:
            w_hat, Linv = _estep(gamma, Xc, T_sig, TT_sig)
            A_b, B_b = _mstep_accumulate(gamma, Xc, w_hat, Linv)
            acc.add((A_b, B_b, (w_hat * w_hat).sum()))
        A, Bm, aux = fetch_all(list(acc.total()))
        A = np.asarray(A, np.float64)
        Bm = np.asarray(Bm, np.float64)
        for c in range(C):
            if total_gamma[c] < gaussian_min_count:
                continue
            T[c] = np.linalg.solve(Bm[c] + 1e-4 * np.eye(R), A[c].T).T.astype(
                np.float32
            )
        logger.info("ivector EM iter %d: mean |w|^2 = %.4f", it, float(aux))
    return T


def extract_ivectors(extractor: IvectorExtractor, feature_batches,
                     device="cuda") -> np.ndarray:
    """Posterior-mean i-vectors for every utterance: (N, R), in batch
    order."""
    dev = resolve_device(device)
    W, gconst = extractor.ubm.device_params(dev)
    centering = extractor.center_means
    if centering is None:
        centering = extractor.ubm.means
    means = torch.from_numpy(np.asarray(centering, np.float64)).to(dev)
    T_sig, TT_sig = _prep_T(extractor.ubm, extractor.T, dev, extractor.sigma_inv)
    out = []
    for feats, lens in feature_batches:
        feats = feats.to(dev)
        gamma, Xc = _utterance_stats(feats, _batch_mask(feats, lens), W, gconst,
                                     means)
        w_hat, _Linv = _estep(gamma, Xc, T_sig, TT_sig)
        out.append(w_hat)
    return np.concatenate([w.cpu().numpy() for w in out], axis=0)


def apply_utterance_cmn(feature_batches):
    """Per-utterance cepstral mean normalisation.

    Not on the production feature path: the i-vector pipeline uses
    :func:`~montreal_forced_aligner_tpu_torch.ops.feats.sliding_cmn` (Kaldi
    ``apply-cmvn-sliding``). Kept as the simple normalisation for synthetic
    features and API users who want utterance CMN."""
    out = []
    for feats, lens in feature_batches:
        mask = _batch_mask(feats, lens)[..., None]
        lens_t = torch.as_tensor(np.asarray(lens), device=feats.device)
        denom = torch.clamp(lens_t[:, None].to(torch.float32), min=1.0)
        zero = torch.zeros((), dtype=feats.dtype, device=feats.device)
        mean = torch.where(mask, feats, zero).sum(dim=1) / denom
        out.append((feats - mean[:, None, :], lens))
    return out


def length_normalize(ivectors: np.ndarray) -> np.ndarray:
    """Scale to sqrt(dim) norm (Kaldi ``ivector-normalize-length``)."""
    norms = np.linalg.norm(ivectors, axis=1, keepdims=True)
    dim = ivectors.shape[1]
    return ivectors / np.maximum(norms, 1e-10) * np.sqrt(dim)
