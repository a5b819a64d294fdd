"""Probabilistic LDA for speaker verification/diarization scoring.

Behavioral spec: reference ``ivector/trainer.py:634-662`` (``PldaTrainer``)
and ``diarization/multiprocessing.py:468-515`` (``PldaClassificationFunction``).
Two-covariance PLDA: between-class covariance B and within-class covariance
W estimated from speaker-labelled i-vectors; scoring is the log-likelihood
ratio of same-speaker vs different-speaker hypotheses in the simultaneously
diagonalized space (Kaldi's ``Plda`` formulation).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class Plda:
    mean: np.ndarray  # (D,)
    transform: np.ndarray  # (D, D): simultaneously diagonalizes W (-> I) and B
    psi: np.ndarray  # (D,) between-class variances in transformed space

    @classmethod
    def train(
        cls,
        ivectors: np.ndarray,  # (N, D)
        speaker_ids: Sequence[int],
        num_em_iters: int = 10,
    ) -> "Plda":
        speaker_ids = np.asarray(speaker_ids)
        mean = ivectors.mean(axis=0)
        x = ivectors - mean
        D = x.shape[1]
        speakers = np.unique(speaker_ids)
        # within/between scatter
        W = np.zeros((D, D))
        B = np.zeros((D, D))
        for s in speakers:
            xs = x[speaker_ids == s]
            mu = xs.mean(axis=0)
            W += (xs - mu).T @ (xs - mu)
            B += len(xs) * np.outer(mu, mu)
        n_within = max(len(x) - len(speakers), 1)
        W /= n_within
        B /= max(len(speakers) - 1, 1)
        W += 1e-6 * np.eye(D)
        # simultaneous diagonalization: whiten W, then rotate to diagonalize B
        evals_w, evecs_w = np.linalg.eigh(W)
        whiten = evecs_w / np.sqrt(np.maximum(evals_w, 1e-10))  # (D, D)
        B_w = whiten.T @ B @ whiten
        evals_b, evecs_b = np.linalg.eigh((B_w + B_w.T) / 2)
        order = np.argsort(evals_b)[::-1]
        transform = (whiten @ evecs_b[:, order]).T  # (D, D)
        psi = np.maximum(evals_b[order], 0.0)
        return cls(mean=mean, transform=transform, psi=psi)

    def project(self, ivectors: np.ndarray) -> np.ndarray:
        return (ivectors - self.mean) @ self.transform.T

    def log_likelihood_ratio(
        self, enroll: np.ndarray, test: np.ndarray
    ) -> np.ndarray:
        """LLR score matrix (n_enroll, n_test) for single-example enrollment
        (Kaldi ``Plda::LogLikelihoodRatio`` with n=1)."""
        u = self.project(np.atleast_2d(enroll))  # (E, D)
        v = self.project(np.atleast_2d(test))  # (T, D)
        psi = self.psi
        # same-speaker: test ~ N(psi/(psi+1) * u, I + psi/(psi+1))
        shrink = psi / (psi + 1.0)
        var_same = 1.0 + psi / (psi + 1.0)
        var_diff = 1.0 + psi
        log_det_same = np.sum(np.log(var_same))
        log_det_diff = np.sum(np.log(var_diff))
        scores = np.zeros((len(u), len(v)))
        for i, ui in enumerate(u):
            mean_same = shrink * ui
            d_same = v - mean_same
            ll_same = -0.5 * (
                log_det_same + np.sum(d_same**2 / var_same, axis=1)
            )
            ll_diff = -0.5 * (log_det_diff + np.sum(v**2 / var_diff, axis=1))
            scores[i] = ll_same - ll_diff
        return scores

    def save(self, path) -> None:
        np.savez_compressed(
            path, mean=self.mean, transform=self.transform, psi=self.psi
        )

    @classmethod
    def load(cls, path) -> "Plda":
        z = np.load(path)
        return cls(mean=z["mean"], transform=z["transform"], psi=z["psi"])


def compute_eer(scores: np.ndarray, labels: np.ndarray) -> float:
    """Equal error rate (reference ``ComputeEerFunction``,
    ``diarization/multiprocessing.py:516``)."""
    order = np.argsort(scores)[::-1]
    labels = np.asarray(labels)[order]
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.0
    tp = np.cumsum(labels)
    fp = np.cumsum(1 - labels)
    fnr = 1.0 - tp / n_pos
    fpr = fp / n_neg
    idx = np.argmin(np.abs(fnr - fpr))
    return float((fnr[idx] + fpr[idx]) / 2)
