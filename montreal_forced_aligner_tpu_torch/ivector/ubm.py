"""Diagonal universal background model (UBM) training.

Counterpart of ``montreal_forced_aligner_tpu/ivector/ubm.py`` (behavioural
spec: reference ``ivector/trainer.py:105-389``, ``DubmTrainer``:
256-Gaussian diagonal UBM, 20 initialisation iterations with progressive
splitting and 4 full EM iterations, frame subsampling 5). The reference's
Gaussian selection (gselect 30) exists to make CPU E-steps cheap; here the
dense posterior over all components is one (N, 2D) x (2D, G) product, so
the E-step is exact. The M-step, the ``keep`` threshold and the seeded
splits run on the host in numpy, as in the JAX package.

The E-step runs in float64, where the JAX package's runs in float32 (the
TPU has no float64): Kaldi accumulates GMM statistics in double, and on
the 32-utterance, 256-Gaussian check of ``chip_smoke.py`` a float32
E-step's rounding alone moves the trained UBM by about 1e-4 of its largest
value (a float64 one: by about 1e-7 for an input change of 1e-8), so the
card and the CPU would not train the same model.
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.device import resolve_device
from montreal_forced_aligner_tpu_torch.training.base import StreamingTreeSum, fetch_all

logger = logging.getLogger("mfa_tpu")


@dataclass
class DiagUbm:
    """A single large diagonal GMM: (G,) weights, (G, D) means/vars."""

    weights: np.ndarray
    means: np.ndarray
    variances: np.ndarray

    @property
    def num_gauss(self) -> int:
        return len(self.weights)

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    def device_params(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(W (2D, G), gconst (G,)) float64 on ``device``: the log-likelihood
        of frame x under Gaussian g is [x, x*x] @ W[:, g] + gconst[g]."""
        iv = 1.0 / np.maximum(self.variances, 1e-8)
        miv = self.means * iv
        gconst = (
            np.log(np.maximum(self.weights, 1e-20))
            - 0.5
            * (
                self.dim * math.log(2 * math.pi)
                - np.log(iv).sum(axis=1)
                + (self.means * miv).sum(axis=1)
            )
        )
        W = np.concatenate([miv, -0.5 * iv], axis=1).T
        return (
            torch.from_numpy(np.ascontiguousarray(W, np.float64)).to(device),
            torch.from_numpy(np.asarray(gconst, np.float64)).to(device),
        )

    def split(self, target: int, perturb: float = 0.1, seed: int = 0) -> "DiagUbm":
        rng = np.random.RandomState(seed)
        weights = list(self.weights)
        means = list(self.means)
        variances = list(self.variances)
        while len(weights) < target:
            g = int(np.argmax(weights))
            w = weights[g] / 2
            std = np.sqrt(variances[g])
            delta = perturb * std * rng.randn(self.dim)
            weights[g] = w
            weights.append(w)
            means.append(means[g] - delta)
            means[g] = means[g] + delta
            variances.append(variances[g].copy())
        return DiagUbm(np.array(weights), np.stack(means), np.stack(variances))


def _ubm_estep(feats, mask, W, gconst):
    """Posterior-weighted statistics of one frame chunk, feats (N, D), in
    float64: (occupancy (G,), first order (G, D), second order (G, D),
    total log-likelihood ())."""
    feats = feats.to(torch.float64)
    xx = torch.cat([feats, feats * feats], dim=1)  # (N, 2D)
    loglikes = xx @ W + gconst[None, :]  # (N, G)
    norm = torch.logsumexp(loglikes, dim=1)
    zero = torch.zeros((), dtype=feats.dtype, device=feats.device)
    post = torch.where(mask[:, None], torch.exp(loglikes - norm[:, None]), zero)
    occ = post.sum(dim=0)
    mean_acc = post.T @ feats
    var_acc = post.T @ (feats * feats)
    ll = torch.where(mask, norm, zero).sum()
    return occ, mean_acc, var_acc, ll


def _collect_frames(feature_batches, subsample: int = 5) -> np.ndarray:
    """Flatten (feats, lens) batches to one (N, D) host frame matrix, every
    ``subsample``-th frame of each utterance (one fetch per batch)."""
    frames = []
    for feats, lens in feature_batches:
        f = feats.cpu().numpy()
        for row in range(f.shape[0]):
            frames.append(f[row, : int(lens[row]) : subsample])
    return np.concatenate(frames, axis=0)


def train_ubm(
    feature_batches,
    num_gauss: int = 256,
    num_init_iterations: int = 20,
    num_iterations: int = 4,
    subsample: int = 5,
    min_gaussian_weight: float = 1e-4,
    chunk: int = 131072,
    seed: int = 0,
    device="cuda",
) -> DiagUbm:
    """Train a diagonal UBM with progressive splitting + EM, its E-steps on
    ``device``."""
    dev = resolve_device(device)
    frames = _collect_frames(feature_batches, subsample)
    N, D = frames.shape
    logger.info("UBM training on %d frames (dim %d)", N, D)
    mean = frames.mean(axis=0)
    var = np.maximum(frames.var(axis=0), 1e-4)
    ubm = DiagUbm(np.ones(1), mean[None, :], var[None, :])

    # progressive split schedule over the initialisation iterations
    targets = np.unique(
        np.minimum(
            num_gauss,
            np.round(
                np.exp(np.linspace(0, np.log(num_gauss), num_init_iterations + 1))
            ).astype(int),
        )
    )
    schedule = list(targets[1:]) + [num_gauss] * num_iterations

    pad = (-N) % chunk
    frames_p = np.concatenate([frames, np.zeros((pad, D), np.float32)])
    mask_full = np.concatenate([np.ones(N, bool), np.zeros(pad, bool)])
    # the frame chunks go to the card once when they fit the residency
    # budget (override: MFA_TPU_UBM_DEVICE_FRAMES_GB); above it they stream
    # every iteration, so a large corpus does not run out of card memory
    budget_bytes = float(os.environ.get("MFA_TPU_UBM_DEVICE_FRAMES_GB", 2.0)) * (1 << 30)
    resident = frames_p.nbytes <= budget_bytes

    def iter_chunks():
        for lo in range(0, len(frames_p), chunk):
            yield (
                torch.from_numpy(np.ascontiguousarray(frames_p[lo : lo + chunk])).to(dev),
                torch.from_numpy(mask_full[lo : lo + chunk]).to(dev),
            )

    device_chunks = list(iter_chunks()) if resident else None
    if not resident:
        logger.info(
            "UBM frames (%.1f GB) exceed the device-residency budget; "
            "streaming per iteration", frames_p.nbytes / (1 << 30),
        )

    for it, target in enumerate(schedule):
        if target > ubm.num_gauss:
            ubm = ubm.split(target, seed=seed + it)
        W, gconst = ubm.device_params(dev)
        # cross-chunk sums in the pairwise order of the JAX package's
        # StreamingTreeSum; one fetch an iteration
        acc = StreamingTreeSum()
        for f_dev, m_dev in (device_chunks or iter_chunks()):
            acc.add(_ubm_estep(f_dev, m_dev, W, gconst))
        occ, mean_acc, var_acc, total_ll = fetch_all(list(acc.total()))
        occ = np.asarray(occ, np.float64)
        mean_acc = np.asarray(mean_acc, np.float64)
        var_acc = np.asarray(var_acc, np.float64)
        total_ll = float(total_ll)
        # M-step
        keep = occ > max(min_gaussian_weight * N, 2.0)
        occ_k = np.maximum(occ, 1e-10)
        new_means = mean_acc / occ_k[:, None]
        new_vars = np.maximum(var_acc / occ_k[:, None] - new_means**2, 1e-4)
        weights = occ / occ.sum()
        ubm = DiagUbm(
            weights[keep] / weights[keep].sum(),
            new_means[keep],
            new_vars[keep],
        )
        logger.info(
            "UBM iter %d: %d gaussians, loglike/frame %.4f",
            it, ubm.num_gauss, total_ll / N,
        )
    return ubm
