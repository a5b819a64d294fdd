"""Device-resident GMM EM update: MLE re-estimation and Gaussian mixing-up
on the device, with only small host round trips per iteration.

Counterpart of ``montreal_forced_aligner_tpu/ops/device_update.py``. The
model (means_invvars / inv_vars / gconsts) and the accumulators stay on the
device across iterations; per iteration the host fetches only the (P, G)
occupancy (to decide mixing-up) plus a few scalars, and ships back the
(P, G) weights and a compact split schedule.

Semantics are those of the host path (Kaldi ``MleDiagGmmUpdate`` +
``gmm-mixup``; reference call sites ``acoustic_modeling/base.py:769-801``,
``monophone.py:280-296``): the split schedule is computed on the host by
:func:`split_schedule_host`, a verbatim copy of the reference package's
(same sequential argmax-of-weights logic, same numpy RNG stream), so the
same seed gives the same splits, then applied on the device as one scatter
of independent writes.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

M_LOG_2PI = math.log(2.0 * math.pi)


def flatten_W_device(miv: torch.Tensor, iv: torch.Tensor) -> torch.Tensor:
    """(P, G, D) model tensors -> the (2D, P*G) likelihood-matmul layout
    (same layout as ``DiagGmmSet.flatten_for_device``)."""
    P, G, D = miv.shape
    return torch.cat(
        [miv.reshape(P * G, D), -0.5 * iv.reshape(P * G, D)], dim=1
    ).T.contiguous()


def gconsts_device(
    weights: torch.Tensor,  # (P, G)
    miv: torch.Tensor,  # (P, G, D)
    iv: torch.Tensor,  # (P, G, D)
    num_gauss: torch.Tensor,  # (P,)
) -> torch.Tensor:
    """Kaldi gconst (see ``DiagGmmSet.compute_gconsts``), -inf on padding."""
    D = miv.shape[2]
    ivc = torch.clamp(iv, min=1e-37)
    mean2_invvar = torch.sum(miv**2 / ivc, dim=2)
    log_det = torch.sum(torch.log(ivc), dim=2)
    logw = torch.log(weights)  # -inf where weight 0
    g = logw + 0.5 * (-D * M_LOG_2PI + log_det - mean2_invvar)
    pad = torch.arange(miv.shape[1], device=miv.device)[None, :] >= num_gauss[:, None]
    return torch.where(pad, -torch.inf, g).to(torch.float32)


def mle_update_means_vars_device(
    miv: torch.Tensor,  # (P, G, D)
    iv: torch.Tensor,  # (P, G, D)
    occ: torch.Tensor,  # (P, G)
    mean_acc: torch.Tensor,  # (P, G, D)
    var_acc: torch.Tensor,  # (P, G, D)
    min_gaussian_occupancy: float = 10.0,
    min_variance: float = 0.001,
    update_means: bool = True,
    update_vars: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Means/variances part of ``ops.stats.mle_update`` on the device:
    components under the occupancy floor keep their previous parameters.
    Returns the new (means_invvars, inv_vars)."""
    ivc = torch.clamp(iv, min=1e-37)
    old_means = miv / ivc
    old_vars = 1.0 / ivc
    valid = (occ > min_gaussian_occupancy)[:, :, None]
    occ_safe = torch.clamp(occ, min=1e-10)[:, :, None]
    new_means = torch.where(valid, mean_acc / occ_safe, old_means)
    ex2 = var_acc / occ_safe
    new_vars = torch.where(valid, ex2 - new_means**2, old_vars)
    new_vars = torch.clamp(new_vars, min=min_variance)
    if not update_means:
        new_means = old_means
    if not update_vars:
        new_vars = old_vars
    new_iv = 1.0 / new_vars
    return (new_means * new_iv).to(torch.float32), new_iv.to(torch.float32)


def update_weights_host(
    weights: np.ndarray,  # (P, G) current weights
    num_gauss: np.ndarray,  # (P,)
    occ: np.ndarray,  # (P, G) fetched occupancy
    update: bool = True,
) -> np.ndarray:
    """Weights part of ``ops.stats.mle_update`` on host (float64): pdfs with
    zero total occupancy keep their previous weights; padding stays zero."""
    P, G = occ.shape
    occ = occ.astype(np.float64)
    tot = occ.sum(axis=1, keepdims=True)
    if update:
        w = np.where(tot > 0, occ / np.maximum(tot, 1e-10), weights)
    else:
        w = weights.astype(np.float64)
    pad = np.arange(G)[None, :] >= num_gauss[:, None]
    w = np.where(pad, 0.0, w)
    wsum = w.sum(axis=1, keepdims=True)
    return w / np.maximum(wsum, 1e-10)


class SplitSchedule:
    """Host-computed mixing-up plan (see ``apply_split_schedule_scaled_device``)."""

    def __init__(self, weights, num_gauss, pdf_idx, dst_idx, origin_idx,
                 delta, new_max_gauss):
        self.weights = weights  # (P, G_new) float32
        self.num_gauss = num_gauss  # (P,) int32
        self.pdf_idx = pdf_idx
        self.dst_idx = dst_idx
        self.origin_idx = origin_idx
        self.delta = delta
        self.new_max_gauss = int(new_max_gauss)

    @property
    def num_writes(self) -> int:
        return len(self.pdf_idx)


def split_schedule_host(
    weights: np.ndarray,  # (P, G) post-MLE weights (float64 ok)
    num_gauss: np.ndarray,  # (P,)
    occs: np.ndarray,  # (P, G) occupancy used to pick split targets
    target_total: int,
    dim: int,
    perturb_factor: float = 0.01,
    power: float = 0.25,
    min_count: float = 20.0,
    seed: int = 0,
) -> Optional[SplitSchedule]:
    """Compute the ``gmm-mixup`` schedule exactly as ``split_gaussians``
    would (same per-pdf target arithmetic, same sequential heaviest-weight
    splits, same ``RandomState(seed)`` draw order), but *symbolically*: each
    component is tracked as (origin slot, accumulated mean offset in units
    of perturb_factor * stddev[origin]) so the device can apply all writes
    in parallel. Returns None when no pdf needs splitting.

    The perturbation is ``perturb_factor * std * randn(D)`` with std taken
    from the component being split; variances are never changed by splits,
    so std always equals the origin component's post-MLE stddev — the chain
    resolves exactly.
    """
    P, G = weights.shape
    occ_pdf = occs.sum(axis=1) if occs.ndim == 2 else occs
    raw = np.maximum(occ_pdf, min_count) ** power
    targets = np.maximum(1, np.floor(raw / raw.sum() * target_total).astype(int))
    targets = np.maximum(targets, num_gauss)
    if not np.any(targets > num_gauss):
        return None
    new_max = int(targets.max())
    new_max = max(int(G), 8, 1 << (new_max - 1).bit_length())

    rng = np.random.RandomState(seed)
    new_weights = np.zeros((P, new_max), dtype=np.float64)
    new_weights[:, :G] = weights
    counts = num_gauss.astype(np.int32).copy()
    pdf_idx: List[int] = []
    dst_idx: List[int] = []
    origin_idx: List[int] = []
    deltas: List[np.ndarray] = []
    # per-pdf symbolic state: slot -> (origin, z-offset) where the final
    # mean is mean[origin] + perturb * std[origin] * z_offset
    for p in range(P):
        n = int(counts[p])
        tgt = int(targets[p])
        if tgt <= n:
            continue
        origin = {g: g for g in range(n)}
        zoff = {g: None for g in range(n)}  # None = untouched
        while n < tgt:
            g = int(np.argmax(new_weights[p, :n]))
            w = new_weights[p, g] / 2.0
            new_weights[p, g] = w
            new_weights[p, n] = w
            z = rng.randn(dim)
            if zoff[g] is None:
                zoff[g] = np.zeros(dim)
            origin[n] = origin[g]
            zoff[n] = zoff[g] - z
            zoff[g] = zoff[g] + z
            n += 1
        counts[p] = n
        for g, z in zoff.items():
            if z is None:
                continue
            pdf_idx.append(p)
            dst_idx.append(g)
            origin_idx.append(origin[g])
            deltas.append(z)
    if not pdf_idx:
        return None
    # the device write applies delta in mean units: perturb * std * z.
    # std is the origin's stddev, unknown on host — encode the z-vector and
    # let the device scale by sqrt(var[origin]) instead.
    return SplitSchedule(
        weights=new_weights.astype(np.float32),
        num_gauss=counts,
        pdf_idx=np.asarray(pdf_idx, np.int32),
        dst_idx=np.asarray(dst_idx, np.int32),
        origin_idx=np.asarray(origin_idx, np.int32),
        delta=np.asarray(deltas, np.float32) * perturb_factor,
        new_max_gauss=new_max,
    )



def apply_split_schedule_device(
    miv: torch.Tensor,  # (P, G, D)
    iv: torch.Tensor,  # (P, G, D)
    weights: torch.Tensor,  # (P, G_new) post-split weights (host-computed)
    num_gauss: torch.Tensor,  # (P,) post-split counts
    pdf_idx: torch.Tensor,  # (M,) pdf of each write
    dst_idx: torch.Tensor,  # (M,) slot written
    origin_idx: torch.Tensor,  # (M,) slot whose pre-split mean/var is read
    delta: torch.Tensor,  # (M, D) float32 mean offset (0 rows = pure copies)
    new_max_gauss: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply a host-computed mixing-up schedule given as mean offsets:
    every affected slot is an independent write ``mean[dst] = mean[origin]
    + delta; var[dst] = var[origin]`` (the host resolved split chains into
    origin + summed offsets, so writes commute). Returns (miv, iv, gconsts)
    grown to ``new_max_gauss``. The training update runs
    :func:`apply_split_schedule_scaled_device`, which scales the draws by
    the origin's deviation on the device."""
    P, G, D = miv.shape
    if new_max_gauss > G:
        pad = new_max_gauss - G
        miv = torch.nn.functional.pad(miv, (0, 0, 0, pad))
        iv = torch.nn.functional.pad(iv, (0, 0, 0, pad), value=1.0)
    ivc = torch.clamp(iv, min=1e-37)
    means = miv / ivc
    variances = 1.0 / ivc
    pdf_idx, dst_idx, origin_idx = (a.long() for a in (pdf_idx, dst_idx, origin_idx))
    src_mean = means[pdf_idx, origin_idx]  # (M, D)
    src_var = variances[pdf_idx, origin_idx]
    means[pdf_idx, dst_idx] = src_mean + delta
    variances[pdf_idx, dst_idx] = src_var
    new_iv = (1.0 / variances).to(torch.float32)
    new_miv = (means * new_iv).to(torch.float32)
    gc = gconsts_device(weights, new_miv, new_iv, num_gauss)
    return new_miv, new_iv, gc


def apply_split_schedule_scaled_device(
    miv: torch.Tensor,
    iv: torch.Tensor,
    weights: torch.Tensor,  # (P, G_new) post-split weights (host-computed)
    num_gauss: torch.Tensor,  # (P,) post-split counts
    pdf_idx: torch.Tensor,  # (M,) pdf of each write
    dst_idx: torch.Tensor,  # (M,) slot written
    origin_idx: torch.Tensor,  # (M,) slot whose pre-split mean/var is read
    z_scaled: torch.Tensor,  # (M, D) perturb_factor * z draws
    new_max_gauss: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply a host-computed mixing-up schedule: every affected slot is an
    independent write ``mean[dst] = mean[origin] + z_scaled * std[origin];
    var[dst] = var[origin]`` (the host resolved split chains, so writes
    commute; repeated writes carry identical values). Returns (miv, iv,
    gconsts) grown to ``new_max_gauss``."""
    P, G, D = miv.shape
    if new_max_gauss > G:
        pad = new_max_gauss - G
        miv = torch.nn.functional.pad(miv, (0, 0, 0, pad))
        iv = torch.nn.functional.pad(iv, (0, 0, 0, pad), value=1.0)
    ivc = torch.clamp(iv, min=1e-37)
    means = miv / ivc
    variances = 1.0 / ivc
    pdf_idx, dst_idx, origin_idx = (a.long() for a in (pdf_idx, dst_idx, origin_idx))
    src_mean = means[pdf_idx, origin_idx]
    src_var = variances[pdf_idx, origin_idx]
    delta = z_scaled * torch.sqrt(src_var)
    means[pdf_idx, dst_idx] = src_mean + delta
    variances[pdf_idx, dst_idx] = src_var
    new_iv = (1.0 / variances).to(torch.float32)
    new_miv = (means * new_iv).to(torch.float32)
    gc = gconsts_device(weights, new_miv, new_iv, num_gauss)
    return new_miv, new_iv, gc


def frame_tids_device(
    state_path: torch.Tensor,  # (B, T) int32
    frame_lengths: torch.Tensor,  # (B,)
    in_src: torch.Tensor,  # (B, S, K)
    in_tid: torch.Tensor,  # (B, S, K)
    final_tid: torch.Tensor,  # (B, S)
) -> torch.Tensor:
    """Per-frame transition-ids on the device (same convention as
    ``ops.viterbi.frame_tids_host``: frame t consumes the arc leaving
    state_path[t]; the last frame takes the final state's exit tid).
    (B, T) int32."""
    B, T = state_path.shape
    K = in_src.shape[2]
    dev = state_path.device
    sp = state_path.long()
    cur = sp[:, 1:]  # (B, T-1) state at frames 1..T-1
    prev = sp[:, :-1]
    idx = cur[:, :, None].expand(B, T - 1, K)
    srcs = torch.gather(in_src, 1, idx)  # (B, T-1, K)
    tids = torch.gather(in_tid, 1, idx)
    match = (srcs == prev[:, :, None]).to(torch.int8)
    k = torch.argmax(match, dim=-1)  # first match, as jnp.argmax
    tid_step = torch.gather(tids, 2, k[:, :, None])[:, :, 0]
    out = torch.zeros((B, T), dtype=torch.int32, device=dev)
    out[:, : T - 1] = tid_step.to(torch.int32)
    fl = frame_lengths.long()
    last = torch.clamp(fl - 1, 0, T - 1)
    last_state = torch.gather(sp, 1, last[:, None])[:, 0]
    ftid = torch.gather(final_tid, 1, last_state[:, None])[:, 0]
    rows = torch.arange(B, device=dev)
    out[rows, last] = torch.where(fl > 0, ftid.to(torch.int32), 0)
    mask = torch.arange(T, device=dev)[None, :] < fl[:, None]
    return torch.where(mask, out, 0)


def masked_feature_moments(
    feats: torch.Tensor,  # (B, T, D)
    frame_lengths: torch.Tensor,  # (B,)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sum (D,), sumsq (D,), n ()) over real frames: the global mean/var
    statistics of a flat start, reduced on the device."""
    B, T, D = feats.shape
    mask = (torch.arange(T, device=feats.device)[None, :]
            < frame_lengths[:, None])[..., None]
    x = torch.where(mask, feats, 0.0)
    return (
        x.sum(dim=(0, 1)),
        (x * x).sum(dim=(0, 1)),
        frame_lengths.sum().to(torch.float32),
    )
