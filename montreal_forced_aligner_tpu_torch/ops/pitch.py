"""Pitch tracking (Kaldi-pitch-style NCCF + Viterbi lag smoothing), in
PyTorch.

Counterpart of ``montreal_forced_aligner_tpu/ops/pitch.py`` (reference
``kalpy.feat.pitch.PitchComputer``, ``compute-kaldi-pitch``; options
``corpus/features.py:823-861``: f0 range 50-800 Hz, ``penalty_factor=0.1``,
``delta_pitch=0.005``; output features selected from {pov,
normalized-log-pitch, delta-pitch}). The same four steps:

1. downsample to 4 kHz (host numpy),
2. NCCF over candidate lags for every frame, on ``device``: the frames of
   all lags come from one gather, then one float32 correlation per lag,
   ``num / sqrt(e1 * e2 + ballast^2)``,
3. Viterbi over the lag trellis with an octave-jump cost, a max-plus loop
   over frames on ``device`` (ties go to the first candidate, as
   ``jnp.argmax`` breaks them), backtraced on the host,
4. POV (probability-of-voicing) and normalized log-pitch features (host
   numpy).

Each row's pitch is its own: ``compute_pitch_batch`` returns for row
``b``, over its ``frame_counts[b]`` frames, what it returns for that row
alone in a batch of one, whatever the other rows and ``max_frames`` are.
The NCCF clamps a row's samples at its own end, the Viterbi keeps a row's
scores at its last frame and backtraces it from there, and delta-pitch
reads nothing past it. (The JAX package clamps at the padded buffer's end
and backtraces every row from the batch's last frame, so there a row's
pitch depends on its batch; in a batch of one the two agree.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class PitchConfig:
    sample_rate: int = 16000
    resample_rate: int = 4000
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 800.0
    penalty_factor: float = 0.1
    delta_pitch: float = 0.005
    nccf_ballast: float = 7000.0
    soft_min_f0: float = 10.0
    add_pov_feature: bool = True
    add_normalized_log_pitch: bool = True
    add_delta_pitch: bool = True

    @property
    def lags(self) -> np.ndarray:
        min_lag = int(np.floor(self.resample_rate / self.max_f0))
        max_lag = int(np.ceil(self.resample_rate / self.min_f0))
        return np.arange(min_lag, max_lag + 1, dtype=np.int32)

    @property
    def num_feature_dims(self) -> int:
        return int(self.add_pov_feature) + int(self.add_normalized_log_pitch) + int(
            self.add_delta_pitch
        )


def _resample_batch(waves: np.ndarray, lengths: np.ndarray, cfg: PitchConfig):
    """Simple decimating low-pass resample to 4 kHz (host numpy)."""
    factor = cfg.sample_rate // cfg.resample_rate
    # box low-pass then decimate (adequate for F0 < 800 Hz)
    kernel = np.ones(factor, dtype=np.float32) / factor
    out = []
    for b in range(waves.shape[0]):
        x = waves[b, : int(lengths[b])].astype(np.float32)
        sm = np.convolve(x, kernel, mode="same")
        out.append(sm[::factor])
    new_lengths = np.array([len(o) for o in out], dtype=np.int32)
    L = max((len(o) for o in out), default=0)
    padded = np.zeros((len(out), L), dtype=np.float32)
    for b, o in enumerate(out):
        padded[b, : len(o)] = o
    return padded, new_lengths


def _nccf(
    waves: torch.Tensor, lengths: torch.Tensor, window: int, shift: int,
    max_frames: int, max_lag: int, ballast: float,
) -> torch.Tensor:
    """NCCF(t, lag) for all frames/lags: (B, T, max_lag + 1) float32 (lag 0
    unused). Frame t at lag l reads samples t*shift + l + k, k < window, of
    its row, clamped to the row's last sample ``lengths[b] - 1`` (so a row
    reads what it reads alone, whatever it is padded to)."""
    B, L = waves.shape
    dev = waves.device
    waves = waves.to(torch.float32)
    starts = torch.arange(max_frames, device=dev) * shift
    idx = torch.clamp(
        starts[:, None] + torch.arange(window + max_lag, device=dev)[None, :],
        0, L - 1,
    )
    ext = waves[:, idx]  # (B, T, window + max_lag)
    last = (lengths.to(device=dev, dtype=torch.long) - 1).clamp(min=0)
    edge = waves.gather(1, last[:, None])  # (B, 1): each row's last sample
    ext = torch.where(idx[None] > last[:, None, None], edge[:, :, None], ext)
    base = ext[..., :window]
    base = base - base.mean(dim=-1, keepdim=True)
    e1 = torch.sum(base * base, dim=-1)  # (B, T)
    outs = [torch.zeros((B, max_frames), dtype=torch.float32, device=dev)]
    for lag in range(1, max_lag + 1):
        other = ext[..., lag : lag + window]
        other = other - other.mean(dim=-1, keepdim=True)
        e2 = torch.sum(other * other, dim=-1)
        num = torch.sum(base * other, dim=-1)
        outs.append(num / torch.sqrt(e1 * e2 + ballast**2))
    return torch.stack(outs, dim=-1)


def _first_argmax(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, index of its first occurrence) along ``dim``: the tie rule of
    ``jnp.argmax``, made explicit so no device's reduction order matters."""
    best = x.max(dim=dim, keepdim=True).values
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    pos = torch.arange(n, device=x.device).reshape(shape)
    first = torch.where(x == best, pos, n).min(dim=dim).values
    return best.squeeze(dim), first


def _viterbi_lags(nccf_sel: torch.Tensor, log_lags: torch.Tensor, penalty: float,
                  num_lags: int, frame_counts: np.ndarray) -> np.ndarray:
    """Max-plus DP over lag candidates with octave-jump penalty:
    score[t, l] = nccf[t, l] - penalty * (log lag_l - log lag_prev)^2.
    One step a frame for the whole batch. Each row's alpha is kept at its
    own last frame ``frame_counts[b] - 1`` and its backtrace starts there
    (the steps past it run but are never read; the path past it repeats
    that frame's lag). Returns the (B, T) int32 lag-index path on the
    host."""
    B, T, D = nccf_sel.shape
    dev = nccf_sel.device
    trans = -penalty * (log_lags[:, None] - log_lags[None, :]) ** 2  # (D, D)
    last = np.asarray(frame_counts, np.int64) - 1
    ending = {int(t): torch.from_numpy(np.flatnonzero(last == t)).to(dev)
              for t in np.unique(last) if t > 0}
    alpha = nccf_sel[:, 0, :]
    final = alpha.clone()  # each row's alpha at its last frame
    bps = []
    for t in range(1, T):
        cand = alpha[:, :, None] + trans[None, :, :]
        best, bp = _first_argmax(cand, 1)
        alpha = best + nccf_sel[:, t, :]
        bps.append(bp.to(torch.int32))
        if t in ending:
            final[ending[t]] = alpha[ending[t]]
    _, best_T = _first_argmax(final, 1)
    state = best_T.cpu().numpy().astype(np.int32)
    path = np.empty((B, T), np.int32)
    path[:, T - 1] = state
    if bps:
        bp_host = torch.stack(bps).cpu().numpy()  # (T - 1, B, D)
        rows = np.arange(B)
        for t in range(T - 2, -1, -1):
            state = np.where(t < last, bp_host[t, rows, state], state)
            path[:, t] = state
    return path


def compute_pitch_batch(
    waves: np.ndarray,  # (B, L) int16-scaled float at cfg.sample_rate
    lengths: np.ndarray,
    cfg: PitchConfig = PitchConfig(),
    max_frames: Optional[int] = None,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Pitch features per 10 ms frame: (B, T, n_dims), frame counts (B,),
    host numpy; the NCCF and the lag Viterbi run on ``device``.

    Dims in order: [pov_feature, normalized_log_pitch, delta_pitch]
    (subset per config), matching the reference's pasted pitch features.
    """
    dev = torch.device(device)
    ds, ds_len = _resample_batch(np.asarray(waves), lengths, cfg)
    shift = int(cfg.resample_rate * cfg.frame_shift_ms / 1000)
    window = int(cfg.resample_rate * cfg.frame_length_ms / 1000)
    frame_counts = np.maximum((ds_len - window) // shift + 1, 1)
    # every row runs to its own end, also where ``max_frames`` cuts it
    T_out = int(frame_counts.max()) if max_frames is None else max_frames
    T = max(T_out, int(frame_counts.max()))
    lags = cfg.lags
    max_lag = int(lags.max())
    nccf = _nccf(
        torch.from_numpy(ds).to(dev), torch.from_numpy(ds_len).to(dev), window,
        shift, T, max_lag, cfg.nccf_ballast,
    )  # (B, T, max_lag+1)
    nccf_sel = nccf[:, :, torch.from_numpy(lags).long().to(dev)].cpu().numpy()
    # soft-min-f0: discourage long lags so subharmonics (octave-down errors)
    # lose ties against the true period (Kaldi's soft_min_f0 device)
    lag_weight = 1.0 - cfg.soft_min_f0 * lags / cfg.resample_rate
    nccf_adj = torch.from_numpy(
        (nccf_sel * lag_weight[None, None, :]).astype(np.float32)
    ).to(dev)
    log_lags = torch.from_numpy(
        np.log(lags.astype(np.float64)).astype(np.float32)
    ).to(dev)
    path = _viterbi_lags(nccf_adj, log_lags, cfg.penalty_factor, len(lags),
                         frame_counts)
    nccf_best = np.take_along_axis(nccf_sel, path[:, :, None], axis=2)[:, :, 0]
    f0 = cfg.resample_rate / lags[path]  # (B, T)

    # POV mapping (Kaldi's NccfToPovFeature: l = log(p/(1-p)) approximation)
    c = np.clip(nccf_best, -1.0, 1.0)
    ndash = np.abs(c)
    pov = -5.2 + 5.4 * np.exp(7.5 * (ndash - 1)) + 4.8 * ndash - 2.0 * np.exp(
        -10.0 * ndash
    ) + 4.2 * np.exp(20.0 * (ndash - 1))
    pov_feature = 2.0 * (1.0 / (1.0 + np.exp(-pov))) - 1.0

    log_pitch = np.log(np.maximum(f0, 1e-3))
    feats = []
    mask = np.arange(T)[None, :] < frame_counts[:, None]
    if cfg.add_pov_feature:
        feats.append(pov_feature)
    if cfg.add_normalized_log_pitch:
        # mean-subtracted log pitch weighted by POV (approximates Kaldi's
        # online POV-weighted mean normalization over the utterance); each
        # row's sums run over its own frames, in the order they run alone
        w = (pov_feature + 1.0) / 2.0 + 1e-3
        mean = np.array([(log_pitch[b, :n] * w[b, :n]).sum() / w[b, :n].sum()
                         for b, n in enumerate(frame_counts)])
        feats.append(log_pitch - mean[:, None])
    if cfg.add_delta_pitch:
        # central difference, 0 at a row's first and last frame: it reads
        # no frame at or past the row's end
        d = np.zeros_like(log_pitch)
        d[:, 1:-1] = np.where(mask[:, 2:],
                              (log_pitch[:, 2:] - log_pitch[:, :-2]) / 2.0, 0.0)
        feats.append(d)
    out = np.stack(feats, axis=-1).astype(np.float32)
    out[~mask] = 0.0
    return out[:, :T_out], frame_counts.astype(np.int32)


def pitch_for_mfcc_frames(
    waves, lengths, mfcc_frame_counts, T_mfcc: int,
    cfg: Optional[PitchConfig] = None,
    device="cuda",
) -> np.ndarray:
    """Pitch features padded/extended to the MFCC frame grid (B, T_mfcc, P):
    the pitch frame count (snip-edges framing at 4 kHz) can fall short of the
    MFCC count; trailing frames repeat the last voiced estimate (the
    reference pastes archives of equal length after kalpy length
    reconciliation)."""
    cfg = cfg or PitchConfig()
    feats, counts = compute_pitch_batch(waves, lengths, cfg, device=device)
    B, T_p, P = feats.shape
    out = np.zeros((B, T_mfcc, P), np.float32)
    for b in range(B):
        n = min(int(counts[b]), T_mfcc, T_p)
        out[b, :n] = feats[b, :n]
        want = min(int(mfcc_frame_counts[b]), T_mfcc)
        if n > 0 and want > n:
            out[b, n:want] = feats[b, n - 1]
    return out
