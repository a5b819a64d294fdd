"""Batched MFCC extraction with Kaldi-compatible semantics, in PyTorch.

Counterpart of ``montreal_forced_aligner_tpu/ops/mfcc.py``: the same
constants (Povey window, mel banks, DCT, lifter), the same host-side
reflection padding and the same per-frame steps, run as one batched tensor
program on whatever device the padded waves live on. Framing is a strided
``unfold``, the spectrum ``torch.fft.rfft``, mel and DCT two float32 matrix
products (TF32 is off package-wide, so they run at full float32 precision).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

EPS_F32 = float(np.finfo(np.float32).eps)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def mel_scale(freq):
    return 1127.0 * np.log1p(np.asarray(freq, dtype=np.float64) / 700.0)


def compute_mel_banks(
    num_bins: int, fft_size: int, sample_rate: float, low_freq: float, high_freq: float
) -> np.ndarray:
    """Triangular mel filterbank over rFFT bins, Kaldi-style.

    Returns (num_fft_bins, num_bins) with num_fft_bins = fft_size // 2 (the
    Nyquist bin is excluded, matching Kaldi's MelBanks which only uses bins
    below fft_size/2).
    """
    if high_freq <= 0:
        high_freq = sample_rate / 2 + high_freq
    num_fft_bins = fft_size // 2
    fft_bin_width = sample_rate / fft_size
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bin_freqs = np.arange(num_fft_bins) * fft_bin_width
    bin_mels = mel_scale(bin_freqs)
    banks = np.zeros((num_fft_bins, num_bins), dtype=np.float64)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = left + mel_delta
        right = center + mel_delta
        up = (bin_mels - left) / (center - left)
        down = (right - bin_mels) / (right - center)
        weight = np.minimum(up, down)
        banks[:, b] = np.maximum(weight, 0.0)
    return banks.astype(np.float32)


def compute_dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Kaldi's normalized DCT-II matrix (row 0 = sqrt(1/N))."""
    mat = np.zeros((num_ceps, num_bins), dtype=np.float64)
    mat[0, :] = math.sqrt(1.0 / num_bins)
    n = np.arange(num_bins)
    for k in range(1, num_ceps):
        mat[k, :] = math.sqrt(2.0 / num_bins) * np.cos(
            math.pi * k * (2 * n + 1) / (2.0 * num_bins)
        )
    return mat.astype(np.float32)


def compute_lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    k = np.arange(num_ceps)
    return (1.0 + 0.5 * q * np.sin(math.pi * k / q)).astype(np.float32)


def povey_window(length: int) -> np.ndarray:
    n = np.arange(length)
    hann = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / (length - 1))
    return (hann**0.85).astype(np.float32)


@dataclass(frozen=True)
class MfccConfig:
    sample_rate: int = 16000
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    num_coefficients: int = 13
    num_mel_bins: int = 23
    low_frequency: float = 20.0
    high_frequency: float = 7800.0
    preemphasis: float = 0.97
    cepstral_lifter: float = 22.0
    dither: float = 0.0
    remove_dc_offset: bool = True
    snip_edges: bool = False
    use_energy: bool = False
    raw_energy: bool = True
    energy_floor: float = 0.0

    @property
    def frame_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def frame_length(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def fft_size(self) -> int:
        return _next_pow2(self.frame_length)

    def num_frames(self, num_samples: int) -> int:
        """Frame count (snip_edges=False: round to nearest, Kaldi formula)."""
        if self.snip_edges:
            if num_samples < self.frame_length:
                return 0
            return 1 + (num_samples - self.frame_length) // self.frame_shift
        return (num_samples + self.frame_shift // 2) // self.frame_shift

    def constants(self) -> dict:
        """Precomputed numpy constants shipped to the device program."""
        return dict(
            window=povey_window(self.frame_length),
            mel=compute_mel_banks(
                self.num_mel_bins,
                self.fft_size,
                self.sample_rate,
                self.low_frequency,
                self.high_frequency,
            ),
            dct=compute_dct_matrix(self.num_coefficients, self.num_mel_bins).T,
            lifter=compute_lifter_coeffs(self.num_coefficients, self.cepstral_lifter),
        )


PAD_LEFT = 480  # host-side reflection padding before the signal (3 chunks)
PAD_RIGHT = 640  # right padding incl. reflection room (4 chunks)


def _mfcc_device(
    waves: torch.Tensor,  # (B, PAD_LEFT + L + PAD_RIGHT), reflection-padded
    cfg: MfccConfig,
    max_frames: int,
) -> torch.Tensor:
    """(B, max_frames, num_coefficients) float32 MFCCs on ``waves.device``;
    frames past each utterance's true count are garbage the caller masks."""
    consts = cfg.constants()
    dev = waves.device
    window = torch.from_numpy(consts["window"]).to(dev)
    mel = torch.from_numpy(consts["mel"]).to(dev)  # (fft/2, n_mel)
    dct = torch.from_numpy(np.ascontiguousarray(consts["dct"])).to(dev)
    lifter = torch.from_numpy(consts["lifter"]).to(dev)

    waves = waves.to(torch.float32)
    shift, length = cfg.frame_shift, cfg.frame_length
    # boundary reflection was applied on the host, so frame t reads
    # waves[t*shift + off : +length] with a constant offset
    off = PAD_LEFT + (shift // 2 - length // 2 if not cfg.snip_edges else 0)
    end = off + (max_frames - 1) * shift + length
    if off < 0 or end > waves.shape[1]:
        raise ValueError(
            f"padded waves of {waves.shape[1]} samples cannot hold "
            f"{max_frames} frames"
        )
    frames = waves[:, off:end].unfold(1, length, shift)  # (B, T, length)

    if cfg.remove_dc_offset:
        frames = frames - frames.mean(-1, keepdim=True)
    tiny = float(np.finfo(np.float32).tiny)
    if cfg.use_energy and cfg.raw_energy:
        log_energy = torch.log(torch.clamp((frames * frames).sum(-1), min=tiny))
    if cfg.preemphasis != 0.0:
        prev = torch.cat([frames[..., :1], frames[..., :-1]], -1)
        frames = frames - cfg.preemphasis * prev
    if cfg.use_energy and not cfg.raw_energy:
        log_energy = torch.log(torch.clamp((frames * frames).sum(-1), min=tiny))
    frames = frames * window

    # power spectrum over the first fft_size//2 bins (Kaldi MelBanks range)
    spec = torch.fft.rfft(frames, n=cfg.fft_size, dim=-1)
    power = (spec.real**2 + spec.imag**2)[..., : cfg.fft_size // 2]
    log_mel = torch.log(torch.clamp(power @ mel, min=EPS_F32))
    ceps = (log_mel @ dct) * lifter
    if cfg.use_energy:
        if cfg.energy_floor > 0.0:
            log_energy = torch.clamp(log_energy, min=math.log(cfg.energy_floor))
        ceps[..., 0] = log_energy
    return ceps


def pad_waves_for_mfcc(
    waves: "list[np.ndarray]", cfg: MfccConfig, padded_len: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Assemble a (B, PAD_LEFT + L) batch with per-utterance boundary
    reflection baked in (snip_edges=False semantics: out-of-range sample s
    maps to -s-1 on the left and 2n-1-s on the right).
    """
    lengths = np.array([len(w) for w in waves], dtype=np.int32)
    L = int(lengths.max()) if padded_len is None else padded_len
    shift = cfg.frame_shift
    L = ((L + shift - 1) // shift) * shift  # chunk-align for reshape framing
    right = PAD_RIGHT
    # ship as int16 when lossless (native 16-bit audio): halves the
    # host->device transfer, which dominates on remote-attached TPUs.
    # int16 inputs are lossless by construction; float inputs need the
    # (full-pass) integrality check.
    int16_ok = all(
        w.dtype == np.int16
        or (
            np.all(w == np.round(w))
            and (w.size == 0 or np.abs(w).max() < 32767.5)
        )
        for w in waves
    )
    dtype = np.int16 if int16_ok else np.float32
    out = np.zeros((len(waves), PAD_LEFT + L + right), dtype=dtype)
    for b, w in enumerate(waves):
        n = len(w)
        src = w.astype(dtype, copy=False) if dtype == np.int16 else w
        out[b, PAD_LEFT : PAD_LEFT + n] = src
        refl = min(PAD_LEFT, n)
        out[b, PAD_LEFT - refl : PAD_LEFT] = src[:refl][::-1]
        refl = min(right, n)
        out[b, PAD_LEFT + n : PAD_LEFT + n + refl] = src[n - refl :][::-1]
    return out, lengths
