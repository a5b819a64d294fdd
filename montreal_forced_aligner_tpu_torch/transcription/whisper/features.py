"""Whisper's log-mel front end.

Counterpart of ``WhisperFeatureExtractor`` (``transformers``
``models/whisper/feature_extraction_whisper.py``: ``__call__`` pads or
truncates the samples to ``n_samples``, and ``_torch_extract_fbank_features``
makes the features). Samples arrive int16-scaled and are divided by 32768,
as the JAX package's wrapper divides them before its processor. Audio past
``n_samples`` (30 s at the published settings) is cut, as the processor
cuts it by default: one utterance is one 30-second window, and the rest of
a longer utterance is not transcribed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class FeatureSettings:
    """``preprocessor_config.json``'s front-end settings."""

    feature_size: int = 80
    sampling_rate: int = 16000
    hop_length: int = 160
    chunk_length: int = 30
    n_fft: int = 400
    padding_value: float = 0.0

    @classmethod
    def from_preprocessor(cls, data: dict) -> "FeatureSettings":
        if float(data.get("dither", 0.0)) != 0.0:
            raise NotImplementedError(
                "a Whisper front end with dither is random; only dither 0 "
                "(the published setting) is supported")
        return cls(**{k: data[k] for k in cls.__dataclass_fields__ if k in data})

    @property
    def n_samples(self) -> int:
        return self.chunk_length * self.sampling_rate


def _hertz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney's mel scale: linear below 1 kHz, logarithmic above."""
    mels = 3.0 * freq / 200.0
    log_region = freq >= 1000.0
    mels[log_region] = 15.0 + np.log(freq[log_region] / 1000.0) * (27.0 / np.log(6.4))
    return mels


def _mel_to_hertz(mels: np.ndarray) -> np.ndarray:
    freq = 200.0 * mels / 3.0
    log_region = mels >= 15.0
    freq[log_region] = 1000.0 * np.exp(np.log(6.4) / 27.0 * (mels[log_region] - 15.0))
    return freq


def mel_filters(num_mel_filters: int, n_fft: int = 400, sampling_rate: int = 16000,
                min_frequency: float = 0.0, max_frequency: float = 8000.0
                ) -> np.ndarray:
    """(1 + n_fft // 2, num_mel_filters) float64 triangular filters on the
    Slaney scale with Slaney's area normalisation (``mel_filter_bank(...,
    norm="slaney", mel_scale="slaney")``)."""
    num_bins = 1 + n_fft // 2
    mel_freqs = np.linspace(_hertz_to_mel(np.array([min_frequency]))[0],
                            _hertz_to_mel(np.array([max_frequency]))[0],
                            num_mel_filters + 2)
    filter_freqs = _mel_to_hertz(mel_freqs)
    fft_freqs = np.linspace(0, sampling_rate // 2, num_bins)
    filter_diff = np.diff(filter_freqs)
    slopes = filter_freqs[None, :] - fft_freqs[:, None]
    down = -slopes[:, :-2] / filter_diff[:-1]
    up = slopes[:, 2:] / filter_diff[1:]
    filters = np.maximum(np.zeros(1), np.minimum(down, up))
    enorm = 2.0 / (filter_freqs[2:num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    return filters * enorm[None, :]


class LogMel:
    """The front end of one checkpoint on one device."""

    def __init__(self, settings: FeatureSettings, device):
        self.settings = settings
        self.device = torch.device(device)
        self.filters = torch.from_numpy(mel_filters(
            settings.feature_size, settings.n_fft, settings.sampling_rate,
        )).to(self.device, torch.float32)
        self.window = torch.hann_window(settings.n_fft, device=self.device)

    def waveform(self, samples: np.ndarray) -> np.ndarray:
        """(n_samples,) float32: int16-scaled samples over 32768, padded with
        ``padding_value`` or cut to ``n_samples``."""
        s = self.settings
        x = np.asarray(samples, dtype=np.float32) / 32768.0
        out = np.full(s.n_samples, s.padding_value, dtype=np.float32)
        n = min(len(x), s.n_samples)
        out[:n] = x[:n]
        return out

    def __call__(self, samples: np.ndarray) -> torch.Tensor:
        """(1, feature_size, n_samples // hop_length) float32 log-mel on
        the device."""
        s = self.settings
        wave = torch.from_numpy(self.waveform(samples)).to(self.device)[None]
        stft = torch.stft(wave, s.n_fft, s.hop_length, window=self.window,
                          return_complex=True)
        magnitudes = stft[..., :-1].abs() ** 2
        mel = self.filters.T @ magnitudes
        log_spec = torch.clamp(mel, min=1e-10).log10()
        peak = log_spec.max(dim=2, keepdim=True)[0].max(dim=1, keepdim=True)[0]
        log_spec = torch.maximum(log_spec, peak - 8.0)
        return (log_spec + 4.0) / 4.0
