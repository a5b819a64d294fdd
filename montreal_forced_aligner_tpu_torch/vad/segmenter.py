"""Voice activity detection (energy and SpeechBrain neural) and segmentation.

Counterpart of ``montreal_forced_aligner_tpu/vad/segmenter.py``
(behavioural spec: reference ``corpus/features.py:379-419,863-895``,
``ComputeVadFunction`` with Kaldi ``compute-vad`` semantics:
``energy_threshold=5.5``, ``energy_mean_scale=0.5``, so a frame is voiced
if its log energy exceeds threshold + mean_scale * the file's mean log
energy; and ``vad/segmenter.py:56``, ``VadSegmenter``: voiced frames merged
into utterance segments under min/max segment lengths and a minimum pause,
defaults from ``vad/models.py:503``). The frame energies run on the device
with the MFCC framing; the thresholds and the merging on the host. The
neural VAD (``SpeechbrainVAD``) needs the speechbrain package.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.device import resolve_device
from montreal_forced_aligner_tpu_torch.io.textgrid import Interval, TextGrid
from montreal_forced_aligner_tpu_torch.ops.mfcc import (
    PAD_LEFT,
    MfccConfig,
    pad_waves_for_mfcc,
)

def _frame_log_energy(waves: torch.Tensor, cfg: MfccConfig, max_frames: int):
    """(B, max_frames) per-frame log energy with the MFCC framing
    (DC-removed, before the window) of reflection-padded waves."""
    waves = waves.to(torch.float32)
    shift, length = cfg.frame_shift, cfg.frame_length
    off = PAD_LEFT + shift // 2 - length // 2
    end = off + (max_frames - 1) * shift + length
    frames = waves[:, off:end].unfold(1, length, shift)  # (B, T, length)
    frames = frames - frames.mean(-1, keepdim=True)
    energy = (frames * frames).sum(-1)
    return torch.log(torch.clamp(energy, min=float(np.finfo(np.float32).tiny)))


def frame_log_energy(wave: np.ndarray, cfg: Optional[MfccConfig] = None,
                     device="cuda") -> np.ndarray:
    """(T,) float32 log energy of each 10 ms frame of one waveform."""
    cfg = cfg or MfccConfig()
    dev = resolve_device(device)
    padded, _lens = pad_waves_for_mfcc([wave], cfg)
    T = cfg.num_frames(len(wave))
    log_e = _frame_log_energy(torch.from_numpy(padded).to(dev), cfg, T)
    return log_e[0, :T].cpu().numpy()


def compute_energy_vad(
    wave: np.ndarray,
    cfg: Optional[MfccConfig] = None,
    energy_threshold: float = 5.5,
    energy_mean_scale: float = 0.5,
    device="cuda",
) -> np.ndarray:
    """Boolean voiced mask per 10 ms frame (Kaldi ``compute-vad``)."""
    log_e = frame_log_energy(wave, cfg, device)
    threshold = energy_threshold + energy_mean_scale * log_e.mean()
    return log_e > threshold


@dataclass
class SegmenterConfig:
    max_segment_length: float = 30.0
    min_segment_length: float = 0.333
    min_pause_duration: float = 0.333
    energy_threshold: float = 5.5
    energy_mean_scale: float = 0.5
    frame_shift: float = 0.01


def segments_from_vad(
    voiced: np.ndarray, config: SegmenterConfig
) -> List[Tuple[float, float]]:
    """Merge voiced frames into segments: close pauses shorter than
    ``min_pause_duration``, drop segments shorter than
    ``min_segment_length``, split segments over ``max_segment_length``."""
    fs = config.frame_shift
    padded = np.concatenate([[False], voiced, [False]])
    starts = np.flatnonzero(~padded[:-1] & padded[1:])
    ends = np.flatnonzero(padded[:-1] & ~padded[1:])
    segs = [(s * fs, e * fs) for s, e in zip(starts, ends)]
    merged: List[Tuple[float, float]] = []
    for s, e in segs:
        if merged and s - merged[-1][1] < config.min_pause_duration:
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    out: List[Tuple[float, float]] = []
    for s, e in merged:
        if e - s < config.min_segment_length:
            continue
        while e - s > config.max_segment_length:
            out.append((s, s + config.max_segment_length))
            s += config.max_segment_length
        out.append((s, e))
    return out


_EXTENSIONS = {
    "long_textgrid": ".TextGrid",
    "short_textgrid": ".TextGrid",
    "json": ".json",
    "csv": ".csv",
}


class VadSegmenter:
    """Segment long audio files into utterances (reference entry point:
    ``mfa create_segments_vad``)."""

    def __init__(self, config: Optional[SegmenterConfig] = None, device="cuda"):
        self.config = config or SegmenterConfig()
        self.device = resolve_device(device)

    def segment_wave(self, wave) -> List[Tuple[float, float]]:
        voiced = compute_energy_vad(
            wave.samples,
            energy_threshold=self.config.energy_threshold,
            energy_mean_scale=self.config.energy_mean_scale,
            device=self.device,
        )
        return segments_from_vad(voiced, self.config)

    def segment_file(self, wav_path) -> List[Tuple[float, float]]:
        from montreal_forced_aligner_tpu_torch.io.wav import read_wave

        return self.segment_wave(read_wave(wav_path))

    def segment_corpus(
        self, corpus_directory, output_directory,
        output_format: str = "long_textgrid",
    ) -> List[Path]:
        """Write one TextGrid (or json/csv, per ``output_format``) per file
        with its detected speech segments, at the file's corpus-relative
        path (``spk0/u1.wav`` -> ``spk0/u1.TextGrid``). The JAX package
        writes every file as its bare stem, so files of the same name in
        two speaker directories overwrite each other."""
        from montreal_forced_aligner_tpu_torch.io.wav import read_wave

        corpus_directory = Path(corpus_directory)
        output_directory = Path(output_directory)
        output_directory.mkdir(parents=True, exist_ok=True)
        out_paths = []
        for wav in sorted(corpus_directory.rglob("*.wav")):
            wave = read_wave(wav)
            segs = self.segment_wave(wave)
            tg = TextGrid()
            tg.xmax = wave.duration
            tg.tiers["segments"] = [Interval(s, e, "speech") for s, e in segs]
            rel = wav.relative_to(corpus_directory)
            out = output_directory / rel.with_suffix(_EXTENSIONS[output_format])
            out.parent.mkdir(parents=True, exist_ok=True)
            if output_format == "json":
                tg.write_json(out)
            elif output_format == "csv":
                tg.write_csv(out, default_speaker="speech")
            else:
                tg.write(out, output_format=output_format)
            out_paths.append(out)
        return out_paths


class SpeechbrainVAD:
    """Neural VAD posteriors from a locally available SpeechBrain VAD
    checkpoint (reference ``MfaVAD``, ``vad/models.py:133``; used by
    ``SpeechbrainVadSegmenter``, ``vad/segmenter.py:328``). Gated on the
    speechbrain package and local weights; the model and the wave sit on
    ``device``, and the frame posteriors, back on the host, are
    thresholded and merged by the same ``segments_from_vad`` as the
    energy VAD's."""

    def __init__(self, model_path, threshold: float = 0.5, device="cuda"):
        self.device = resolve_device(device)
        try:
            from speechbrain.inference.VAD import VAD as _SbVAD
        except ImportError as e:
            raise RuntimeError(
                "speechbrain is not available; neural VAD needs the "
                "speechbrain package and a local checkpoint directory"
            ) from e
        model_path = Path(model_path)
        if not model_path.exists():
            raise FileNotFoundError(
                f"no local SpeechBrain VAD checkpoint at {model_path}"
            )
        self.model = _SbVAD.from_hparams(
            source=str(model_path), savedir=str(model_path),
            run_opts={"device": str(self.device)},
        )
        self.threshold = threshold

    def voiced_frames(
        self, samples: np.ndarray, sample_rate: int = 16000,
        frame_shift: float = 0.01,
    ) -> np.ndarray:
        """Boolean per-frame speech decisions at ``frame_shift`` rate."""
        if sample_rate != 16000:
            from montreal_forced_aligner_tpu_torch.corpus.corpus import _resample
            from montreal_forced_aligner_tpu_torch.io.wav import WaveData

            wd = WaveData(
                samples=np.asarray(samples, dtype=np.float32),
                sample_rate=sample_rate,
                num_channels=1,
                duration=len(samples) / sample_rate,
            )
            samples = _resample(wd, 16000).samples
            sample_rate = 16000
        wav = torch.from_numpy(
            np.asarray(samples, dtype=np.float32) / 32768.0
        ).unsqueeze(0).to(self.device)
        with torch.no_grad():
            probs = self.model.get_speech_prob_chunk(wav).cpu().numpy().reshape(-1)
        n_out = int(len(samples) / sample_rate / frame_shift)
        if len(probs) == 0 or n_out == 0:
            return np.zeros(n_out, dtype=bool)
        idx = np.minimum(
            (np.arange(n_out) * len(probs) // max(n_out, 1)), len(probs) - 1
        )
        return probs[idx] > self.threshold


class SpeechbrainVadSegmenter(VadSegmenter):
    """``VadSegmenter`` with neural frame decisions (reference
    ``SpeechbrainVadSegmenter``, ``vad/segmenter.py:328``)."""

    def __init__(self, model_path, config: Optional[SegmenterConfig] = None,
                 device="cuda"):
        super().__init__(config, device)
        self.vad = SpeechbrainVAD(model_path, device=self.device)

    def segment_wave(self, wave) -> List[Tuple[float, float]]:
        voiced = self.vad.voiced_frames(
            wave.samples, wave.sample_rate, self.config.frame_shift
        )
        return segments_from_vad(voiced, self.config)
