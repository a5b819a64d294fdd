"""The one generator of every traffic mix: a pool of utterances cut into
jobs, each a corpus directory (``spk/utt.wav`` + ``utt.lab``), from a mix's
data file (``traffic/<mix>.json``) and the run's seed.

The work is the mix's alone: the utterance lengths and what is said
(words) are drawn once from its ``size_seed``, so every run seed gives the
same lengths, speakers, transcripts and jobs in the same order, and the
run's seed draws only the audio (noise plus three tones an utterance, made
on the device in one pass a job). A transcript's words decide how much of
the graph compiler's caches a job meets, so a seed that drew them would
change the work: on an H100 machine, one seed's window ran 351 and 364
audio-s/s in two runs where others ran 416-510.

A job is planned whole (its sizes, paths and words) when the pool is
made, and its files are written only when :meth:`Job.prepare` is first
called, so a run writes the jobs its window reaches and no others."""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import numpy as np
import torch

TONES_HZ = (220.0, 440.0, 880.0, 1760.0)
NOISE_AMPLITUDE = 800.0
TONE_AMPLITUDE = 2000.0


@dataclass
class Utterance:
    speaker: str
    name: str
    seconds: float
    words: List[str]
    path: Path  # the .wav


@dataclass
class Job:
    index: int
    directory: Path
    utterances: List[Utterance] = field(default_factory=list)
    sample_rate: int = 16000
    audio_seed: int = 0
    device: object = None
    prepared: bool = False

    @property
    def audio_s(self) -> float:
        return float(sum(u.seconds for u in self.utterances))

    def prepare(self) -> "Job":
        """Write the job's corpus (``spk/utt.wav`` + ``utt.lab``), once."""
        if not self.prepared:
            secs = np.array([u.seconds for u in self.utterances])
            waves = synthesize(secs, self.audio_seed, self.sample_rate, self.device)
            for u, wave in zip(self.utterances, waves):
                u.path.parent.mkdir(parents=True, exist_ok=True)
                write_wave(u.path, wave, self.sample_rate)
                u.path.with_suffix(".lab").write_text(" ".join(u.words))
            self.prepared = True
        return self


def lengths(traffic: dict) -> np.ndarray:
    """Every utterance's length in seconds, in pool order (whole samples)."""
    spec = traffic["length_s"]
    n = traffic["speakers"] * traffic["utterances_per_speaker"]
    rng = np.random.default_rng(traffic["size_seed"])
    if spec["dist"] == "lognormal":
        # mean and sigma of the lengths' logarithm chosen so that the
        # lengths' own mean is spec["mean"]
        mu = np.log(spec["mean"]) - 0.5 * spec["sigma"] ** 2
        x = rng.lognormal(mu, spec["sigma"], n)
    elif spec["dist"] == "uniform":
        x = rng.uniform(spec["min"], spec["max"], n)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    x = np.clip(x, spec["min"], spec["max"])
    sr = traffic["sample_rate"]
    return np.round(x * sr) / sr


def zipf_cdf(n: int, s: float) -> np.ndarray:
    """The cumulative probabilities of ranks 1..n, each proportional to
    rank^-s."""
    p = 1.0 / np.arange(1, n + 1) ** s
    return np.cumsum(p / p.sum())


def zipf_words(words: List[str], count: int, cdf: np.ndarray, rng) -> List[str]:
    """``count`` words drawn by :func:`zipf_cdf`'s ranks."""
    idx = np.minimum(np.searchsorted(cdf, rng.random(count), side="right"), len(words) - 1)
    return [words[i] for i in idx]


def write_wave(path: Path, pcm: np.ndarray, sample_rate: int) -> None:
    """16-bit mono PCM WAV."""
    data = np.ascontiguousarray(pcm, "<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                      2 * sample_rate, 2, 16))
        f.write(b"data" + struct.pack("<I", len(data)) + data)


def read_wave(path: Path) -> np.ndarray:
    """The int16 samples of a file :func:`write_wave` wrote."""
    raw = Path(path).read_bytes()
    n = struct.unpack("<I", raw[40:44])[0]
    return np.frombuffer(raw[44:44 + n], "<i2")


def synthesize(seconds: np.ndarray, seed: int, sample_rate: int, device) -> List[np.ndarray]:
    """int16 waves of the given lengths: Gaussian noise plus three of
    :data:`TONES_HZ` at random phases each, drawn on ``device`` from
    ``seed`` in one pass."""
    n = np.round(seconds * sample_rate).astype(np.int64)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    k = len(n)
    rng = np.random.default_rng([int(seed), 1])
    tones = np.stack([rng.choice(len(TONES_HZ), 3, replace=False) for _ in range(k)])
    freq = torch.tensor(np.asarray(TONES_HZ)[tones], dtype=torch.float64, device=device)
    phase = torch.tensor(rng.random((k, 3)), dtype=torch.float64, device=device)
    total = int(n.sum())
    counts = torch.tensor(n, device=device)
    utt = torch.repeat_interleave(torch.arange(k, device=device), counts)
    starts = torch.cumsum(counts, 0) - counts
    t = (torch.arange(total, device=device) - starts[utt]).to(torch.float64) / sample_rate
    wave = torch.randn(total, generator=gen, device=device, dtype=torch.float32) * NOISE_AMPLITUDE
    for j in range(3):
        wave += (TONE_AMPLITUDE * torch.sin(2 * np.pi * freq[utt, j] * t + phase[utt, j])
                 ).to(torch.float32)
    pcm = torch.clamp(torch.round(wave), -32768, 32767).to(torch.int16).cpu().numpy()
    return np.split(pcm, np.cumsum(n)[:-1])


def make_jobs(traffic: dict, words: List[str], seed: int, out_dir: Path, device) -> List[Job]:
    """The mix's pool planned as corpus directories under ``out_dir``, one
    a job: the pool's speakers in order, ``speakers / jobs`` to a job."""
    n_spk, n_jobs = traffic["speakers"], traffic["jobs"]
    if n_spk % n_jobs:
        raise ValueError(f"{n_spk} speakers do not split into {n_jobs} jobs")
    per_job = n_spk // n_jobs * traffic["utterances_per_speaker"]
    secs = lengths(traffic)
    if traffic.get("balance_jobs"):
        secs = balanced(secs, n_jobs, traffic.get("job_seconds_cap", np.inf))
    rng = np.random.default_rng([traffic["size_seed"], 3])
    cdf = zipf_cdf(len(words), traffic["zipf_s"])
    return [_job(traffic, j, secs[j * per_job:(j + 1) * per_job], j * per_job, words, cdf,
                 rng, seed * 1000 + j, Path(out_dir) / f"job{j:02d}", device)
            for j in range(n_jobs)]


def balanced(secs: np.ndarray, n_jobs: int, cap: float = np.inf) -> np.ndarray:
    """The lengths reordered so that each consecutive run of ``len(secs) /
    n_jobs`` holds about the same audio (counted up to ``cap`` an
    utterance): longest first, each to the job with the least so far."""
    per = len(secs) // n_jobs
    jobs, totals = [[] for _ in range(n_jobs)], np.zeros(n_jobs)
    for i in np.argsort(-np.minimum(secs, cap), kind="stable"):
        open_ = [j for j in range(n_jobs) if len(jobs[j]) < per]
        j = min(open_, key=lambda k: totals[k])
        jobs[j].append(secs[i])
        totals[j] += min(secs[i], cap)
    return np.concatenate([np.asarray(j) for j in jobs])


def make_warmup(traffic: dict, words: List[str], seed: int, out_dir: Path, device) -> Job:
    """A job for the set-up's warm-up, apart from the window's jobs: the
    first ``warmup_speakers`` speakers' sizes, other words and audio;
    written at once."""
    per = traffic["utterances_per_speaker"]
    n = traffic["warmup_speakers"] * per
    rng = np.random.default_rng([traffic["size_seed"], 2])
    cdf = zipf_cdf(len(words), traffic["zipf_s"])
    return _job(traffic, -1, lengths(traffic)[:n], 0, words, cdf, rng, seed * 1000 + 999,
                Path(out_dir) / "warmup", device, prefix="w").prepare()


def _job(traffic, index, secs, first, words, cdf, rng, audio_seed, directory, device,
         prefix="s") -> Job:
    """One job's plan: utterances ``first``, ``first + 1``, ... of the pool
    with lengths ``secs``, their words drawn now from ``rng``."""
    per, sr = traffic["utterances_per_speaker"], traffic["sample_rate"]
    job = Job(index, Path(directory), sample_rate=sr, audio_seed=audio_seed, device=device)
    for k, s in enumerate(secs):
        i = first + k
        speaker = f"{prefix}{i // per:03d}"
        name = f"{speaker}-u{i % per:03d}"
        count = max(1, int(round(traffic["words_per_s"] * s)))
        text = zipf_words(words, count, cdf, rng)
        path = job.directory / speaker / f"{name}.wav"
        job.utterances.append(Utterance(speaker, name, float(s), text, path))
    return job
