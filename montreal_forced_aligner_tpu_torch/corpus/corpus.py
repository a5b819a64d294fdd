"""Corpus loading: pair sound files with transcripts.

Behavioral spec: reference ``corpus/classes.py`` (``FileData.parse_file``) and
``corpus/acoustic_corpus.py:1530`` (threaded directory scan). Layouts:

* prosodylab: ``speaker_dir/utt.wav`` + ``utt.lab``/``utt.txt`` (speaker =
  parent directory name)
* TextGrid: ``file.wav`` + ``file.TextGrid`` where each interval tier is a
  speaker and each non-empty interval an utterance

The reference's Postgres/Polars metadata store is replaced by a plain
in-memory table of utterances; features/alignments live in arrays keyed by
utterance index.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from montreal_forced_aligner_tpu_torch import tracing
from montreal_forced_aligner_tpu_torch.io.textgrid import TextGrid
from montreal_forced_aligner_tpu_torch.io.wav import WaveData, read_wave

AUDIO_EXTENSIONS = {".wav", ".flac", ".mp3", ".opus"}
TRANSCRIPT_EXTENSIONS = {".lab", ".txt"}


@dataclass
class Utterance:
    id: int
    speaker: str
    file_path: Path
    file_name: str
    begin: float
    end: Optional[float]  # None = whole file
    channel: int
    text: str
    # filled during processing
    normalized_tokens: Optional[List[str]] = None
    num_samples: int = 0
    num_frames: int = 0

    @property
    def duration(self) -> float:
        return (self.end or 0.0) - self.begin


@dataclass
class Corpus:
    utterances: List[Utterance] = field(default_factory=list)
    speakers: List[str] = field(default_factory=list)
    files: Dict[str, Path] = field(default_factory=dict)

    @property
    def num_utterances(self) -> int:
        return len(self.utterances)

    def subset(self, utterance_ids) -> "Corpus":
        """A new Corpus holding the given utterances (re-numbered 0..n-1);
        speakers are restricted to those present."""
        import dataclasses

        utts = [
            dataclasses.replace(self.utterances[i], id=new_id)
            for new_id, i in enumerate(utterance_ids)
        ]
        speakers = sorted({u.speaker for u in utts})
        return Corpus(utterances=utts, speakers=speakers, files=dict(self.files))

    @property
    def speaker_index(self) -> Dict[str, int]:
        return {s: i for i, s in enumerate(self.speakers)}

    @classmethod
    @tracing.traced("corpus_load")
    def load(
        cls,
        directory,
        speaker_characters=0,
        audio_directory=None,
        require_transcripts=True,
    ) -> "Corpus":
        """Scan a corpus directory.

        ``speaker_characters``: 0 = speaker from directory names (default);
        N > 0 = first N characters of the file name; "prosodylab" = second
        underscore-separated field of the file name (reference
        ``--speaker_characters``, ``corpus/classes.py:26``).
        ``audio_directory``: additional root searched for sound files whose
        transcripts live (by stem) under ``directory`` (reference
        ``--audio_directory``).
        ``require_transcripts``: when False (transcribe/diarize/VAD
        workflows), untranscribed sound files become empty-text
        whole-file utterances instead of raising ``NoTranscriptsError``
        — the reference always creates them (``corpus/acoustic_corpus.py``
        sound-file-only loading); alignment/training keep the hard error
        because they cannot do anything with textless audio.
        """
        directory = Path(directory)
        corpus = cls()
        speakers = set()
        wavs = sorted(
            p
            for ext in AUDIO_EXTENSIONS
            for p in directory.rglob(f"*{ext}")
        )
        transcript_index: Dict[str, Path] = {}
        if audio_directory is not None:
            audio_directory = Path(audio_directory)
            seen = {w.stem for w in wavs}
            wavs += sorted(
                p
                for ext in AUDIO_EXTENSIONS
                for p in audio_directory.rglob(f"*{ext}")
                if p.stem not in seen
            )
            for ext in (".TextGrid", ".textgrid", *TRANSCRIPT_EXTENSIONS):
                for p in directory.rglob(f"*{ext}"):
                    transcript_index.setdefault(p.stem, p)
        if not wavs:
            from montreal_forced_aligner_tpu_torch.exceptions import (
                EmptyCorpusError,
            )

            raise EmptyCorpusError(directory)

        def speaker_from_stem(stem: str, default: str) -> str:
            if speaker_characters in (0, "0", None):
                return default
            if speaker_characters == "prosodylab":
                parts = stem.split("_")
                return parts[1] if len(parts) > 1 else default
            n = int(speaker_characters)
            return stem[:n] if n > 0 else default

        uid = 0
        for wav in wavs:
            uid_before = uid
            stem = wav.stem
            # identical file names under different speaker directories are
            # distinct recordings (reference duplicated-name corpus,
            # tests/conftest.py:352): key them by relative path so neither
            # the metadata nor the TextGrid exports collide
            file_key = stem
            if file_key in corpus.files and corpus.files[file_key] != wav:
                try:
                    file_key = wav.relative_to(directory).with_suffix("").as_posix()
                except ValueError:
                    file_key = f"{wav.parent.name}/{stem}"
            tg_path = None
            lab_path = None
            for ext in (".TextGrid", ".textgrid"):
                cand = wav.with_suffix(ext)
                if cand.exists():
                    tg_path = cand
                    break
            if tg_path is None:
                for ext in TRANSCRIPT_EXTENSIONS:
                    cand = wav.with_suffix(ext)
                    if cand.exists():
                        lab_path = cand
                        break
            if tg_path is None and lab_path is None and stem in transcript_index:
                cand = transcript_index[stem]
                if cand.suffix.lower() == ".textgrid":
                    tg_path = cand
                else:
                    lab_path = cand
            corpus.files[file_key] = wav
            if tg_path is not None:
                tg = TextGrid.read(tg_path)
                # stereo files map the second half of speaker tiers onto
                # channel 1 (reference corpus/classes.py:188-190)
                from montreal_forced_aligner_tpu_torch.io.wav import probe_channels

                num_channels = probe_channels(wav)
                num_tiers = max(len(tg.tiers), 1)
                for tier_index, (tier_name, intervals) in enumerate(
                    tg.tiers.items()
                ):
                    speaker = tier_name.strip() or stem
                    channel = 0
                    if num_channels == 2 and tier_index >= num_tiers / 2:
                        channel = 1
                    for iv in intervals:
                        if not iv.label.strip():
                            continue
                        speakers.add(speaker)
                        corpus.utterances.append(
                            Utterance(
                                id=uid,
                                speaker=speaker,
                                file_path=wav,
                                file_name=file_key,
                                begin=iv.begin,
                                end=iv.end,
                                channel=channel,
                                text=iv.label.strip(),
                            )
                        )
                        uid += 1
            elif lab_path is not None:
                speaker = speaker_from_stem(
                    stem, wav.parent.name if wav.parent != directory else stem
                )
                with open(lab_path, "r", encoding="utf-8") as f:
                    text = f.read().strip()
                if text:
                    speakers.add(speaker)
                    corpus.utterances.append(
                        Utterance(
                            id=uid,
                            speaker=speaker,
                            file_path=wav,
                            file_name=file_key,
                            begin=0.0,
                            end=None,
                            channel=0,
                            text=text,
                        )
                    )
                    uid += 1
            if not require_transcripts and uid == uid_before:
                # untranscribed sound file (no transcript, empty .lab, or
                # all-empty TextGrid tiers): whole-file empty-text
                # utterance so transcribe/diarize/VAD can process it
                # (reference sound-file-only corpus loading)
                speaker = speaker_from_stem(
                    stem, wav.parent.name if wav.parent != directory else stem
                )
                speakers.add(speaker)
                corpus.utterances.append(
                    Utterance(
                        id=uid,
                        speaker=speaker,
                        file_path=wav,
                        file_name=file_key,
                        begin=0.0,
                        end=None,
                        channel=0,
                        text="",
                    )
                )
                uid += 1
        corpus.speakers = sorted(speakers)
        if require_transcripts and wavs and not corpus.utterances:
            from montreal_forced_aligner_tpu_torch.exceptions import (
                NoTranscriptsError,
            )

            raise NoTranscriptsError(directory, len(wavs))
        return corpus

    # -- file pathology audit -------------------------------------------------
    def audit_files(self) -> List[dict]:
        """Per-file health report for validation (reference analyze_setup's
        wav triage, ``validation/corpus_validator.py:77``): unreadable or
        truncated containers, sample-rate mixtures within a speaker, and
        basic metadata (rate/channels/duration). Returns a list of issue
        dicts: {"file", "issue", "detail"}."""
        from montreal_forced_aligner_tpu_torch.io.wav import probe_wave

        issues: List[dict] = []
        meta: Dict[str, dict] = {}
        for key, path in sorted(self.files.items()):
            info = probe_wave(path)
            meta[key] = info
            if info.get("issue"):
                issues.append(
                    {
                        "file": str(path),
                        "issue": info["issue"],
                        "detail": info.get("detail", ""),
                    }
                )
        # sample-rate mixtures within a speaker (per-speaker CMVN/fMLLR
        # statistics assume consistent acoustics)
        by_speaker: Dict[str, Dict[int, List[str]]] = {}
        for utt in self.utterances:
            info = meta.get(utt.file_name)
            if not info or not info.get("sample_rate"):
                continue
            by_speaker.setdefault(utt.speaker, {}).setdefault(
                int(info["sample_rate"]), []
            ).append(utt.file_name)
        for speaker, rates in sorted(by_speaker.items()):
            if len(rates) > 1:
                detail = ", ".join(
                    f"{r} Hz: {sorted(set(fs))[:3]}"
                    for r, fs in sorted(rates.items())
                )
                issues.append(
                    {
                        "file": speaker,
                        "issue": "mixed_sample_rates",
                        "detail": (
                            f"speaker {speaker!r} mixes sample rates "
                            f"({detail}); per-speaker CMVN/fMLLR will "
                            "average across them after resampling"
                        ),
                    }
                )
        # utterance segments past the end of their file
        for utt in self.utterances:
            info = meta.get(utt.file_name)
            if not info or not info.get("duration"):
                continue
            if utt.end is not None and utt.end > info["duration"] + 0.05:
                issues.append(
                    {
                        "file": utt.file_name,
                        "issue": "segment_past_end",
                        "detail": (
                            f"utterance [{utt.begin:.2f}, {utt.end:.2f}] "
                            f"exceeds the file's {info['duration']:.2f}s "
                            "audio (truncated recording or stale "
                            "TextGrid?)"
                        ),
                    }
                )
        return issues

    def load_audio(self, utt: Utterance, native: bool = False):
        return read_wave(
            utt.file_path,
            begin=utt.begin,
            end=utt.end,
            channel=utt.channel,
            native=native,
        )

    def load_audio_parallel(self, target_rate: int, num_workers: int = 8):
        """Decode every utterance's audio with a thread pool, resampled to
        ``target_rate``; returns samples in ``self.utterances`` order.
        16-bit sources that need no resampling stay int16 (the feature
        pipeline converts on device; the narrow dtype halves host copies
        and host->device transfer).

        The reference parallelizes corpus loading over multiprocessing jobs
        (``corpus/base.py`` ``_load_corpus`` + job queues); decode here is
        either file I/O or the native FLAC library (ctypes releases the GIL),
        so threads suffice and avoid pickling the corpus.
        """
        import concurrent.futures

        def one(utt):
            wav = self.load_audio(utt, native=True)
            if wav.sample_rate != target_rate:
                wav = _resample(wav, target_rate)
            return wav.samples

        if num_workers <= 1 or len(self.utterances) <= 1:
            return [one(u) for u in self.utterances]
        with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
            return list(pool.map(one, self.utterances))


def _resample(wav: WaveData, target_rate: int) -> WaveData:
    """Linear-interpolation resample (host; rare path — the reference
    delegates to libsndfile/sox)."""
    ratio = target_rate / wav.sample_rate
    n_out = int(round(len(wav.samples) * ratio))
    x_old = np.arange(len(wav.samples)) / wav.sample_rate
    x_new = np.arange(n_out) / target_rate
    return WaveData(
        samples=np.interp(x_new, x_old, wav.samples).astype(np.float32),
        sample_rate=target_rate,
        num_channels=wav.num_channels,
        duration=wav.duration,
    )
