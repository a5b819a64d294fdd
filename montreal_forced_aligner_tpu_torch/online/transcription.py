"""Single-utterance online transcription.

Counterpart of ``montreal_forced_aligner_tpu/online/transcription.py``
(reference ``online/transcription.py:28``, ``transcribe_utterance_online``:
the GMM decode of one utterance against the model, the lexicon and an LM):
the production :class:`Transcriber` on a one-utterance corpus; and its
whisper and speechbrain variants (``:99,:122``), which call the neural
wrappers of :mod:`..transcription.torch_models` directly.
"""

from __future__ import annotations

import tempfile
from pathlib import Path
from typing import Optional

import numpy as np


def transcribe_utterance_online(
    acoustic_model_path,
    dictionary_path,
    samples: np.ndarray,
    sample_rate: int = 16000,
    language_model_path=None,
    acoustic_scale: float = 1.0 / 12,
    beam_like_nbest: int = 1,
    device="cuda",
) -> "TranscriptionResult":
    """Decode one utterance's samples (int16-scaled float or int16); returns
    its :class:`TranscriptionResult`. Without an LM, a flat unigram over
    the dictionary's words decodes it."""
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus, Utterance
    from montreal_forced_aligner_tpu_torch.io.wav import write_wave
    from montreal_forced_aligner_tpu_torch.transcription.transcriber import (
        Transcriber,
    )

    with tempfile.TemporaryDirectory(prefix="mfa_tpu_online_") as tmp:
        wav_path = Path(tmp) / "utterance.wav"
        write_wave(wav_path, np.asarray(samples, np.float32), sample_rate)
        corpus = Corpus(
            utterances=[
                Utterance(
                    id=0,
                    speaker="speaker",
                    file_path=wav_path,
                    file_name="utterance",
                    begin=0.0,
                    end=None,
                    channel=0,
                    text="",
                )
            ],
            speakers=["speaker"],
            files={"utterance": wav_path},
        )
        from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
            ArpaModel,
            train_lm_from_texts,
        )

        if language_model_path is not None:
            lm = ArpaModel.read(language_model_path)
        else:
            from montreal_forced_aligner_tpu_torch.dictionary.lexicon import (
                Lexicon,
            )

            lex = Lexicon.load(dictionary_path)
            words = sorted(
                w for w in lex.words
                if not (w.startswith("<") or w.startswith("["))
            )
            lm, _c = train_lm_from_texts([" ".join(words)], order=1)
        tr = Transcriber(
            acoustic_model_path,
            dictionary_path,
            lm=lm,
            batch_size=1,
            acoustic_scale=acoustic_scale,
            device=device,
        )
        return tr.transcribe_corpus(corpus)[0]


def transcribe_utterance_online_whisper(
    model_path, samples: np.ndarray, sample_rate: int = 16000,
    language: Optional[str] = None, device="cuda",
) -> str:
    """Reference ``online/transcription.py:99`` (faster-whisper variant)."""
    from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
        WhisperTranscriber,
    )

    return WhisperTranscriber(model_path, language=language,
                              device=device).transcribe(_at_16k(samples, sample_rate))


def _at_16k(samples: np.ndarray, sample_rate: int) -> np.ndarray:
    if sample_rate == 16000:
        return np.asarray(samples, np.float32)
    from montreal_forced_aligner_tpu_torch.corpus.corpus import _resample
    from montreal_forced_aligner_tpu_torch.io.wav import WaveData

    wd = WaveData(
        samples=np.asarray(samples, np.float32),
        sample_rate=sample_rate,
        num_channels=1,
        duration=len(samples) / sample_rate,
    )
    return _resample(wd, 16000).samples


def transcribe_utterance_online_speechbrain(
    model_path, samples: np.ndarray, sample_rate: int = 16000, device="cuda",
) -> str:
    """Reference ``online/transcription.py:122`` (speechbrain variant)."""
    from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
        SpeechbrainTranscriber,
    )

    return SpeechbrainTranscriber(model_path, device=device).transcribe(
        _at_16k(samples, sample_rate)
    )
