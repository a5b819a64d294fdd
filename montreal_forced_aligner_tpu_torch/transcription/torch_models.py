"""Neural transcription backends: Whisper and SpeechBrain ASR.

Counterpart of ``montreal_forced_aligner_tpu/transcription/torch_models.py``
(reference ``transcription/models.py:29,160`` and the speechbrain workers,
``transcription/multiprocessing.py:583-1001``). Whisper runs as the port's
own PyTorch model (:mod:`.whisper`) from a local Hugging Face checkpoint
directory, with the same token ids and text as the JAX package's
``transformers`` wrapper; no ``transformers`` is needed, so the JAX
package's ``found_transformers`` has no counterpart. The SpeechBrain
checkpoints are built by the package's own hparams, so that wrapper needs
the ``speechbrain`` package, as the JAX package's does, and runs the model
on the given device. Both transcribe one utterance at a time.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch import tracing
from montreal_forced_aligner_tpu_torch.device import resolve_device

logger = logging.getLogger("mfa_tpu")

MODEL_SAMPLE_RATE = 16000  # whisper + speechbrain checkpoints expect 16 kHz


def _iso_language(language) -> Optional[str]:
    """Accepts a ``Language`` enum, a language name, or an ISO code
    (reference passes Language through to whisper, ``data.py:481``).
    The ``unknown``/``multilingual`` sentinels mean "no hint" -> None."""
    if language is None:
        return None
    from montreal_forced_aligner_tpu_torch.data import Language

    if isinstance(language, Language):
        if language in (Language.unknown, Language.multilingual):
            return None
        return language.iso_code
    name = str(language).lower()
    if name in ("unknown", "multilingual"):
        return None
    try:
        return Language[name].iso_code
    except KeyError:
        return name  # assume it is already an ISO code


def _samples_at_model_rate(wav) -> np.ndarray:
    """int16-scaled float samples resampled to the checkpoint rate."""
    if wav.sample_rate != MODEL_SAMPLE_RATE:
        from montreal_forced_aligner_tpu_torch.corpus.corpus import _resample

        wav = _resample(wav, MODEL_SAMPLE_RATE)
    return np.asarray(wav.samples, dtype=np.float32)


def _missing_checkpoint(kind: str, model_path: Path) -> FileNotFoundError:
    return FileNotFoundError(
        f"no local {kind} checkpoint at {model_path}; this environment has "
        "no network egress, so weights must be provided as a local directory"
    )


class WhisperTranscriber:
    """Transcribe with a locally available Whisper checkpoint (reference
    ``WhisperTranscriber``, ``transcription/transcriber.py:1850``): the
    log-mel front end, the encoder and the decoding its generation config
    asks for (greedy or beam search, timestamps, conditioning on earlier
    windows) on ``device``."""

    def __init__(self, model_path, language: Optional[str] = None, device="cuda"):
        from montreal_forced_aligner_tpu_torch.transcription.whisper import (
            FeatureSettings,
            LogMel,
            Whisper,
            WhisperTokenizer,
            load_checkpoint,
        )

        self.device = resolve_device(device)
        model_path = Path(model_path)
        if not model_path.exists():
            raise _missing_checkpoint("Whisper", model_path)
        ckpt = load_checkpoint(model_path, self.device)
        self.config = ckpt.config
        self.generation = ckpt.generation
        self.model = Whisper.from_weights(ckpt.dims, ckpt.state_dict)
        self.log_mel = LogMel(FeatureSettings.from_preprocessor(ckpt.preprocessor),
                              self.device)
        self.tokenizer = WhisperTokenizer(model_path)
        self.language = _iso_language(language)
        if self.language is not None and self.generation.lang_to_id is None:
            # minimal / pre-multilingual generation configs cannot condition
            # on a language; decode unconditioned rather than erroring
            logger.warning(
                "whisper checkpoint lacks multilingual token maps; ignoring "
                "language hint %r", self.language,
            )
            self.language = None

    def features(self, samples: np.ndarray) -> torch.Tensor:
        with tracing.span("whisper.features"):
            return self.log_mel(samples)

    def decode(self, samples: np.ndarray, **kw):
        """The :class:`.whisper.Decoded` of one utterance's samples, under
        the checkpoint's generation config."""
        from montreal_forced_aligner_tpu_torch.transcription.whisper.generate import (
            generate,
        )

        return generate(
            self.model, self.features(samples), self.generation,
            language=self.language,
            config_forced_ids=self.config.get("forced_decoder_ids"), **kw)

    def transcribe(
        self, samples: np.ndarray, sample_rate: int = MODEL_SAMPLE_RATE
    ) -> str:
        if sample_rate != MODEL_SAMPLE_RATE:
            raise ValueError(
                f"whisper expects {MODEL_SAMPLE_RATE} Hz input, got "
                f"{sample_rate}; resample first (transcribe_corpus does)"
            )
        return self.tokenizer.decode(self.decode(samples).ids).strip()

    @tracing.traced("transcribe_corpus")
    def transcribe_corpus(self, corpus) -> Dict[int, str]:
        out = {}
        for utt in corpus.utterances:
            wav = corpus.load_audio(utt)
            out[utt.id] = self.transcribe(_samples_at_model_rate(wav))
        return out


def found_speechbrain() -> bool:
    try:
        import speechbrain  # noqa: F401

        return True
    except ImportError:
        return False


class SpeechbrainTranscriber:
    """Transcribe with a locally available SpeechBrain ASR checkpoint
    (reference ``SpeechbrainTranscriber``,
    ``transcription/transcriber.py:1967``; worker spec
    ``transcription/multiprocessing.py:583-1001``), its modules and inputs
    on ``device``."""

    def __init__(self, model_path, language: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        if not found_speechbrain():
            raise RuntimeError(
                "speechbrain is not available; install it and provide a "
                "local checkpoint directory (no network egress here)"
            )
        model_path = Path(model_path)
        if not model_path.exists():
            raise _missing_checkpoint("SpeechBrain", model_path)
        from speechbrain.inference.ASR import EncoderDecoderASR

        self.model = EncoderDecoderASR.from_hparams(
            source=str(model_path), savedir=str(model_path),
            run_opts={"device": str(self.device)},
        )
        if language is not None:
            # speechbrain ASR checkpoints are single-language; the hint only
            # documents intent (unlike whisper there is nothing to condition)
            logger.warning(
                "speechbrain checkpoints are single-language; --language "
                "%s has no effect on decoding", language,
            )
        self.language = _iso_language(language)

    def transcribe(
        self, samples: np.ndarray, sample_rate: int = MODEL_SAMPLE_RATE
    ) -> str:
        if sample_rate != MODEL_SAMPLE_RATE:
            raise ValueError(
                f"speechbrain expects {MODEL_SAMPLE_RATE} Hz input, got "
                f"{sample_rate}; resample first (transcribe_corpus does)"
            )
        wav = torch.from_numpy(
            np.asarray(samples, dtype=np.float32) / 32768.0
        ).unsqueeze(0).to(self.device)
        lens = torch.ones(1, device=self.device)
        with torch.no_grad():
            preds, _ = self.model.transcribe_batch(wav, lens)
        return preds[0].strip().lower()

    def transcribe_corpus(self, corpus) -> Dict[int, str]:
        out = {}
        for utt in corpus.utterances:
            wav = corpus.load_audio(utt)
            out[utt.id] = self.transcribe(_samples_at_model_rate(wav))
        return out
