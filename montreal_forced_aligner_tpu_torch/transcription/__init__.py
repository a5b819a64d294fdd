"""Transcription: dense and LVCSR decoding against a language model."""
from montreal_forced_aligner_tpu_torch.transcription.transcriber import Transcriber

__all__ = ["Transcriber"]
