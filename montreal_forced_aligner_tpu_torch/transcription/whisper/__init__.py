"""Whisper as the port's own PyTorch model, read from a local Hugging Face
checkpoint directory: :mod:`.checkpoint` (settings and weights),
:mod:`.features` (the log-mel front end), :mod:`.model` (encoder and
decoder), :mod:`.generate` (greedy and beam decoding under the
generation config; its function ``generate`` is not re-exported here, as
the name would hide the module) and :mod:`.tokenizer` (ids to text)."""

from montreal_forced_aligner_tpu_torch.transcription.whisper.checkpoint import (
    GenerationSettings,
    WhisperCheckpoint,
    WhisperDims,
    load_checkpoint,
    read_safetensors,
    read_weights,
)
from montreal_forced_aligner_tpu_torch.transcription.whisper.features import (
    FeatureSettings,
    LogMel,
    mel_filters,
)
from montreal_forced_aligner_tpu_torch.transcription.whisper.generate import (
    Decoded,
    greedy_generate,
)
from montreal_forced_aligner_tpu_torch.transcription.whisper.model import Whisper
from montreal_forced_aligner_tpu_torch.transcription.whisper.tokenizer import (
    WhisperTokenizer,
)

__all__ = [
    "Decoded", "FeatureSettings", "GenerationSettings", "LogMel", "Whisper",
    "WhisperCheckpoint", "WhisperDims", "WhisperTokenizer", "greedy_generate",
    "load_checkpoint", "mel_filters", "read_safetensors", "read_weights",
]
