"""wav2vec 2.0 with a CTC head as the port's own PyTorch model, read from a
local Hugging Face ``Wav2Vec2ForCTC`` directory: :mod:`.checkpoint`
(settings, vocabulary and weights), :mod:`.model` (normalisation,
convolutions, encoder, head) and :mod:`.ctc` (greedy decoding to text)."""

from montreal_forced_aligner_tpu_torch.transcription.wav2vec2.checkpoint import (
    Wav2Vec2Checkpoint,
    Wav2Vec2Dims,
    is_ctc_checkpoint,
    load_checkpoint,
)
from montreal_forced_aligner_tpu_torch.transcription.wav2vec2.model import Wav2Vec2ForCTC

__all__ = ["Wav2Vec2Checkpoint", "Wav2Vec2Dims", "Wav2Vec2ForCTC", "is_ctc_checkpoint",
           "load_checkpoint"]
