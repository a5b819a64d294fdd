from montreal_forced_aligner_tpu_torch.dictionary.tokenizer import SimpleTokenizer
from montreal_forced_aligner_tpu_torch.tokenization.trainer import (
    TokenizerModel,
    TokenizerTrainer,
    TrainedTokenizer,
)

__all__ = [
    "SimpleTokenizer",
    "TokenizerModel",
    "TokenizerTrainer",
    "TrainedTokenizer",
]
