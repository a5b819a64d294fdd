from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
    ArpaModel,
    NgramCounter,
    train_ngram_model,
)

__all__ = ["ArpaModel", "NgramCounter", "train_ngram_model"]
