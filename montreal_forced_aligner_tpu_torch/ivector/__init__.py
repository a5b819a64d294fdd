from montreal_forced_aligner_tpu_torch.ivector.ubm import DiagUbm, train_ubm
from montreal_forced_aligner_tpu_torch.ivector.extractor import (
    IvectorExtractor,
    train_ivector_extractor,
)
from montreal_forced_aligner_tpu_torch.ivector.plda import Plda

__all__ = [
    "DiagUbm",
    "train_ubm",
    "IvectorExtractor",
    "train_ivector_extractor",
    "Plda",
]
