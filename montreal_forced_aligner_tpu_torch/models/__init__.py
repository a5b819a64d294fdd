from montreal_forced_aligner_tpu_torch.models.transition_model import HmmTopology, TransitionModel
from montreal_forced_aligner_tpu_torch.models.gmm import DiagGmmSet
from montreal_forced_aligner_tpu_torch.models.tree import ContextDependency
from montreal_forced_aligner_tpu_torch.models.acoustic_model import AcousticModel

__all__ = [
    "HmmTopology",
    "TransitionModel",
    "DiagGmmSet",
    "ContextDependency",
    "AcousticModel",
]
