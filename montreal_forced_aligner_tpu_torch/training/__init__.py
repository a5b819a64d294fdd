from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig, TrainingPipeline
from montreal_forced_aligner_tpu_torch.training.monophone import MonophoneTrainer

__all__ = ["TrainingPipeline", "TrainerConfig", "MonophoneTrainer"]
