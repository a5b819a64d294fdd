from montreal_forced_aligner_tpu_torch.diarization.clustering import (
    agglomerative_cluster,
    kmeans_cluster,
)
from montreal_forced_aligner_tpu_torch.diarization.speaker_diarizer import (
    SpeakerDiarizer,
)

__all__ = ["agglomerative_cluster", "kmeans_cluster", "SpeakerDiarizer"]
