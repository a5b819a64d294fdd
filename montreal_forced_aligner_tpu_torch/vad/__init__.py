from montreal_forced_aligner_tpu_torch.vad.segmenter import VadSegmenter, compute_energy_vad

__all__ = ["VadSegmenter", "compute_energy_vad"]
