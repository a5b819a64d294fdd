from montreal_forced_aligner_tpu_torch.io.kaldi_io import KaldiBinaryReader, read_kaldi_object
from montreal_forced_aligner_tpu_torch.io.wav import read_wave

__all__ = ["KaldiBinaryReader", "read_kaldi_object", "read_wave"]
