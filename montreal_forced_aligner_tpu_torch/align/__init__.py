from montreal_forced_aligner_tpu_torch.align.aligner import AlignerConfig, PretrainedAligner

__all__ = ["PretrainedAligner", "AlignerConfig"]
