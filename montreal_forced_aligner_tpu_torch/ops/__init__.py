"""Device operations of the port (PyTorch): the names the JAX package's
``ops`` exports, on the port's functions."""

from montreal_forced_aligner_tpu_torch.ops.feats import (
    accumulate_cmvn_stats,
    apply_cmvn,
    compute_deltas,
    splice_frames,
)
from montreal_forced_aligner_tpu_torch.ops.gmm_loglikes import gmm_loglikes
from montreal_forced_aligner_tpu_torch.ops.mfcc import MfccConfig, compute_mfcc_batch
from montreal_forced_aligner_tpu_torch.ops.viterbi import viterbi_align_batch

__all__ = [
    "MfccConfig",
    "compute_mfcc_batch",
    "accumulate_cmvn_stats",
    "apply_cmvn",
    "compute_deltas",
    "splice_frames",
    "gmm_loglikes",
    "viterbi_align_batch",
]
