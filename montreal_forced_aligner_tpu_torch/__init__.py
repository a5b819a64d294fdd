"""PyTorch/CUDA port of the TPU-native forced alignment framework.

A second package beside ``montreal_forced_aligner_tpu`` (the JAX reference,
which it never imports). Host code (corpus, lexicon, models, graph
compiler) is copied from the reference package; device code is PyTorch,
with hand-written CUDA kernels for the band Viterbi forward and backtrace
and the per-state GMM emissions (``csrc/``), built with ``nvcc`` at first
use.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``
and raises when no card is present; pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels.
"""

import torch

# every float32 product runs at full precision, as the reference runs them
# at Precision.HIGHEST: TF32 would flip near-ties in the Viterbi argmax
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
