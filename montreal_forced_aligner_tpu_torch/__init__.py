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

# On the CPU, ``torch.log`` and ``torch.exp`` call MKL's vector math
# library, which picks its code path on the process's first call, and that
# pick is not thread-safe: when the first call is a parallel one (a tensor
# of more than one grain), a thread that enters while another is picking
# computes its chunk with a less accurate log (up to 4e-5 off on the MFCC's
# log-mel energies), so the first features of a process could differ from
# its later ones and from another process's, and every alignment and
# statistic after them with it. One call here, on this thread, makes the
# pick before any parallel call.
torch.log(torch.ones(1))

__version__ = "0.1.0"
