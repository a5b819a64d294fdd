"""Kaldi-parity harness of the port.

Counterpart of ``montreal_forced_aligner_tpu/parity``: an independent, slow,
pure-numpy implementation of Kaldi's ``compile-train-graphs`` +
``gmm-align-compiled`` semantics (:mod:`reference_decoder`, copied as it
is), a corpus-level harness (:mod:`harness`) that runs the port's production
aligner (on the card: kernels K1-K3) against it and reports frame and
boundary agreement, and an accuracy runner (:mod:`accuracy`) that scores the
port's alignments against a directory of reference TextGrids.
"""

from montreal_forced_aligner_tpu_torch.parity.reference_decoder import (
    ReferenceAligner,
)

__all__ = ["ReferenceAligner"]
