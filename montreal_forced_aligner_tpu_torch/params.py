"""Device-resident GMM parameters, and how they are made from numpy arrays.

:func:`gmm_params_from_numpy` takes the arrays of a loaded model (``gmm.*``
of either package's ``DiagGmmSet``, the speaker-independent
``alignment_model[1]``, ``lda_mat``) and returns a :class:`GmmParams`
module, so the tests can feed the JAX reference and the port the same
numbers.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.ops.cuda_emission import pack_rows


class GmmParams(torch.nn.Module):
    """Buffers of one diagonal GMM set as the emission paths consume them:

    * ``W`` (2D, P*G): ``[means*invvars; -0.5*invvars]`` for the all-pdf
      product (``ops/gmm_loglikes.py``);
    * ``gconsts`` (P, G), -inf on padded Gaussians;
    * ``rows`` (P, G, D2p): per-pdf rows for the state-emission kernel
      (``ops/cuda_emission.py``), gconst folded in;
    * ``lda`` (E, D*7) or None: the model's LDA transform.
    """

    def __init__(self, W, gconsts, rows, lda=None):
        super().__init__()
        self.register_buffer("W", W)
        self.register_buffer("gconsts", gconsts)
        self.register_buffer("rows", rows)
        self.register_buffer("lda", lda)

    @property
    def num_pdfs(self) -> int:
        return self.gconsts.shape[0]

    @property
    def num_gauss(self) -> int:
        return self.gconsts.shape[1]


def gmm_params_from_numpy(
    means_invvars: np.ndarray,  # (P, G, D)
    inv_vars: np.ndarray,  # (P, G, D)
    gconsts: np.ndarray,  # (P, G), -inf padding
    lda_mat: Optional[np.ndarray] = None,
    boost_silence: float = 1.0,
    silence_pdfs: Optional[np.ndarray] = None,
) -> GmmParams:
    """A CPU :class:`GmmParams`; move it with ``.to(device)``. With
    ``boost_silence != 1``, ``log(boost_silence)`` is added to the gconsts of
    ``silence_pdfs`` (``gmm-boost-silence`` semantics)."""
    gconsts = np.array(gconsts, dtype=np.float32)
    if boost_silence != 1.0:
        if silence_pdfs is None:
            raise ValueError("boost_silence needs silence_pdfs")
        gconsts[np.asarray(silence_pdfs, np.int64)] += math.log(boost_silence)
    P, G, D = means_invvars.shape
    miv = np.asarray(means_invvars, np.float32).reshape(-1, D)
    iv = np.asarray(inv_vars, np.float32).reshape(-1, D)
    W = np.concatenate([miv, -0.5 * iv], axis=1).T.astype(np.float32)
    rows = pack_rows(means_invvars, inv_vars, gconsts)
    return GmmParams(
        torch.from_numpy(np.ascontiguousarray(W)),
        torch.from_numpy(gconsts),
        torch.from_numpy(rows),
        None if lda_mat is None
        else torch.from_numpy(np.ascontiguousarray(lda_mat, dtype=np.float32)),
    )
