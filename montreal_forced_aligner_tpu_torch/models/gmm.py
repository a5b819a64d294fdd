"""Diagonal-covariance GMM acoustic model as dense arrays.

The reference evaluates per-frame GMM log-likelihoods one utterance at a time
in C++ (``kalpy.gmm.align``; call sites ``alignment/multiprocessing.py:791-853``).
Here the whole model is three dense tensors padded to a uniform
gaussians-per-pdf count so likelihood evaluation for a batch of frames is a
single MXU matmul:

    loglikes[t, pdf] = logsumexp_g ( gconst[pdf, g]
                                     + means_invvars[pdf, g] . x_t
                                     - 0.5 * inv_vars[pdf, g] . x_t^2 )

which is computed as ``concat([x, x^2]) @ W + gconst`` with
``W = concat([means_invvars, -0.5 * inv_vars])``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from montreal_forced_aligner_tpu_torch.io.kaldi_io import (
    KaldiBinaryReader,
    KaldiBinaryWriter,
    KaldiReadError,
)

M_LOG_2PI = math.log(2.0 * math.pi)


@dataclass
class DiagGmmSet:
    """A set of diagonal GMMs (one per pdf), padded to ``max_gauss``.

    Arrays:
      weights        (num_pdfs, max_gauss)  mixture weights, 0 for padding
      means_invvars  (num_pdfs, max_gauss, dim)
      inv_vars       (num_pdfs, max_gauss, dim)  1 for padding rows
      gconsts        (num_pdfs, max_gauss)  -inf for padding
      num_gauss      (num_pdfs,) actual component counts
    """

    weights: np.ndarray
    means_invvars: np.ndarray
    inv_vars: np.ndarray
    gconsts: np.ndarray
    num_gauss: np.ndarray

    @property
    def num_pdfs(self) -> int:
        return self.weights.shape[0]

    @property
    def max_gauss(self) -> int:
        return self.weights.shape[1]

    @property
    def dim(self) -> int:
        return self.means_invvars.shape[2]

    @property
    def total_gauss(self) -> int:
        return int(self.num_gauss.sum())

    # -- derived quantities --------------------------------------------------
    def compute_gconsts(self) -> None:
        """Recompute gconsts from weights/means/vars (Kaldi definition):

        gconst = log(w) + 0.5 * ( -D*log(2pi) + sum(log inv_var)
                                   - sum(mean^2 * inv_var) )
        """
        mean2_invvar = np.sum(self.means_invvars**2 / np.maximum(self.inv_vars, 1e-37), axis=2)
        log_det = np.sum(np.log(np.maximum(self.inv_vars, 1e-37)), axis=2)
        with np.errstate(divide="ignore"):
            logw = np.log(self.weights)
        g = logw + 0.5 * (-self.dim * M_LOG_2PI + log_det - mean2_invvar)
        pad = np.arange(self.max_gauss)[None, :] >= self.num_gauss[:, None]
        g = np.where(pad, -np.inf, g)
        self.gconsts = g.astype(np.float32)

    def pad_gauss(self, min_max_gauss: int) -> "DiagGmmSet":
        """Widen the (padded) gaussian axis to at least ``min_max_gauss``
        without changing any component. Used by training to keep device
        array shapes stable across mixup iterations (padding rows carry
        weight 0 / gconst -inf and never win)."""
        G = self.max_gauss
        if G >= min_max_gauss:
            return self
        P, D = self.num_pdfs, self.dim
        extra = min_max_gauss - G
        return DiagGmmSet(
            weights=np.pad(self.weights, ((0, 0), (0, extra))),
            means_invvars=np.pad(
                self.means_invvars, ((0, 0), (0, extra), (0, 0))
            ),
            inv_vars=np.pad(
                self.inv_vars,
                ((0, 0), (0, extra), (0, 0)),
                constant_values=1.0,
            ),
            gconsts=np.pad(
                self.gconsts,
                ((0, 0), (0, extra)),
                constant_values=-np.inf,
            ),
            num_gauss=self.num_gauss.copy(),
        )

    def get_means(self) -> np.ndarray:
        return self.means_invvars / np.maximum(self.inv_vars, 1e-37)

    def get_vars(self) -> np.ndarray:
        return 1.0 / np.maximum(self.inv_vars, 1e-37)

    # -- serialization (Kaldi AmDiagGmm format) ------------------------------
    @classmethod
    def read(cls, reader: KaldiBinaryReader) -> "DiagGmmSet":
        reader.expect_token("<DIMENSION>")
        dim = reader.read_int32()
        reader.expect_token("<NUMPDFS>")
        num_pdfs = reader.read_int32()
        weights_list: List[np.ndarray] = []
        miv_list: List[np.ndarray] = []
        iv_list: List[np.ndarray] = []
        gc_list: List[Optional[np.ndarray]] = []
        for _ in range(num_pdfs):
            reader.expect_token("<DiagGMM>")
            token = reader.read_token()
            gconsts = None
            if token == "<GCONSTS>":
                gconsts = reader.read_vector()
                token = reader.read_token()
            if token != "<WEIGHTS>":
                raise KaldiReadError(f"expected <WEIGHTS>, got {token!r}")
            weights = reader.read_vector()
            reader.expect_token("<MEANS_INVVARS>")
            miv = reader.read_matrix()
            reader.expect_token("<INV_VARS>")
            iv = reader.read_matrix()
            reader.expect_token("</DiagGMM>")
            if miv.shape[1] != dim:
                raise KaldiReadError("dimension mismatch in DiagGMM")
            weights_list.append(weights)
            miv_list.append(miv)
            iv_list.append(iv)
            gc_list.append(gconsts)
        return cls.from_lists(weights_list, miv_list, iv_list, gc_list)

    @classmethod
    def from_lists(cls, weights_list, miv_list, iv_list, gc_list=None) -> "DiagGmmSet":
        num_pdfs = len(weights_list)
        dim = miv_list[0].shape[1]
        counts = np.array([len(w) for w in weights_list], dtype=np.int32)
        max_gauss = int(counts.max())
        weights = np.zeros((num_pdfs, max_gauss), dtype=np.float32)
        miv = np.zeros((num_pdfs, max_gauss, dim), dtype=np.float32)
        iv = np.ones((num_pdfs, max_gauss, dim), dtype=np.float32)
        gconsts = np.full((num_pdfs, max_gauss), -np.inf, dtype=np.float32)
        have_gc = gc_list is not None and all(g is not None for g in gc_list)
        for i in range(num_pdfs):
            n = counts[i]
            weights[i, :n] = weights_list[i]
            miv[i, :n] = miv_list[i]
            iv[i, :n] = iv_list[i]
            if have_gc:
                gconsts[i, :n] = gc_list[i]
        out = cls(
            weights=weights,
            means_invvars=miv,
            inv_vars=iv,
            gconsts=gconsts,
            num_gauss=counts,
        )
        if not have_gc:
            out.compute_gconsts()
        return out

    def write(self, writer: KaldiBinaryWriter) -> None:
        writer.write_token("<DIMENSION>")
        writer.write_int32(self.dim)
        writer.write_token("<NUMPDFS>")
        writer.write_int32(self.num_pdfs)
        for i in range(self.num_pdfs):
            n = int(self.num_gauss[i])
            writer.write_token("<DiagGMM>")
            writer.write_token("<GCONSTS>")
            writer.write_vector(self.gconsts[i, :n])
            writer.write_token("<WEIGHTS>")
            writer.write_vector(self.weights[i, :n])
            writer.write_token("<MEANS_INVVARS>")
            writer.write_matrix(self.means_invvars[i, :n])
            writer.write_token("<INV_VARS>")
            writer.write_matrix(self.inv_vars[i, :n])
            writer.write_token("</DiagGMM>")

    # -- flattened layout for the TPU likelihood matmul ----------------------
    def flatten_for_device(self):
        """Returns (W, gconsts, pad_mask) where
        W : (2*dim, num_pdfs*max_gauss) float32 — ``[means_invvars; -0.5*inv_vars]``
        gconsts : (num_pdfs, max_gauss) with -inf padding
        """
        miv = self.means_invvars.reshape(-1, self.dim)  # (P*G, D)
        iv = self.inv_vars.reshape(-1, self.dim)
        W = np.concatenate([miv, -0.5 * iv], axis=1).T.astype(np.float32)  # (2D, P*G)
        return W, self.gconsts.astype(np.float32)
