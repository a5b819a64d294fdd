"""Reference i-vector extractor archive interop (Kaldi binary members).

The reference's ``IvectorExtractorModel`` (reference ``models.py:814-929``)
is a zip of Kaldi-binary members — ``final.ie`` (IvectorExtractor),
``final.dubm`` (DiagGmm), optional ``plda`` (Plda), ``ivector_lda.mat``,
``num_utts.ark``/``speaker_ivectors.ark`` — plus ``meta.json``
(``ivector/trainer.py:532-543``). This module reads and writes those
members clean-room from the Kaldi serialization formats so pretrained MFA
i-vector models drive ``diarize_speakers``/speaker classification here,
and repo-trained extractors export for reference tooling (consumed at
reference ``ivector/trainer.py:390-633``,
``diarization/speaker_diarizer.py:307``).

Model-form mapping. Kaldi's extractor stores per component ``M_i`` (D x K
double) with the UBM mean folded into column 0 (``M_i[:, 0] =
m_i / prior_offset``; the i-vector prior is ``N(prior_offset * e_0, I)``)
and a full-covariance ``Sigma_inv_i`` (SpMatrix); ``ivector_dim`` is M's
FULL column count K and the bundled PLDA/ivector_lda are K-dimensional.
Import therefore keeps ALL K columns as ``T`` and centers the E-step by
``prior_offset * M[:, :, 0]`` (``IvectorExtractor.center_means``), while
posteriors keep the dubm exactly as read — with ``w' = w -
prior_offset*e_0 ~ N(0, I)`` the centered posterior mean equals Kaldi's
extracted i-vector after its own prior-offset subtraction, at the
archive's dimension. Export of a native centered model writes
``M_i = [m_i / prior_offset | T_i]`` (ivector_dim R+1) with the PLDA
embedded into that space (:func:`_pad_plda`, score-preserving); export of
an imported Kaldi-form model writes ``M`` back verbatim, so genuine
archives round-trip exactly.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from montreal_forced_aligner_tpu_torch.io.kaldi_io import (
    KaldiBinaryReader,
    KaldiBinaryWriter,
    open_kaldi_stream,
)
from montreal_forced_aligner_tpu_torch.ivector.extractor import IvectorExtractor
from montreal_forced_aligner_tpu_torch.ivector.plda import Plda
from montreal_forced_aligner_tpu_torch.ivector.ubm import DiagUbm

PRIOR_OFFSET = 100.0  # Kaldi's default ivector prior offset

REFERENCE_MEMBERS = (
    "final.ie",
    "final.ubm",
    "final.dubm",
    "ivector_lda.mat",
    "plda",
    "num_utts.ark",
    "speaker_ivectors.ark",
)


# -- single DiagGmm (final.dubm; Kaldi gmm/diag-gmm.cc) ---------------------
def read_diag_gmm(data: bytes) -> DiagUbm:
    reader, _binary = open_kaldi_stream(data)
    reader.expect_token("<DiagGMM>")
    token = reader.read_token()
    if token == "<GCONSTS>":
        reader.read_vector()  # recomputed on demand
        token = reader.read_token()
    if token != "<WEIGHTS>":
        raise ValueError(f"final.dubm: expected <WEIGHTS>, got {token!r}")
    weights = reader.read_vector()
    reader.expect_token("<MEANS_INVVARS>")
    miv = reader.read_matrix()
    reader.expect_token("<INV_VARS>")
    inv_vars = reader.read_matrix()
    reader.expect_token("</DiagGMM>")
    variances = 1.0 / np.maximum(inv_vars, 1e-37)
    return DiagUbm(
        weights=np.asarray(weights, np.float64),
        means=np.asarray(miv * variances, np.float64),
        variances=np.asarray(variances, np.float64),
    )


def write_diag_gmm(ubm: DiagUbm, stream) -> None:
    w = KaldiBinaryWriter(stream)
    inv_vars = 1.0 / np.maximum(ubm.variances, 1e-37)
    miv = ubm.means * inv_vars
    gconsts = (
        np.log(np.maximum(ubm.weights, 1e-37))
        + 0.5 * np.log(inv_vars).sum(axis=1)
        - 0.5 * ubm.dim * np.log(2 * np.pi)
        - 0.5 * (ubm.means * miv).sum(axis=1)
    )
    w.write_token("<DiagGMM>")
    w.write_token("<GCONSTS>")
    w.write_vector(gconsts)
    w.write_token("<WEIGHTS>")
    w.write_vector(ubm.weights)
    w.write_token("<MEANS_INVVARS>")
    w.write_matrix(miv)
    w.write_token("<INV_VARS>")
    w.write_matrix(inv_vars)
    w.write_token("</DiagGMM>")


# -- IvectorExtractor (final.ie; Kaldi ivector/ivector-extractor.cc) --------
def read_ivector_extractor(data: bytes):
    """Returns (M (C, D, K) float64, sigma_inv (C, D, D) float64,
    w_vec (C,), prior_offset)."""
    reader, _binary = open_kaldi_stream(data)
    reader.expect_token("<IvectorExtractor>")
    reader.expect_token("<w>")
    w_mat = reader.read_matrix()  # (C, K) if ivector-dependent weights
    reader.expect_token("<w_vec>")
    w_vec = reader.read_vector()
    reader.expect_token("<M>")
    size = reader.read_int32()
    M = np.stack([reader.read_matrix() for _ in range(size)])
    reader.expect_token("<SigmaInv>")
    sigma_inv = np.stack(
        [reader.read_packed_matrix() for _ in range(size)]
    )
    reader.expect_token("<IvectorOffset>")
    prior_offset = reader.read_double()
    reader.expect_token("</IvectorExtractor>")
    if w_mat.size:
        # ivector-dependent weights carry no analogue here; the shared
        # w_vec is what posterior computation uses
        pass
    return (
        np.asarray(M, np.float64),
        np.asarray(sigma_inv, np.float64),
        np.asarray(w_vec, np.float64),
        float(prior_offset),
    )


def write_ivector_extractor(extractor: IvectorExtractor, stream) -> None:
    w = KaldiBinaryWriter(stream)
    ubm = extractor.ubm
    C, D = ubm.means.shape
    p = float(getattr(extractor, "prior_offset", None) or PRIOR_OFFSET)
    w.write_token("<IvectorExtractor>")
    w.write_token("<w>")
    w.write_matrix_double(np.zeros((0, 0)))  # no ivector-dependent weights
    w.write_token("<w_vec>")
    w.write_vector_double(ubm.weights)
    w.write_token("<M>")
    w.write_int32(C)
    kaldi_form = getattr(extractor, "center_means", None) is not None
    for c in range(C):
        if kaldi_form:
            # imported models already carry the full Kaldi M (mean folded
            # into column 0); write it back verbatim
            M_c = np.asarray(extractor.T[c], np.float64)
        else:
            # native centered form m + T w': Kaldi's convention folds the
            # mean into column 0 at 1/prior_offset scale, so the written
            # model's ivector_dim is R+1 (see _pad_plda for the matching
            # PLDA embedding)
            M_c = np.concatenate(
                [ubm.means[c][:, None] / p, extractor.T[c]], axis=1
            )
        w.write_matrix_double(M_c)
    w.write_token("<SigmaInv>")
    sigma_inv_full = getattr(extractor, "sigma_inv", None)
    for c in range(C):
        if sigma_inv_full is not None:
            w.write_packed_matrix_double(sigma_inv_full[c])
        else:
            w.write_packed_matrix_double(
                np.diag(1.0 / np.maximum(ubm.variances[c], 1e-37))
            )
    w.write_token("<IvectorOffset>")
    w.write_double(p)
    w.write_token("</IvectorExtractor>")


# -- Plda (plda; Kaldi ivector/plda.cc) -------------------------------------
def read_plda(data: bytes) -> Plda:
    reader, _binary = open_kaldi_stream(data)
    reader.expect_token("<Plda>")
    mean = reader.read_vector()
    transform = reader.read_matrix()
    psi = reader.read_vector()
    reader.expect_token("</Plda>")
    return Plda(
        mean=np.asarray(mean, np.float64),
        transform=np.asarray(transform, np.float64),
        psi=np.asarray(psi, np.float64),
    )


def write_plda(plda: Plda, stream) -> None:
    w = KaldiBinaryWriter(stream)
    w.write_token("<Plda>")
    w.write_vector_double(plda.mean)
    w.write_matrix_double(plda.transform)
    w.write_vector_double(plda.psi)
    w.write_token("</Plda>")


def _pad_plda(plda: Plda) -> Plda:
    """Embed an R-dim PLDA into the (R+1)-dim Kaldi i-vector space a
    native model exports to (the extra leading coordinate is the folded
    prior-offset dimension, ~constant across utterances): identity on
    dim 0 with psi=0, so its contribution to same/different-speaker
    log-likelihood ratios cancels exactly and scores match the R-dim
    model's."""
    R = plda.mean.shape[0]
    transform = np.zeros((R + 1, R + 1))
    transform[0, 0] = 1.0
    transform[1:, 1:] = plda.transform
    return Plda(
        mean=np.concatenate([[0.0], plda.mean]),
        transform=transform,
        psi=np.concatenate([[0.0], plda.psi]),
    )


# -- archive-level load/save ------------------------------------------------
def is_reference_archive(path) -> bool:
    """True for a reference ``IvectorExtractorModel`` zip or an unpacked
    directory holding ``final.ie`` (vs this framework's own .npz)."""
    path = Path(path)
    if path.is_dir():
        return (path / "final.ie").exists()
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as zf:
        names = {Path(n).name for n in zf.namelist()}
    return "final.ie" in names


def load_reference_archive(path) -> IvectorExtractor:
    """Load a reference i-vector extractor archive into the framework's
    extractor (full-covariance Sigma_inv preserved for exact E-steps)."""
    path = Path(path)
    members: Dict[str, bytes] = {}
    if path.is_dir():
        for name in (*REFERENCE_MEMBERS, "meta.json"):
            p = path / name
            if p.exists():
                members[name] = p.read_bytes()
    else:
        with zipfile.ZipFile(path) as zf:
            for n in zf.namelist():
                base = Path(n).name
                if base in REFERENCE_MEMBERS or base == "meta.json":
                    members[base] = zf.read(n)
    if "final.ie" not in members or "final.dubm" not in members:
        raise ValueError(
            f"{path}: reference ivector archive needs final.ie and "
            f"final.dubm (found {sorted(members)})"
        )
    ubm = read_diag_gmm(members["final.dubm"])
    M, sigma_inv, w_vec, prior_offset = read_ivector_extractor(
        members["final.ie"]
    )
    # Kaldi's ivector_dim is M's FULL column count: keep every column in
    # T (the bundled PLDA/ivector_lda are that dimension) and center the
    # E-step by the mean Kaldi folds into column 0. Posteriors keep the
    # dubm exactly as read (the reference's gselect/posterior model).
    # With w' = w - prior_offset*e0 ~ N(0, I): mean_c(w) = M_c w =
    # prior_offset*M_c[:,0] + M_c w', so the centered posterior mean
    # equals Kaldi's extracted i-vector after its prior-offset
    # subtraction.
    plda = read_plda(members["plda"]) if "plda" in members else None
    extractor = IvectorExtractor(
        ubm=ubm, T=np.asarray(M, np.float32), plda=plda
    )
    extractor.center_means = M[:, :, 0] * prior_offset
    extractor.sigma_inv = sigma_inv
    extractor.prior_offset = prior_offset
    if "meta.json" in members:
        try:
            extractor.meta = json.loads(members["meta.json"].decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            pass
    if "ivector_lda.mat" in members:
        reader, _b = open_kaldi_stream(members["ivector_lda.mat"])
        extractor.lda = reader.read_matrix()
    return extractor


def save_reference_archive(
    extractor: IvectorExtractor, path, meta: Optional[dict] = None
) -> Path:
    """Write the reference ``IvectorExtractorModel`` zip (``final.ie`` +
    ``final.dubm`` + optional ``plda`` + ``meta.json``)."""
    path = Path(path)
    buf_ie = io.BytesIO()
    write_ivector_extractor(extractor, buf_ie)
    buf_dubm = io.BytesIO()
    write_diag_gmm(extractor.ubm, buf_dubm)
    kaldi_form = getattr(extractor, "center_means", None) is not None
    # Kaldi's ivector_dim counts ALL columns of M, including the folded
    # prior-offset column a native export adds
    written_dim = int(extractor.ivector_dim) + (0 if kaldi_form else 1)
    base_meta = {
        "version": "3.0.0",
        "architecture": "ivector",
        "ivector_dimension": written_dim,
        "num_gselect": 20,
        "min_post": 0.025,
        "posterior_scale": 1.0,
        "features": {
            "type": "mfcc",
            "use_energy": True,
            "frame_shift": 10,
            "snip_edges": True,
        },
    }
    if getattr(extractor, "meta", None):
        base_meta.update(extractor.meta)
    if meta:
        base_meta.update(meta)
    import socket

    tmp_zip = path.with_name(
        f"{path.name}.tmp{socket.gethostname()}.{os.getpid()}"
    )
    with zipfile.ZipFile(tmp_zip, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("final.ie", buf_ie.getvalue())
        zf.writestr("final.dubm", buf_dubm.getvalue())
        if extractor.plda is not None:
            plda = extractor.plda
            if not kaldi_form and plda.mean.shape[0] == extractor.ivector_dim:
                plda = _pad_plda(plda)  # match the written ivector_dim
            buf_plda = io.BytesIO()
            write_plda(plda, buf_plda)
            zf.writestr("plda", buf_plda.getvalue())
        lda = getattr(extractor, "lda", None)
        if lda is not None:
            buf_lda = io.BytesIO()
            KaldiBinaryWriter(buf_lda).write_matrix(lda)
            zf.writestr("ivector_lda.mat", buf_lda.getvalue())
        zf.writestr("meta.json", json.dumps(base_meta, indent=2))
    os.replace(tmp_zip, path)
    return path
