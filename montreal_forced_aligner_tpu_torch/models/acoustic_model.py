"""Acoustic model archive: load/save MFA-compatible model bundles.

The reference packages models as zip archives containing ``final.mdl``,
optional ``final.alimdl``, ``tree``, optional ``lda.mat``, ``phones.txt`` and
``meta.json``/``meta.yaml`` (spec: reference ``models.py:360-586``). This
loader accepts both the reference's archives (so published pretrained models
work unchanged) and our own.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import zipfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from montreal_forced_aligner_tpu_torch.io.kaldi_io import (
    KaldiBinaryWriter,
    KaldiTextWriter,
    open_kaldi_stream,
    read_text_vector,
)
from montreal_forced_aligner_tpu_torch.models.gmm import DiagGmmSet
from montreal_forced_aligner_tpu_torch.models.transition_model import TransitionModel
from montreal_forced_aligner_tpu_torch.models.tree import ContextDependency


def read_am_file(path) -> tuple:
    """Read a ``final.mdl``-style file (binary or text mode): TransitionModel
    followed by AmDiagGmm."""
    reader, _binary = open_kaldi_stream(str(path))
    tm = TransitionModel.read(reader)
    gmm = DiagGmmSet.read(reader)
    return tm, gmm


def write_am_file(
    path, transition_model: TransitionModel, gmm: DiagGmmSet, binary: bool = True
) -> None:
    """Write a ``final.mdl``-style file; ``binary=False`` produces Kaldi
    text mode (what ``gmm-copy --binary=false`` emits)."""
    with open(path, "wb") as f:
        writer = KaldiBinaryWriter(f) if binary else KaldiTextWriter(f)
        transition_model.write(writer)
        gmm.write(writer)


def read_tree_file(path) -> ContextDependency:
    """Read a ``tree`` file (binary or text mode; the EventMap token protocol
    is identical across modes)."""
    reader, _binary = open_kaldi_stream(str(path))
    return ContextDependency.read(reader)


def parse_symbol_table(path) -> Dict[str, int]:
    table: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                table[parts[0]] = int(parts[1])
    return table


@dataclass
class AcousticModel:
    """A loaded GMM-HMM acoustic model with all device-ready arrays."""

    transition_model: TransitionModel
    gmm: DiagGmmSet
    tree: ContextDependency
    meta: Dict = field(default_factory=dict)
    # phone symbol table: name -> id (includes <eps> 0 and disambig symbols)
    phone_table: Dict[str, int] = field(default_factory=dict)
    lda_mat: Optional[np.ndarray] = None
    # speaker-independent model for the first pass of SAT alignment
    alignment_model: Optional[tuple] = None  # (TransitionModel, DiagGmmSet)
    occs: Optional[np.ndarray] = None
    # phone -> {pdf_id: count} mapping from the final training alignment
    # (reference bundle member ``phone_pdf.counts``,
    # ``acoustic_modeling/trainer.py:665``; JSON)
    phone_pdf_counts: Optional[Dict] = None
    # phone LM over aligned phone sequences (reference bundles
    # ``phone_lm.fst`` built by ``train_phone_lm``,
    # ``transcription/transcriber.py:737``; persisted here as ARPA —
    # ``phone_lm.arpa`` — consumed by ``--use_phone_model``)
    phone_lm: Optional[object] = None  # language_modeling.ngram.ArpaModel

    @property
    def phone_names(self) -> Dict[int, str]:
        return {v: k for k, v in self.phone_table.items()}

    @property
    def frame_shift_ms(self) -> float:
        return float(self.meta.get("features", {}).get("frame_shift", 10))

    @property
    def uses_lda(self) -> bool:
        return bool(self.meta.get("features", {}).get("lda", self.lda_mat is not None))

    @property
    def uses_deltas(self) -> bool:
        f = self.meta.get("features", {})
        # this framework writes "deltas"; reference archives write
        # "uses_deltas" (models.py:494-586 feature config keys)
        if "deltas" in f:
            return bool(f["deltas"])
        if "uses_deltas" in f:
            return bool(f["uses_deltas"])
        return self.lda_mat is None

    @property
    def uses_fmllr(self) -> bool:
        f = self.meta.get("features", {})
        # reference archives mark SAT models with
        # "uses_speaker_adaptation" (not "fmllr"); honoring only our own
        # key silently skipped the two-pass for genuine MFA SAT models.
        # Meta.yaml-era archives carry neither key, but the reference
        # forces speaker adaptation on whenever final.alimdl is bundled
        # (reference models.py:653-661) — mirror that fallback.
        return bool(
            f.get(
                "fmllr",
                f.get(
                    "uses_speaker_adaptation", self.alignment_model is not None
                ),
            )
        )

    @property
    def position_dependent_phones(self) -> bool:
        # heuristic matching the reference's phone naming (_B/_E/_I/_S
        # suffixes, ``dictionary/mixins.py:89``)
        return any(
            name.endswith(("_B", "_E", "_I", "_S")) for name in self.phone_table
        )

    @classmethod
    def load(cls, path) -> "AcousticModel":
        """Load from a zip archive or an unpacked directory."""
        path = Path(path)
        if path.is_dir():
            return cls._load_dir(path)
        with tempfile.TemporaryDirectory() as tmp:
            with zipfile.ZipFile(path) as zf:
                zf.extractall(tmp)
            root = Path(tmp)
            # archives may nest contents in a single directory
            entries = list(root.iterdir())
            if len(entries) == 1 and entries[0].is_dir():
                root = entries[0]
            return cls._load_dir(root)

    @classmethod
    def _load_dir(cls, root: Path) -> "AcousticModel":
        tm, gmm = read_am_file(root / "final.mdl")
        tree_path = root / "tree"
        if tree_path.exists():
            tree = read_tree_file(tree_path)
        else:
            raise FileNotFoundError(f"no tree file in {root}")
        meta: Dict = {}
        if (root / "meta.json").exists():
            with open(root / "meta.json", "r", encoding="utf-8") as f:
                meta = json.load(f)
        elif (root / "meta.yaml").exists():
            import yaml

            with open(root / "meta.yaml", "r", encoding="utf-8") as f:
                meta = yaml.safe_load(f)
        phone_table: Dict[str, int] = {}
        if (root / "phones.txt").exists():
            phone_table = parse_symbol_table(root / "phones.txt")
        lda = None
        if (root / "lda.mat").exists():
            reader, _binary = open_kaldi_stream(str(root / "lda.mat"))
            lda = reader.read_matrix()
        alimdl = None
        if (root / "final.alimdl").exists():
            alimdl = read_am_file(root / "final.alimdl")
        occs = None
        if (root / "final.occs").exists():
            with open(root / "final.occs", "rb") as f:
                head = f.read(2)
                f.seek(0)
                if head == b"\x00B":
                    reader, _ = open_kaldi_stream(str(root / "final.occs"))
                    occs = reader.read_vector()
                else:
                    occs = read_text_vector(f.read().decode("utf-8"))
        phone_pdf_counts = None
        if (root / "phone_pdf.counts").exists():
            with open(root / "phone_pdf.counts", "r", encoding="utf-8") as f:
                raw = json.load(f)
            phone_pdf_counts = {
                phone: {int(pdf): float(c) for pdf, c in pdfs.items()}
                for phone, pdfs in raw.items()
            }
        phone_lm = None
        if (root / "phone_lm.arpa").exists():
            from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
                ArpaModel,
            )

            phone_lm = ArpaModel.read(root / "phone_lm.arpa")
        elif (root / "phone_lm.fst").exists():
            # genuine MFA archives bundle the phone LM as a binary OpenGrm
            # n-gram FST (reference models.py:367-379); labels follow the
            # archive's phone symbol table
            from montreal_forced_aligner_tpu_torch.io.openfst import read_fst
            from montreal_forced_aligner_tpu_torch.language_modeling.fst_convert import (
                ngram_fst_to_arpa,
            )

            import struct as _struct

            try:
                phone_lm = ngram_fst_to_arpa(
                    read_fst(root / "phone_lm.fst"), phone_table
                )
            # a truncated/corrupt optional member must degrade with the
            # warning, not make the whole archive unloadable
            # (struct.error/IndexError come from the binary reader)
            except (ValueError, _struct.error, IndexError, KeyError) as e:
                logging.getLogger("mfa_tpu").warning(
                    "could not parse phone_lm.fst (%s); --use_phone_model "
                    "will retrain the phone LM from alignments", e,
                )
        return cls(
            transition_model=tm,
            gmm=gmm,
            tree=tree,
            meta=meta,
            phone_table=phone_table,
            lda_mat=lda,
            alignment_model=alimdl,
            occs=occs,
            phone_pdf_counts=phone_pdf_counts,
            phone_lm=phone_lm,
        )

    def save(self, path, extra_files: Optional[Dict[str, Path]] = None) -> None:
        """Write an MFA-compatible model archive."""
        path = Path(path)
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            write_am_file(root / "final.mdl", self.transition_model, self.gmm)
            with open(root / "tree", "wb") as f:
                self.tree.write(KaldiBinaryWriter(f))
            with open(root / "meta.json", "w", encoding="utf-8") as f:
                json.dump(self.meta, f, indent=2)
            if self.phone_table:
                with open(root / "phones.txt", "w", encoding="utf-8") as f:
                    for name, idx in sorted(self.phone_table.items(), key=lambda kv: kv[1]):
                        f.write(f"{name} {idx}\n")
            if self.lda_mat is not None:
                with open(root / "lda.mat", "wb") as f:
                    KaldiBinaryWriter(f).write_matrix(self.lda_mat)
            if self.alignment_model is not None:
                write_am_file(root / "final.alimdl", *self.alignment_model)
            if self.phone_pdf_counts is not None:
                with open(root / "phone_pdf.counts", "w", encoding="utf-8") as f:
                    json.dump(
                        {
                            phone: {str(pdf): c for pdf, c in pdfs.items()}
                            for phone, pdfs in self.phone_pdf_counts.items()
                        },
                        f,
                        ensure_ascii=False,
                    )
            if self.phone_lm is not None:
                self.phone_lm.write(root / "phone_lm.arpa")
                # also the reference's member form (binary OpenFst n-gram
                # acceptor, reference models.py:367-379) so trained
                # archives are member-for-member drop-ins. Labels reuse
                # the archive phone-table ids where the LM vocabulary
                # matches (this framework's phone LM is over
                # position-stripped base phones) and the table is embedded
                # so the file is self-describing for OpenFst tooling.
                from montreal_forced_aligner_tpu_torch.io.openfst import write_fst
                from montreal_forced_aligner_tpu_torch.language_modeling.fst_convert import (
                    arpa_to_ngram_fst,
                )
                from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
                    BOS,
                    EOS,
                    UNK,
                )

                symbols = {"<eps>": 0}
                next_id = max(self.phone_table.values(), default=0) + 1
                for (word,) in self.phone_lm.ngrams[1]:
                    if word in (BOS, EOS, UNK):
                        continue
                    pid = self.phone_table.get(word)
                    if pid is None or pid in symbols.values():
                        pid = next_id
                        next_id += 1
                    symbols[word] = pid
                lm_fst = arpa_to_ngram_fst(self.phone_lm, symbols)
                lm_fst.isymbols = symbols
                lm_fst.osymbols = symbols
                write_fst(lm_fst, root / "phone_lm.fst")
            if extra_files:
                for name, src in extra_files.items():
                    shutil.copy(src, root / name)
            # write-then-rename: multi-host runs may save the (identical)
            # model to one shared path from every process; an atomic rename
            # can't produce a torn archive. PIDs are only unique per
            # machine, so the suffix includes the hostname for shared
            # filesystems (NFS across hosts)
            import socket

            tmp_zip = path.with_name(
                f"{path.name}.tmp{socket.gethostname()}.{os.getpid()}"
            )
            with zipfile.ZipFile(tmp_zip, "w", zipfile.ZIP_DEFLATED) as zf:
                for p in sorted(root.rglob("*")):
                    zf.write(p, p.relative_to(root))
            os.replace(tmp_zip, path)
