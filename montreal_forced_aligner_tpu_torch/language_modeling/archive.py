"""MFA LanguageModel archives: large + medium + small ARPA variants.

Behavioral spec: reference ``models.py:1258`` (``LanguageModel`` — a zip
holding ``<name>.arpa`` plus entropy-pruned ``<name>_medium.arpa`` and
``<name>_small.arpa``; decoding uses the smallest available model, CARPA
rescoring the largest, ``decode_arpa_path``/``carpa_path``) and
``language_modeling/trainer.py:122`` (``prune_large_language_model`` —
``ngramshrink --method=relative_entropy`` at thresholds 3e-7 / 1e-7).
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from pathlib import Path
from typing import Optional

from montreal_forced_aligner_tpu_torch.language_modeling.ngram import ArpaModel

PRUNE_THRESH_SMALL = 0.0000003
PRUNE_THRESH_MEDIUM = 0.0000001


class LanguageModelArchive:
    """A trained LM bundle, loadable from a ``.zip`` archive or a bare
    ``.arpa`` file (in which case only the large model exists)."""

    def __init__(
        self,
        large: ArpaModel,
        medium: Optional[ArpaModel] = None,
        small: Optional[ArpaModel] = None,
        meta: Optional[dict] = None,
        name: str = "lm",
    ):
        self.large = large
        self.medium = medium
        self.small = small
        self.meta = meta or {}
        self.name = name

    @property
    def decode_model(self) -> ArpaModel:
        """Smallest available model — what decoding graphs are built from
        (reference ``decode_arpa_path``)."""
        return self.small or self.medium or self.large

    @property
    def rescore_model(self) -> ArpaModel:
        """Largest available model — what lattice rescoring uses
        (reference ``carpa_path``)."""
        return self.large or self.medium or self.small

    @classmethod
    def train(
        cls,
        texts,
        order: int = 3,
        prune_thresh_small: float = PRUNE_THRESH_SMALL,
        prune_thresh_medium: float = PRUNE_THRESH_MEDIUM,
        name: str = "lm",
    ) -> "LanguageModelArchive":
        from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
            train_lm_from_texts,
        )

        large, counter = train_lm_from_texts(texts, order=order)
        medium = large.prune_relative_entropy(prune_thresh_medium)
        small = large.prune_relative_entropy(prune_thresh_small)
        meta = {
            "architecture": "ngram",
            "order": order,
            "method": "kneser_ney",
            "prune_thresh_small": prune_thresh_small,
            "prune_thresh_medium": prune_thresh_medium,
            "training": {
                "num_sentences": counter.num_sentences,
                "num_words": sum(counter.counts[1].values()),
            },
        }
        return cls(large, medium, small, meta, name)

    def save(self, path) -> Path:
        """Write the reference's archive layout (zip of ARPAs + meta)."""
        path = Path(path)
        name = path.stem or self.name
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            self.large.write(root / f"{name}.arpa")
            if self.medium is not None:
                # the reference matches "_med" (models.py:1333-1338, which
                # renames "_medium" inputs to "_med") — write what it reads
                self.medium.write(root / f"{name}_med.arpa")
            if self.small is not None:
                self.small.write(root / f"{name}_small.arpa")
            with open(root / "meta.json", "w", encoding="utf-8") as f:
                json.dump(self.meta, f, indent=2)
            import socket

            tmp_zip = path.with_name(
                f"{path.name}.tmp{socket.gethostname()}.{os.getpid()}"
            )
            with zipfile.ZipFile(tmp_zip, "w", zipfile.ZIP_DEFLATED) as zf:
                for p in sorted(root.iterdir()):
                    zf.write(p, p.name)
            os.replace(tmp_zip, path)
        return path

    @classmethod
    def load(cls, path) -> "LanguageModelArchive":
        path = Path(path)
        if path.suffix.lower() in (".arpa", ".lm", ".txt"):
            return cls(ArpaModel.read(path), name=path.stem)
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            with zipfile.ZipFile(path) as zf:
                zf.extractall(root)
            large = medium = small = None
            meta = {}
            for p in sorted(root.rglob("*")):
                if p.name == "meta.json":
                    meta = json.loads(p.read_text(encoding="utf-8"))
                elif p.suffix == ".arpa" or p.suffix == ".lm":
                    # the reference names the pruned variants "_small" and
                    # "_med" (accepting legacy "_medium"); anything else is
                    # the full model. Variant suffixes are matched relative
                    # to the archive base name so an archive itself named
                    # e.g. "foo_small.zip" keeps its full model
                    # "foo_small.arpa" in the large slot.
                    stem = p.stem
                    if stem != path.stem and stem.endswith("_small"):
                        small = ArpaModel.read(p)
                    elif stem != path.stem and stem.endswith(("_med", "_medium")):
                        medium = ArpaModel.read(p)
                    else:
                        large = ArpaModel.read(p)
            if large is None:
                large = medium or small
                if large is None:
                    raise ValueError(f"no ARPA files in archive {path}")
            return cls(large, medium, small, meta, path.stem)
