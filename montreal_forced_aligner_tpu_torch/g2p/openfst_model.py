"""Reference-format G2P model interop: load MFA's pynini-built G2P archives
and run inference without pynini.

Spec: reference ``G2PModel`` (``models.py:930``) — a zip with ``model.fst``
(binary OpenFst), ``phones.txt``/``phones.sym`` and
``graphemes.txt``/``graphemes.sym`` symbol tables, ``meta.json`` with
``architecture`` ("pynini" pair-ngram or "phonetisaurus"). Inference
mirrors the reference ``Rewriter``/``PhonetisaurusRewriter``
(``g2p/generator.py:153,239``): compose the grapheme string with the model
FST, take the k cheapest paths, read the phone labels.

The pair-ngram family maps one grapheme per input label; the phonetisaurus
family uses chunked labels (up to ``grapheme_order`` graphemes joined by
``sequence_separator``, and multi-phone output chunks) — both reduce to the
same lazy composition with per-label input expansions.
"""

from __future__ import annotations

import json
import logging
import tempfile
import unicodedata
import zipfile
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from montreal_forced_aligner_tpu_torch.io.openfst import (
    SimpleFst,
    read_fst,
    read_symbol_table,
    shortest_paths,
)

logger = logging.getLogger("mfa_tpu")


def is_reference_g2p_archive(path) -> bool:
    """True when ``path`` is a reference-format G2P zip (contains a binary
    ``.fst`` member rather than this framework's ``g2p.arpa``)."""
    try:
        with zipfile.ZipFile(path) as zf:
            names = [Path(n).name for n in zf.namelist()]
    except (zipfile.BadZipFile, IsADirectoryError, FileNotFoundError):
        return False
    return any(n.endswith(".fst") for n in names) and "g2p.arpa" not in names


class OpenFstG2PModel:
    """A loaded reference G2P model; exposes the same ``generate`` surface
    as :class:`~montreal_forced_aligner_tpu_torch.g2p.generator.G2PGenerator`."""

    def __init__(
        self,
        fst: SimpleFst,
        grapheme_table: Dict[str, int],
        phone_table: Dict[str, int],
        meta: Optional[dict] = None,
    ):
        self.fst = fst
        self.grapheme_table = grapheme_table
        self.phone_names = {v: k for k, v in phone_table.items()}
        self.meta = meta or {}
        self.sequence_separator = self.meta.get("sequence_separator", "|")
        self.unicode_decomposition = bool(
            self.meta.get("unicode_decomposition", False)
        )
        # per-ilabel grapheme expansions: pair-ngram labels are single
        # graphemes; phonetisaurus labels are separator-joined chunks
        grapheme_names = {v: k for k, v in grapheme_table.items()}
        self._ilabel_graphemes: Dict[int, Tuple[str, ...]] = {}
        sep = self.sequence_separator
        for gid, name in grapheme_names.items():
            if gid == 0 or name in ("<eps>", "<s>", "</s>", "<unk>", "<space>"):
                continue
            parts = tuple(p for p in name.split(sep) if p) if sep in name else (name,)
            self._ilabel_graphemes[gid] = parts
        # input-side composition state, immutable after construction
        self._known_parts = {
            g for parts in self._ilabel_graphemes.values() for g in parts
        }
        # output phone expansions (phonetisaurus chunks multiple phones)
        self._olabel_phones: Dict[int, Tuple[str, ...]] = {}
        for pid, name in self.phone_names.items():
            if pid == 0 or name in ("<eps>", "<s>", "</s>", "<unk>"):
                continue
            parts = (
                tuple(p for p in name.split(sep) if p and p != "_")
                if sep in name
                else (name,)
            )
            self._olabel_phones[pid] = parts

    # -- loading --------------------------------------------------------------
    @classmethod
    def load(cls, path) -> "OpenFstG2PModel":
        path = Path(path)
        with tempfile.TemporaryDirectory() as tmp:
            root = Path(tmp)
            with zipfile.ZipFile(path) as zf:
                zf.extractall(root)
            entries = list(root.iterdir())
            if len(entries) == 1 and entries[0].is_dir():
                root = entries[0]
            fst_path = root / "model.fst"
            if not fst_path.exists():
                cands = sorted(root.glob("*.fst"))
                if not cands:
                    raise FileNotFoundError(f"no .fst member in {path}")
                fst_path = cands[0]
            fst = read_fst(fst_path)
            phones = None
            graphemes = None
            for name in ("phones.txt", "phones.sym"):
                if (root / name).exists():
                    phones = read_symbol_table(root / name)
                    break
            for name in ("graphemes.txt", "graphemes.sym"):
                if (root / name).exists():
                    graphemes = read_symbol_table(root / name)
                    break
            meta = {}
            if (root / "meta.json").exists():
                meta = json.loads((root / "meta.json").read_text("utf-8"))
            elif (root / "meta.yaml").exists():
                import yaml

                meta = yaml.safe_load((root / "meta.yaml").read_text("utf-8"))
            if phones is None and fst.osymbols:
                phones = fst.osymbols
            if graphemes is None and fst.isymbols:
                graphemes = fst.isymbols
            if phones is None and graphemes is not None:
                # tokenizer archives (reference TokenizerModel,
                # models.py:1121) transduce characters to characters and
                # carry a single graphemes.sym for both sides
                phones = graphemes
            if phones is None or graphemes is None:
                raise FileNotFoundError(
                    f"{path}: missing phones/graphemes symbol tables "
                    "(reference G2PModel archives carry phones.txt + "
                    "graphemes.txt, models.py:930)"
                )
        return cls(fst, graphemes, phones, meta)

    # -- inference ------------------------------------------------------------
    def generate(
        self, word: str, num_pronunciations: int = 1
    ) -> List[Tuple[Tuple[str, ...], float]]:
        """Top-k (phones, -cost) for a word (same contract as
        ``G2PGenerator.generate``; scores are negated tropical costs so
        "higher is better" holds for both engines)."""
        if self.unicode_decomposition:
            word = unicodedata.normalize("NFD", word)
        chars = list(word)
        # composition matches on grapheme STRINGS: chunked tables
        # (phonetisaurus convention) often contain only multi-grapheme
        # chunk symbols, so single graphemes may have no id of their own
        missing = [c for c in chars if c not in self._known_parts]
        if missing:
            logger.debug("G2P: graphemes not in model: %r", missing)
            return []
        paths = shortest_paths(
            self.fst, chars, k=max(num_pronunciations * 4, 8),
            ilabel_expansions=self._ilabel_graphemes,
        )
        out: List[Tuple[Tuple[str, ...], float]] = []
        seen = set()
        for olabels, cost in paths:
            phones: List[str] = []
            for o in olabels:
                phones.extend(self._olabel_phones.get(o, ()))
            sig = tuple(phones)
            if not sig or sig in seen:
                continue
            seen.add(sig)
            out.append((sig, -cost))
            if len(out) >= num_pronunciations:
                break
        return out

    def generate_pronunciations(
        self, words: Sequence[str], num_pronunciations: int = 1
    ) -> Dict[str, List[str]]:
        out = {}
        for w in words:
            out[w] = [
                " ".join(p) for p, _s in self.generate(w, num_pronunciations)
            ]
        return out
