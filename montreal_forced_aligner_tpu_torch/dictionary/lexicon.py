"""Pronunciation lexicon.

Parses MFA-format dictionary files (word, optional probability columns,
pronunciation; column semantics per reference ``utils.py:1004-1056``) into an
in-memory lexicon with position-dependent phone handling (``_B/_E/_I/_S``
suffixes, reference ``dictionary/mixins.py:89``) and silence-probability
metadata used by the alignment graph compiler (reference
``dictionary/multispeaker.py:3105-3225`` builds L.fst from the same data).

There is deliberately no FST library here: pronunciation expansion happens at
graph-build time on the host and ships to TPU as integer arrays.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

_PROB_PATTERN = re.compile(r"\b(\d+\.\d+|1)\b")

POSITIONS = ["_B", "_E", "_I", "_S"]


@dataclass
class Pronunciation:
    phones: Tuple[str, ...]
    probability: Optional[float] = None
    silence_after_probability: Optional[float] = None
    silence_before_correction: Optional[float] = None
    non_silence_before_correction: Optional[float] = None


def parse_dictionary_file(path) -> Iterable[Tuple[str, Pronunciation]]:
    """Yield (word, Pronunciation) rows from an MFA-format dictionary file.

    Column order: word [prob [silence_after [silence_before_correction
    [non_silence_before_correction]]]] phone+  (reference ``utils.py:1004``).
    """
    with open(path, "r", encoding="utf-8") as f:
        for i, raw in enumerate(f):
            line = raw.strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) <= 1:
                from montreal_forced_aligner_tpu_torch.exceptions import (
                    DictionaryParseError,
                )

                raise DictionaryParseError(
                    path, i + 1, raw, "no pronunciation after the word"
                )
            word = unicodedata.normalize("NFKC", parts.pop(0))
            probs: List[Optional[float]] = [None, None, None, None]
            for j in range(4):
                if parts and _PROB_PATTERN.match(parts[0]):
                    probs[j] = float(parts.pop(0))
                else:
                    break
            yield word, Pronunciation(
                phones=tuple(parts),
                probability=probs[0],
                silence_after_probability=probs[1],
                silence_before_correction=probs[2],
                non_silence_before_correction=probs[3],
            )


@dataclass
class Lexicon:
    """Word -> pronunciations, plus phone inventory bookkeeping.

    ``phone_table`` maps *position-tagged* phone names to integer ids when the
    acoustic model uses position-dependent phones, plain names otherwise; it
    is shared with (or loaded from) the acoustic model's ``phones.txt``.
    """

    words: Dict[str, List[Pronunciation]] = field(default_factory=dict)
    phone_table: Dict[str, int] = field(default_factory=dict)
    position_dependent: bool = False
    oov_word: str = "<unk>"
    oov_phone: str = "spn"
    silence_word: str = "<eps>"
    silence_phone: str = "sil"
    laughter_word: str = "[laughter]"
    bracketed_word: str = "[bracketed]"
    cutoff_word: str = "<cutoff>"
    silence_probability: float = 0.5
    initial_silence_probability: float = 0.5
    final_silence_correction: Optional[float] = None
    final_non_silence_correction: Optional[float] = None

    @classmethod
    def load(
        cls,
        path,
        phone_table: Optional[Dict[str, int]] = None,
        position_dependent: Optional[bool] = None,
        **kwargs,
    ) -> "Lexicon":
        lex = cls(**kwargs)
        for word, pron in parse_dictionary_file(path):
            lex.add_pronunciation(word, pron)
        if phone_table is not None:
            lex.phone_table = dict(phone_table)
            if position_dependent is None:
                position_dependent = any(
                    n.endswith(tuple(POSITIONS)) for n in phone_table
                )
            lex.position_dependent = bool(position_dependent)
            lex.prune_to_phone_inventory()
        else:
            lex.build_phone_table(position_dependent=bool(position_dependent))
        return lex

    def prune_to_phone_inventory(self) -> int:
        """Drop pronunciations using phones absent from the model's phone
        table (words left with no pronunciation become OOVs). Returns the
        number of pruned pronunciations.

        When EVERY word would be pruned the dictionary and model evidently
        use different phone sets — raise :class:`PhoneMismatchError`
        (reference ``AcousticModel.validate``, ``models.py:790``) instead of
        silently aligning everything to ``<unk>``."""
        known = set()
        for name in self.phone_table:
            known.add(name)
            for pos in POSITIONS:
                if name.endswith(pos):
                    known.add(name[: -len(pos)])
        pruned = 0
        missing_phones = set()
        had_words = bool(self.words)
        for word in list(self.words):
            kept = []
            for p in self.words[word]:
                bad = [ph for ph in p.phones if ph not in known]
                if bad:
                    missing_phones.update(bad)
                else:
                    kept.append(p)
            pruned += len(self.words[word]) - len(kept)
            if kept:
                self.words[word] = kept
            else:
                del self.words[word]
        if had_words and not self.words:
            from montreal_forced_aligner_tpu_torch.exceptions import (
                PhoneMismatchError,
            )

            raise PhoneMismatchError(
                missing_phones, set(self.phone_table) - {"<eps>"}
            )
        if pruned:
            import logging

            logging.getLogger("mfa_tpu").warning(
                "pruned %d pronunciations using phones absent from the "
                "model (%s); affected words fall back to other "
                "pronunciations or <unk>",
                pruned, sorted(missing_phones)[:10],
            )
        return pruned

    def bump_version(self) -> None:
        """Mark lexicon-derived costs stale (invalidates the native graph
        compiler's caches; see graph/native_compile.py)."""
        self.version = getattr(self, "version", 0) + 1

    def add_pronunciation(self, word: str, pron: Pronunciation) -> None:
        self.bump_version()
        existing = self.words.setdefault(word, [])
        if any(p.phones == pron.phones for p in existing):
            return
        existing.append(pron)

    def build_phone_table(self, position_dependent: bool = False) -> None:
        """Construct a phone symbol table (id 0 = <eps>, then silence phones,
        then sorted non-silence phones; positional variants if requested) —
        mirrors the reference's phone numbering scheme
        (``dictionary/multispeaker.py:1966``)."""
        self.position_dependent = position_dependent
        phones = sorted(
            {p for prons in self.words.values() for pr in prons for p in pr.phones}
        )
        table: Dict[str, int] = {"<eps>": 0}
        idx = 1
        sil_base = [self.silence_phone, self.oov_phone]
        for base in sil_base:
            if position_dependent:
                table[base] = idx
                idx += 1
                for pos in POSITIONS:
                    table[base + pos] = idx
                    idx += 1
            else:
                table[base] = idx
                idx += 1
        for base in phones:
            if base in sil_base:
                continue
            if position_dependent:
                for pos in POSITIONS:
                    table[base + pos] = idx
                    idx += 1
            else:
                table[base] = idx
                idx += 1
        self.phone_table = table

    # -- queries -------------------------------------------------------------
    @property
    def silence_phone_id(self) -> int:
        return self.phone_table[self.silence_phone]

    def phone_id(self, base: str, position: Optional[str]) -> int:
        """Phone id for a base phone at a word position ('_B'.. or None)."""
        if self.position_dependent and position is not None:
            name = base + position
            if name in self.phone_table:
                return self.phone_table[name]
        if base in self.phone_table:
            return self.phone_table[base]
        raise KeyError(f"phone {base!r} (pos {position}) not in phone table")

    def pronunciation_phone_ids(self, phones: Tuple[str, ...]) -> List[int]:
        """Map a pronunciation to position-tagged phone ids."""
        n = len(phones)
        out = []
        for i, p in enumerate(phones):
            if n == 1:
                pos = "_S"
            elif i == 0:
                pos = "_B"
            elif i == n - 1:
                pos = "_E"
            else:
                pos = "_I"
            out.append(self.phone_id(p, pos))
        return out

    def lookup(self, word: str) -> Tuple[str, List[Pronunciation]]:
        """Resolve a normalized word to (output word, pronunciations); OOVs
        map to the oov word with the oov phone.

        Word-specific cutoffs ``<cutoff-xyz>`` of an in-vocabulary word get
        the OOV phone plus every non-empty prefix of each of the word's
        pronunciations (the reference synthesizes these entries up front in
        ``find_all_cutoffs``, ``dictionary/multispeaker.py:2767-2896``; here
        they resolve dynamically at graph-build time)."""
        if word in self.words:
            return word, self.words[word]
        cut = self._cutoff_base(word)
        if cut is not None and cut in self.words:
            prons = [Pronunciation(phones=(self.oov_phone,))]
            seen = {prons[0].phones}
            for pron in self.words[cut]:
                for i in range(1, len(pron.phones) + 1):
                    prefix = tuple(pron.phones[:i])
                    if prefix not in seen:
                        seen.add(prefix)
                        prons.append(Pronunciation(phones=prefix))
            return word, prons
        return self.oov_word, [Pronunciation(phones=(self.oov_phone,))]

    def _cutoff_base(self, word: str) -> Optional[str]:
        """The base word of a word-specific cutoff token, e.g.
        ``<cutoff-hello>`` -> ``hello`` (None if not a cutoff token)."""
        stem = self.cutoff_word[:-1] + "-"
        if word.startswith(stem) and word.endswith(self.cutoff_word[-1]):
            base = word[len(stem) : -1]
            return base or None
        return None

    def oov_pronunciations(self) -> List[Pronunciation]:
        return [Pronunciation(phones=(self.oov_phone,))]

    def write(self, path) -> None:
        """Export in MFA dictionary format (reference
        ``dictionary/multispeaker.py:2426``)."""
        with open(path, "w", encoding="utf-8") as f:
            for word in sorted(self.words):
                for pron in self.words[word]:
                    cols = [word]
                    for v in (
                        pron.probability,
                        pron.silence_after_probability,
                        pron.silence_before_correction,
                        pron.non_silence_before_correction,
                    ):
                        if v is None:
                            break
                        cols.append(f"{v:.2f}")
                    cols.extend(pron.phones)
                    f.write("\t".join(cols) + "\n")


def load_dictionary_argument(path, phone_table=None, **kwargs):
    """Resolve the CLI dictionary argument into {name: Lexicon} plus a
    speaker->name mapping (reference ``MultispeakerDictionaryMixin``,
    ``dictionary/multispeaker.py:61,289-327``): a plain dictionary file maps
    every speaker to it; a yaml file maps speaker names (and ``default``)
    to dictionary paths."""
    import yaml as _yaml
    from pathlib import Path as _P

    path = _P(path)
    if path.suffix.lower() in (".yaml", ".yml"):
        with open(path, "r", encoding="utf-8") as f:
            mapping = _yaml.safe_load(f) or {}
        lexicons = {}
        speaker_map = {}
        for speaker, dict_path in mapping.items():
            dict_path = str(dict_path)
            if dict_path not in lexicons:
                lexicons[dict_path] = Lexicon.load(
                    dict_path, phone_table=phone_table, **kwargs
                )
            speaker_map[speaker] = dict_path
        default = speaker_map.get("default")
        return lexicons, speaker_map, default
    lex = Lexicon.load(path, phone_table=phone_table, **kwargs)
    return {str(path): lex}, {}, str(path)
