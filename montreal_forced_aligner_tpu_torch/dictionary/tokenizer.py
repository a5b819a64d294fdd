"""Simple rule-based tokenizer for corpus text normalization.

Behavioral spec: reference ``tokenization/simple.py`` (``SanitizeFunction``
``:14``, ``SplitWordsFunction`` ``:107``, ``SimpleTokenizer`` ``:314``) with
the default punctuation/clitic/bracket inventories from
``dictionary/mixins.py:22-32``. Language-specific tokenizers (spacy, sudachi,
…) are separate optional components; this covers the default path used by
alignment.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

DEFAULT_PUNCTUATION = list(
    r'、。।，？！!@<>→"”()“„–,.:;—¿?¡：）|؟!\\&%#*،~【】，…‥「」『』〝〟″⟨⟩♪・‚‘‹›«»～′$+=‘۔―'
)
DEFAULT_WORD_BREAK_MARKERS = list(r'？！!()，,.:;¡¿?“„"”&~%#—…‥、。|【】$+=〝〟″‹›«»・⟨⟩،「」『』؟')
DEFAULT_QUOTE_MARKERS = list("“„\"”〝〟″「」『』‚ʻʿ‘′'")
DEFAULT_CLITIC_MARKERS = list("'’‘")
DEFAULT_COMPOUND_MARKERS = list("-‑/")
DEFAULT_BRACKETS = [("<", ">"), ("[", "]"), ("{", "}"), ("(", ")"), ("＜", "＞")]


@dataclass
class SimpleTokenizer:
    word_set: Optional[set] = None  # known words (for clitic/compound splits)
    punctuation: Sequence[str] = field(default_factory=lambda: DEFAULT_PUNCTUATION)
    clitic_markers: Sequence[str] = field(default_factory=lambda: DEFAULT_CLITIC_MARKERS)
    compound_markers: Sequence[str] = field(default_factory=lambda: DEFAULT_COMPOUND_MARKERS)
    word_break_markers: Sequence[str] = field(
        default_factory=lambda: DEFAULT_WORD_BREAK_MARKERS
    )
    brackets: Sequence[Tuple[str, str]] = field(default_factory=lambda: DEFAULT_BRACKETS)
    laughter_word: str = "[laughter]"
    oov_word: str = "<unk>"
    bracketed_word: str = "[bracketed]"
    cutoff_word: str = "<cutoff>"
    ignore_case: bool = True

    def __post_init__(self):
        self._clitic_chars = "".join(self.clitic_markers)
        self._compound_chars = "".join(self.compound_markers)
        brk = "".join(re.escape(c) for c in set(self.word_break_markers) | {" ", "\t"})
        self._break_regex = re.compile(rf"[{brk}]+")
        punct = "".join(re.escape(c) for c in set(self.punctuation))
        self._edge_punct_regex = re.compile(rf"^[{punct}]+|[{punct}]+$")
        bracket_patterns = "|".join(
            re.escape(l) + r"[^" + re.escape(l + r) + r"]*" + re.escape(r)
            for l, r in self.brackets
        )
        self._bracket_regex = re.compile(rf"({bracket_patterns})")
        self._laughter_regex = re.compile(r"\[(laugh(ing|ter)?|lachen|lg)\]", re.IGNORECASE)
        self._cutoff_identifier = re.compile(
            r"^[<[{](cutoff|hes(itation)?)([-_](?P<word>[^>\]}]+))?[>\]}]$",
            re.IGNORECASE,
        )

    def _known(self, word: str) -> bool:
        return self.word_set is not None and word in self.word_set

    def _split_clitics(self, word: str) -> Optional[List[str]]:
        for marker in self.clitic_markers:
            if marker in word:
                parts = word.split(marker)
                if len(parts) < 2 or any(not p for p in parts):
                    continue
                # attach the marker: left parts keep trailing marker,
                # final part keeps leading marker (reference SplitWordsFunction)
                candidates = []
                for i, p in enumerate(parts):
                    if i < len(parts) - 1:
                        candidates.append(p + marker)
                    else:
                        candidates.append(marker + p)
                # try variants: suffix-attached or prefix-attached forms;
                # a part with no known form survives bare as an OOV token —
                # the split happens as long as SOME part is known (the
                # reference splits "myrsa's" into OOV "myrsa" + clitic "'s")
                resolved = []
                any_known = False
                for i, p in enumerate(parts):
                    # first part: initial-clitic form ("l'"); final part:
                    # prefer the final-clitic form ("'s") over the
                    # suffix-attached one; middle parts may be either
                    if i == 0:
                        options = [p + marker, p]
                    elif i == len(parts) - 1:
                        options = [marker + p, p + marker, p]
                    else:
                        options = [p + marker, marker + p, p]
                    pick = next((o for o in options if self._known(o)), None)
                    if pick is None:
                        resolved.append(p)
                    else:
                        any_known = True
                        resolved.append(pick)
                if not any_known:
                    return None
                return resolved
        return None

    def _split_compounds(self, word: str) -> Optional[List[str]]:
        """Split on compound markers when at least one part is a known
        word (reference SplitWordsFunction: "talking-ajfish" splits because
        "talking" is known, "asds-asda" stays joined because neither part
        is); unknown parts survive as OOV tokens."""
        for marker in self.compound_markers:
            if marker in word:
                parts = [p for p in word.split(marker) if p]
                if len(parts) >= 2 and any(self._known(p) for p in parts):
                    return parts
        return None

    def tokenize(self, text: str) -> List[str]:
        """Normalize a transcript into a list of word tokens."""
        text = unicodedata.normalize("NFKC", text)
        if self.ignore_case:
            text = text.lower()
        # normalize every clitic-marker variant to the canonical first one
        # (reference SanitizeFunction: curly apostrophes etc. become ')
        for m in self.clitic_markers[1:]:
            text = text.replace(m, self.clitic_markers[0])
        tokens: List[str] = []
        # protect bracketed spans from being split
        pieces = self._bracket_regex.split(text)
        for piece in pieces:
            if not piece:
                continue
            if any(
                piece.startswith(l) and piece.endswith(r) for l, r in self.brackets
            ):
                if self._laughter_regex.match(piece):
                    tokens.append(self.laughter_word)
                elif m := self._cutoff_identifier.match(piece):
                    # keep word-specific cutoffs (<cutoff-xyz>) when the
                    # base word is known — the lexicon synthesizes prefix
                    # pronunciations for them (reference find_all_cutoffs,
                    # dictionary/multispeaker.py:2767)
                    base = m.group("word")
                    if base and self._known(base):
                        tokens.append(
                            f"{self.cutoff_word[:-1]}-{base}{self.cutoff_word[-1]}"
                        )
                    else:
                        tokens.append(self.cutoff_word)
                elif piece in ("<s>", "</s>", "<eps>"):
                    # structural symbols normalize to the OOV word
                    # (reference weird-words behavior: <s> -> <unk>)
                    tokens.append(self.oov_word)
                else:
                    tokens.append(piece if self._known(piece) else self.bracketed_word)
                continue
            for word in self._break_regex.split(piece):
                if not word:
                    continue
                word = self._edge_punct_regex.sub("", word)
                if not word:
                    continue
                # a token of nothing but markers (a bare dash or quote) is
                # punctuation, not a word
                if not word.strip(self._clitic_chars + self._compound_chars):
                    continue
                if self._known(word):
                    tokens.append(word)
                    continue
                # edge clitic markers act as quotes when the marked form is
                # unknown (reference: "her'" -> "her", "'something" ->
                # "something")
                stripped = word.strip(self._clitic_chars)
                if stripped and stripped != word:
                    word = stripped
                    if self._known(word):
                        tokens.append(word)
                        continue
                split = self._split_clitics(word) or self._split_compounds(word)
                if split:
                    tokens.extend(split)
                else:
                    tokens.append(word)
        return tokens

    def __call__(self, text: str) -> Tuple[str, List[str]]:
        """Returns (normalized_text, oov_list) like the reference's
        ``NormalizeTextFunction`` (``corpus/multiprocessing.py:255``)."""
        tokens = self.tokenize(text)
        cutoff_stem = self.cutoff_word[:-1] + "-"
        oovs = [
            t
            for t in tokens
            if self.word_set is not None
            and t not in self.word_set
            and t not in (self.laughter_word, self.cutoff_word, self.bracketed_word)
            and not t.startswith(cutoff_stem)
        ]
        return " ".join(tokens), oovs
