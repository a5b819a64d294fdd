"""Language-specific tokenizers (reference ``tokenization/{english,japanese,
chinese,korean,thai,spacy}.py``).

One abstraction: a :class:`LanguageTokenizer` maps raw text to a list of
word tokens *before* the :class:`SimpleTokenizer` normalization pass. Each
language is dependency-gated exactly like the reference (spacy /
sudachipy / hangul-jamo+mecab / pythainlp / pkuseg+dragonmapper): when the
package is present the full pipeline runs; when absent the tokenizer
degrades gracefully (English falls back to a pure-rule implementation of
the reference's deterministic retokenization rules; the CJK/Thai
tokenizers fall back to dictionary maximum-matching segmentation over the
pronunciation lexicon's words — the vocabulary that actually matters for
alignment — with a one-time warning; full morphological fidelity still
requires the external segmentation models).

English rules ported from the reference (``tokenization/english.py:20-434``):

- ``EnglishReTokenize``: merge ``<stem>in '`` -> ``<stem>ing`` (g-dropping)
  and ``<prefix> - <word>`` for the generic prefixes
  {non, electro, multi, cross, pseudo, techno, robo, thermo};
- ``n't`` normalizes to ``-n't``;
- ``EnglishSplitPrefixes`` / ``EnglishSplitSuffixes``: split
  prefixed/suffixed forms into morphemes (``re-``, ``in-``, ``un-``,
  ``non-`` prefixes; ``-ing -ness -less -able/-ible -ability -ably -s -es
  -ed -ly`` suffixes) when the base form is in-vocabulary and the composed
  form is not — the reference gates on the spacy vocabulary's ``is_oov``
  plus POS/morph features; the fallback gates on the pronunciation
  dictionary's word set (the vocabulary that actually matters for
  alignment) and surface form, including the reference's base-recovery
  rules (restore silent ``e``, ``i``->``y``, undouble final consonants —
  ``find_base_form``, ``english.py:139-158``).
"""

from __future__ import annotations

import logging
import re
from typing import Callable, List, Optional, Sequence

logger = logging.getLogger("mfa_tpu")

# bracketed spans the simple tokenizer maps to special words
# (DEFAULT_BRACKETS in dictionary/tokenizer.py); kept whole across
# whitespace so "[no speech]" stays one span
_BRACKETED_SPAN = re.compile(r"[<\[{(＜][^>\]})＞]*[>\]})＞]")

GENERIC_PREFIXES = {
    "non", "electro", "multi", "cross", "pseudo", "techno", "robo", "thermo",
}
VERB_ADJ_PREFIXES = ["re", "in", "un", "non"]
SUFFIXES = [
    "ability", "ibility", "ably", "ibly", "able", "ible",
    "ness", "less", "ing", "ed", "ly", "es", "s",
]
# norm forms the reference emits for each suffix (``english.py`` NORM rows)
SUFFIX_NORM = {
    "ability": "-ability", "ibility": "-ability",
    "ably": "-ly", "ibly": "-ly",
    "able": "-able", "ible": "-able",
    "ness": "-ness", "less": "-less",
    "ing": "-ing", "ed": "-ed", "ly": "-ly", "es": "-s", "s": "-s",
}


class LanguageTokenizer:
    """Base: identity pre-tokenization (whitespace handled downstream)."""

    name = "generic"

    def pre_tokenize(self, text: str) -> str:
        return text


class EnglishTokenizer(LanguageTokenizer):
    """English retokenization; full spacy pipeline when available, pure
    rules otherwise (``tokenization/english.py``)."""

    name = "english"

    def __init__(self, word_set: Optional[set] = None, ignore_case: bool = True):
        self.word_set = {w.lower() for w in word_set} if word_set else set()
        self.ignore_case = ignore_case
        self._nlp = None
        try:  # pragma: no cover - spacy is optional
            import spacy

            try:
                self._nlp = spacy.load("en_core_web_sm")
            except Exception:
                self._nlp = None
        except ImportError:
            self._nlp = None

    # -- vocabulary helpers (fallback path) ------------------------------
    def _in_vocab(self, w: str) -> bool:
        return w.lower() in self.word_set

    def _find_base_form(self, word: str, suffix: str) -> Optional[str]:
        """Reference ``find_base_form`` (``english.py:139-158``): strip the
        suffix, then try restoring a silent e, i->y, or undoubling the
        final consonant."""
        if not word.endswith(suffix):
            return None
        base = word[: -len(suffix)]
        if not base:
            return None
        if self._in_vocab(base):
            return base
        if self._in_vocab(base + "e"):
            return base + "e"
        if base.endswith("i") and self._in_vocab(base[:-1] + "y"):
            return base[:-1] + "y"
        if re.search(r"(\w)\1$", base) and self._in_vocab(base[:-1]):
            return base[:-1]
        return None

    def _split_word(self, word: str) -> List[str]:
        """Morpheme split when the composed form is OOV but the base is
        known and the suffix morpheme exists in the dictionary. Edge
        punctuation is ignored for matching (the simple tokenizer strips it
        downstream anyway); the reference operates on spacy tokens, which
        arrive pre-separated from punctuation."""
        # sentence punctuation only — bracketed spans ([...]/<...>) must
        # survive intact for the simple tokenizer's [bracketed] handling
        trimmed = word.strip(".,;:!?\"")
        if trimmed and trimmed != word:
            inner = self._split_word(trimmed)
            if inner != [trimmed]:
                return inner
            return [word]
        lower = word.lower()
        if self._in_vocab(lower) or not self.word_set:
            return [word]
        # prefixes (reference EnglishSplitPrefixes: re-/in-/un-/non- and
        # the generic set, gated on base being in vocabulary)
        for prefix in list(GENERIC_PREFIXES) + VERB_ADJ_PREFIXES:
            if (
                lower.startswith(prefix)
                and len(lower) >= len(prefix) + 2
                and self._in_vocab(lower[len(prefix):])
                and self._in_vocab(prefix + "-")
            ):
                return [prefix + "-", word[len(prefix):]]
        for suffix in SUFFIXES:
            norm = SUFFIX_NORM[suffix]
            if not self._in_vocab(norm):
                continue
            base = self._find_base_form(lower, suffix)
            if base is not None:
                return [base, norm]
        return [word]

    def pre_tokenize(self, text: str) -> str:
        # g-dropping: <stem>in' -> <stem>ing  (EnglishReTokenize)
        text = re.sub(r"\b(\w+in)['’](?=\s|$)", r"\1g", text)
        # n't -> -n't norm handled by keeping the clitic attached; the
        # simple tokenizer's clitic handling covers standard cases.
        # generic prefixes joined over an explicit hyphen+space
        for p in GENERIC_PREFIXES:
            text = re.sub(rf"\b({p})\s*-\s*(\w)", r"\1-\2", text)
        # protect bracketed/cutoff spans (possibly multi-word: "[no
        # speech]", "<cutoff my word>") from whitespace splitting — the
        # simple tokenizer must see them whole to map them to its
        # special words
        out: List[str] = []
        pos = 0
        for m in _BRACKETED_SPAN.finditer(text):
            for tok in text[pos : m.start()].split():
                out.extend(self._split_word(tok))
            out.append(m.group(0))
            pos = m.end()
        for tok in text[pos:].split():
            out.extend(self._split_word(tok))
        return " ".join(out)


class DictionarySegmenter:
    """Viterbi maximum-matching segmentation over the pronunciation
    dictionary's word list.

    The in-framework fallback for unsegmented scripts when the reference's
    external segmenters (sudachipy / pkuseg / mecab-ko / pythainlp) are
    unavailable: the vocabulary that matters for alignment is the lexicon's,
    and a run of unspaced text is split into the cheapest cover of lexicon
    words (cost 1 per word, 2 per unknown character, longest word preferred
    on ties — classic maximum matching). A chunk that contains no
    multi-character dictionary word is left intact (so Latin OOVs never
    shatter into letters).
    """

    def __init__(self, word_set):
        self.words = {
            w for w in (word_set or ())
            if w and not w.startswith(("<", "[", "{", "("))
        }
        self.max_len = max((len(w) for w in self.words), default=1)

    def segment_chunk(self, chunk: str):
        n = len(chunk)
        if n <= 1 or chunk in self.words or not self.words:
            return [chunk]
        INF = 1e9
        cost = [0.0] + [INF] * n
        back = [0] * (n + 1)
        for i in range(1, n + 1):
            cost[i] = cost[i - 1] + 2.0  # unknown single character
            back[i] = i - 1
            top = min(self.max_len, i)
            for L in range(1, top + 1):
                if chunk[i - L : i] in self.words:
                    c = cost[i - L] + 1.0
                    if c <= cost[i]:  # <=: longest word wins ties
                        cost[i] = c
                        back[i] = i - L
        out = []
        i = n
        covered = 0
        while i > 0:
            j = back[i]
            piece = chunk[j:i]
            if piece in self.words:
                covered += i - j
            out.append(piece)
            i = j
        # only split when dictionary words cover at least half the chunk:
        # CJK runs over a single-character-rich lexicon still segment, but
        # a mostly-unknown run (e.g. a Latin OOV that happens to contain
        # one lexicon letter) stays whole instead of shattering
        if covered * 2 < n:
            return [chunk]
        return out[::-1]

    def __call__(self, text: str) -> str:
        out = []
        pos = 0
        # bracketed spans stay whole (they map to special words downstream)
        for m in _BRACKETED_SPAN.finditer(text):
            for chunk in text[pos : m.start()].split():
                out.extend(self.segment_chunk(chunk))
            out.append(m.group(0))
            pos = m.end()
        for chunk in text[pos:].split():
            out.extend(self.segment_chunk(chunk))
        return " ".join(out)


class _GatedTokenizer(LanguageTokenizer):
    """Shell for tokenizers whose segmentation model is an optional
    dependency; falls back to dictionary maximum-matching segmentation
    (over the lexicon's words) with a one-time warning when the external
    package is absent."""

    package = ""
    install_hint = ""

    def __init__(self, word_set=None, **kwargs):
        self._impl = None
        self._warned = False
        self._fallback = None
        if word_set:
            self._fallback = DictionarySegmenter(word_set)
        try:
            self._impl = self._build(**kwargs)
        except Exception:
            # not just ImportError: a partially-installed stack (package
            # present, model data missing — OSError from spacy/pkuseg,
            # RuntimeError from mecab without a dicdir) must also fall
            # back gracefully rather than crash aligner construction
            self._impl = None

    def _build(self, **kwargs):  # pragma: no cover - packages absent here
        raise ImportError(self.package)

    def pre_tokenize(self, text: str) -> str:
        if self._impl is None:
            if not self._warned:
                logger.warning(
                    "%s tokenizer requires %s (%s); falling back to %s",
                    self.name, self.package, self.install_hint,
                    "dictionary maximum-matching segmentation"
                    if self._fallback is not None
                    else "the simple tokenizer",
                )
                self._warned = True
            if self._fallback is not None:
                return self._fallback(text)
            return text
        return self._impl(text)


class JapaneseTokenizer(_GatedTokenizer):
    name = "japanese"
    package = "sudachipy"
    install_hint = "pip install sudachipy sudachidict-core"

    def _build(self, **kwargs):  # pragma: no cover
        import sudachipy

        tok = sudachipy.Dictionary(dict="core").create(
            mode=sudachipy.SplitMode.B
        )

        def run(text: str) -> str:
            morphs = tok.tokenize(text)
            words = [
                m.surface()
                for m in morphs
                if m.part_of_speech()[0] != "補助記号" or
                re.match(r"[-_<({\[>)}\]]+", m.surface())
            ]
            return " ".join(words)

        return run


class ChineseTokenizer(_GatedTokenizer):
    name = "chinese"
    package = "spacy-pkuseg + dragonmapper"
    install_hint = "pip install spacy-pkuseg dragonmapper hanziconv"

    def _build(self, **kwargs):  # pragma: no cover
        import spacy_pkuseg as pkuseg

        seg = pkuseg.pkuseg()

        def run(text: str) -> str:
            return " ".join(seg.cut(text))

        return run


class KoreanTokenizer(_GatedTokenizer):
    name = "korean"
    package = "mecab-ko + jamo"
    install_hint = "pip install python-mecab-ko jamo"

    def _build(self, **kwargs):  # pragma: no cover
        import mecab

        m = mecab.MeCab()

        def run(text: str) -> str:
            return " ".join(m.morphs(text))

        return run


class ThaiTokenizer(_GatedTokenizer):
    name = "thai"
    package = "pythainlp"
    install_hint = "pip install pythainlp"

    def _build(self, **kwargs):  # pragma: no cover
        from pythainlp.tokenize import word_tokenize

        def run(text: str) -> str:
            return " ".join(
                w for w in word_tokenize(text, keep_whitespace=False)
            )

        return run


_LANGUAGES = {
    "english": EnglishTokenizer,
    "en": EnglishTokenizer,
    "japanese": JapaneseTokenizer,
    "ja": JapaneseTokenizer,
    "chinese": ChineseTokenizer,
    "zh": ChineseTokenizer,
    "mandarin": ChineseTokenizer,
    "korean": KoreanTokenizer,
    "ko": KoreanTokenizer,
    "thai": ThaiTokenizer,
    "th": ThaiTokenizer,
}


def get_language_tokenizer(
    language: Optional[str], word_set: Optional[set] = None
) -> Optional[LanguageTokenizer]:
    """Factory: None for unknown/unset languages (simple tokenizer only)."""
    if not language:
        return None
    key = language.lower()
    if key in ("unknown", ""):
        return None
    cls = _LANGUAGES.get(key)
    if cls is None:
        logger.warning(
            "no language-specific tokenizer for %r; using the simple "
            "tokenizer", language,
        )
        return None
    return cls(word_set=word_set)


def compose_tokenizer(simple_tokenizer, language_tokenizer):
    """Wrap a SimpleTokenizer so language pre-tokenization runs first."""
    if language_tokenizer is None:
        return simple_tokenizer

    class _Composed:
        def __init__(self, simple, lang):
            self._simple = simple
            self._lang = lang
            # expose the attributes downstream code reads
            self.word_set = getattr(simple, "word_set", None)
            self.oov_word = getattr(simple, "oov_word", "<unk>")

        def tokenize(self, text: str):
            return self._simple.tokenize(self._lang.pre_tokenize(text))

    return _Composed(simple_tokenizer, language_tokenizer)
