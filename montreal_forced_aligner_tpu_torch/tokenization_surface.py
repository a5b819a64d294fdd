"""The language-tokenizer engine API surface this framework consumes,
pinned in ONE place (the same treatment ``speechbrain_surface`` gives the
neural seam).

The gated tokenizers in :mod:`.tokenization.languages` integrate external
segmentation engines exactly like the reference
(``tokenization/japanese.py:15`` sudachipy, ``chinese.py`` spacy-pkuseg,
``korean.py`` mecab-ko, ``thai.py`` pythainlp, ``english.py``/``spacy.py``
spacy pipelines). None of those packages is a dependency, so the
engine code paths would otherwise be unexecutable shells that a real
install could break silently. This module lists every (module, name,
attribute) the shells consume; the test mocks
(``tests/mock_tokenizer_engines.py``) implement exactly this surface so
the gated paths execute in CI, and the contract test additionally holds
the REAL packages to it whenever they are installed.
"""

from __future__ import annotations

# module path -> name -> attributes consumed on that name.
# () means the name itself is called (a function / constructor whose
# result is used directly); a non-empty tuple lists the attributes or
# methods the wrappers touch on the class / enum / instances.
TOKENIZATION_SURFACE = {
    # JapaneseTokenizer._build:
    #   sudachipy.Dictionary(dict="core").create(mode=sudachipy.SplitMode.B)
    #   morpheme.surface(), morpheme.part_of_speech()[0]
    "sudachipy": {
        "Dictionary": ("create",),
        "SplitMode": ("B",),
        "Morpheme": ("surface", "part_of_speech"),
    },
    # ChineseTokenizer._build: spacy_pkuseg.pkuseg().cut(text) -> [str]
    "spacy_pkuseg": {
        "pkuseg": ("cut",),
    },
    # KoreanTokenizer._build: mecab.MeCab().morphs(text) -> [str]
    "mecab": {
        "MeCab": ("morphs",),
    },
    # ThaiTokenizer._build:
    #   pythainlp.tokenize.word_tokenize(text, keep_whitespace=False)
    "pythainlp.tokenize": {
        "word_tokenize": (),
    },
    # EnglishTokenizer: spacy.load("en_core_web_sm") when available
    "spacy": {
        "load": (),
    },
}


def check_surface(get_module) -> list:
    """Return [(module, name, attr)] entries missing from an implementation.

    ``get_module``: callable mapping a module path to a module object
    (e.g. ``importlib.import_module``). Used by the interface tests to
    hold both the mocks and the real packages to the same contract. A
    module that cannot be imported at all reports every entry under it
    (callers filter to the packages they expect present)."""
    missing = []
    for mod_path, names in TOKENIZATION_SURFACE.items():
        try:
            mod = get_module(mod_path)
        except Exception:
            for name, attrs in names.items():
                missing.append((mod_path, name, None))
                missing.extend(
                    (mod_path, name, a) for a in attrs
                )
            continue
        for name, attrs in names.items():
            obj = getattr(mod, name, None)
            if obj is None:
                missing.append((mod_path, name, None))
                missing.extend((mod_path, name, a) for a in attrs)
                continue
            if not attrs and not callable(obj):
                missing.append((mod_path, name, "callable"))
            for a in attrs:
                if not hasattr(obj, a):
                    missing.append((mod_path, name, a))
    return missing
