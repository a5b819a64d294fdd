"""Whisper token ids to text.

Counterpart of ``WhisperTokenizer.decode(ids, skip_special_tokens=True)``
(``transformers`` ``models/whisper/tokenization_whisper.py``): special
tokens are skipped, added tokens are kept as their text, every other run
of tokens goes through GPT-2's byte-level decode (each character of a
token stands for one byte), timestamp tokens (``<|1.08|>``) are removed
from the text, and the saved ``clean_up_tokenization_spaces`` is
followed. Reads ``vocab.json`` and the added tokens
(``tokenizer_config.json``'s ``added_tokens_decoder``, else
``added_tokens.json`` with ``special_tokens_map.json``).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Iterable, List

_TIMESTAMP = re.compile(r"<\|(\d+\.\d+)\|>")
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                 "cls_token", "mask_token", "additional_special_tokens")


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map from each byte to a printable character."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def clean_up_tokenization(text: str) -> str:
    """The tokenizer's clean-up of spaces before punctuation and English
    contractions."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                 (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _token_content(value) -> str:
    return value["content"] if isinstance(value, dict) else value


def _read_json(path: Path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class WhisperTokenizer:
    def __init__(self, path):
        path = Path(path)
        self.id_to_token: Dict[int, str] = {
            i: t for t, i in _read_json(path / "vocab.json").items()}
        config = {}
        if (path / "tokenizer_config.json").exists():
            config = _read_json(path / "tokenizer_config.json")
        self.added: Dict[int, str] = {}
        self.special: set = set()
        for i, entry in (config.get("added_tokens_decoder") or {}).items():
            self.added[int(i)] = entry["content"]
            if entry.get("special"):
                self.special.add(int(i))
        if not self.added and (path / "added_tokens.json").exists():
            self.added = {i: t for t, i in _read_json(path / "added_tokens.json").items()}
        special_names = set()
        sources = [config]
        if (path / "special_tokens_map.json").exists():
            sources.append(_read_json(path / "special_tokens_map.json"))
        for source in sources:
            for key in _SPECIAL_KEYS:
                value = source.get(key)
                if value is None:
                    continue
                values = value if isinstance(value, list) else [value]
                special_names.update(_token_content(v) for v in values)
        self.id_to_token.update(self.added)
        token_to_id = {t: i for i, t in self.id_to_token.items()}
        self.special.update(token_to_id[t] for t in special_names if t in token_to_id)
        self.clean_up = bool(config.get("clean_up_tokenization_spaces", False))
        self.byte_decoder = {c: b for b, c in bytes_to_unicode().items()}

    def _bytes_text(self, tokens: List[str]) -> str:
        return bytearray(self.byte_decoder[c] for c in "".join(tokens)).decode(
            "utf-8", errors="replace")

    def decode(self, ids: Iterable[int]) -> str:
        """Text of ``ids`` with special tokens skipped (before ``.strip()``)."""
        pieces, run = [], []
        for i in ids:
            i = int(i)
            if i in self.special:
                continue
            token = self.id_to_token.get(i)
            if token is None:
                continue
            if i in self.added:
                if run:
                    pieces.append(self._bytes_text(run))
                    run = []
                pieces.append(token)
            else:
                run.append(token)
        if run:
            pieces.append(self._bytes_text(run))
        text = "".join(pieces)
        if self.clean_up:
            text = clean_up_tokenization(text)
        return _TIMESTAMP.sub("", text)
