"""Phonological rules: generate pronunciation variants.

Behavioral spec: reference ``data.py:114-210`` (``PhonologicalRule``: a
segment with preceding/following contexts and a replacement, realized as a
regex over the space-joined phone string; ``^``/``$`` mark word-initial/
final) and ``dictionary/multispeaker.py:1601,1729`` (rules loaded from yaml
and applied to dictionary pronunciations to add variants).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional

import yaml

from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon, Pronunciation


@dataclass
class PhonologicalRule:
    segment: str  # space-separated phones; alternatives with "|" per slot
    replacement: str  # space-separated phones ("" = deletion)
    preceding_context: str = ""
    following_context: str = ""
    probability: Optional[float] = None
    dialect: Optional[str] = None

    def __post_init__(self):
        self.initial = self.preceding_context.startswith("^")
        self.final = self.following_context.endswith("$")
        prec = self.preceding_context.lstrip("^").strip()
        foll = self.following_context.rstrip("$").strip()

        def slot_pattern(ctx: str) -> str:
            slots = [f"({s})" for s in ctx.split() if s]
            return " ".join(slots)

        components = []
        if prec:
            components.append(rf"(?P<preceding>{slot_pattern(prec)})")
        components.append(rf"(?P<segment>{slot_pattern(self.segment)})")
        if foll:
            components.append(rf"(?P<following>{slot_pattern(foll)})")
        pattern = " ".join(components)
        if self.initial:
            pattern = "^" + pattern
        if self.final:
            pattern += "$"
        self._pattern = re.compile(pattern, flags=re.UNICODE)
        self._has_prec = bool(prec)
        self._has_foll = bool(foll)

    def matches(self, pronunciation: str) -> bool:
        return self._pattern.search(pronunciation) is not None

    def apply(self, pronunciation: str) -> str:
        """Replace every matching segment (reference ``apply_rule``)."""
        parts = []
        if self._has_prec:
            parts.append(r"\g<preceding>")
        if self.replacement:
            parts.append(self.replacement)
        if self._has_foll:
            parts.append(r"\g<following>")
        out = self._pattern.sub(" ".join(parts), pronunciation)
        return re.sub(r"\s+", " ", out).strip()

    @classmethod
    def load_rules(cls, path) -> List["PhonologicalRule"]:
        with open(path, "r", encoding="utf-8") as f:
            data = yaml.safe_load(f) or {}
        rules = []
        for entry in data.get("rules", []):
            rules.append(
                cls(
                    segment=str(entry.get("segment", "")),
                    replacement=str(entry.get("replacement", "") or ""),
                    preceding_context=str(entry.get("preceding_context", "") or ""),
                    following_context=str(entry.get("following_context", "") or ""),
                    probability=entry.get("probability"),
                    dialect=entry.get("dialect"),
                )
            )
        return rules


def apply_rules_to_lexicon(
    lexicon: Lexicon, rules: List[PhonologicalRule]
) -> int:
    """Add rule-generated pronunciation variants (reference
    ``dictionary/multispeaker.py:1729``); returns the number added."""
    lexicon.bump_version()
    added = 0
    for word, prons in list(lexicon.words.items()):
        existing = {p.phones for p in prons}
        for pron in list(prons):
            text = " ".join(pron.phones)
            for rule in rules:
                if not rule.matches(text):
                    continue
                new = tuple(rule.apply(text).split())
                if not new or new in existing:
                    continue
                existing.add(new)
                lexicon.add_pronunciation(
                    word,
                    Pronunciation(phones=new, probability=rule.probability),
                )
                added += 1
    return added
