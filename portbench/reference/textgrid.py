"""Reads back the long TextGrids the program writes and holds them against
the alignment it returned: the words tier must hold its words and the
phones tier its phones other than silence, with the same labels and times."""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Tuple

SILENCE = ("sil", "sp")
_TIER = re.compile(r'name = "(.*)"')
_NUM = re.compile(r"(xmin|xmax) = (\S+)")
_TEXT = re.compile(r'text = "(.*)"')


def read(path: Path) -> Dict[str, List[Tuple[float, float, str]]]:
    """{tier name: [(begin, end, label)]} of the labelled intervals."""
    tiers: Dict[str, List[Tuple[float, float, str]]] = {}
    name, lo, hi = None, None, None
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        line = line.strip()
        if m := _TIER.fullmatch(line):
            name = m.group(1)
            tiers[name] = []
        elif m := _NUM.fullmatch(line):
            if m.group(1) == "xmin":
                lo = float(m.group(2))
            else:
                hi = float(m.group(2))
        elif (m := _TEXT.fullmatch(line)) and name is not None:
            if m.group(1):
                tiers[name].append((lo, hi, m.group(1).replace('""', '"')))
    return tiers


def matches(path: Path, aln, tol: float = 1e-9) -> bool:
    """Whether the file at ``path`` holds exactly ``aln``'s words and
    non-silence phones."""
    tiers = read(path)
    want = {
        "words": [(w.begin, w.end, w.label) for w in aln.words],
        "phones": [(p.begin, p.end, p.label) for p in aln.phones
                   if p.label not in SILENCE],
    }
    for name, rows in want.items():
        got = tiers.get(name)
        if got is None or len(got) != len(rows):
            return False
        for (a0, a1, al), (b0, b1, bl) in zip(got, rows):
            if al != bl or abs(a0 - b0) > tol or abs(a1 - b1) > tol:
                return False
    return True
