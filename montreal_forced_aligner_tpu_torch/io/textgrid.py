"""Praat TextGrid reading/writing (no praatio dependency).

Output format follows the reference's export (word + phone interval tiers per
speaker, long TextGrid; spec: reference ``textgrid.py:279-560``). The parser
accepts both long and short formats for reading reference alignments
(``alignment/base.py:2536`` evaluates against reference tiers).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Interval:
    begin: float
    end: float
    label: str


@dataclass
class TextGrid:
    xmin: float = 0.0
    xmax: float = 0.0
    tiers: "Dict[str, List[Interval]]" = field(default_factory=dict)

    # -- writing -------------------------------------------------------------
    def write(self, path, output_format: str = "long_textgrid") -> None:
        """Write long (default) or short TextGrid (reference
        ``export_textgrid`` formats, ``textgrid.py:463``)."""
        if output_format == "short_textgrid":
            return self._write_short(path)
        with open(path, "w", encoding="utf-8") as f:
            f.write('File type = "ooTextFile"\n')
            f.write('Object class = "TextGrid"\n\n')
            f.write(f"xmin = {self.xmin}\n")
            f.write(f"xmax = {self.xmax}\n")
            f.write("tiers? <exists>\n")
            f.write(f"size = {len(self.tiers)}\n")
            f.write("item []:\n")
            for i, (name, intervals) in enumerate(self.tiers.items(), start=1):
                f.write(f"    item [{i}]:\n")
                f.write('        class = "IntervalTier"\n')
                f.write(f'        name = "{name}"\n')
                f.write(f"        xmin = {self.xmin}\n")
                f.write(f"        xmax = {self.xmax}\n")
                filled = _fill_gaps(intervals, self.xmin, self.xmax)
                f.write(f"        intervals: size = {len(filled)}\n")
                for j, iv in enumerate(filled, start=1):
                    f.write(f"        intervals [{j}]:\n")
                    f.write(f"            xmin = {iv.begin}\n")
                    f.write(f"            xmax = {iv.end}\n")
                    label = iv.label.replace('"', '""')
                    f.write(f'            text = "{label}"\n')

    def _write_short(self, path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write('File type = "ooTextFile"\n')
            f.write('Object class = "TextGrid"\n\n')
            f.write(f"{self.xmin}\n{self.xmax}\n<exists>\n{len(self.tiers)}\n")
            for name, intervals in self.tiers.items():
                label = name.replace('"', '""')
                f.write(f'"IntervalTier"\n"{label}"\n')
                f.write(f"{self.xmin}\n{self.xmax}\n")
                filled = _fill_gaps(intervals, self.xmin, self.xmax)
                f.write(f"{len(filled)}\n")
                for iv in filled:
                    text = iv.label.replace('"', '""')
                    f.write(f'{iv.begin}\n{iv.end}\n"{text}"\n')

    def write_json(self, path) -> None:
        """Reference json schema: {"start", "end", "tiers": {name:
        {"type": "interval", "entries": [[begin, end, label], ...]}}}."""
        import json

        data = {"start": self.xmin, "end": self.xmax, "tiers": {}}
        for name, intervals in self.tiers.items():
            data["tiers"][name] = {
                "type": "interval",
                "entries": [[iv.begin, iv.end, iv.label] for iv in intervals],
            }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=4, ensure_ascii=False)

    def write_csv(self, path, default_speaker: str = "speaker") -> None:
        """Reference csv schema: Begin, End, Label, Type, Speaker rows; tier
        names are either "words"/"phones" (single speaker, whose real name
        the caller passes as ``default_speaker``) or "<speaker> - <type>"."""
        import csv

        with open(path, "w", encoding="utf-8", newline="") as f:
            writer = csv.DictWriter(
                f, fieldnames=["Begin", "End", "Label", "Type", "Speaker"]
            )
            writer.writeheader()
            for name, intervals in self.tiers.items():
                if " - " in name:
                    speaker, ann_type = name.rsplit(" - ", 1)
                else:
                    speaker, ann_type = default_speaker, name
                for iv in intervals:
                    writer.writerow(
                        {
                            "Begin": iv.begin,
                            "End": iv.end,
                            "Label": iv.label,
                            "Type": ann_type,
                            "Speaker": speaker,
                        }
                    )

    # -- reading -------------------------------------------------------------
    @classmethod
    def read(cls, path) -> "TextGrid":
        with open(path, "r", encoding="utf-8-sig", errors="replace") as f:
            content = f.read()
        long_tg = None
        if re.search(r"item\s*\[", content):
            try:
                long_tg = cls._read_long(content)
                if long_tg.tiers:
                    return long_tg
            except Exception:
                long_tg = None
        try:
            return cls._read_short(content)
        except Exception:
            # long-format content that legitimately parsed to zero tiers
            if long_tg is not None:
                return long_tg
            raise

    @classmethod
    def _read_long(cls, content: str) -> "TextGrid":
        tg = cls()
        header = re.search(r"xmin\s*=\s*([-\d.e+]+)", content)
        tg.xmin = float(header.group(1)) if header else 0.0
        header = re.search(r"xmax\s*=\s*([-\d.e+]+)", content)
        tg.xmax = float(header.group(1)) if header else 0.0
        # split into items
        items = re.split(r"item\s*\[\d+\]\s*:", content)
        for item in items[1:]:
            name_m = re.search(r'name\s*=\s*"((?:[^"]|"")*)"', item)
            if name_m is None:
                continue
            name = name_m.group(1).replace('""', '"')
            intervals = []
            for m in re.finditer(
                r"intervals\s*\[\d+\]\s*:\s*"
                r"xmin\s*=\s*([-\d.e+]+)\s*"
                r"xmax\s*=\s*([-\d.e+]+)\s*"
                r'text\s*=\s*"((?:[^"]|"")*)"',
                item,
            ):
                label = m.group(3).replace('""', '"').strip()
                intervals.append(Interval(float(m.group(1)), float(m.group(2)), label))
            tg.tiers[name] = intervals
        return tg

    @classmethod
    def _read_short(cls, content: str) -> "TextGrid":
        lines = [ln.strip() for ln in content.splitlines() if ln.strip()]
        tg = cls()
        # short format: header lines then per-tier blocks
        idx = 0

        def next_val():
            nonlocal idx
            v = lines[idx]
            idx += 1
            return v

        next_val()  # File type
        next_val()  # Object class
        tg.xmin = float(next_val())
        tg.xmax = float(next_val())
        next_val()  # <exists>
        n_tiers = int(next_val())
        for _ in range(n_tiers):
            next_val()  # "IntervalTier"
            name = next_val().strip('"')
            float(next_val())  # tier xmin
            float(next_val())  # tier xmax
            n_ints = int(next_val())
            intervals = []
            for _ in range(n_ints):
                b = float(next_val())
                e = float(next_val())
                lab = next_val().strip('"').strip()
                intervals.append(Interval(b, e, lab))
            tg.tiers[name] = intervals
        return tg


def _fill_gaps(intervals: List[Interval], xmin: float, xmax: float) -> List[Interval]:
    """Insert empty intervals so the tier tiles [xmin, xmax] contiguously."""
    out: List[Interval] = []
    cur = xmin
    for iv in sorted(intervals, key=lambda x: x.begin):
        if iv.begin - cur > 1e-6:
            out.append(Interval(cur, iv.begin, ""))
        out.append(Interval(max(iv.begin, cur), iv.end, iv.label))
        cur = iv.end
    if xmax - cur > 1e-6:
        out.append(Interval(cur, xmax, ""))
    return out
