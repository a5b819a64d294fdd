"""Phonetic-context decision tree (Kaldi ``ContextDependency`` format).

Clean-room parser + evaluator. The reference consumes trees through
``_kalpy.tree.read_tree`` (call sites: ``acoustic_modeling/triphone.py:383-458``,
model loading ``models.py:367-379``). The tree maps an *event* — a phone
context window of width N with central position P, plus a pdf-class — to a
pdf-id. For TPU alignment we evaluate trees on the host at graph-build time
and ship flat int32 pdf-id tables to the device.

EventMap node kinds:
  ``CE`` constant (leaf: pdf-id)
  ``SE`` split on a key with a yes-set of values
  ``TE`` table lookup on a key
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch.io.kaldi_io import (
    KaldiBinaryReader,
    KaldiBinaryWriter,
    KaldiReadError,
)

KPDF_CLASS = -1  # event key for the pdf-class


class EventMap:
    def map(self, event: Dict[int, int]) -> Optional[int]:
        raise NotImplementedError

    def multi_map(self, event: Dict[int, int], out: set) -> None:
        """Collect all reachable answers when some keys are unspecified."""
        raise NotImplementedError

    def max_answer(self) -> int:
        raise NotImplementedError

    def write(self, writer: KaldiBinaryWriter) -> None:
        raise NotImplementedError

    @staticmethod
    def read(reader: KaldiBinaryReader) -> Optional["EventMap"]:
        token = reader.read_token()
        if token == "NULL":
            return None
        if token == "CE":
            return ConstantEventMap(reader.read_int32())
        if token == "SE":
            key = reader.read_int32()
            yes_set = reader.read_int32_vector()
            reader.expect_token("{")
            yes = EventMap.read(reader)
            no = EventMap.read(reader)
            reader.expect_token("}")
            return SplitEventMap(key, yes_set, yes, no)
        if token == "TE":
            key = reader.read_int32()
            size = reader.read_int32()
            reader.expect_token("(")
            table = [EventMap.read(reader) for _ in range(size)]
            reader.expect_token(")")
            return TableEventMap(key, table)
        raise KaldiReadError(f"unknown EventMap token {token!r}")


@dataclass
class ConstantEventMap(EventMap):
    answer: int

    def map(self, event):
        return self.answer

    def multi_map(self, event, out):
        out.add(self.answer)

    def max_answer(self):
        return self.answer

    def write(self, writer):
        writer.write_token("CE")
        writer.write_int32(self.answer)


class SplitEventMap(EventMap):
    def __init__(self, key, yes_set, yes, no):
        self.key = key
        self.yes_set = np.asarray(yes_set, dtype=np.int32)
        self._yes_lookup = set(int(v) for v in self.yes_set)
        self.yes = yes
        self.no = no

    def map(self, event):
        value = event.get(self.key)
        if value is None:
            return None
        child = self.yes if value in self._yes_lookup else self.no
        return None if child is None else child.map(event)

    def multi_map(self, event, out):
        value = event.get(self.key)
        if value is None:
            for child in (self.yes, self.no):
                if child is not None:
                    child.multi_map(event, out)
        else:
            child = self.yes if value in self._yes_lookup else self.no
            if child is not None:
                child.multi_map(event, out)

    def max_answer(self):
        return max(
            child.max_answer() if child is not None else -1
            for child in (self.yes, self.no)
        )

    def write(self, writer):
        writer.write_token("SE")
        writer.write_int32(self.key)
        writer.write_int32_vector(self.yes_set)
        writer.write_token("{")
        for child in (self.yes, self.no):
            if child is None:
                writer.write_token("NULL")
            else:
                child.write(writer)
        writer.write_token("}")


class TableEventMap(EventMap):
    def __init__(self, key, table):
        self.key = key
        self.table = table

    def map(self, event):
        value = event.get(self.key)
        if value is None or value < 0 or value >= len(self.table):
            return None
        child = self.table[value]
        return None if child is None else child.map(event)

    def multi_map(self, event, out):
        value = event.get(self.key)
        if value is None:
            for child in self.table:
                if child is not None:
                    child.multi_map(event, out)
        elif 0 <= value < len(self.table):
            child = self.table[value]
            if child is not None:
                child.multi_map(event, out)

    def max_answer(self):
        answers = [c.max_answer() for c in self.table if c is not None]
        return max(answers) if answers else -1

    def write(self, writer):
        writer.write_token("TE")
        writer.write_int32(self.key)
        writer.write_int32(len(self.table))
        writer.write_token("(")
        for child in self.table:
            if child is None:
                writer.write_token("NULL")
            else:
                child.write(writer)
        writer.write_token(")")


@dataclass
class ContextDependency:
    """Decision tree: context width N, central position P, and the event map."""

    N: int
    P: int
    to_pdf: EventMap

    @classmethod
    def read(cls, reader: KaldiBinaryReader) -> "ContextDependency":
        reader.expect_token("ContextDependency")
        N = reader.read_int32()
        P = reader.read_int32()
        reader.expect_token("ToPdf")
        to_pdf = EventMap.read(reader)
        reader.expect_token("EndContextDependency")
        return cls(N=N, P=P, to_pdf=to_pdf)

    def write(self, writer: KaldiBinaryWriter) -> None:
        writer.write_token("ContextDependency")
        writer.write_int32(self.N)
        writer.write_int32(self.P)
        writer.write_token("ToPdf")
        self.to_pdf.write(writer)
        writer.write_token("EndContextDependency")

    @property
    def num_pdfs(self) -> int:
        return self.to_pdf.max_answer() + 1

    def compute_pdf(self, context: List[int], pdf_class: int) -> int:
        """pdf-id for a full phone context window (length N) + pdf class.

        Out-of-window positions (sentence boundaries) use phone id 0
        (epsilon), matching the reference's graph compiler behavior.
        """
        if len(context) != self.N:
            raise ValueError(f"context length {len(context)} != N={self.N}")
        event = {KPDF_CLASS: pdf_class}
        for i, p in enumerate(context):
            event[i] = p
        ans = self.to_pdf.map(event)
        if ans is None:
            raise KeyError(f"tree has no pdf for context={context} pdf_class={pdf_class}")
        return ans

    def pdfs_for_phone_pdf_class(self, phone: int, pdf_class: int) -> List[int]:
        """All pdf-ids reachable for (central phone, pdf-class) across contexts."""
        event = {KPDF_CLASS: pdf_class, self.P: phone}
        out: set = set()
        self.to_pdf.multi_map(event, out)
        return sorted(out)

    @classmethod
    def monophone(cls, phones: List[int], topo) -> "ContextDependency":
        """Flat-start monophone tree: TE over phones, each a TE over pdf
        classes with consecutively numbered leaves (spec: flat start in
        reference ``acoustic_modeling/monophone.py:298-339``).
        """
        max_phone = max(phones)
        table: List[Optional[EventMap]] = [None] * (max_phone + 1)
        pdf = 0
        for phone in sorted(phones):
            n_classes = topo.num_pdf_classes(phone)
            sub: List[Optional[EventMap]] = []
            for _ in range(n_classes):
                sub.append(ConstantEventMap(pdf))
                pdf += 1
            table[phone] = TableEventMap(KPDF_CLASS, sub)
        return cls(N=1, P=0, to_pdf=TableEventMap(0, table))
