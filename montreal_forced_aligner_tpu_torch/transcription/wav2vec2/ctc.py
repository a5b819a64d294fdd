"""Greedy CTC decoding: each frame's best character, repeats collapsed,
the blank dropped, the word delimiter read as a space (as
``Wav2Vec2CTCTokenizer.decode`` does with its defaults)."""

from __future__ import annotations

from itertools import groupby
from typing import Dict, List

import torch

BLANK = "<pad>"
UNKNOWN = "<unk>"
WORD_DELIMITER = "|"


def greedy_ids(log_probs: torch.Tensor) -> torch.Tensor:
    """(T, vocab) -> (T,) each frame's best id, on the same device."""
    return log_probs.argmax(dim=-1)


def collapse(ids: List[int], vocab: Dict[str, int]) -> str:
    """The text of a frame-id sequence: runs of one id read once, blanks
    dropped, the delimiter a space, the rest joined and stripped."""
    chars = {i: c for c, i in vocab.items()}
    out = [chars.get(i, UNKNOWN) for i, _ in groupby(ids)]
    out = [" " if c == WORD_DELIMITER else c for c in out if c != BLANK]
    return "".join(out).strip()


def decode(log_probs: torch.Tensor, vocab: Dict[str, int]) -> str:
    """The greedy transcript of one utterance's log-probabilities (waits
    for the card to fetch the ids)."""
    return collapse(greedy_ids(log_probs).tolist(), vocab)
