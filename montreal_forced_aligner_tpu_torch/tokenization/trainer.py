"""Trainable tokenizers.

Behavioral spec: reference ``tokenization/trainer.py`` (``TokenizerTrainer``
``:419`` and the Phonetisaurus variant ``:265``): learn a transduction from
raw text to tokenized/normalized text from example pairs. The reference
trains pair-ngram FSTs with pynini/OpenGrm; here the same pair-ngram idea
reuses our G2P machinery — input characters play the grapheme role and
output characters (including the space) play the phone role — so training is
many-to-many EM + a Kneser-Ney pair-symbol LM, and inference is the G2P beam
search.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from montreal_forced_aligner_tpu_torch.g2p.generator import G2PGenerator
from montreal_forced_aligner_tpu_torch.g2p.trainer import G2PModel, G2PTrainer

logger = logging.getLogger("mfa_tpu")

SPACE = "▁"  # visible space marker on the output side


class TokenizerModel(G2PModel):
    """Same container as a G2P model; output symbols are characters."""


@dataclass
class TrainedTokenizer:
    model: G2PModel
    beam: int = 16

    def __post_init__(self):
        self._gen = G2PGenerator(self.model, beam=self.beam)

    def tokenize(self, text: str) -> str:
        """Raw text -> tokenized text (spaces restored from SPACE marks)."""
        out_parts = []
        for chunk in text.split():
            results = self._gen.generate(chunk, num_pronunciations=1)
            if not results:
                out_parts.append(chunk)
                continue
            chars, _score = results[0]
            joined = "".join(chars).replace(SPACE, " ")
            # reference tokenizer FSTs mark boundaries with <space>
            joined = joined.replace("<space>", " ")
            out_parts.append(joined.strip())
        return " ".join(p for p in out_parts if p)


class TokenizerTrainer:
    """Train from (raw, tokenized) utterance pairs (reference entry point:
    ``mfa train_tokenizer``)."""

    def __init__(self, order: int = 6, num_alignment_iterations: int = 6):
        self.order = order
        self.num_alignment_iterations = num_alignment_iterations

    def train_from_pairs(
        self, pairs: List[Tuple[str, str]]
    ) -> TrainedTokenizer:
        """pairs: [(raw_text, tokenized_text)]. Aligned word-chunk by
        word-chunk: raw whitespace chunks map to their tokenized output."""
        g2p_pairs = []
        for raw, tokenized in pairs:
            raw_chunks = raw.split()
            tok_out = tokenized.replace(" ", SPACE)
            if len(raw_chunks) == 1:
                g2p_pairs.append((raw, list(tok_out)))
            else:
                # align chunks 1:1 when counts match after tokenization of
                # each; otherwise treat the whole line as one unit
                tok_chunks = tokenized.split()
                if len(raw_chunks) == len(tok_chunks):
                    for r, t in zip(raw_chunks, tok_chunks):
                        g2p_pairs.append((r, list(t)))
                else:
                    g2p_pairs.append(
                        ("".join(raw_chunks), list(tok_out))
                    )
        trainer = G2PTrainer(
            order=self.order,
            grapheme_order=2,
            phone_order=2,
            num_alignment_iterations=self.num_alignment_iterations,
            # tokenization expands symbols (digits -> words), which needs
            # epsilon-grapheme insertions on the output side
            allow_insertions=True,
            allow_deletions=True,
        )
        model = trainer.train_from_pairs(g2p_pairs)
        model.meta["model_kind"] = "tokenizer"
        return TrainedTokenizer(model=model)
