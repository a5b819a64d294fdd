"""Transcript-guided segmentation of long recordings.

Behavioral spec: reference ``SegmentTranscriptFunction``
(``vad/multiprocessing.py:409``) and ``TranscriptionSegmenter``
(``vad/segmenter.py:575``): split a long transcribed file into utterance
segments by aligning the full transcript and cutting at aligned silences,
carrying the corresponding transcript words into each segment.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from montreal_forced_aligner_tpu_torch.data import UtteranceAlignment


@dataclass
class TranscriptSegment:
    begin: float
    end: float
    text: str


def segments_from_alignment(
    alignment: UtteranceAlignment,
    min_pause: float = 0.15,
    max_segment_length: float = 30.0,
    padding: float = 0.05,
) -> List[TranscriptSegment]:
    """Cut an aligned utterance at silences longer than ``min_pause``,
    keeping segments under ``max_segment_length`` where possible."""
    words = sorted(alignment.words, key=lambda w: w.begin)
    if not words:
        return []
    segments: List[TranscriptSegment] = []
    cur_words = [words[0]]

    def flush():
        segments.append(
            TranscriptSegment(
                begin=max(cur_words[0].begin - padding, 0.0),
                end=cur_words[-1].end + padding,
                text=" ".join(w.label for w in cur_words),
            )
        )

    for prev, nxt in zip(words[:-1], words[1:]):
        gap = nxt.begin - prev.end
        would_exceed = (nxt.end - cur_words[0].begin) > max_segment_length
        if gap >= min_pause or would_exceed:
            flush()
            cur_words = [nxt]
        else:
            cur_words.append(nxt)
    flush()
    return segments


def segment_transcribed_file(
    aligner,
    samples: np.ndarray,
    text: str,
    min_pause: float = 0.15,
    max_segment_length: float = 30.0,
) -> List[TranscriptSegment]:
    """Align a long transcribed waveform and split it into utterances."""
    from montreal_forced_aligner_tpu_torch.online.alignment import (
        align_utterance_online,
    )

    alignment = align_utterance_online(aligner, samples, text)
    return segments_from_alignment(
        alignment, min_pause=min_pause, max_segment_length=max_segment_length
    )
