"""Programmatic batch-alignment API.

Counterpart of ``montreal_forced_aligner_tpu/wrapper.py`` in the port: the
same record schema and output dicts, aligned by the port's
``PretrainedAligner`` on ``device`` (the card by default; ``"cpu"`` runs the
plain PyTorch versions of the kernels).

Behavioral spec: the fork's ``wrapper.py:13-139`` (class ``MFA``): take a
list of records ``{"speaker_id", "file_id", "text", "audio_path"}`` (or
in-memory samples), align them with a pretrained model + dictionary, and
return per-record word/phone intervals. The fork built a temporary corpus
directory and shelled through ``PretrainedAligner``; here records feed the
corpus pipeline directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from montreal_forced_aligner_tpu_torch.align.aligner import AlignerConfig, PretrainedAligner
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus, Utterance
from montreal_forced_aligner_tpu_torch.data import UtteranceAlignment


class MFA:
    """Batch alignment API (fork parity: ``wrapper.MFA``)."""

    def __init__(
        self,
        acoustic_model_path,
        dictionary_path,
        config: Optional[AlignerConfig] = None,
        g2p_model_path=None,
        device="cuda",
    ):
        self.aligner = PretrainedAligner(
            acoustic_model_path,
            dictionary_path,
            config,
            g2p_model_path=g2p_model_path,
            device=device,
        )
        mesh = self.aligner.mesh
        if mesh is not None and mesh.world_size > 1:
            # a rank's shard would lose the in-memory samples, and ranks
            # given other records would merge results by record index
            raise ValueError(
                "MFA aligns the records it is given in its own process: give "
                "each rank its own records and no AlignerConfig(distributed=True)")

    def align(
        self, records: Sequence[Dict]
    ) -> List[Dict]:
        """records: dicts with ``text`` and either ``audio_path`` or
        ``samples`` (+ optional ``speaker_id``, ``file_id``, ``begin``,
        ``end``). Returns one dict per record with ``words`` and ``phones``
        interval lists."""
        corpus = Corpus()
        speakers = set()
        for i, rec in enumerate(records):
            speaker = str(rec.get("speaker_id", "speaker"))
            speakers.add(speaker)
            corpus.utterances.append(
                Utterance(
                    id=i,
                    speaker=speaker,
                    file_path=rec.get("audio_path"),
                    file_name=str(rec.get("file_id", i)),
                    begin=float(rec.get("begin", 0.0)),
                    end=rec.get("end"),
                    channel=int(rec.get("channel", 0)),
                    text=rec["text"],
                )
            )
            if "samples" in rec:
                corpus.utterances[-1]._samples = np.asarray(
                    rec["samples"], dtype=np.float32
                )
        corpus.speakers = sorted(speakers)

        original_load = corpus.load_audio

        def load_audio(utt, native=False):
            if hasattr(utt, "_samples"):
                from montreal_forced_aligner_tpu_torch.io.wav import WaveData

                sr = self.aligner.mfcc_config.sample_rate
                return WaveData(
                    samples=utt._samples,
                    sample_rate=sr,
                    num_channels=1,
                    duration=len(utt._samples) / sr,
                )
            return original_load(utt, native=native)

        corpus.load_audio = load_audio
        results = self.aligner.align_corpus(corpus)
        out = []
        for i, rec in enumerate(records):
            aln: Optional[UtteranceAlignment] = results.get(i)
            if aln is None:
                out.append({"file_id": rec.get("file_id", i), "words": [], "phones": []})
                continue
            out.append(
                {
                    "file_id": rec.get("file_id", i),
                    "speaker_id": rec.get("speaker_id", "speaker"),
                    "log_likelihood": aln.per_frame_log_likelihood,
                    "words": [
                        {
                            "word": w.label,
                            "begin": round(w.begin, 4),
                            "end": round(w.end, 4),
                        }
                        for w in aln.words
                    ],
                    "phones": [
                        {
                            "phone": p.label,
                            "begin": round(p.begin, 4),
                            "end": round(p.end, 4),
                        }
                        for p in aln.phones
                    ],
                }
            )
        return out
