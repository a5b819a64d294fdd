"""Neural speaker embeddings (x-vectors) for diarization.

Counterpart of ``montreal_forced_aligner_tpu/diarization/embeddings.py``
(behavioural spec: reference ``diarization/multiprocessing.py:610-749``,
the SpeechBrain ``EncoderClassifier`` workers, engaged when ``mfa
diarize_speakers`` is given ``speechbrain`` in place of an i-vector
extractor, ``speaker_diarizer.py:307``). Gated on the speechbrain package
and a local checkpoint directory; the model and each utterance's wave sit
on the embedder's device (``run_opts={"device": ...}``, as the package
expects), and the embeddings come back to the host for the same
clustering stack as i-vectors (``diarization/clustering.py``).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.device import resolve_device

logger = logging.getLogger("mfa_tpu")

MODEL_SAMPLE_RATE = 16000


def found_speechbrain() -> bool:
    try:
        import speechbrain  # noqa: F401

        return True
    except ImportError:
        return False


class XVectorEmbedder:
    """Per-utterance speaker embeddings from a locally available SpeechBrain
    ``EncoderClassifier`` checkpoint (x-vector or ECAPA family — the
    reference default is ``speechbrain/spkrec-ecapa-voxceleb``,
    ``diarization/multiprocessing.py:610``)."""

    def __init__(self, model_path, device="cuda"):
        self.device = resolve_device(device)
        if not found_speechbrain():
            raise RuntimeError(
                "speechbrain is not available; x-vector diarization needs "
                "the speechbrain package and a local checkpoint directory "
                "(pass an i-vector extractor archive instead for the "
                "device-native path)"
            )
        model_path = Path(model_path)
        if not model_path.exists():
            raise FileNotFoundError(
                f"no local SpeechBrain speaker checkpoint at {model_path}; "
                "this environment has no network egress, so weights must be "
                "provided as a local directory"
            )
        from speechbrain.inference.speaker import EncoderClassifier

        self.model = EncoderClassifier.from_hparams(
            source=str(model_path), savedir=str(model_path),
            run_opts={"device": str(self.device)},
        )

    def embed(
        self, samples: np.ndarray, sample_rate: int = MODEL_SAMPLE_RATE
    ) -> np.ndarray:
        """Embedding vector for one utterance's samples (int16-scaled)."""
        if sample_rate != MODEL_SAMPLE_RATE:
            from montreal_forced_aligner_tpu_torch.corpus.corpus import _resample
            from montreal_forced_aligner_tpu_torch.io.wav import WaveData

            wd = WaveData(
                samples=np.asarray(samples, dtype=np.float32),
                sample_rate=sample_rate,
                num_channels=1,
                duration=len(samples) / sample_rate,
            )
            samples = _resample(wd, MODEL_SAMPLE_RATE).samples
        wav = torch.from_numpy(
            np.asarray(samples, dtype=np.float32) / 32768.0
        ).unsqueeze(0).to(self.device)
        with torch.no_grad():
            emb = self.model.encode_batch(wav)
        return emb.cpu().numpy().reshape(-1)

    def embed_corpus(self, corpus) -> np.ndarray:
        """(num_utterances, E) embeddings, corpus utterance order."""
        out = []
        for utt in corpus.utterances:
            wav = corpus.load_audio(utt)
            out.append(self.embed(wav.samples, wav.sample_rate))
        return np.stack(out)


class XVectorDiarizer:
    """Speaker diarizer over neural embeddings: same clustering/PLDA stack
    as the i-vector :class:`SpeakerDiarizer`, different front end
    (reference engages this when ``--ivector_extractor_path speechbrain``)."""

    def __init__(self, embedder: XVectorEmbedder, plda=None,
                 metric: str = "cosine"):
        self.embedder = embedder
        self.plda = plda
        self.metric = metric

    def cluster_corpus(
        self,
        corpus,
        num_speakers: Optional[int] = None,
        threshold: Optional[float] = None,
        method: str = "agglomerative",
        min_cluster_size: int = 15,
    ):
        from montreal_forced_aligner_tpu_torch.diarization.clustering import (
            agglomerative_cluster,
            cluster_matrix,
            cosine_distance_matrix,
        )
        from montreal_forced_aligner_tpu_torch.diarization.speaker_diarizer import (
            DiarizationResult,
        )
        from montreal_forced_aligner_tpu_torch.ivector.extractor import (
            length_normalize,
        )

        emb = length_normalize(self.embedder.embed_corpus(corpus))
        if method == "agglomerative":
            if self.metric == "plda" and self.plda is not None:
                scores = self.plda.log_likelihood_ratio(emb, emb)
                d = -(scores + scores.T) / 2
                d -= d.min()
            else:
                d = cosine_distance_matrix(emb)
            labels = agglomerative_cluster(
                d, num_clusters=num_speakers, threshold=threshold
            )
        else:
            labels = cluster_matrix(
                emb,
                method,
                metric=(
                    self.metric
                    if self.metric != "plda" or self.plda
                    else "cosine"
                ),
                num_clusters=num_speakers,
                distance_threshold=threshold,
                min_cluster_size=min_cluster_size,
                plda=self.plda,
            )
        return DiarizationResult(labels=labels, ivectors=emb)
