"""Speaker diarization / classification over i-vectors.

Counterpart of ``montreal_forced_aligner_tpu/diarization/speaker_diarizer.py``
(behavioural spec: reference ``diarization/speaker_diarizer.py``,
``SpeakerDiarizer``: extract utterance i-vectors, cluster them
(``cluster_utterances`` ``:1074``) or classify them against enrolled
speakers with PLDA (``classify_speakers`` ``:307``), then relabel the
corpus). The i-vectors are extracted on the diarizer's device; clustering
and scoring run on the host.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
from montreal_forced_aligner_tpu_torch.device import resolve_device
from montreal_forced_aligner_tpu_torch.diarization.clustering import (
    agglomerative_cluster,
    cluster_matrix,
    cosine_distance_matrix,
)
from montreal_forced_aligner_tpu_torch.ivector.extractor import (
    IvectorExtractor,
    extract_ivectors,
    length_normalize,
)
from montreal_forced_aligner_tpu_torch.ivector.plda import Plda

logger = logging.getLogger("mfa_tpu")


@dataclass
class DiarizationResult:
    labels: np.ndarray  # (num_utterances,) cluster/speaker index
    ivectors: np.ndarray  # (num_utterances, R)


class SpeakerDiarizer:
    def __init__(
        self,
        extractor: IvectorExtractor,
        plda: Optional[Plda] = None,
        metric: str = "cosine",
        device="cuda",
    ):
        self.extractor = extractor
        self.plda = plda
        self.metric = metric
        self.device = resolve_device(device)

    def utterance_ivectors(self, feature_batches) -> np.ndarray:
        iv = extract_ivectors(self.extractor, feature_batches, device=self.device)
        return length_normalize(iv)

    def cluster_utterances(
        self,
        feature_batches,
        num_speakers: Optional[int] = None,
        threshold: Optional[float] = None,
        method: str = "agglomerative",
        min_cluster_size: int = 15,
    ) -> DiarizationResult:
        """Cluster utterance i-vectors with any of the reference's
        ``ClusterType`` algorithms (``cluster_utterances``,
        ``speaker_diarizer.py:1074`` -> ``cluster_matrix``,
        ``multiprocessing.py:245``)."""
        iv = self.utterance_ivectors(feature_batches)
        if method == "agglomerative":
            if self.metric == "plda" and self.plda is not None:
                scores = self.plda.log_likelihood_ratio(iv, iv)
                d = -(scores + scores.T) / 2
                d -= d.min()
            else:
                d = cosine_distance_matrix(iv)
            labels = agglomerative_cluster(
                d, num_clusters=num_speakers, threshold=threshold
            )
        else:
            labels = cluster_matrix(
                iv,
                method,
                metric=self.metric if self.metric != "plda" or self.plda else "cosine",
                num_clusters=num_speakers,
                distance_threshold=threshold,
                min_cluster_size=min_cluster_size,
                plda=self.plda,
            )
        return DiarizationResult(labels=labels, ivectors=iv)

    def classify_speakers(
        self,
        feature_batches,
        enrolled: Dict[str, np.ndarray],
        ivectors: Optional[np.ndarray] = None,
    ) -> List[str]:
        """Assign each utterance the enrolled speaker with the best score
        (PLDA if available, else cosine). Pass ``ivectors`` to reuse
        already-extracted utterance i-vectors."""
        iv = (
            ivectors
            if ivectors is not None
            else self.utterance_ivectors(feature_batches)
        )
        names = list(enrolled)
        enroll = length_normalize(np.stack([enrolled[n] for n in names]))
        if self.plda is not None:
            scores = self.plda.log_likelihood_ratio(enroll, iv)  # (E, N)
        else:
            a = enroll / np.linalg.norm(enroll, axis=1, keepdims=True)
            b = iv / np.linalg.norm(iv, axis=1, keepdims=True)
            scores = a @ b.T
        best = scores.argmax(axis=0)
        return [names[i] for i in best]

    def relabel_corpus(
        self,
        corpus: Corpus,
        labels: np.ndarray,
        order: Sequence[int],
        prefix: str = "speaker",
    ) -> Corpus:
        """Overwrite utterance speakers with cluster labels (reference
        export path ``speaker_diarizer.py:1505``). ``labels`` are in batch
        order: label i belongs to ``corpus.utterances[order[i]]``, the
        ``order`` that ``corpus_feature_batches`` returns. (The JAX
        package pairs them with the corpus order, which relabels the wrong
        utterances whenever the batches sorted them by length.)"""
        for pos, utt_idx in enumerate(order):
            corpus.utterances[utt_idx].speaker = f"{prefix}{int(labels[pos])}"
        corpus.speakers = sorted({u.speaker for u in corpus.utterances})
        return corpus
