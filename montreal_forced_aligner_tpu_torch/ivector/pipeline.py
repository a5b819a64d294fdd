"""Corpus -> i-vector feature batches (MFCC + sliding-window CMN + deltas).

Counterpart of ``montreal_forced_aligner_tpu/ivector/pipeline.py``
(behavioural spec: reference ``corpus/ivector_corpus.py`` and
``IvectorConfigMixin``, ``corpus/features.py:896``): i-vector features are
MFCCs with sliding-window CMN (Kaldi ``apply-cmvn-sliding``, see
:func:`~montreal_forced_aligner_tpu_torch.ops.feats.sliding_cmn`) and
deltas; frame subsampling happens downstream. Speaker-level CMVN is not
used (speakers may be unknown, as in diarization).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
from montreal_forced_aligner_tpu_torch.device import resolve_device
from montreal_forced_aligner_tpu_torch.ivector.extractor import (
    IvectorExtractor,
    extract_ivectors,
    length_normalize,
    train_ivector_extractor,
)
from montreal_forced_aligner_tpu_torch.ivector.plda import Plda
from montreal_forced_aligner_tpu_torch.ivector.ubm import train_ubm
from montreal_forced_aligner_tpu_torch.ops.feats import compute_deltas, sliding_cmn
from montreal_forced_aligner_tpu_torch.ops.mfcc import MfccConfig, compute_mfcc_batch
from montreal_forced_aligner_tpu_torch.training.base import PhaseClock


def corpus_feature_batches(
    corpus: Corpus,
    batch_size: int = 16,
    cfg: Optional[MfccConfig] = None,
    use_deltas: bool = True,
    device="cuda",
):
    """Returns (batches [(feats (B, T, D) float64 on ``device``, lens (B,)
    host)], order): batch row i of the concatenated batches is
    ``corpus.utterances[order[i]]`` (utterances sorted by length, stably).

    The features are float64 from the waveform on (the JAX package's are
    float32): the UBM's EM amplifies a change of 1e-6 in its input to about
    1e-4 in the model, and float32 MFCCs from the card's FFT and the CPU's
    differ by more than that."""
    dev = resolve_device(device)
    cfg = cfg or MfccConfig()
    waves = [corpus.load_audio(utt).samples for utt in corpus.utterances]
    order = list(np.argsort([len(w) for w in waves], kind="stable"))
    batches = []
    for lo in range(0, len(order), batch_size):
        idx = order[lo : lo + batch_size]
        feats, flens = compute_mfcc_batch([waves[i] for i in idx], cfg=cfg,
                                          device=dev, dtype=torch.float64)
        lens = torch.from_numpy(flens).to(dev)
        # Kaldi apply-cmvn-sliding (centred, 300-frame window, mean only),
        # the reference's i-vector normalisation
        # (``ivector/multiprocessing.py:108``); an utterance shorter than
        # the window gets whole-utterance CMN
        feats = sliding_cmn(feats, lens)
        if use_deltas:
            feats = compute_deltas(feats, lens)
        batches.append((feats, flens))
    return batches, order


def train_ivector_model(
    corpus: Corpus,
    num_gauss: int = 256,
    ivector_dim: int = 192,
    num_iterations: int = 10,
    batch_size: int = 16,
    train_plda: bool = True,
    device="cuda",
    clock: Optional[PhaseClock] = None,
) -> IvectorExtractor:
    """``mfa train_ivector``'s work: the corpus's i-vector features, a
    diagonal UBM, the T-matrix and, with ``train_plda`` and at least two
    speakers, a PLDA over the speaker-labelled i-vectors, bundled with the
    extractor. ``clock`` charges "features", "ubm", "stats", "em" and
    "plda"."""
    dev = resolve_device(device)
    clock = clock or PhaseClock(dev)
    with clock("features"):
        batches, order = corpus_feature_batches(corpus, batch_size=batch_size,
                                                device=dev)
    with clock("ubm"):
        ubm = train_ubm(batches, num_gauss=num_gauss, device=dev)
    extractor = train_ivector_extractor(batches, ubm, ivector_dim=ivector_dim,
                                        num_iterations=num_iterations,
                                        device=dev, clock=clock)
    if train_plda and len(corpus.speakers) >= 2:
        with clock("plda"):
            iv = length_normalize(extract_ivectors(extractor, batches, device=dev))
            spk_of = {s: i for i, s in enumerate(corpus.speakers)}
            speaker_ids = np.array(
                [spk_of[corpus.utterances[i].speaker] for i in order]
            )
            extractor.plda = Plda.train(iv, speaker_ids)
    return extractor
