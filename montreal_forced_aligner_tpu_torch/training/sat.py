"""Speaker-adapted training (SAT) with fMLLR.

Counterpart of ``montreal_forced_aligner_tpu/training/sat.py``; the fMLLR
statistics are the aligner's (``ops/transforms.accumulate_fmllr_stats``) and
the solve is the native row sweep (``estimate_speaker_fmllr``).

Behavioral spec: reference ``acoustic_modeling/sat.py`` — triphone-style
training on speaker-adapted features with per-speaker fMLLR transforms
re-estimated at iterations [2, 6, 12] (``:208-220,279``), silence frames
weighted out of the estimation (``corpus/features.py:608``
``silence_weight=0.0``), and a speaker-independent ``final.alimdl`` created
at the end from two-feature stats (``:258-307``).
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from montreal_forced_aligner_tpu_torch.models.transition_model import HmmTopology
from montreal_forced_aligner_tpu_torch.ops.transforms import (
    accumulate_fmllr_stats,
    estimate_speaker_fmllr,
)
from montreal_forced_aligner_tpu_torch.training.base import (
    TrainerConfig,
    TrainingPipeline,
    _accumulate_batch,
)
from montreal_forced_aligner_tpu_torch.training.triphone import TriphoneTrainer
from montreal_forced_aligner_tpu_torch.ops.stats import GmmAccumulators, mle_update

logger = logging.getLogger("mfa_tpu")


def compose_fmllr(new: np.ndarray, old: np.ndarray) -> np.ndarray:
    """Compose x -> A_new (A_old x + b_old) + b_new: (D, D+1) each."""
    D = new.shape[0]
    A_new, b_new = new[:, :D], new[:, D]
    A_old, b_old = old[:, :D], old[:, D]
    A = A_new @ A_old
    b = A_new @ b_old + b_new
    return np.hstack([A, b[:, None]]).astype(np.float32)


class SatTrainer(TriphoneTrainer):
    train_type = "sat"

    def __init__(
        self,
        lexicon,
        topo: HmmTopology,
        config: Optional[TrainerConfig] = None,
        num_leaves: int = 2500,
        fmllr_iterations: Optional[List[int]] = None,
        fmllr_min_count: float = 500.0,
        lda_mat: Optional[np.ndarray] = None,
        quick: bool = False,
        **kwargs,
    ):
        super().__init__(lexicon, topo, config, num_leaves=num_leaves, **kwargs)
        self.quick = quick
        if fmllr_iterations is not None:
            self.fmllr_iterations = fmllr_iterations
        else:
            # reference sat.py:208-220: standard [2,4,6,12]; quick [2,6,12]
            self.fmllr_iterations = [2, 6, 12] if quick else [2, 4, 6, 12]
        self.fmllr_min_count = fmllr_min_count
        self.lda_mat = lda_mat
        self.speaker_transforms: Optional[np.ndarray] = None
        self.alignment_gmm = None  # speaker-independent model for pass 1

    @property
    def realignment_iterations(self) -> List[int]:
        # quick variant realigns only at [10, 15] (reference sat.py:208-220)
        if self.quick:
            return [i for i in (10, 15) if i < self.config.num_iterations]
        return super().realignment_iterations

    def _base_feature_kwargs(self) -> dict:
        if self.lda_mat is not None:
            return dict(uses_deltas=False, lda_mat=self.lda_mat)
        return dict(uses_deltas=True, lda_mat=None)

    def _silence_weight_mask(self, fb, sil_mask_dev):
        """0.0 on silence-phone frames, else 1.0 (silence_weight=0.0);
        computed on device from a (P,) silence-pdf mask — fetching the
        per-frame pdfs to the host cost a (B, T) d2h round trip per batch."""
        from montreal_forced_aligner_tpu_torch.ops.feats import (
            nonsilence_weight,
        )

        return nonsilence_weight(fb.frame_pdf, sil_mask_dev)

    def _estimate_fmllr(self, pipeline: TrainingPipeline) -> None:
        # the device-resident EM keeps the model on device between host
        # syncs; this hook reads self.gmm, so sync first
        self.sync_host_model(pipeline)
        # dense speaker space of the (rank's) corpus
        S = len(pipeline.corpus.speakers)
        D = pipeline.feature_dim
        K = np.zeros((S, D, D + 1))
        G = np.zeros((S, D, D + 1, D + 1))
        beta = np.zeros(S)
        means = pipeline.put_rep(self.gmm.get_means())
        iv = pipeline.put_rep(self.gmm.inv_vars)
        gc = pipeline.put_rep(self.gmm.gconsts)
        miv = pipeline.put_rep(self.gmm.means_invvars)
        from montreal_forced_aligner_tpu_torch.ops.feats import silence_pdf_mask

        sil_mask = pipeline.put_rep(
            silence_pdf_mask(self._silence_pdfs(), self.gmm.num_pdfs)
        )
        pending = []
        for fb in pipeline.batches:
            weight = self._silence_weight_mask(fb, sil_mask)
            out = accumulate_fmllr_stats(
                fb.put_b(fb.feats),
                pipeline.put_b(fb.frame_lengths),
                fb.frame_pdf,
                pipeline.put_b(fb.speaker_idx),
                weight,
                means,
                iv,
                gc,
                miv,
                S,
            )
            pending.append(out)
        from montreal_forced_aligner_tpu_torch.training.base import fetch_all

        # a rank holds its speakers whole (the corpus shards by speaker):
        # their transforms come from this rank's statistics alone
        for k, g, b in fetch_all(pending):
            K += k
            G += g
            beta += b
        inc = estimate_speaker_fmllr(K, G, beta, min_count=self.fmllr_min_count)
        if self.speaker_transforms is None:
            self.speaker_transforms = inc
        else:
            self.speaker_transforms = np.stack(
                [
                    compose_fmllr(inc[s], self.speaker_transforms[s])
                    for s in range(S)
                ]
            )
        pipeline.set_feature_transform(
            **self._base_feature_kwargs(),
            speaker_transforms=self.speaker_transforms,
        )
        self._realign(pipeline)
        logger.info(
            "estimated fMLLR for %d/%d speakers (beta median %.0f)",
            int((beta >= self.fmllr_min_count).sum()), S, float(np.median(beta)),
        )

    def post_iteration(self, iteration: int, pipeline: TrainingPipeline) -> None:
        if iteration in self.fmllr_iterations:
            with pipeline.clock("fmllr"):
                self._estimate_fmllr(pipeline)

    def finalize(self, pipeline: TrainingPipeline) -> None:
        """Create the speaker-independent alignment model from SI-feature
        stats under the adapted alignment (two-feats stats,
        reference ``sat.py:258-307``)."""
        if self.speaker_transforms is None:
            return
        with pipeline.clock("sat_finalize"):
            self._finalize_alignment_model(pipeline)

    def _finalize_alignment_model(self, pipeline: TrainingPipeline) -> None:
        # SI features, adapted alignments
        pipeline.set_feature_transform(**self._base_feature_kwargs())
        # restore alignments (set_feature_transform clears them)
        W, _ = self.gmm.flatten_for_device()
        acc = GmmAccumulators.zeros(
            self.gmm.num_pdfs, self.gmm.max_gauss, self.gmm.dim,
            self.tm.num_transition_ids,
        )
        gconsts = pipeline.put_rep(self.gmm.gconsts)
        Wj = pipeline.put_rep(W)
        pending = []
        for fb in pipeline.batches:
            # recover the alignment labels from the cached state paths
            sp = fb.host_state_path()
            b = np.arange(sp.shape[0])[:, None]
            frame_pdf = fb.put_b(fb.garrs["state_pdf"][b, sp])
            fb.frame_pdf = frame_pdf
            out = _accumulate_batch(
                fb.put_b(fb.feats),  # SI features
                pipeline.put_b(fb.frame_lengths),
                frame_pdf,
                Wj,
                gconsts,
                self.gmm.num_pdfs,
            )
            pending.append((fb, out))
        from montreal_forced_aligner_tpu_torch.training.base import fetch_all

        fetched = fetch_all([out for _fb, out in pending])
        for (fb, _out), (occ, mean_acc, var_acc, ll) in zip(pending, fetched):
            ft = fb.host_frame_tid()
            tcounts = np.bincount(
                ft[ft > 0],
                minlength=self.tm.num_transition_ids + 1,
            ) if ft is not None else np.zeros(self.tm.num_transition_ids + 1)
            acc.add(occ, mean_acc, var_acc, tcounts, float(ll),
                    float(fb.frame_lengths.sum()))
        pipeline.reduce_accumulators(acc)
        self.alignment_gmm, _ = mle_update(
            self.gmm, acc, min_gaussian_occupancy=self.config.min_gaussian_occupancy
        )
        # put the adapted features back for any subsequent stage
        pipeline.set_feature_transform(
            **self._base_feature_kwargs(),
            speaker_transforms=self.speaker_transforms,
        )
        for fb in pipeline.batches:
            sp = fb.host_state_path()
            b = np.arange(sp.shape[0])[:, None]
            fb.frame_pdf = fb.put_b(fb.garrs["state_pdf"][b, sp])

    def feature_meta(self) -> dict:
        return {
            "type": "mfcc",
            "deltas": self.lda_mat is None,
            "lda": self.lda_mat is not None,
            "fmllr": True,
            "pitch": getattr(self, "use_pitch", False),
            "frame_shift": 10,
            "splice_left_context": 3 if self.lda_mat is not None else None,
            "splice_right_context": 3 if self.lda_mat is not None else None,
        }

    def export_model(self):
        model = super().export_model()
        model.lda_mat = self.lda_mat
        if self.alignment_gmm is not None:
            model.alignment_model = (self.tm, self.alignment_gmm)
        return model


