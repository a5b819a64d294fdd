"""MAP adaptation of a pretrained model to a new corpus, in PyTorch on one
device.

Counterpart of ``montreal_forced_aligner_tpu/training/adapt.py``. Behavioral
spec: reference ``alignment/adapting.py`` (``AdaptingAligner``): run the
full alignment workflow — for SAT models that is pass-1 alignment with the
speaker-independent ``final.alimdl``, per-speaker fMLLR estimation, then
pass-2 alignment on the transformed features (``alignment/base.py:491-558``
via ``AdaptingAligner.align()``, ``adapting.py:200-260``) — then accumulate
GMM stats, I-smooth with ``mapping_tau=20`` pseudo-counts and MLE-update
*means only* (``adapting.py:86-135``). The primary model accumulates on the
fMLLR-transformed features; the speaker-independent alignment model
accumulates on SI features under the same (pass-2) alignment — the
two-feats semantics of ``AccStatsTwoFeatsFunction`` (``sat.py:46``).

With a distributed aligner each rank adapts on its own speakers: it
estimates their fMLLR transforms from its own statistics (a speaker's
statistics never leave its rank) and the MAP statistics are reduced over
the ranks. Both passes align through the training alignment
(``training/base.py``): the state-emission kernel K3 when the model is large enough, then the band
Viterbi kernels K1 and K2. Both models align unboosted, as the reference
package's adaptation does. The statistics sum in a fixed order
(``ops/stats.py``) and the per-batch fMLLR and GMM sums are added in float64
on the host in batch order, so two runs on one card give identical models.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from montreal_forced_aligner_tpu_torch.align.aligner import (
    AlignerConfig,
    PretrainedAligner,
)
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
from montreal_forced_aligner_tpu_torch.models.acoustic_model import AcousticModel
from montreal_forced_aligner_tpu_torch.ops.stats import (
    GmmAccumulators,
    ismooth_stats_from_model,
    mle_update,
)
from montreal_forced_aligner_tpu_torch.training.base import (
    TrainingPipeline,
    _accumulate_batch,
    _align_batch,
    fetch_all,
    train_gmm,
)

logger = logging.getLogger("mfa_tpu")


class MapAdapter:
    """Adapt a pretrained acoustic model to a corpus (reference entry point:
    ``mfa adapt``). ``device`` defaults to the card and raises without one.
    After :meth:`adapt`, ``phase_seconds`` holds its host-clock seconds by
    phase (with the card synchronised at each boundary when
    ``sync_phases`` is set) and ``pipeline`` the feature batches."""

    def __init__(
        self,
        acoustic_model_path,
        dictionary_path,
        mapping_tau: float = 20.0,
        config: Optional[AlignerConfig] = None,
        device="cuda",
    ):
        self.aligner = PretrainedAligner(
            acoustic_model_path, dictionary_path, config, device=device
        )
        self.device = self.aligner.device
        self.mapping_tau = mapping_tau
        self.sync_phases = False
        self.phase_seconds = {}
        self.pipeline: Optional[TrainingPipeline] = None

    # -- alignment over the training pipeline --------------------------------
    def _align_paths(self, pipeline, gmm) -> None:
        """Viterbi-align every batch with ``gmm`` (unboosted) on the
        pipeline's current features; the alignment stays on the batches."""
        W, gconsts = gmm.flatten_for_device()
        model = train_gmm(
            pipeline.put_rep(W), pipeline.put_rep(gconsts),
            pipeline.put_rep(gmm.means_invvars), pipeline.put_rep(gmm.inv_vars),
        )
        scale = self.aligner.config.acoustic_scale
        for fb in pipeline.batches:
            out = _align_batch(
                fb.put_b(fb.feats), pipeline.put_b(fb.frame_lengths), fb.graph,
                model, scale, band_limits=fb.band_limits,
            )
            fb.set_device_alignment(out[0], out[1], fb.graph)

    def _estimate_fmllr(self, pipeline, gmm) -> np.ndarray:
        """Per-speaker fMLLR transforms from the current alignment
        (reference ``calc_fmllr`` within the align workflow,
        ``corpus/features.py:422-548``, silence_weight=0): statistics on the
        device per batch, summed on the host in float64 in batch order."""
        from montreal_forced_aligner_tpu_torch.ops.feats import (
            nonsilence_weight,
            silence_pdf_mask,
        )
        from montreal_forced_aligner_tpu_torch.ops.transforms import (
            accumulate_fmllr_stats,
            estimate_speaker_fmllr,
        )
        from montreal_forced_aligner_tpu_torch.params import fmllr_params_from_numpy

        S = len(pipeline.corpus.speakers)
        fm = fmllr_params_from_numpy(
            gmm, silence_pdf_mask(self.aligner._silence_pdfs(), gmm.num_pdfs)
        ).to(pipeline.device)
        pending = []
        for fb in pipeline.batches:
            pending.append(
                accumulate_fmllr_stats(
                    fb.put_b(fb.feats),
                    pipeline.put_b(fb.frame_lengths),
                    fb.frame_pdf,
                    pipeline.put_b(fb.speaker_idx.astype(np.int64)),
                    nonsilence_weight(fb.frame_pdf, fm.sil_mask),
                    fm.means, fm.inv_vars, fm.gconsts, fm.miv, S,
                )
            )
        D = gmm.dim
        K = np.zeros((S, D, D + 1))
        G = np.zeros((S, D, D + 1, D + 1))
        beta = np.zeros(S)
        for k, g, b in fetch_all(pending):
            K += k.astype(np.float64)
            G += g.astype(np.float64)
            beta += b.astype(np.float64)
        return estimate_speaker_fmllr(
            K, G, beta, min_count=self.aligner.config.fmllr_min_count
        )

    def _accumulate_stats(self, pipeline, gmm, tm) -> GmmAccumulators:
        """GMM stats for the pipeline's alignment on its *current* features
        (callers switch features for the two-feats pass); each batch's
        frames-by-pdf layout is made once per alignment and kept."""
        W, gconsts = gmm.flatten_for_device()
        W = pipeline.put_rep(W)
        gconsts = pipeline.put_rep(gconsts)
        acc = GmmAccumulators.zeros(
            gmm.num_pdfs, gmm.max_gauss, gmm.dim, tm.num_transition_ids
        )
        pending = []
        for fb in pipeline.batches:
            pending.append(
                _accumulate_batch(
                    fb.put_b(fb.feats),
                    pipeline.put_b(fb.frame_lengths),
                    fb.frame_pdf,
                    W,
                    gconsts,
                    gmm.num_pdfs,
                    layout=fb.pdf_layout(gmm.num_pdfs),
                )
            )
        for occ, mean_acc, var_acc, ll in fetch_all(pending):
            acc.add(
                occ, mean_acc, var_acc,
                np.zeros(tm.num_transition_ids + 1),
                float(ll), 0.0,
            )
        return pipeline.reduce_accumulators(acc)

    def _map_update(self, gmm, acc):
        acc = ismooth_stats_from_model(gmm, acc, self.mapping_tau)
        new_gmm, _ = mle_update(gmm, acc, update_flags="m")
        return new_gmm

    def adapt(
        self, corpus_directory, speaker_characters=0, audio_directory=None
    ) -> AcousticModel:
        model = self.aligner.model
        corpus = Corpus.load(
            corpus_directory,
            speaker_characters=speaker_characters,
            audio_directory=audio_directory,
        )
        # a distributed aligner's ranks adapt on their own speakers and
        # reduce the statistics (a single process keeps one device)
        mesh = self.aligner.mesh
        if mesh is not None and len(mesh.devices) != 1:
            mesh = None
        if mesh is not None and mesh.world_size > 1:
            from montreal_forced_aligner_tpu_torch.parallel.multihost import (
                shard_corpus,
            )

            corpus = shard_corpus(corpus)[0]
        pipeline = TrainingPipeline(
            corpus,
            self.aligner.lexicon,
            mfcc_config=self.aligner.mfcc_config,
            batch_size=self.aligner.config.batch_size,
            uses_deltas=model.uses_deltas,
            lda_mat=model.lda_mat,
            use_pitch=self.aligner.use_pitch,
            mesh=mesh,
            device=self.device,
        )
        clock = pipeline.clock
        clock.sync = self.sync_phases
        self.pipeline = pipeline
        self.phase_seconds = clock.seconds
        pipeline.prepare_features()
        pipeline.compile_graphs(self.aligner.compiler)

        two_pass = model.uses_fmllr and model.alignment_model is not None
        if two_pass:
            # reference AdaptingAligner runs the full SAT align workflow:
            # pass 1 with final.alimdl on SI features, per-speaker fMLLR,
            # pass 2 with final.mdl on transformed features
            # (alignment/base.py:491-558)
            ali_tm, ali_gmm = model.alignment_model
            with clock("pass_1"):
                self._align_paths(pipeline, ali_gmm)
            with clock("fmllr"):
                transforms = self._estimate_fmllr(pipeline, model.gmm)
                pipeline.set_feature_transform(
                    uses_deltas=model.uses_deltas and model.lda_mat is None,
                    lda_mat=model.lda_mat,
                    speaker_transforms=transforms,
                )
            with clock("pass_2"):
                self._align_paths(pipeline, model.gmm)
            n_est = int(
                (np.abs(transforms[:, :, -1]).sum(axis=1) > 0).sum()
            )
            logger.info(
                "adapt: estimated fMLLR for %d speakers before pass 2", n_est
            )
        else:
            with clock("pass_1"):
                self._align_paths(pipeline, model.gmm)

        # adapt the primary model on the (possibly transformed) features
        with clock("stats"):
            acc = self._accumulate_stats(pipeline, model.gmm, model.transition_model)
        total = acc.occ.sum()
        with clock("map_update"):
            new_gmm = self._map_update(model.gmm, acc)
        logger.info("MAP-adapted %d pdfs over %.0f frames", new_gmm.num_pdfs, total)

        adapted = AcousticModel(
            transition_model=model.transition_model,
            gmm=new_gmm,
            tree=model.tree,
            meta=dict(model.meta),
            phone_table=dict(model.phone_table),
            lda_mat=model.lda_mat,
        )
        # adapt the speaker-independent alignment model with SI features
        # under the same pass-2 alignment (two-feats stats, sat.py:46)
        if model.alignment_model is not None:
            ali_tm, ali_gmm = model.alignment_model
            with clock("si_stats"):
                if two_pass:
                    # keep the alignment, swap the features back to SI; the
                    # alignment set back makes a new frame_pdf tensor, so each
                    # batch's frames-by-pdf layout is made again
                    paths = [fb.host_state_path() for fb in pipeline.batches]
                    scores = [fb.host_align_scores() for fb in pipeline.batches]
                    tids = [fb.host_frame_tid() for fb in pipeline.batches]
                    pipeline.set_feature_transform(
                        uses_deltas=model.uses_deltas and model.lda_mat is None,
                        lda_mat=model.lda_mat,
                    )
                    for fb, sp, sc, ft in zip(pipeline.batches, paths, scores, tids):
                        fb.set_host_alignment(sp, ft, sc)
                acc2 = self._accumulate_stats(pipeline, ali_gmm, ali_tm)
            with clock("si_map_update"):
                adapted.alignment_model = (ali_tm, self._map_update(ali_gmm, acc2))
        return adapted
