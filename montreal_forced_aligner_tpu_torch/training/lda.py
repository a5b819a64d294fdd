"""LDA + MLLT training stage.

Counterpart of ``montreal_forced_aligner_tpu/training/lda.py``; the LDA and
MLLT statistics accumulate on the device (``ops/transforms.py``), the
transforms are solved on the host.

Behavioral spec: reference ``acoustic_modeling/lda.py`` — splice ±3 frames,
estimate a 40-dim LDA transform from the previous stage's alignments
(``:54-120,314-370``), then triphone-style training on LDA features with
MLLT (STC) re-estimation at iterations [2, 4, 6, 12] composed into the
transform and into the model means (``:122-181,372-455``).
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

from montreal_forced_aligner_tpu_torch.models.transition_model import HmmTopology
from montreal_forced_aligner_tpu_torch.ops.feats import splice_frames
from montreal_forced_aligner_tpu_torch.ops.transforms import (
    accumulate_lda_stats,
    accumulate_mllt_stats,
    estimate_lda,
    solve_mllt,
)
from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig, TrainingPipeline
from montreal_forced_aligner_tpu_torch.training.triphone import TriphoneTrainer

logger = logging.getLogger("mfa_tpu")


class LdaTrainer(TriphoneTrainer):
    train_type = "lda"

    def __init__(
        self,
        lexicon,
        topo: HmmTopology,
        config: Optional[TrainerConfig] = None,
        num_leaves: int = 2500,
        lda_dimension: int = 40,
        splice_left: int = 3,
        splice_right: int = 3,
        mllt_iterations: Optional[List[int]] = None,
        **kwargs,
    ):
        super().__init__(lexicon, topo, config, num_leaves=num_leaves, **kwargs)
        self.lda_dimension = lda_dimension
        self.splice_left = splice_left
        self.splice_right = splice_right
        self.mllt_iterations = (
            mllt_iterations if mllt_iterations is not None else [2, 4, 6, 12]
        )
        self.lda_mat: Optional[np.ndarray] = None

    def _estimate_lda(self, pipeline: TrainingPipeline, num_classes: int) -> None:
        # the spliced width of the raw features: pitch models paste their
        # pitch columns after CMVN and splice the pasted width (reference
        # ``FinalFeatureFunction``, ``corpus/features.py:254``)
        D_spliced = pipeline.raw_dim * (
            self.splice_left + 1 + self.splice_right
        )
        counts = np.zeros(num_classes)
        sums = np.zeros((num_classes, D_spliced))
        second = np.zeros((D_spliced, D_spliced))
        pending = []
        for fb in pipeline.batches:
            assert fb.frame_pdf is not None, "previous-stage alignment required"
            spliced = splice_frames(
                fb.put_b(fb.raw),
                pipeline.put_b(fb.frame_lengths),
                self.splice_left,
                self.splice_right,
            )
            out = accumulate_lda_stats(
                spliced,
                pipeline.put_b(fb.frame_lengths),
                fb.frame_pdf,
                num_classes,
            )
            pending.append(out)
        from montreal_forced_aligner_tpu_torch.training.base import fetch_all

        for c, s, sec in fetch_all(pending):
            counts += c
            sums += s
            second += sec
        counts, sums, second = pipeline.reduce_host(counts, sums, second)
        self.lda_mat = estimate_lda(
            counts, sums, second, target_dim=self.lda_dimension
        )
        logger.info("estimated LDA transform %s", self.lda_mat.shape)

    def initialize(self, pipeline: TrainingPipeline) -> None:
        with pipeline.clock("tree"):
            # labels + LDA estimation use the previous stage's alignment/features
            labels = self._extract_labels(pipeline)
            # the previous stage's pdf count, the largest over the ranks
            prev_num_classes = max(
                (int(fb.frame_pdf.max().item()) + 1 for fb in pipeline.batches),
                default=0,
            )
            if pipeline.world_size > 1:
                from montreal_forced_aligner_tpu_torch.parallel.multihost import (
                    host_allreduce_max,
                )

                prev_num_classes = host_allreduce_max(prev_num_classes)
            self._estimate_lda(pipeline, prev_num_classes)
            pipeline.set_feature_transform(uses_deltas=False, lda_mat=self.lda_mat)

            # triphone-style init on the LDA features
            dim = pipeline.feature_dim
            tree_stats = self._accumulate_tree_stats(labels, dim)
            from montreal_forced_aligner_tpu_torch.training.tree_builder import (
                Root,
                auto_questions,
                build_tree,
                init_gmm_from_tree,
            )
            from montreal_forced_aligner_tpu_torch.models.transition_model import (
                TransitionModel,
            )

            groups = self.phone_groups()
            questions = auto_questions(tree_stats, groups, self.cluster_pdf_class)
            roots = [Root(set(g)) for g in groups]
            with pipeline.clock("build_tree"):
                self.tree = build_tree(
                    tree_stats, questions, roots, max_leaves=self.num_leaves
                )
            logger.info("built LDA-stage tree with %d leaves", self.tree.num_pdfs)
            self.tm = TransitionModel.from_topology_and_tree(self.topo, self.tree)
            mean, var = pipeline.global_mean_var()
            self.gmm = init_gmm_from_tree(self.tree, fallback_mean=mean, fallback_var=var)
            self._convert_alignments(labels)
        acc = self._accumulate(pipeline)
        self._update(acc, mixup_target=self.initial_gaussians)
        pipeline.compile_graphs(self.make_compiler())
        self._realign(pipeline)

    def post_iteration(self, iteration: int, pipeline: TrainingPipeline) -> None:
        if iteration not in self.mllt_iterations:
            return
        with pipeline.clock("mllt"):
            self._estimate_mllt(iteration, pipeline)

    def _estimate_mllt(self, iteration: int, pipeline: TrainingPipeline) -> None:
        # this hook reads AND rotates self.gmm on host: sync the
        # device-resident model down first, invalidate the mirror after
        self.sync_host_model(pipeline)
        D = self.gmm.dim
        G_total = np.zeros((D, D, D))
        beta_total = 0.0
        means = pipeline.put_rep(self.gmm.get_means())
        iv = pipeline.put_rep(self.gmm.inv_vars)
        gc = pipeline.put_rep(self.gmm.gconsts)
        miv = pipeline.put_rep(self.gmm.means_invvars)
        pending = []
        for fb in pipeline.batches:
            out = accumulate_mllt_stats(
                fb.put_b(fb.feats),
                pipeline.put_b(fb.frame_lengths),
                fb.frame_pdf,
                means,
                iv,
                gc,
                miv,
            )
            pending.append(out)
        from montreal_forced_aligner_tpu_torch.training.base import fetch_all

        for G_mats, beta in fetch_all(pending):
            G_total += G_mats
            beta_total += float(beta)
        G_total, beta_arr = pipeline.reduce_host(G_total, np.array([beta_total]))
        beta_total = float(beta_arr[0])
        M = solve_mllt(G_total, beta_total)
        logger.info(
            "MLLT at iter %d: |log det| = %.4f",
            iteration,
            abs(float(np.linalg.slogdet(M)[1])),
        )
        # compose into the LDA transform and rotate the model means
        self.lda_mat = (M @ self.lda_mat).astype(np.float32)
        old_means = self.gmm.get_means()  # (P, G, D)
        new_means = np.einsum("de,pge->pgd", M, old_means)
        self.gmm.means_invvars = (new_means * self.gmm.inv_vars).astype(np.float32)
        self.gmm.compute_gconsts()
        self.invalidate_device_model()
        pipeline.set_feature_transform(uses_deltas=False, lda_mat=self.lda_mat)
        # feature change invalidates cached alignments; refresh them
        self._realign(pipeline)

    def feature_meta(self) -> dict:
        return {
            "type": "mfcc",
            "deltas": False,
            "lda": True,
            "fmllr": False,
            "pitch": getattr(self, "use_pitch", False),
            "frame_shift": 10,
            "splice_left_context": self.splice_left,
            "splice_right_context": self.splice_right,
        }

    def export_model(self):
        model = super().export_model()
        model.lda_mat = self.lda_mat
        return model
