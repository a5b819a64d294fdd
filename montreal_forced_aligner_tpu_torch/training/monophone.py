"""Monophone training (flat start + Viterbi EM).

Behavioral spec: reference ``acoustic_modeling/monophone.py`` —
flat-start init from global feature stats (``:298-339``), equal-spaced first
alignment (``:37-139``), realignment schedule (every iteration for the first
quarter, every 2nd until half, every 3rd after; ``:206-217``), Gaussian
mixing-up toward ``max_gaussians`` with linear increments until
``num_iterations - 10`` (``base.py:451-453``).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from montreal_forced_aligner_tpu_torch.models.gmm import DiagGmmSet
from montreal_forced_aligner_tpu_torch.models.transition_model import (
    HmmTopology,
    TransitionModel,
)
from montreal_forced_aligner_tpu_torch.models.tree import ContextDependency
from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig, TrainingPipeline
from montreal_forced_aligner_tpu_torch.training.em import ViterbiEmTrainer


class MonophoneTrainer(ViterbiEmTrainer):
    train_type = "mono"

    def __init__(
        self,
        lexicon,
        config: Optional[TrainerConfig] = None,
        num_silence_states: int = 5,
        num_non_silence_states: int = 3,
        phone_topologies=None,
        variable_length_topology: bool = True,
    ):
        super().__init__(lexicon, config)
        self.num_silence_states = num_silence_states
        self.num_non_silence_states = num_non_silence_states
        self.variable_length_topology = variable_length_topology
        # per-phone-id (min_states, max_states) overrides
        # (reference --topology_path, ``multispeaker.py:252``)
        self.phone_topologies = phone_topologies

    @property
    def realignment_iterations(self) -> List[int]:
        n = self.config.num_iterations
        iters = [1]
        for i in range(2, n):
            if i <= n // 4:
                iters.append(i)
            elif i <= n // 2:
                if i - iters[-1] > 1:
                    iters.append(i)
            else:
                if i - iters[-1] > 2:
                    iters.append(i)
        return iters

    def initialize(self, pipeline: TrainingPipeline) -> None:
        """``gmm_init_mono`` flat start + equal alignment + first update."""
        phones = sorted(v for k, v in self.lexicon.phone_table.items() if v > 0)
        silence = self._silence_phone_ids()
        topo = HmmTopology.standard(
            phones,
            silence_phones=silence,
            num_non_silence_states=self.num_non_silence_states,
            num_silence_states=self.num_silence_states,
            phone_topologies=self.phone_topologies,
            variable_length=self.variable_length_topology,
        )
        self.tree = ContextDependency.monophone(phones, topo)
        self.tm = TransitionModel.from_topology_and_tree(topo, self.tree)
        mean, var = pipeline.global_mean_var()
        num_pdfs = self.tree.num_pdfs
        inv_var = 1.0 / var
        self.gmm = DiagGmmSet.from_lists(
            weights_list=[np.ones(1, np.float32)] * num_pdfs,
            miv_list=[(mean * inv_var)[None, :].astype(np.float32)] * num_pdfs,
            iv_list=[inv_var[None, :].astype(np.float32)] * num_pdfs,
        )
        pipeline.compile_graphs(self.make_compiler())
        self._realign(pipeline, equal=True)
        acc = self._accumulate(pipeline)
        self._update(acc, mixup_target=None)
