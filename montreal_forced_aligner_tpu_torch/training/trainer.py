"""Full training recipe orchestration.

Counterpart of ``montreal_forced_aligner_tpu/training/trainer.py`` on one
device (``device="cuda"`` by default; it raises without a card). Options
that reach the reference package only through a mesh, several processes or
host extras raise ``NotImplementedError`` naming their ROADMAP.md item.

Behavioral spec: reference ``acoustic_modeling/trainer.py`` — the default
recipe chains monophone → triphone → LDA+MLLT → SAT (→ SAT) with growing
subsets and Gaussian budgets (``:193-240``), interleaving each stage with
alignment by the previous stage's model (``:569-642``), and exports the final
model (``:456``).

Differences from the reference's process model: one shared
:class:`TrainingPipeline` holds device-resident features for every stage;
"alignment workflows" between stages are implicit (each stage starts from the
alignments the previous stage left cached on the pipeline batches).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
from montreal_forced_aligner_tpu_torch.device import resolve_device
from montreal_forced_aligner_tpu_torch.ops import cuda_build
from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon
from montreal_forced_aligner_tpu_torch.models.acoustic_model import AcousticModel
from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig, TrainingPipeline
from montreal_forced_aligner_tpu_torch.training.lda import LdaTrainer
from montreal_forced_aligner_tpu_torch.training.monophone import MonophoneTrainer
from montreal_forced_aligner_tpu_torch.training.sat import SatTrainer
from montreal_forced_aligner_tpu_torch.training.triphone import TriphoneTrainer

logger = logging.getLogger("mfa_tpu")


@dataclass
class StageConfig:
    name: str
    kind: str  # mono | tri | lda | sat
    num_iterations: int
    max_gaussians: int
    num_leaves: int = 0
    subset: int = 0
    quick: bool = False  # sat-quick: sparser fMLLR/realign schedules
    # pron_prob stages: train a G2P model on the aligned pronunciations
    # and regenerate the lexicon from it (reference train_g2p variant,
    # acoustic_modeling/pronunciation_probabilities.py:160,420)
    train_g2p: bool = False


# Default recipe (reference ``trainer.py:193-240``; subsets are applied when
# the corpus is larger than the subset size)
DEFAULT_RECIPE = [
    StageConfig("monophone", "mono", 40, 1000, subset=10000),
    StageConfig("triphone", "tri", 35, 10000, num_leaves=2000, subset=20000),
    StageConfig("lda", "lda", 35, 15000, num_leaves=2500, subset=20000),
    StageConfig("sat_1", "sat", 35, 15000, num_leaves=2500, subset=20000),
    StageConfig("sat_2", "sat", 35, 40000, num_leaves=4200, subset=50000),
    StageConfig("pron_prob_1", "pron_prob", 0, 0, subset=50000),
    StageConfig("sat_3", "sat", 35, 100000, num_leaves=5000, subset=150000),
    StageConfig("pron_prob_2", "pron_prob", 0, 0, subset=150000),
    StageConfig(
        "sat_quick", "sat", 20, 150000, num_leaves=7000, subset=0, quick=True
    ),
]


class TrainableAligner:
    """Train an acoustic model through the staged recipe (reference entry
    point: ``mfa train``, ``command_line/train_acoustic_model.py``)."""

    def __init__(
        self,
        corpus_directory,
        dictionary_path,
        recipe: Optional[List[StageConfig]] = None,
        base_config: Optional[TrainerConfig] = None,
        batch_size: int = 16,
        position_dependent_phones: bool = True,
        working_directory=None,
        features_on_host: bool = False,
        phone_set_type: str = "UNKNOWN",
        num_graph_workers: int = 0,
        use_pitch: bool = False,
        mfcc_config=None,
        rules_path=None,
        topology_path=None,
        variable_length_topology: bool = True,
        phone_groups_path=None,
        speaker_characters=0,
        audio_directory=None,
        distributed: Optional[bool] = None,
        mesh=None,
        language=None,
        device="cuda",
    ):
        recipe = recipe if recipe is not None else DEFAULT_RECIPE
        bad = []
        if distributed or mesh is not None:
            bad.append("distributed/mesh: multi-GPU is ROADMAP.md Queue 1 item 15")
        if use_pitch:
            bad.append("use_pitch: ROADMAP.md Queue 1 item 11 (alignment extras)")
        if rules_path is not None:
            bad.append("rules_path: ROADMAP.md Queue 1 item 16 (host extras)")
        if language is not None:
            bad.append("language: ROADMAP.md Queue 1 item 16 (host extras)")
        if num_graph_workers > 0:
            bad.append("num_graph_workers > 0: ROADMAP.md Queue 1 item 16 "
                       "(host extras)")
        if any(st.train_g2p for st in recipe):
            bad.append("train_g2p stages: ROADMAP.md Queue 1 item 16 (host "
                       "extras)")
        if bad:
            raise NotImplementedError("not ported yet: " + "; ".join(bad))
        self.device = resolve_device(device)
        self.corpus = Corpus.load(
            corpus_directory,
            speaker_characters=speaker_characters,
            audio_directory=audio_directory,
        )
        self.rules_path = rules_path
        self.topology_path = topology_path
        # reference default since MFA 2.0: phones as short as one frame
        # (changelog_2.0_pre_release.rst:77); False = classic Bakis chains
        self.variable_length_topology = variable_length_topology
        self.lexicon = Lexicon.load(
            dictionary_path, position_dependent=position_dependent_phones
        )
        self.recipe = recipe
        self.base_config = base_config or TrainerConfig()
        self.batch_size = batch_size
        self.working_directory = (
            Path(working_directory) if working_directory else None
        )
        self.features_on_host = features_on_host
        self.phone_set_type = phone_set_type
        self.num_graph_workers = num_graph_workers
        # after phone_set_type: topology yaml keys may match stress/tone-
        # stripped base phones of the resolved set
        self.phone_topologies = self._load_phone_topologies(topology_path)
        self.phone_groups = self._load_phone_groups(phone_groups_path)
        self.use_pitch = use_pitch
        self.mfcc_config = mfcc_config
        self.models: Dict[str, AcousticModel] = {}
        self.trainers: Dict[str, object] = {}
        # synchronise the card at each phase boundary of the run, so that
        # each phase's seconds hold its device work (a measurement switch)
        self.sync_phases = False
        # after train(): the pipeline, its phase seconds, and each stage's
        # wall seconds and kernel launches (ops/cuda_build.LAUNCHES)
        self.pipeline: Optional[TrainingPipeline] = None
        self.phase_seconds: Dict[str, float] = {}
        self.stage_seconds: Dict[str, float] = {}
        self.stage_launches: Dict[str, Dict[str, int]] = {}

    def _load_phone_topologies(self, topology_path):
        """Per-phone (min_states, max_states) overrides from a yaml of
        ``{phone: {min_states: N, max_states: M}}`` (reference
        ``--topology_path``, ``multispeaker.py:252``). Keys match either the
        exact phone, its position-stripped form, or (ARPA/PINYIN/IPA phone
        sets) its stress/tone-stripped base phone, and expand to every
        positional variant's phone id. Unmatched yaml keys are reported."""
        if topology_path is None:
            return None
        import yaml

        from montreal_forced_aligner_tpu_torch.data import PhoneSetType
        from montreal_forced_aligner_tpu_torch.dictionary.lexicon import POSITIONS
        from montreal_forced_aligner_tpu_torch.models.transition_model import (
            DEFAULT_NUM_NON_SILENCE_STATES,
        )

        with open(topology_path, encoding="utf8") as f:
            raw = yaml.safe_load(f) or {}
        try:
            pst = PhoneSetType[str(self.phone_set_type).upper()]
        except KeyError:
            pst = PhoneSetType.UNKNOWN

        def strip_pos(name):
            for pos in POSITIONS:
                if name.endswith(pos):
                    return name[: -len(pos)]
            return name

        if pst is PhoneSetType.AUTO:
            pst = PhoneSetType.detect(
                {strip_pos(n) for n in self.lexicon.phone_table if n}
            )
        # the reference only applies topologies to non-silence phones
        # (``multispeaker.py:261`` filters on non_silence_phones)
        silence_bases = {"sil", "sp", "spn", "<eps>"}
        out = {}
        matched = set()
        for name, pid in self.lexicon.phone_table.items():
            stripped = strip_pos(name)
            if stripped in silence_bases or pid <= 0:
                continue
            for key in (name, stripped, pst.base_phone(stripped)):
                if key in raw:
                    v = raw[key] or {}
                    mn = int(v.get("min_states", 1))
                    mx = int(
                        v.get("max_states", DEFAULT_NUM_NON_SILENCE_STATES)
                    )
                    if mn < 1 or mn > mx:
                        raise ValueError(
                            f"topology for {key}: need 1 <= min_states <= "
                            f"max_states, got ({mn}, {mx})"
                        )
                    out[pid] = (mn, mx)
                    matched.add(key)
                    break
        unmatched = set(raw) - matched
        if unmatched:
            logger.warning(
                "topology config entries matched no non-silence phone "
                "(silence topologies are fixed, as in the reference): %s",
                sorted(unmatched),
            )
        return out or None

    def _load_phone_groups(self, phone_groups_path):
        """Tree-root phone groups from a yaml of ``{group: [phones...]}``
        or ``[[phones...], ...]`` (reference ``--phone_groups_path``,
        ``dictionary/multispeaker.py:206-240``). Phones within a group must
        share an HMM topology, as in the reference
        (``PhoneGroupTopologyMismatchError``)."""
        if phone_groups_path is None:
            return None
        import yaml

        from montreal_forced_aligner_tpu_torch.dictionary.lexicon import POSITIONS
        from montreal_forced_aligner_tpu_torch.models.transition_model import (
            DEFAULT_NUM_NON_SILENCE_STATES,
        )

        with open(phone_groups_path, encoding="utf8") as f:
            raw = yaml.safe_load(f) or {}
        if isinstance(raw, dict):
            raw = list(raw.values())

        def strip_pos(name):
            for pos in POSITIONS:
                if name.endswith(pos):
                    return name[: -len(pos)]
            return name

        known_bases = {
            strip_pos(n) for n, pid in self.lexicon.phone_table.items()
            if pid > 0
        }
        pid_by_base = {}
        for name, pid in self.lexicon.phone_table.items():
            if pid > 0:
                pid_by_base.setdefault(strip_pos(name), []).append(pid)
        groups: List[List[str]] = []
        errors = []
        for members in raw:
            if not members:
                continue
            members = sorted(
                {m for m in members if m in known_bases}
            )
            if not members:
                continue
            topos = set()
            for base in members:
                mn, mx = 1, DEFAULT_NUM_NON_SILENCE_STATES
                if self.phone_topologies:
                    for pid in pid_by_base.get(base, ()):
                        if pid in self.phone_topologies:
                            mn, mx = self.phone_topologies[pid]
                            break
                topos.add((mn, mx))
            if len(topos) > 1:
                errors.append((members, sorted(topos)))
            groups.append(members)
        if errors:
            raise ValueError(
                "phones grouped together must share a topology (reference "
                f"PhoneGroupTopologyMismatchError): {errors}"
            )
        return groups or None

    def _checkpoint_paths(self, stage_name: str):
        if self.working_directory is None:
            return None, None
        d = self.working_directory / stage_name
        return d / "model.zip", d / "aux.npz"

    def _save_checkpoint(self, stage_name: str, trainer, model) -> None:
        """Per-stage checkpoint (reference: filesystem-is-the-checkpoint,
        ``acoustic_modeling/base.py:820-826`` skips existing models)."""
        model_path, aux_path = self._checkpoint_paths(stage_name)
        if model_path is None:
            return
        model_path.parent.mkdir(parents=True, exist_ok=True)
        model.save(model_path)
        aux = {}
        if getattr(trainer, "speaker_transforms", None) is not None:
            aux["speaker_transforms"] = trainer.speaker_transforms
        if aux:
            # write-then-rename like model.save: every process of a
            # multi-host run checkpoints to the same shared path
            import socket

            # (suffix stays .npz: np.savez appends it otherwise)
            tmp = aux_path.with_name(
                f"{aux_path.stem}.tmp{socket.gethostname()}.{os.getpid()}.npz"
            )
            np.savez_compressed(tmp, **aux)
            os.replace(tmp, aux_path)

    def _load_checkpoint(self, stage, pipeline, topo, lda_mat):
        """Returns a trainer reconstructed from a stage checkpoint (with the
        pipeline realigned by its model), or None."""
        model_path, aux_path = self._checkpoint_paths(stage.name)
        if model_path is None or not model_path.exists():
            return None
        from montreal_forced_aligner_tpu_torch.training.em import ViterbiEmTrainer
        from montreal_forced_aligner_tpu_torch.training.sat import SatTrainer

        model = AcousticModel.load(model_path)
        cfg = replace(
            self.base_config,
            num_iterations=stage.num_iterations,
            max_gaussians=stage.max_gaussians,
        )
        if stage.kind == "sat":
            trainer = SatTrainer(
                self.lexicon, model.transition_model.topo, cfg,
                lda_mat=model.lda_mat,
            )
        else:
            trainer = ViterbiEmTrainer(self.lexicon, cfg)
            trainer.train_type = stage.kind
        trainer.tm = model.transition_model
        trainer.gmm = model.gmm
        trainer.tree = model.tree
        if getattr(model, "lda_mat", None) is not None:
            trainer.lda_mat = model.lda_mat
        if aux_path is not None and aux_path.exists():
            aux = np.load(aux_path)
            if "speaker_transforms" in aux:
                trainer.speaker_transforms = aux["speaker_transforms"]
        # restore the stage's feature transform + alignments
        pipeline.set_feature_transform(
            uses_deltas=model.uses_deltas and model.lda_mat is None,
            lda_mat=model.lda_mat,
            speaker_transforms=getattr(trainer, "speaker_transforms", None),
        )
        pipeline.compile_graphs(trainer.make_compiler())
        trainer._realign(pipeline)
        logger.info("resumed stage %s from %s", stage.name, model_path)
        self.models[stage.name] = model
        self.trainers[stage.name] = trainer
        return trainer, model

    def filter_training_utterances(self, pipeline) -> set:
        """Utterances unusable for training: empty transcript or nothing but
        OOVs (reference ``acoustic_modeling/trainer.py:324``)."""
        excluded = set()
        oov_samples = []
        for utt in self.corpus.utterances:
            tokens = pipeline.tokenizer.tokenize(utt.text)
            if not any(t in self.lexicon.words for t in tokens):
                excluded.add(utt.id)
                oov_samples.extend(tokens[:2])
        if excluded and len(excluded) == self.corpus.num_utterances:
            from montreal_forced_aligner_tpu_torch.exceptions import AllOovError

            raise AllOovError(self.corpus.num_utterances, oov_samples)
        if excluded:
            logger.info(
                "excluding %d utterances with empty/OOV-only transcripts",
                len(excluded),
            )
        return excluded

    def quality_check_subset(self, pipeline, z_threshold: float = -3.0) -> None:
        """Drop alignment outliers from later stages: utterances whose
        alignment log-likelihood/frame z-score is below ``z_threshold``
        (reference ``quality_check_subset``, ``trainer.py:516``)."""
        lls = pipeline.utterance_loglikes()
        if len(lls) < 10:
            return
        vals = np.asarray(list(lls.values()))
        mean, std = vals.mean(), vals.std()
        if std <= 1e-6:
            return
        bad = {i for i, v in lls.items() if (v - mean) / std < z_threshold}
        if bad:
            logger.info(
                "quality check: excluding %d outlier utterances "
                "(loglike z < %.1f)", len(bad), z_threshold,
            )
            self._excluded |= bad

    # -- run-state marker (reference workflow done/dirty flags,
    # ``abc.py:1085-1109`` + ``check_previous_run``) --------------------------
    def _run_fingerprint(self) -> dict:
        return {
            "recipe": [
                {
                    "name": st.name, "kind": st.kind,
                    "num_iterations": st.num_iterations,
                    "max_gaussians": st.max_gaussians,
                    "num_leaves": getattr(st, "num_leaves", None),
                    "subset": getattr(st, "subset", None),
                }
                for st in self.recipe
            ],
            "batch_size": self.batch_size,
            "variable_length_topology": self.variable_length_topology,
            "phone_set_type": str(self.phone_set_type),
        }

    def _mark_run_state(self, state: str) -> None:
        """Write RUNNING/DONE markers so an interrupted run is detectable
        (the reference marks workflows dirty on error and resumes or wipes
        with --clean). On resume after a crash, a RUNNING marker plus a
        differing configuration fingerprint warns that checkpoints were
        produced under different settings."""
        if self.working_directory is None:
            return
        import json as _json

        self.working_directory.mkdir(parents=True, exist_ok=True)
        marker = self.working_directory / "run_state.json"
        if state == "running" and marker.exists():
            try:
                prev = _json.loads(marker.read_text())
            except Exception:
                prev = {}
            if prev.get("state") == "running":
                logger.warning(
                    "previous training run in %s did not finish cleanly; "
                    "resuming from its checkpoints (use --clean to start "
                    "fresh)", self.working_directory,
                )
            if prev.get("fingerprint") not in (
                None, self._run_fingerprint()
            ):
                logger.warning(
                    "training configuration differs from the one that "
                    "produced the checkpoints in %s (recipe/batch/topology "
                    "changed); resuming may mix incompatible state — "
                    "use --clean unless this is intentional",
                    self.working_directory,
                )
        marker.write_text(
            _json.dumps(
                {"state": state, "fingerprint": self._run_fingerprint()}
            )
        )

    def train(self) -> AcousticModel:
        self._mark_run_state("running")
        model = self._train_impl()
        self._mark_run_state("done")
        return model

    def _train_impl(self) -> AcousticModel:
        pipeline = TrainingPipeline(
            self.corpus, self.lexicon, batch_size=self.batch_size,
            features_on_host=self.features_on_host,
            num_graph_workers=self.num_graph_workers,
            use_pitch=self.use_pitch,
            mfcc_config=self.mfcc_config,
            device=self.device,
        )
        pipeline.clock.sync = self.sync_phases
        self.pipeline = pipeline
        self.phase_seconds = pipeline.clock.seconds
        self.stage_seconds = {}
        self.stage_launches = {}
        pipeline.prepare_features()
        self._excluded = self.filter_training_utterances(pipeline)
        topo = None
        lda_mat = None
        model = None
        prev_trainer = None
        from montreal_forced_aligner_tpu_torch.training.base import (
            select_training_subset,
        )

        all_ids = {u.id for u in self.corpus.utterances}
        import time as _time

        for stage in self.recipe:
            logger.info("=== stage %s (%s) ===", stage.name, stage.kind)
            _t0 = _time.perf_counter()
            _launched = dict(cuda_build.LAUNCHES)
            if stage.kind != "pron_prob":
                stage_subset = stage.subset
                if stage_subset and stage_subset < self.corpus.num_utterances:
                    subset = select_training_subset(
                        self.corpus, stage_subset,
                        seed=1234 + self.base_config.seed,
                    )
                    subset -= self._excluded
                    pipeline.set_subset(subset)
                    logger.info("subset: %d utterances", len(subset))
                elif self._excluded:
                    pipeline.set_subset(all_ids - self._excluded)
                else:
                    pipeline.set_subset(None)
                if prev_trainer is not None:
                    # align the (possibly larger) subset with the previous
                    # stage's model (reference ``trainer.py:588-607``)
                    prev_trainer._realign(pipeline)
            cfg = replace(
                self.base_config,
                num_iterations=stage.num_iterations,
                max_gaussians=stage.max_gaussians,
            )
            if stage.kind == "mono":
                trainer = MonophoneTrainer(
                    self.lexicon, cfg,
                    phone_topologies=self.phone_topologies,
                    variable_length_topology=self.variable_length_topology,
                )
            elif stage.kind == "tri":
                trainer = TriphoneTrainer(
                    self.lexicon, topo, cfg, num_leaves=stage.num_leaves,
                    phone_set_type=self.phone_set_type,
                    custom_phone_groups=self.phone_groups,
                )
            elif stage.kind == "lda":
                trainer = LdaTrainer(
                    self.lexicon, topo, cfg, num_leaves=stage.num_leaves,
                    phone_set_type=self.phone_set_type,
                    custom_phone_groups=self.phone_groups,
                )
            elif stage.kind == "sat":
                trainer = SatTrainer(
                    self.lexicon,
                    topo,
                    cfg,
                    num_leaves=stage.num_leaves,
                    lda_mat=lda_mat,
                    phone_set_type=self.phone_set_type,
                    custom_phone_groups=self.phone_groups,
                    quick=stage.quick,
                )
            elif stage.kind == "pron_prob":
                self._estimate_pronunciation_probabilities(
                    pipeline, train_g2p=stage.train_g2p
                )
                self.stage_seconds[stage.name] = _time.perf_counter() - _t0
                continue
            else:
                raise ValueError(f"unknown stage kind {stage.kind}")
            resumed = self._load_checkpoint(stage, pipeline, topo, lda_mat)
            if resumed is not None:
                trainer, model = resumed
                prev_trainer = trainer
                topo = trainer.tm.topo
                if getattr(trainer, "lda_mat", None) is not None:
                    lda_mat = trainer.lda_mat
                continue
            if self.working_directory is not None:
                # mid-stage resume: <iter>.npz checkpoints (reference writes
                # <iter>.mdl each iteration, acoustic_modeling/base.py:820)
                trainer.checkpoint_dir = (
                    self.working_directory / stage.name / "iters"
                )
            model = trainer.train(pipeline)
            if self.sync_phases and self.device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.device)
            self.stage_seconds[stage.name] = _time.perf_counter() - _t0
            self.stage_launches[stage.name] = {
                k: n - _launched.get(k, 0) for k, n in cuda_build.LAUNCHES.items()
            }
            self.quality_check_subset(pipeline)
            self._save_checkpoint(stage.name, trainer, model)
            self.models[stage.name] = model
            self.trainers[stage.name] = trainer
            prev_trainer = trainer
            topo = trainer.tm.topo
            if getattr(trainer, "lda_mat", None) is not None:
                lda_mat = trainer.lda_mat
        if model is not None and prev_trainer is not None:
            self._attach_final_artifacts(prev_trainer, pipeline, model)
        return model

    def _attach_final_artifacts(self, trainer, pipeline, model) -> None:
        """Compute the reference's finalize-time bundle members on the final
        alignment: ``phone_pdf.counts`` (per-phone pdf counts from smoothed
        transition stats, ``acoustic_modeling/trainer.py:665``) and the
        phone LM (``train_phone_lm``, ``transcription/transcriber.py:737``)
        persisted as ``phone_lm.arpa`` for ``--use_phone_model``."""
        from collections import Counter, defaultdict

        try:
            tcounts = trainer._get_tcounts(pipeline)
        except Exception:
            return
        tm = trainer.tm
        phone_names = {v: k for k, v in self.lexicon.phone_table.items()}
        mapping = defaultdict(Counter)
        smoothing = 1.0
        for tid in range(1, tm.num_transition_ids + 1):
            pdf = int(tm.id2pdf[tid])
            phone = phone_names.get(tm.transition_id_to_phone(tid))
            if phone is None:
                continue
            mapping[phone][pdf] += smoothing + float(tcounts[tid])
        model.phone_pdf_counts = {
            p: dict(c) for p, c in sorted(mapping.items())
        }
        # phone LM from the final alignment's phone sequences (silence
        # stripped: the decode graph's optional-silence branches model it)
        texts = []
        sil = {self.lexicon.silence_phone, "sp", self.lexicon.oov_phone}
        strip = lambda n: (
            n.rsplit("_", 1)[0]
            if n.endswith(("_B", "_E", "_I", "_S"))
            else n
        )
        for fb in pipeline.batches:
            sp = fb.host_state_path()
            if sp is None:
                continue
            ph = fb.garrs["state_phone"][
                np.arange(sp.shape[0])[:, None], sp
            ]
            inst = fb.garrs["state_instance"][
                np.arange(sp.shape[0])[:, None], sp
            ]
            for row in range(len(fb.utt_indices)):
                L = int(fb.frame_lengths[row])
                if L <= 0:
                    continue
                change = np.flatnonzero(np.diff(inst[row, :L])) + 1
                starts = np.concatenate([[0], change])
                labels = [
                    strip(phone_names.get(int(p), ""))
                    for p in ph[row, starts]
                ]
                labels = [l for l in labels if l and l not in sil]
                if labels:
                    texts.append(" ".join(labels))
        if texts:
            from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
                train_lm_from_texts,
            )

            model.phone_lm, _ = train_lm_from_texts(texts, order=2)

    def export_model(self, path) -> None:
        # pron_prob stages produce no model of their own (they update the
        # lexicon); export the last stage that trained one
        final = None
        for stage in reversed(self.recipe):
            if stage.name in self.models:
                final = self.models[stage.name]
                break
        if final is None:
            raise RuntimeError("no trained model to export")
        final.save(path)

    def _estimate_pronunciation_probabilities(
        self, pipeline, train_g2p: bool = False
    ) -> None:
        """Pronunciation-probability stage (reference
        ``acoustic_modeling/pronunciation_probabilities.py``): derive word
        alignments from the cached stage alignments, count pronunciations
        and surrounding silences, and fold the estimated probabilities into
        the shared lexicon so subsequent stages compile weighted graphs."""
        from montreal_forced_aligner_tpu_torch.align.aligner import frames_to_alignment
        from montreal_forced_aligner_tpu_torch.training.pronunciation import (
            PronunciationCounter,
            apply_probabilities_to_lexicon,
            compute_pronunciation_probabilities,
        )

        phone_names = {v: k for k, v in self.lexicon.phone_table.items()}
        counter = PronunciationCounter()
        n = 0
        for fb in pipeline.batches:
            if not fb.has_alignment():
                continue
            sp = fb.host_state_path()
            b = np.arange(sp.shape[0])[:, None]
            phone_f = fb.garrs["state_phone"][b, sp]
            word_f = fb.garrs["state_word"][b, sp]
            inst_f = fb.garrs["state_instance"][b, sp]
            for row, i in enumerate(fb.utt_indices):
                utt = self.corpus.utterances[i]
                L = int(fb.frame_lengths[row])
                if L <= 0:
                    # out of the stage's subset (an earlier quality check
                    # excluded it): no alignment to count. The reference
                    # package indexes its empty frame labels here and raises.
                    continue
                g = pipeline.graphs[i]
                aln = frames_to_alignment(
                    utt,
                    g.words,
                    phone_f[row, :L],
                    word_f[row, :L],
                    inst_f[row, :L],
                    0.0,
                    phone_names,
                    0.01,
                )
                counter.add_utterance(aln, self.lexicon.silence_phone)
                n += 1
        if n == 0:
            logger.warning("pron_prob stage skipped: no cached alignments")
            return
        result = compute_pronunciation_probabilities(counter)
        apply_probabilities_to_lexicon(self.lexicon, result)
        logger.info(
            "estimated pronunciation probabilities from %d utterances "
            "(corpus silence probability %.2f)",
            n,
            result.silence_probability,
        )
        if train_g2p:
            # reference train_g2p variant: the G2P model trained on these
            # aligned pronunciations replaces the lexicon for subsequent
            # stages (pronunciation_probabilities.py:160,420)
            from montreal_forced_aligner_tpu_torch.training.pronunciation import (
                train_g2p_lexicon,
            )

            g2p_model = train_g2p_lexicon(self.lexicon, counter)
            if g2p_model is not None:
                self.g2p_models = getattr(self, "g2p_models", {})
                self.g2p_models[len(self.g2p_models)] = g2p_model
