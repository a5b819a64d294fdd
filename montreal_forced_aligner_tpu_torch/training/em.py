"""Generic Viterbi-EM training loop shared by all GMM trainer stages.

Counterpart of ``montreal_forced_aligner_tpu/training/em.py``, in PyTorch on
the pipeline's device: the model and the accumulators stay on the device
between host syncs, as in the reference package.

The loop structure mirrors the reference's ``AcousticModelTrainingMixin``
contract (``acoustic_modeling/base.py:745-835``): initialize → per iteration
[realign on schedule → accumulate stats → MLE update → Gaussian increment] →
finalize. Each stage (mono/tri/LDA/SAT) customizes initialization and feature
handling; the loop itself is stage-independent.
"""

from __future__ import annotations

import logging
import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon
from montreal_forced_aligner_tpu_torch.graph.compiler import AlignmentGraphCompiler
from montreal_forced_aligner_tpu_torch.models.acoustic_model import AcousticModel
from montreal_forced_aligner_tpu_torch.models.gmm import DiagGmmSet
from montreal_forced_aligner_tpu_torch.models.transition_model import TransitionModel
from montreal_forced_aligner_tpu_torch.models.tree import ContextDependency
from montreal_forced_aligner_tpu_torch.training.base import (
    TrainerConfig,
    TrainingPipeline,
    _accumulate_batch,
    _align_batch,
    _equal_align_batch,
    fetch_all,
    train_gmm,
)

logger = logging.getLogger("mfa_tpu")


def _sum_frames(frame_lengths):
    return frame_lengths.sum().to(torch.float32)


class DeviceAccumulators(NamedTuple):
    """EM statistics resident on the device (the form of the reference's
    parent-process accumulator objects)."""

    occ: torch.Tensor  # (P, G)
    mean: torch.Tensor  # (P, G, D)
    var: torch.Tensor  # (P, G, D)
    loglike: torch.Tensor  # ()
    frames: torch.Tensor  # ()


class _DeviceModelMirror:
    """Device-resident copy of the stage's GMM (means_invvars / inv_vars /
    gconsts + the flattened likelihood matrix), kept authoritative between
    host syncs so EM iterations never ship or fetch the model.

    The host ``DiagGmmSet`` keeps owning ``weights`` and ``num_gauss``
    (tiny; the mixing-up schedule is decided on host), while the (P, G, D)
    tensors live here. ``host_stale`` marks that ``gmm.means_invvars`` /
    ``inv_vars`` / ``gconsts`` no longer reflect the device state."""

    def __init__(self):
        self.miv = None
        self.iv = None
        self.gconsts = None
        self.W = None
        self.gconsts_boosted = None
        self.host_stale = False
        self._align_gmm = None

    @property
    def valid(self) -> bool:
        return self.miv is not None

    def load_from_host(self, gmm, pipeline, boost_gconst_add=None) -> None:
        from montreal_forced_aligner_tpu_torch.ops.device_update import (
            flatten_W_device,
        )

        self.miv = pipeline.put_rep(gmm.means_invvars)
        self.iv = pipeline.put_rep(gmm.inv_vars)
        self.gconsts = pipeline.put_rep(gmm.gconsts)
        self.W = flatten_W_device(self.miv, self.iv)
        self.gconsts_boosted = None
        if boost_gconst_add is not None:
            self.gconsts_boosted = pipeline.put_rep(
                gmm.gconsts + boost_gconst_add
            )
        self.host_stale = False
        self._align_gmm = None

    def set_device_model(self, miv, iv, gconsts, boost_vec=None) -> None:
        from montreal_forced_aligner_tpu_torch.ops.device_update import (
            flatten_W_device,
        )

        self.miv = miv
        self.iv = iv
        self.gconsts = gconsts
        self.W = flatten_W_device(miv, iv)
        self.gconsts_boosted = (
            None if boost_vec is None else gconsts + boost_vec
        )
        self.host_stale = True
        self._align_gmm = None

    def invalidate(self) -> None:
        self.miv = None
        self.iv = None
        self.gconsts = None
        self.W = None
        self.gconsts_boosted = None
        self.host_stale = False
        self._align_gmm = None

    def align_gmm(self):
        """The model the training alignment reads (``base.TrainGmm``), made
        from the device tensors at the first realignment after each update
        or mixing-up: W, the (boosted) gconsts, and K3's rows and split rows
        packed on the device when the emission rule takes K3."""
        if self._align_gmm is None:
            gc = self.gconsts_boosted if self.gconsts_boosted is not None else self.gconsts
            self._align_gmm = train_gmm(self.W, gc, self.miv, self.iv)
        return self._align_gmm


class ViterbiEmTrainer:
    """Shared Viterbi-EM machinery; stages subclass and implement
    :meth:`initialize`."""

    def __init__(self, lexicon: Lexicon, config: Optional[TrainerConfig] = None):
        self.lexicon = lexicon
        self.config = config or TrainerConfig()
        self.tm: Optional[TransitionModel] = None
        self.gmm: Optional[DiagGmmSet] = None
        self.tree: Optional[ContextDependency] = None
        self.iteration_log: List[dict] = []
        # device-resident EM state (see _DeviceModelMirror)
        self._mirror = _DeviceModelMirror()
        self._tcounts: Optional[np.ndarray] = None
        self._pipeline: Optional[TrainingPipeline] = None

    # -- stage hooks ---------------------------------------------------------
    train_type = "base"

    def initialize(self, pipeline: TrainingPipeline) -> None:
        """Set up tm/gmm/tree, compile graphs into the pipeline, and leave a
        first alignment cached on every batch."""
        raise NotImplementedError

    def finalize(self, pipeline: TrainingPipeline) -> None:
        pass

    def post_iteration(self, iteration: int, pipeline: TrainingPipeline) -> None:
        """Stage hook after the MLE update of each iteration (MLLT/fMLLR
        estimation for the LDA/SAT stages)."""

    # -- schedule ------------------------------------------------------------
    @property
    def realignment_iterations(self) -> List[int]:
        """Default: realign every 10th iteration (reference
        ``triphone.py:318-325``); monophone overrides."""
        return list(range(10, self.config.num_iterations, 10))

    # -- helpers -------------------------------------------------------------
    def _silence_phone_ids(self) -> List[int]:
        lex = self.lexicon
        out = set()
        for base in (lex.silence_phone, lex.oov_phone, "sp"):
            for name, pid in lex.phone_table.items():
                if name == base or (
                    name.startswith(base + "_") and len(name) == len(base) + 2
                ):
                    out.add(pid)
        return sorted(out)

    def _silence_pdfs(self) -> List[int]:
        pdfs = set()
        for pid in self._silence_phone_ids():
            try:
                self.tm.topo.entry_for_phone(pid)
            except (KeyError, IndexError):
                continue
            for cls in range(self.tm.topo.num_pdf_classes(pid)):
                pdfs.update(self.tree.pdfs_for_phone_pdf_class(pid, cls))
        return sorted(pdfs)

    # -- device model mirror -------------------------------------------------
    def _boost_add(self) -> Optional[np.ndarray]:
        """(P, 1) gconst additive for gmm-boost-silence, or None."""
        if self.config.boost_silence == 1.0:
            return None
        add = np.zeros((self.gmm.num_pdfs, 1), np.float32)
        add[self._silence_pdfs()] = math.log(self.config.boost_silence)
        return add

    def _ensure_mirror(self, pipeline: TrainingPipeline) -> _DeviceModelMirror:
        if not self._mirror.valid:
            self._mirror.load_from_host(
                self.gmm, pipeline, boost_gconst_add=self._boost_add()
            )
        return self._mirror

    def sync_host_model(self, pipeline=None) -> None:
        """Fetch the device-resident model back into ``self.gmm`` (one d2h
        round trip; called at stage boundaries and before host-side hooks
        that read the model — MLLT, fMLLR estimation, checkpoints)."""
        m = self._mirror
        if not m.valid or not m.host_stale:
            return
        miv, iv, gc = fetch_all([m.miv, m.iv, m.gconsts])
        self.gmm.means_invvars = np.asarray(miv, dtype=np.float32)
        self.gmm.inv_vars = np.asarray(iv, dtype=np.float32)
        # carry the device-computed gconsts bit-exactly (recomputing on host
        # promotes through float64 and would make a checkpoint-resumed run
        # diverge in ulps from the uninterrupted one)
        gc = np.asarray(gc, dtype=np.float32)
        pad = (
            np.arange(self.gmm.max_gauss)[None, :]
            >= self.gmm.num_gauss[:, None]
        )
        self.gmm.gconsts = np.where(pad, -np.inf, gc).astype(np.float32)
        m.host_stale = False

    def invalidate_device_model(self) -> None:
        """Host ``self.gmm`` changed out-of-band (MLLT rotation, checkpoint
        load): drop the device mirror so the next use re-ships it."""
        self._mirror.invalidate()

    def make_compiler(self) -> AlignmentGraphCompiler:
        return AlignmentGraphCompiler(
            self.tm,
            self.tree,
            self.lexicon,
            transition_scale=self.config.transition_scale,
            self_loop_scale=self.config.self_loop_scale,
        )

    # -- core steps ----------------------------------------------------------
    def _realign(self, pipeline: TrainingPipeline, equal: bool = False) -> None:
        """Viterbi-realign every batch. Everything stays on the device: the
        state paths, per-frame pdfs and transition-ids are derived by device
        gathers; host copies materialize lazily (``FeatureBatch.host_*``)
        only for checkpoints and stage-boundary consumers."""
        with pipeline.clock("equal_align" if equal else "realign"):
            self._realign_batches(pipeline, equal)
        self._tcounts = None

    def _realign_batches(self, pipeline: TrainingPipeline, equal: bool) -> None:
        if not equal:
            gmm = self._ensure_mirror(pipeline).align_gmm()
        for fb in pipeline.batches:
            flens = pipeline.put_b(fb.frame_lengths)
            if equal:
                out = _equal_align_batch(
                    fb.put_b(fb.feats), flens, fb.graph,
                    band_limits=fb.band_limits,
                )
            else:
                out = _align_batch(
                    fb.put_b(fb.feats), flens, fb.graph, gmm,
                    self.config.acoustic_scale,
                    band_limits=fb.band_limits,
                )
            fb.set_device_alignment(out[0], out[1], fb.graph)

    def _get_tcounts(self, pipeline: TrainingPipeline) -> np.ndarray:
        """Per-transition-id counts of the current alignment (cached between
        realignments — the alignment, hence the counts, only change there)."""
        if self._tcounts is not None:
            return self._tcounts
        from montreal_forced_aligner_tpu_torch.ops.stats import (
            accumulate_transition_stats,
        )

        num_tids = self.tm.num_transition_ids
        if all(fb.frame_tid_dev is not None for fb in pipeline.batches):
            total = None
            for fb in pipeline.batches:
                t = accumulate_transition_stats(
                    fb.frame_tid_dev,
                    pipeline.put_b(fb.frame_lengths),
                    num_tids,
                )
                total = t if total is None else total + t
            counts = fetch_all([total])[0]
        else:
            counts = np.zeros(num_tids + 1)
            for fb in pipeline.batches:
                ft = fb.host_frame_tid()
                if ft is None:
                    continue
                counts += np.bincount(
                    ft[ft > 0], minlength=num_tids + 1
                )[: num_tids + 1]
        self._tcounts = counts
        return counts

    def _accumulate(self, pipeline: TrainingPipeline):
        """GMM stats for the current alignment, summed into device-resident
        (P, G[, D]) tensors — nothing crosses back to the host here (the
        update fetches only the (P, G) occupancy + scalars)."""
        with pipeline.clock("stats"):
            return self._accumulate_device(pipeline)

    def _accumulate_device(self, pipeline: TrainingPipeline):
        m = self._ensure_mirror(pipeline)
        occ = mean = var = ll = frames = None
        for fb in pipeline.batches:
            flens = pipeline.put_b(fb.frame_lengths)
            o, ma, va, l = _accumulate_batch(
                fb.put_b(fb.feats),
                flens,
                fb.frame_pdf,
                m.W,
                m.gconsts,
                self.gmm.num_pdfs,
                layout=fb.pdf_layout(self.gmm.num_pdfs),
            )
            f = _sum_frames(flens)
            if occ is None:
                occ, mean, var, ll, frames = o, ma, va, l, f
            else:
                occ, mean, var = occ + o, mean + ma, var + va
                ll, frames = ll + l, frames + f
        return DeviceAccumulators(occ, mean, var, ll, frames)

    def _update(self, acc, mixup_target: Optional[int]) -> dict:
        """MLE update + mixing-up. Returns {"loglike", "frames"}."""
        with self._pipeline.clock("update"):
            return self._update_device(acc, mixup_target)

    def _update_device(self, acc: "DeviceAccumulators",
                       mixup_target: Optional[int]) -> dict:
        """Device-resident update: means/vars re-estimate on device from the
        device accumulators; the host fetches only the (P, G) occupancy to
        compute weights (float64, exact ``mle_update`` semantics) and the
        mixing-up schedule, which the device applies as one scatter."""
        from montreal_forced_aligner_tpu_torch.ops.device_update import (
            apply_split_schedule_scaled_device,
            gconsts_device,
            mle_update_means_vars_device,
            split_schedule_host,
            update_weights_host,
        )

        pipeline = self._pipeline
        m = self._mirror
        occ_h, ll_h, frames_h = fetch_all([acc.occ, acc.loglike, acc.frames])
        occ_h = np.asarray(occ_h, dtype=np.float64)
        miv, iv = mle_update_means_vars_device(
            m.miv, m.iv, acc.occ, acc.mean, acc.var,
            min_gaussian_occupancy=self.config.min_gaussian_occupancy,
        )
        w = update_weights_host(
            self.gmm.weights.astype(np.float64), self.gmm.num_gauss, occ_h
        )
        sched = None
        if mixup_target is not None and mixup_target > self.gmm.total_gauss:
            sched = split_schedule_host(
                w, self.gmm.num_gauss, occ_h, mixup_target, self.gmm.dim,
                power=self.config.power, seed=self.config.seed,
            )
        num_gauss = self.gmm.num_gauss
        if sched is None:
            w32 = np.zeros_like(self.gmm.weights)
            w32[:] = w
            gc = gconsts_device(
                pipeline.put_rep(w32), miv, iv, pipeline.put_rep(num_gauss)
            )
        else:
            # pad the schedule to a power-of-two bucket by repeating the
            # first write (identical duplicate writes commute), as the
            # reference package does: the same writes, in the same layout
            M = sched.num_writes
            Mp = max(8, 1 << (M - 1).bit_length())
            rep = lambda a: np.concatenate(
                [a, np.repeat(a[:1], Mp - M, axis=0)], axis=0
            )
            miv, iv, gc = apply_split_schedule_scaled_device(
                miv, iv,
                pipeline.put_rep(sched.weights),
                pipeline.put_rep(sched.num_gauss),
                pipeline.put_rep(rep(sched.pdf_idx)),
                pipeline.put_rep(rep(sched.dst_idx)),
                pipeline.put_rep(rep(sched.origin_idx)),
                pipeline.put_rep(rep(sched.delta)),
                sched.new_max_gauss,
            )
            w32 = sched.weights
            num_gauss = sched.num_gauss
        # host keeps weights/num_gauss authoritative; (P, G, D) tensors are
        # device-authoritative until sync_host_model()
        self.gmm.weights = w32
        self.gmm.num_gauss = num_gauss
        boost = self._boost_add()
        m.set_device_model(
            miv, iv, gc,
            boost_vec=None if boost is None else pipeline.put_rep(boost),
        )
        self.tm.mle_update(self._get_tcounts(pipeline).astype(np.float64))
        return {"loglike": float(ll_h), "frames": float(frames_h)}

    # -- per-iteration checkpoints ------------------------------------------
    # directory for mid-stage resume (reference: training writes <iter>.mdl
    # every iteration and skips finished ones on rerun,
    # ``acoustic_modeling/base.py:820-826``); set by the orchestrator
    checkpoint_dir = None

    def _save_iter_checkpoint(self, it, pipeline, current_target) -> None:
        import json as _json
        from pathlib import Path

        self.sync_host_model(pipeline)
        d = Path(self.checkpoint_dir)
        d.mkdir(parents=True, exist_ok=True)
        data = {
            "iteration": np.array(it),
            "current_target": np.array(current_target),
            "tm_log_probs": self.tm.log_probs,
            "gmm_weights": self.gmm.weights,
            "gmm_miv": self.gmm.means_invvars,
            "gmm_iv": self.gmm.inv_vars,
            "gmm_gconsts": self.gmm.gconsts,
            "gmm_num_gauss": self.gmm.num_gauss,
            "iteration_log": np.frombuffer(
                _json.dumps(self.iteration_log).encode(), dtype=np.uint8
            ),
        }
        if getattr(self, "lda_mat", None) is not None:
            data["lda_mat"] = self.lda_mat
        if getattr(self, "speaker_transforms", None) is not None:
            data["speaker_transforms"] = self.speaker_transforms
        for i, fb in enumerate(pipeline.batches):
            if fb.has_alignment():
                data[f"state_path_{i}"] = fb.host_state_path()
                data[f"frame_tid_{i}"] = fb.host_frame_tid()
                data[f"align_scores_{i}"] = fb.host_align_scores()
        tmp = d / f"{it}.npz.tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **data)
        tmp.rename(d / f"{it}.npz")
        # only the latest checkpoint is needed for resume
        for old in d.glob("*.npz"):
            if old.stem.isdigit() and int(old.stem) < it:
                old.unlink()

    def _load_iter_checkpoint(self, pipeline) -> int:
        """Returns (resume_iteration, current_target) or (0, None). Must run
        after initialize(): graphs are compiled with the stage-initial model
        (as the reference compiles train graphs once per stage), then the
        checkpointed model/alignments/feature state replace the initial
        ones."""
        import json as _json
        from pathlib import Path

        from montreal_forced_aligner_tpu_torch.models.gmm import DiagGmmSet

        if self.checkpoint_dir is None:
            return 0, None
        d = Path(self.checkpoint_dir)
        if not d.exists():
            return 0, None
        stems = [int(p.stem) for p in d.glob("*.npz") if p.stem.isdigit()]
        iters = sorted(stems, reverse=True)
        if not iters:
            return 0, None
        it = iters[0]
        if it > self.config.num_iterations:
            return 0, None
        data = np.load(d / f"{it}.npz")
        self.tm.log_probs = data["tm_log_probs"]
        gmm = DiagGmmSet(
            weights=data["gmm_weights"],
            means_invvars=data["gmm_miv"],
            inv_vars=data["gmm_iv"],
            gconsts=np.zeros(data["gmm_weights"].shape, np.float32),
            num_gauss=data["gmm_num_gauss"],
        )
        if "gmm_gconsts" in data:
            gmm.gconsts = data["gmm_gconsts"]
        else:
            gmm.compute_gconsts()
        self.gmm = gmm
        self._mirror.invalidate()
        self._tcounts = None
        self.iteration_log = _json.loads(
            bytes(data["iteration_log"]).decode()
        )
        if "lda_mat" in data:
            self.lda_mat = data["lda_mat"]
        if "speaker_transforms" in data:
            self.speaker_transforms = data["speaker_transforms"]
        # restore the stage's feature state if it diverged (MLLT/fMLLR)
        if "lda_mat" in data or "speaker_transforms" in data:
            pipeline.set_feature_transform(
                uses_deltas="lda_mat" not in data,
                lda_mat=data["lda_mat"] if "lda_mat" in data else None,
                speaker_transforms=(
                    data["speaker_transforms"]
                    if "speaker_transforms" in data
                    else None
                ),
            )
        for i, fb in enumerate(pipeline.batches):
            key = f"state_path_{i}"
            if key not in data:
                continue
            fb.set_host_alignment(
                data[key], data[f"frame_tid_{i}"], data[f"align_scores_{i}"]
            )
        logger.info(
            "%s: resumed from iteration %d (%s)", self.train_type, it,
            d / f"{it}.npz",
        )
        return it, int(data["current_target"])

    # -- main loop -----------------------------------------------------------
    def train(self, pipeline: TrainingPipeline) -> AcousticModel:
        cfg = self.config
        self._pipeline = pipeline
        self.use_pitch = getattr(pipeline, "use_pitch", False)
        self.initialize(pipeline)
        self.sync_host_model(pipeline)
        if cfg.max_gaussians > self.gmm.total_gauss:
            # pre-pad the gaussian axis to the first mixup bucket, as the
            # reference package does: the padding decides the slot order,
            # and so where the split schedule writes
            self.gmm = self.gmm.pad_gauss(8)
            self.invalidate_device_model()

        initial_gaussians = self.gmm.total_gauss
        final_gauss_iter = max(cfg.num_iterations - 10, 1)
        increment = max(
            int((cfg.max_gaussians - initial_gaussians) / final_gauss_iter), 0
        )
        current_target = initial_gaussians
        realign_iters = set(self.realignment_iterations)
        start_it, resumed_target = self._load_iter_checkpoint(pipeline)
        if resumed_target is not None:
            current_target = resumed_target

        import time as _time

        _last_ckpt = _time.time()
        for it in range(start_it + 1, cfg.num_iterations + 1):
            _t0 = _time.time()
            if it in realign_iters:
                self._realign(pipeline)
            _t_realign = _time.time() - _t0
            acc = self._accumulate(pipeline)
            if it <= final_gauss_iter:
                current_target = min(current_target + increment, cfg.max_gaussians)
            stats = self._update(acc, mixup_target=current_target)
            self.post_iteration(it, pipeline)
            ll_frame = stats["loglike"] / max(stats["frames"], 1.0)
            _elapsed = _time.time() - _t0
            self.iteration_log.append(
                {
                    "iteration": it,
                    "loglike_per_frame": ll_frame,
                    "num_gaussians": int(self.gmm.total_gauss),
                    "seconds": round(_elapsed, 3),
                    "realign_seconds": round(_t_realign, 3),
                }
            )
            logger.info(
                "%s iter %d: loglike/frame %.4f, %d gaussians (%.2fs%s)",
                self.train_type, it, ll_frame, self.gmm.total_gauss,
                _elapsed,
                f", realign {_t_realign:.2f}s" if it in realign_iters else "",
            )
            if self.checkpoint_dir is not None and (
                cfg.checkpoint_interval_s <= 0
                or it == cfg.num_iterations
                or _time.time() - _last_ckpt >= cfg.checkpoint_interval_s
            ):
                self._save_iter_checkpoint(it, pipeline, current_target)
                _last_ckpt = _time.time()
        self.sync_host_model(pipeline)
        self.finalize(pipeline)
        return self.export_model()

    def export_model(self) -> AcousticModel:
        lex = self.lexicon
        base_phones = sorted(
            {
                k.rsplit("_", 1)[0] if k.endswith(("_B", "_E", "_I", "_S")) else k
                for k, v in lex.phone_table.items()
                if v > 0
            }
            - {lex.silence_phone, lex.oov_phone, "sp", "<eps>"}
        )
        meta = {
            "architecture": "gmm-hmm",
            "version": "0.1.0-tpu",
            "train_type": self.train_type,
            "phones": base_phones,
            "features": self.feature_meta(),
        }
        return AcousticModel(
            transition_model=self.tm,
            gmm=self.gmm,
            tree=self.tree,
            meta=meta,
            phone_table=dict(lex.phone_table),
        )

    def feature_meta(self) -> dict:
        return {
            "type": "mfcc",
            "deltas": True,
            "lda": False,
            "fmllr": False,
            "pitch": getattr(self, "use_pitch", False),
            "frame_shift": 10,
        }
