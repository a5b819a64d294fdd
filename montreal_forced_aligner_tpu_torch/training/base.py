"""Shared training infrastructure, in PyTorch on one device.

Counterpart of ``montreal_forced_aligner_tpu/training/base.py``.
:class:`TrainingPipeline` prepares a corpus once (tokenization, audio, MFCC
plus per-speaker CMVN) and keeps the final features on the device in
length-bucketed batches; trainers iterate over those batches. Between
Viterbi realignments only (B, T) pdf-id tensors and the accumulators move
anywhere.

The training alignment is the aligner's own emission and Viterbi path
(``align.aligner._emit_and_align``): all pdfs and a gather below the
emission kernel's threshold, the state-emission kernel K3 above it, then the
band Viterbi kernels K1 and K2 (the dense recursion for graphs outside the
band buckets). The statistics reduce in a fixed order (``ops/stats.py``), so
a run is reproducible bit for bit on one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.align.aligner import (
    _emission_kernel_eligible,
    _emit_and_align,
    _feats_and_sums,
    _mfcc_and_sums,
    _round_up,
)
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
from montreal_forced_aligner_tpu_torch.device import resolve_device
from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon
from montreal_forced_aligner_tpu_torch.dictionary.tokenizer import SimpleTokenizer
from montreal_forced_aligner_tpu_torch.graph.compiler import (
    AlignmentGraphCompiler,
    CompiledGraph,
    batch_graphs,
    ship_graph_to_device,
)
from montreal_forced_aligner_tpu_torch.ops.feats import (
    add_to_speakers,
    apply_per_speaker_transform,
    apply_transform,
    cmvn_means,
    compute_deltas,
    splice_frames,
)
from montreal_forced_aligner_tpu_torch.ops.mfcc import (
    MfccConfig,
    mfcc_host_batch,
    pad_waves_for_mfcc,
)
from montreal_forced_aligner_tpu_torch.ops.stats import (
    SegmentLayout,
    frame_layout,
    gmm_stats_tiles,
    segment_moments,
)
from montreal_forced_aligner_tpu_torch.ops.viterbi import (
    BatchedGraph,
    band_limits_from_arcs,
    densify_band,
    viterbi_align_batch,
    viterbi_align_batch_band,
)
from montreal_forced_aligner_tpu_torch.params import GmmParams
from montreal_forced_aligner_tpu_torch.tokenization.languages import (
    compose_tokenizer,
    get_language_tokenizer,
)
from montreal_forced_aligner_tpu_torch.tracing import PhaseClock


@dataclass
class TrainerConfig:
    """Defaults per reference ``acoustic_modeling/base.py:645`` and
    ``monophone.py:163-217``."""

    num_iterations: int = 40
    max_gaussians: int = 1000
    power: float = 0.25
    boost_silence: float = 1.25
    acoustic_scale: float = 0.1
    transition_scale: float = 1.0
    self_loop_scale: float = 0.1
    min_gaussian_occupancy: float = 10.0
    batch_size: int = 16
    subset: int = 0  # 0 = use all utterances
    # RNG seed for Gaussian split perturbations + subset sampling
    # (reference GLOBAL_CONFIG.seed; runs are deterministic per seed)
    seed: int = 0
    # minimum seconds between per-iteration resume checkpoints (0 = every
    # iteration); each save fetches the model and the state paths
    checkpoint_interval_s: float = 0.0


def to_host(x) -> Optional[np.ndarray]:
    """A tensor (or array) as a host numpy array."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fetch_all(tree):
    """Host copies of a (nested) list or tuple of tensors, fetched after all
    the work behind them was queued: one ``.cpu()`` per tensor."""
    if isinstance(tree, (list, tuple)):
        return [fetch_all(x) for x in tree]
    return to_host(tree)


class TrainGmm(NamedTuple):
    """One model as the training alignment reads it: ``params`` (W,
    gconsts, and for K3 its rows) with silence boosting applied, and the
    emission rule."""

    params: GmmParams
    use_emission_kernel: bool


@dataclass
class FeatureBatch:
    utt_indices: List[int]
    raw: torch.Tensor  # (B, T, n_mfcc) CMVN-normalized MFCCs
    feats: torch.Tensor  # (B, T, D_final) stage features
    frame_lengths: np.ndarray  # (B,) effective lengths (0 = out of subset)
    device: torch.device = None
    full_frame_lengths: np.ndarray = None  # (B,) true lengths
    speaker_idx: np.ndarray = None  # (B,) dense speaker index per row
    # filled when graphs are attached
    garrs: Optional[dict] = None
    graph: Optional[BatchedGraph] = None
    # transition-id arrays of the graph on the device (the aligner ships
    # only what its Viterbi reads)
    in_tid_dev: Optional[torch.Tensor] = None  # (B, S, K)
    final_tid_dev: Optional[torch.Tensor] = None  # (B, S)
    # band-sparse transition bucket (None when offsets exceed the largest
    # band; the band itself is densified on the device from the arc lists)
    band_limits: Optional[tuple] = None  # (lb, ub)
    # cached alignment (updated on realignment iterations)
    frame_pdf: Optional[torch.Tensor] = None  # (B, T) int32 device
    frame_tid: Optional[np.ndarray] = None  # (B, T) int32 host cache
    state_path: Optional[np.ndarray] = None  # (B, T) int32 host cache
    align_scores: Optional[np.ndarray] = None  # (B,) host cache
    # device-resident alignment (authoritative when set; the host fields
    # above become lazily-fetched caches)
    state_path_dev: Optional[torch.Tensor] = None  # (B, T) int32 device
    frame_tid_dev: Optional[torch.Tensor] = None  # (B, T) int32 device
    align_scores_dev: Optional[torch.Tensor] = None  # (B,) device
    # frames grouped by aligned pdf (ops/stats.py), made once per alignment:
    # (the frame_pdf tensor it was made from, key, layout)
    _layout: Optional[tuple] = None

    def set_device_alignment(self, state_path, scores, graph) -> None:
        """Record a fresh alignment without leaving the device: derive the
        per-frame pdf and transition-id tensors on the device and invalidate
        the host caches."""
        from montreal_forced_aligner_tpu_torch.ops.device_update import (
            frame_tids_device,
        )

        self.state_path_dev = state_path
        self.align_scores_dev = scores
        self.frame_pdf = _frame_pdf_device(graph.state_pdf, state_path)
        self.frame_tid_dev = frame_tids_device(
            state_path,
            self.put_b(self.frame_lengths),
            graph.in_src,
            self.in_tid_dev,
            self.final_tid_dev,
        )
        self.state_path = None
        self.frame_tid = None
        self.align_scores = None

    def set_host_alignment(self, state_path, frame_tid, align_scores) -> None:
        """Record an alignment from host arrays (checkpoint load, alignment
        conversion); device copies move at their use sites."""
        self.state_path = state_path
        self.frame_tid = frame_tid
        self.align_scores = align_scores
        self.state_path_dev = None
        self.frame_tid_dev = None
        self.align_scores_dev = None
        if state_path is not None and self.garrs is not None:
            b = np.arange(state_path.shape[0])[:, None]
            self.frame_pdf = self.put_b(self.garrs["state_pdf"][b, state_path])

    def host_state_path(self) -> Optional[np.ndarray]:
        if self.state_path is None and self.state_path_dev is not None:
            self.state_path = to_host(self.state_path_dev)
        return self.state_path

    def host_frame_tid(self) -> Optional[np.ndarray]:
        if self.frame_tid is None and self.frame_tid_dev is not None:
            self.frame_tid = to_host(self.frame_tid_dev)
        return self.frame_tid

    def host_align_scores(self) -> Optional[np.ndarray]:
        if self.align_scores is None and self.align_scores_dev is not None:
            self.align_scores = to_host(self.align_scores_dev)
        return self.align_scores

    def has_alignment(self) -> bool:
        return self.state_path is not None or self.state_path_dev is not None

    def put_b(self, x) -> torch.Tensor:
        """A batch array or tensor on the pipeline's device."""
        return _put(x, self.device)

    def pdf_layout(self, num_pdfs: int) -> SegmentLayout:
        """The batch's valid frames grouped by aligned pdf, made once per
        (alignment, frame lengths, pdf count) and kept."""
        key = (self.frame_lengths.tobytes(), num_pdfs)
        cached = self._layout
        if cached is None or cached[0] is not self.frame_pdf or cached[1] != key:
            layout = frame_layout(self.frame_pdf, self.put_b(self.frame_lengths),
                                  num_pdfs)
            self._layout = cached = (self.frame_pdf, key, layout)
        return cached[2]


def _put(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _frame_pdf_device(state_pdf, state_path):
    return torch.gather(state_pdf, 1, state_path.long())


class TrainingPipeline:
    """Corpus -> final feature batches + alignment graphs on one device."""

    def __init__(
        self,
        corpus: Corpus,
        lexicon: Lexicon,
        mfcc_config: Optional[MfccConfig] = None,
        batch_size: int = 16,
        uses_deltas: bool = True,
        lda_mat: Optional[np.ndarray] = None,
        use_pitch: bool = False,
        features_on_host: bool = False,
        num_graph_workers: int = 0,
        mesh=None,
        language=None,
        device="cuda",
    ):
        # multi-GPU: a ``parallel.mesh.Mesh`` of this rank's one device; the
        # rank's statistics meet the other ranks' in reduce_card/reduce_host.
        # A rank holds its speakers whole: per-speaker statistics (CMVN,
        # fMLLR) stay on it
        self.mesh = mesh
        if mesh is not None:
            if len(mesh.devices) != 1:
                raise ValueError(
                    "a training mesh holds one device per rank: launch one "
                    "process per card (python -m torch.distributed.run "
                    "--nproc_per_node N ...)")
            device = mesh.device
        self.device = resolve_device(device)
        self.corpus = corpus
        self.lexicon = lexicon
        self.mfcc_config = mfcc_config or MfccConfig()
        self.batch_size = batch_size
        self.uses_deltas = uses_deltas
        self.lda_mat = lda_mat
        self.use_pitch = use_pitch
        # big-corpus mode: keep feature batches in (pinned) host memory
        # instead of the card's; each use moves them to the card
        self.features_on_host = features_on_host
        # fan host graph compilation of context-dependent trees out over a
        # spawn pool (0 = in-process); the pool persists across training
        # stages (made at first use)
        self.num_graph_workers = num_graph_workers
        self._graph_pool = None
        # what the features phase shipped: align.aligner.resolve_transfer_mode
        self.last_transfer_mode: Optional[str] = None
        self.tokenizer = compose_tokenizer(
            SimpleTokenizer(word_set=set(lexicon.words)),
            get_language_tokenizer(language, word_set=set(lexicon.words)),
        )
        self.batches: List[FeatureBatch] = []
        self.graphs: List[CompiledGraph] = []
        self._spk_mean: Optional[np.ndarray] = None
        self.clock = PhaseClock(self.device)

    def put_b(self, x) -> torch.Tensor:
        return _put(x, self.device)

    def put_rep(self, x) -> torch.Tensor:
        return _put(x, self.device)

    @property
    def world_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.world_size

    def reduce_card(self, tensors) -> List[torch.Tensor]:
        """Statistics on the card summed over the ranks in rank order
        (``parallel.data_parallel.ordered_allreduce``); unchanged without a
        mesh or a process group. Every rank calls it once per pass, whatever
        its batch count: lockstep is one collective per statistic pass."""
        if self.mesh is None:
            return list(tensors)
        from montreal_forced_aligner_tpu_torch.parallel.data_parallel import (
            ordered_allreduce,
        )

        return ordered_allreduce(tensors)

    def reduce_host(self, *arrays) -> List[np.ndarray]:
        """Host statistics summed over the ranks in rank order, in float64
        for floats, in one collective; unchanged on one rank."""
        if self.world_size == 1:
            return list(arrays)
        from montreal_forced_aligner_tpu_torch.parallel.multihost import (
            host_allreduce_sum,
        )

        arrays = [np.asarray(a, np.float64) for a in arrays]
        flat = host_allreduce_sum(np.concatenate([a.reshape(-1) for a in arrays]))
        out, off = [], 0
        for a in arrays:
            out.append(flat[off:off + a.size].reshape(a.shape))
            off += a.size
        return out

    def reduce_accumulators(self, acc):
        """``ops.stats.GmmAccumulators`` summed over the ranks (in place)."""
        if self.world_size == 1:
            return acc
        acc.occ, acc.mean_acc, acc.var_acc, acc.transition_counts, tail = (
            self.reduce_host(acc.occ, acc.mean_acc, acc.var_acc,
                             acc.transition_counts,
                             np.array([acc.total_loglike, acc.total_frames])))
        acc.total_loglike, acc.total_frames = float(tail[0]), float(tail[1])
        return acc

    def _store(self, x: torch.Tensor) -> torch.Tensor:
        """Where a feature batch lives: the card, or pinned host memory."""
        if not self.features_on_host:
            return x
        x = x.cpu()
        return x.pin_memory() if self.device.type == "cuda" else x

    @property
    def raw_dim(self) -> int:
        """Width of the raw features: the CMVN'd MFCCs, then the pasted
        pitch columns of a pitch model."""
        base = self.mfcc_config.num_coefficients
        if self.use_pitch:
            from montreal_forced_aligner_tpu_torch.ops.pitch import PitchConfig

            base += PitchConfig().num_feature_dims
        return base

    @property
    def feature_dim(self) -> int:
        base = self.raw_dim
        if self.lda_mat is not None:
            return self.lda_mat.shape[0]
        return base * 3 if self.uses_deltas else base

    def prepare_features(self) -> None:
        with self.clock("features"):
            self._prepare_features()

    def _prepare_features(self) -> None:
        corpus = self.corpus
        speaker_index = corpus.speaker_index
        num_speakers = len(corpus.speakers)
        waves: List[np.ndarray] = corpus.load_audio_parallel(
            self.mfcc_config.sample_rate
        )
        order = np.argsort([len(w) for w in waves], kind="stable")
        batch_lists = [
            list(order[i : i + self.batch_size])
            for i in range(0, len(order), self.batch_size)
        ]
        D = self.mfcc_config.num_coefficients
        # float64 totals on the host, one utterance at a time in corpus order
        spk_sum = torch.zeros((num_speakers, D), dtype=torch.float64)
        spk_count = torch.zeros(num_speakers, dtype=torch.float64)
        from montreal_forced_aligner_tpu_torch.align.aligner import (
            resolve_transfer_mode,
        )

        # MFA_TPU_TRANSFER_MODE forces the mode; "auto" probes the link
        transfer_mode = resolve_transfer_mode(device=self.device)
        self.last_transfer_mode = transfer_mode
        stash = []
        for batch in batch_lists:
            wave_list = [waves[i] for i in batch]
            L = _round_up(max(len(w) for w in wave_list), 16000)
            padded, lens = pad_waves_for_mfcc(wave_list, self.mfcc_config, L)
            flens = np.array(
                [self.mfcc_config.num_frames(int(n)) for n in lens], np.int32
            )
            if transfer_mode == "features":
                feats16 = mfcc_host_batch(
                    padded, self.mfcc_config, self.mfcc_config.num_frames(L)
                ).astype(np.float16)
                feats_dev, sums = _feats_and_sums(
                    self.put_b(feats16), self.put_b(flens))
            else:
                feats_dev, sums = _mfcc_and_sums(
                    self.put_b(padded),
                    self.put_b(flens),
                    self.mfcc_config,
                    self.mfcc_config.num_frames(L),
                )
            stash.append((batch, self._store(feats_dev), flens, sums))
        # every batch is queued before any sum is fetched
        for (batch, _f, flens, _s), sums in zip(
            stash, fetch_all([s for _b, _f, _fl, s in stash])
        ):
            spk = [speaker_index[corpus.utterances[i].speaker] for i in batch]
            for row, i in enumerate(batch):
                corpus.utterances[i].num_frames = int(flens[row])
            add_to_speakers(spk_sum, torch.from_numpy(sums[: len(batch)]), spk)
            add_to_speakers(spk_count, torch.from_numpy(flens[: len(batch)]), spk)
        self._spk_mean = cmvn_means(spk_sum, spk_count).numpy()
        # normalize and finalize features on the device (raw = CMVN'd MFCCs
        # kept for later stages that change the feature transform)
        for batch, feats_dev, flens, _sums in stash:
            spk_idx = np.zeros(len(flens), np.int32)
            spk_idx[: len(batch)] = [
                speaker_index[corpus.utterances[i].speaker] for i in batch
            ]
            mean_rows = self._spk_mean[spk_idx]
            raw = _normalize_raw(self.put_b(feats_dev), self.put_b(mean_rows))
            if self.use_pitch:
                from montreal_forced_aligner_tpu_torch.ops.pitch import (
                    pitch_for_mfcc_frames,
                )

                wave_list = [waves[i] for i in batch]
                L = max(len(w) for w in wave_list)
                wbuf = np.zeros((len(flens), L), np.float32)
                wlens = np.zeros(len(flens), np.int32)
                for r, w in enumerate(wave_list):
                    wbuf[r, : len(w)] = w
                    wlens[r] = len(w)
                pitch = pitch_for_mfcc_frames(wbuf, wlens, flens, int(raw.shape[1]),
                                              device=self.device)
                raw = torch.cat([raw, self.put_b(pitch)], dim=-1)
            final = _finalize_features(
                raw,
                self.put_b(flens),
                None if self.lda_mat is None else self.put_rep(self.lda_mat),
                self.uses_deltas,
            )
            self.batches.append(
                FeatureBatch(
                    utt_indices=[int(i) for i in batch],
                    raw=self._store(raw),
                    feats=self._store(final),
                    frame_lengths=flens,
                    device=self.device,
                    full_frame_lengths=flens.copy(),
                    speaker_idx=spk_idx,
                )
            )

    def set_feature_transform(
        self,
        uses_deltas: bool = True,
        lda_mat: Optional[np.ndarray] = None,
        speaker_transforms: Optional[np.ndarray] = None,
    ) -> None:
        """Recompute every batch's stage features from the raw MFCCs:
        deltas (mono/tri), splice+LDA (LDA/SAT), optionally followed by
        per-speaker fMLLR transforms (SAT)."""
        self.uses_deltas = uses_deltas
        self.lda_mat = lda_mat
        lda_t = None if lda_mat is None else self.put_rep(lda_mat)
        trans_t = (None if speaker_transforms is None
                   else self.put_rep(np.asarray(speaker_transforms, np.float32)))
        for fb in self.batches:
            final = _finalize_features(
                self.put_b(fb.raw), self.put_b(fb.frame_lengths), lda_t,
                uses_deltas,
            )
            if trans_t is not None:
                final = apply_per_speaker_transform(
                    final, self.put_b(fb.speaker_idx), trans_t,
                )
            fb.feats = self._store(final)
            fb.frame_pdf = None
            fb.frame_tid = None
            fb.frame_tid_dev = None

    def utterance_loglikes(self) -> Dict[int, float]:
        """Per-utterance alignment log-likelihood per frame from the most
        recent realignment (reference stores these per utterance,
        ``alignment/mixins.py:305-358``)."""
        out: Dict[int, float] = {}
        for fb in self.batches:
            scores = fb.host_align_scores()
            if scores is None:
                continue
            for row, i in enumerate(fb.utt_indices):
                L = int(fb.frame_lengths[row])
                if L > 0:
                    out[i] = float(scores[row]) / L
        return out

    def set_subset(self, utt_indices: Optional[set]) -> None:
        """Restrict training to a subset by zeroing the effective frame
        lengths of excluded utterances (the reference materializes subset
        split directories instead, ``corpus/base.py:2845``). None = full."""
        for fb in self.batches:
            if utt_indices is None:
                fb.frame_lengths = fb.full_frame_lengths.copy()
            else:
                fl = np.zeros_like(fb.full_frame_lengths)
                for row, i in enumerate(fb.utt_indices):
                    if i in utt_indices:
                        fl[row] = fb.full_frame_lengths[row]
                fb.frame_lengths = fl

    def compile_graphs(
        self, compiler: AlignmentGraphCompiler, num_workers: Optional[int] = None
    ) -> None:
        with self.clock("graph_compile"):
            self._compile_graphs(compiler, num_workers)

    def _compile_graphs(
        self, compiler: AlignmentGraphCompiler, num_workers: Optional[int] = None
    ) -> None:
        """Every utterance's graph: the native core for a monophone tree,
        else the persistent worker pool when it is on and the corpus has at
        least four utterances per worker, else the Python compiler here."""
        from montreal_forced_aligner_tpu_torch.graph.native_compile import (
            compile_batch_native,
        )

        if num_workers is None:
            num_workers = self.num_graph_workers
        corpus = self.corpus
        self.graphs = [None] * corpus.num_utterances
        flat_indices = [i for fb in self.batches for i in fb.utt_indices]
        for i in flat_indices:
            utt = corpus.utterances[i]
            if utt.normalized_tokens is None:
                utt.normalized_tokens = self.tokenizer.tokenize(utt.text)
        tokens = [corpus.utterances[i].normalized_tokens for i in flat_indices]
        compiled = compile_batch_native(compiler, tokens)
        if compiled is None and num_workers > 0 and len(flat_indices) >= 4 * num_workers:
            if self._graph_pool is None:
                from montreal_forced_aligner_tpu_torch.graph.parallel import (
                    SharedGraphCompilerPool,
                )

                # persistent across stages: each stage rebuilds the compiler
                # (new tree/model), so the table ships per call instead of
                # respawning workers per stage
                self._graph_pool = SharedGraphCompilerPool(num_workers)
            compiled = self._graph_pool.compile_all(
                [("", t) for t in tokens], {"": compiler}
            )
        elif compiled is None:
            compiled = [compiler.compile(t) for t in tokens]
        for i, g in zip(flat_indices, compiled):
            self.graphs[i] = g
        for fb in self.batches:
            graphs = [self.graphs[i] for i in fb.utt_indices]
            fb.garrs = batch_graphs(graphs)
            fb.band_limits = band_limits_from_arcs(fb.garrs)
            fb.graph = ship_graph_to_device(fb.garrs, self.device)
            fb.in_tid_dev = self.put_b(fb.garrs["in_tid"].astype(np.int32))
            fb.final_tid_dev = self.put_b(fb.garrs["final_tid"].astype(np.int32))

    # -- global stats for flat starts ---------------------------------------
    def global_mean_var(self, max_batches: int = 4) -> Tuple[np.ndarray, np.ndarray]:
        """Global feature mean/var over (a prefix of) the corpus (spec:
        flat-start ``gmm_init_mono`` from ~10 feature matrices,
        ``monophone.py:298-339``). Moments reduce on the device; only (D,)
        vectors come to the host."""
        from montreal_forced_aligner_tpu_torch.ops.device_update import (
            masked_feature_moments,
        )

        tot = np.zeros(self.feature_dim)
        totsq = np.zeros(self.feature_dim)
        n = 0.0
        pending = [
            masked_feature_moments(
                self.put_b(fb.feats), self.put_b(fb.frame_lengths)
            )
            for fb in self.batches[:max_batches]
        ]
        for s, sq, cnt in [fetch_all(p) for p in pending]:
            tot += s.astype(np.float64)
            totsq += sq.astype(np.float64)
            n += float(cnt)
        # each rank's first batches, reduced over the ranks
        tot, totsq, n_arr = self.reduce_host(tot, totsq, np.array([n]))
        n = float(n_arr[0])
        mean = tot / max(n, 1.0)
        var = np.maximum(totsq / max(n, 1.0) - mean**2, 1e-3)
        return mean, var


class StreamingTreeSum:
    """Pairwise (binomial-counter) reduction over a stream of stat tuples:
    float32 cross-batch error at O(log n) depth like a full tree reduction,
    holding only O(log n) live tensors."""

    def __init__(self):
        self._levels = []

    def add(self, part) -> None:
        i = 0
        while i < len(self._levels) and self._levels[i] is not None:
            part = tuple(a + b for a, b in zip(self._levels[i], part))
            self._levels[i] = None
            i += 1
        if i == len(self._levels):
            self._levels.append(part)
        else:
            self._levels[i] = part

    def total(self):
        acc = None
        for lvl in self._levels:
            if lvl is None:
                continue
            acc = lvl if acc is None else tuple(
                a + b for a, b in zip(acc, lvl)
            )
        return acc


def _normalize_raw(feats, mean_rows):
    return feats - mean_rows[:, None, :]


def _finalize_features(x, frame_lengths, lda, uses_deltas):
    if lda is not None:
        return apply_transform(splice_frames(x, frame_lengths, 3, 3), lda)
    if uses_deltas:
        return compute_deltas(x, frame_lengths)
    return x


def train_gmm(W, gconsts, miv, iv) -> TrainGmm:
    """The training alignment's model on the device from its (2D, P*G)
    likelihood matrix, (P, G) gconsts (boosted where the stage boosts
    silence) and (P, G, D) tensors, with the aligner's emission rule; K3's
    rows are packed on the device when the rule takes K3."""
    from montreal_forced_aligner_tpu_torch.ops.cuda_emission import (
        pack_rows_device,
    )

    P, G = gconsts.shape
    use_k = _emission_kernel_eligible(P, G)
    if use_k:
        rows = pack_rows_device(miv, iv, gconsts)
    else:
        rows = torch.zeros((P, G, 8), dtype=torch.float32, device=W.device)
    return TrainGmm(GmmParams(W, gconsts, rows), use_k)


def _align_batch(
    feats, frame_lengths, graph, gmm: TrainGmm, acoustic_scale,
    band_limits=None,
):
    """Viterbi-align one batch with the current GMM: the aligner's emission
    rule (all pdfs and a gather, or K3), then the band Viterbi (K1, K2)
    when the graph's arc offsets fit a band, else the dense recursion.
    Returns (state_path (B, T) int32, best_score (B,))."""
    return _emit_and_align(
        feats, frame_lengths, graph, gmm.params, acoustic_scale,
        band_limits=band_limits, use_emission_kernel=gmm.use_emission_kernel,
    )


def _equal_align_batch(
    feats, frame_lengths, graph, alpha: float = 10.0, band_limits=None,
):
    """First-pass equal alignment (reference ``MonoAlignEqualFunction``,
    ``monophone.py:37``; Kaldi ``align-equal-compiled``): Viterbi against a
    diagonal position prior ``emit[t, s] = -alpha * (t/L - s/S)^2``, built
    on the device, which spreads frames evenly over the graph states while
    honoring graph structure; band-sparse when the graph fits a band."""
    B, T, _ = feats.shape
    S = graph.state_pdf.shape[1]
    dev = feats.device
    t_pos = (torch.arange(T, device=dev)[None, :, None] + 0.5) / torch.clamp(
        frame_lengths[:, None, None], min=1
    )
    s_pos = (torch.arange(S, device=dev)[None, None, :] + 0.5) / torch.clamp(
        graph.num_states[:, None, None], min=1
    )
    emit = (-alpha * (t_pos - s_pos) ** 2).to(torch.float32)
    if band_limits is not None:
        lb, ub = band_limits
        band = densify_band(graph, lb, ub)
        return viterbi_align_batch_band(
            emit, frame_lengths, band, graph.start, graph.final, lb, ub,
            acoustic_scale=1.0,
        )
    return viterbi_align_batch(emit, frame_lengths, graph, acoustic_scale=1.0)


def _accumulate_batch(
    feats,  # (B, T, D)
    frame_lengths,  # (B,)
    frame_pdf,  # (B, T) int32
    W,  # (2D, P*G)
    gconsts,  # (P, G)
    num_pdfs: int,
    layout: Optional[SegmentLayout] = None,
):
    """GMM stats for one batch (Viterbi-hard pdf per frame):

    occ      = segsum_pdf(post)            (P, G)
    mean_acc = segsum_pdf(post x)          (P, G, D)
    var_acc  = segsum_pdf(post x^2)        (P, G, D)

    Each tile of frames of one pdf gathers that pdf's parameters once;
    the per-pdf sums have a fixed order (``ops/stats.py``). ``layout``
    (the batch's frames by pdf) is made here when not given.
    """
    B, T, D = feats.shape
    P, G = gconsts.shape
    if layout is None:
        layout = frame_layout(frame_pdf, frame_lengths, num_pdfs)
    Wp = W.reshape(2 * D, P, G).permute(1, 0, 2).contiguous()
    return gmm_stats_tiles(feats.reshape(B * T, D), layout, Wp, gconsts)


def _accumulate_events(
    feats,  # (B, T, D)
    frame_lengths,  # (B,)
    frame_event,  # (B, T) int32 event id per frame
    num_events: int,
):
    """Per-event (count, sum, sumsq), fixed-order segmented sums (tree
    stats)."""
    B, T, D = feats.shape
    layout = frame_layout(frame_event, frame_lengths, num_events)
    return segment_moments(feats.reshape(B * T, D), layout)


def select_training_subset(
    corpus, subset_size: int, min_word_count: int = 3, seed: int = 1234
) -> set:
    """Pick a training subset with the reference's preference rules
    (``create_subset``, ``corpus/base.py:2526-2680``):

    - only utterances with more than ``min_word_count`` (3) words;
    - subsets <= 25k exclude cutoff/hesitation-containing utterances;
    - prefer speakers with at least 30 (then 15, then 5)
      shorter-than-average utterances, the first threshold whose speakers
      cover the subset;
    - when the eligible pool exceeds 10x the subset, sample from the 10x
      shortest candidates (shuffled), then drop speakers that landed
      fewer than 5 utterances in the subset.

    The reference's per-dictionary quotas and ignored/duration-deviation
    flags apply to its multi-dictionary DB corpora; this pipeline carries
    one lexicon and filters outliers via ``quality_check_subset`` instead.
    """
    import random
    import re
    from collections import Counter

    cutoff_re = re.compile(r"[<\[{](cutoff|hes)", re.IGNORECASE)
    eligible: List[Tuple[object, float]] = []  # (utterance, duration proxy)
    for utt in corpus.utterances:
        tokens = utt.normalized_tokens or utt.text.split()
        if len(tokens) <= min_word_count:
            continue
        if subset_size <= 25000 and any(cutoff_re.match(t) for t in tokens):
            continue
        dur = float(utt.num_frames if utt.num_frames else len(tokens))
        eligible.append((utt, dur))
    if len(eligible) <= subset_size:
        return {utt.id for utt, _d in eligible}

    average = sum(d for _u, d in eligible) / len(eligible)
    shorter_counts = Counter(
        utt.speaker for utt, d in eligible if d <= average
    )
    preferred_speakers = None
    for utt_count_cutoff in (30, 15, 5):
        valid = {
            s for s, c in shorter_counts.items() if c >= utt_count_cutoff
        }
        if sum(shorter_counts[s] for s in valid) >= subset_size:
            preferred_speakers = valid
            break

    pool = eligible
    if preferred_speakers is not None:
        pool = [
            (u, d) for u, d in eligible if u.speaker in preferred_speakers
        ]
    rng = random.Random(seed)
    larger = subset_size * 10
    if len(eligible) > larger:
        pool = sorted(pool, key=lambda x: (x[1], x[0].id))[:larger]
        if len(pool) >= subset_size:
            chosen = rng.sample(pool, subset_size)
        else:
            chosen = pool
        # drop speakers that landed too few utterances to train on
        spk_counts = Counter(u.speaker for u, _d in chosen)
        thin = {s for s, c in spk_counts.items() if c < 5}
        chosen = [(u, d) for u, d in chosen if u.speaker not in thin]
    elif len(pool) >= subset_size:
        chosen = rng.sample(pool, subset_size)
    else:
        chosen = pool
    return {u.id for u, _d in chosen}
