"""Pretrained-model corpus alignment pipeline, in PyTorch.

Counterpart of ``montreal_forced_aligner_tpu/align/aligner.py``
(``PretrainedAligner._align_corpus_impl``): corpus load → audio load →
phase A, MFCC plus per-speaker CMVN sums, and pitch for pitch models
(device; in the "features" transfer mode the MFCCs are computed on the
host and shipped as float16) → host graph compile (native C++ for monophone trees, else Python,
in a worker pool with ``num_graph_workers``) → graph ship → final
features, CMVN then deltas or splice+LDA (device) →
graph-state emissions and band Viterbi (device: kernels K3, K1, K2) → one
fetch of every state path → CTM intervals → TextGrid export.

SAT models with speaker adaptation run two passes (reference
``_fmllr_second_pass_feats``): the speaker-independent model aligns, the
final model's fMLLR statistics are summed per speaker on the device, one
fetch brings them to the host for the row-sweep solve, and the adapted
features align with the final model. Utterances over
``online.alignment.LONG_UTTERANCE_FRAMES`` take the single-utterance path
with the chunked exact Viterbi.

Utterances are bucketed by length so each batch pads little; every batch
is dispatched before any result is fetched, so host work (graph compile,
padding) overlaps the device's. Batches go round-robin to the local devices
of ``AlignerConfig.devices``; when the caller asks for a multi-GPU run
(``distributed``) each rank aligns its own speakers and the ranks exchange
the results.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus, Utterance
from montreal_forced_aligner_tpu_torch.data import (
    CtmInterval,
    UtteranceAlignment,
    WordCtmInterval,
)
from montreal_forced_aligner_tpu_torch.device import resolve_device
from montreal_forced_aligner_tpu_torch.dictionary.lexicon import (
    Pronunciation,
    load_dictionary_argument,
)
from montreal_forced_aligner_tpu_torch.dictionary.rules import (
    PhonologicalRule,
    apply_rules_to_lexicon,
)
from montreal_forced_aligner_tpu_torch.dictionary.tokenizer import SimpleTokenizer
from montreal_forced_aligner_tpu_torch.g2p.generator import G2PGenerator
from montreal_forced_aligner_tpu_torch.g2p.trainer import G2PModel
from montreal_forced_aligner_tpu_torch.graph.compiler import (
    AlignmentGraphCompiler,
    CompiledGraph,
    batch_graphs,
    ship_graph_to_device,
)
from montreal_forced_aligner_tpu_torch.io.textgrid import Interval, TextGrid
from montreal_forced_aligner_tpu_torch.io.wav import read_wave
from montreal_forced_aligner_tpu_torch.models.acoustic_model import AcousticModel
from montreal_forced_aligner_tpu_torch.ops import tiles
from montreal_forced_aligner_tpu_torch.ops.cuda_emission import state_loglikes
from montreal_forced_aligner_tpu_torch.ops.feats import (
    add_to_speakers,
    apply_per_speaker_transform,
    apply_transform,
    cmvn_means,
    compute_deltas,
    frame_sums,
    nonsilence_weight,
    silence_pdf_mask,
    splice_frames,
)
from montreal_forced_aligner_tpu_torch.ops.gmm_loglikes import (
    gmm_loglikes,
    select_state_emissions,
)
from montreal_forced_aligner_tpu_torch.ops.mfcc import (
    MfccConfig,
    _mfcc_device,
    mfcc_host_batch,
    pad_waves_for_mfcc,
)
from montreal_forced_aligner_tpu_torch.ops.transforms import (
    FmllrEstimate,
    accumulate_fmllr_stats,
    estimate_speaker_fmllr,
    stats_to_host,
    zero_fmllr_totals,
)
from montreal_forced_aligner_tpu_torch.ops.viterbi import (
    BatchedGraph,
    band_limits_from_arcs,
    densify_band,
    extract_frame_labels_host,
    viterbi_align_batch,
    viterbi_align_batch_band,
)
from montreal_forced_aligner_tpu_torch.params import (
    FmllrParams,
    GmmParams,
    fmllr_params_from_numpy,
    gmm_params_from_numpy,
)
from montreal_forced_aligner_tpu_torch.tokenization.languages import (
    compose_tokenizer,
    get_language_tokenizer,
)

POSITIONS = ("_B", "_E", "_I", "_S")

# bytes of the (B, frames, P) pdf log-likelihoods per chunk of the
# confidence margin (``gmm_loglikes`` bounds its own Gaussians' tiles)
_CONFIDENCE_CHUNK_BYTES = 512 << 20

_logger = logging.getLogger("mfa_tpu")


def _mfcc_and_sums(
    padded_waves: torch.Tensor,  # (B, L) int16 or float32
    frame_lengths: torch.Tensor,  # (B,) int32
    cfg: MfccConfig,
    max_frames: int,
):
    """MFCC + each utterance's float64 feature sums over its own frames
    (for CMVN, ``ops.feats.frame_sums``): (feats (B, T, D), sums (B, D))."""
    feats = _mfcc_device(padded_waves, cfg, max_frames)
    return feats, frame_sums(feats, frame_lengths)


def _feats_and_sums(feats16: torch.Tensor, frame_lengths: torch.Tensor):
    """Phase A for features computed on the host (``ops.mfcc.
    mfcc_host_batch``) and shipped as float16: float32 on the device, and
    the per-utterance sums of :func:`_mfcc_and_sums`: (feats (B, T, D),
    sums (B, D))."""
    feats = feats16.to(torch.float32)
    return feats, frame_sums(feats, frame_lengths)


def _final_feats(feats, frame_lengths, mean_rows, lda=None, pitch=None):
    """CMVN-subtract, optional pitch paste, then deltas (no LDA) or splice
    ±3 + LDA (pitch is pasted after CMVN, reference
    ``FinalFeatureFunction``, ``corpus/features.py:254``)."""
    x = feats - mean_rows[:, None, :]
    if pitch is not None:
        x = torch.cat([x, pitch], dim=-1)
    if lda is None:
        return compute_deltas(x, frame_lengths)
    return apply_transform(splice_frames(x, frame_lengths, 3, 3), lda)


def _phone_confidence(ff, state_path, graph, W, gconsts) -> torch.Tensor:
    """Per-frame confidence margin (B, T): the aligned pdf's log-likelihood
    minus the best pdf's (reference ``PhoneConfidenceFunction``,
    ``alignment/multiprocessing.py:1353``); always <= 0. All pdfs in
    float32 and a gather, in chunks of frames."""
    B, T, _D = ff.shape
    P = gconsts.shape[0]
    frame_pdf = graph.state_pdf.gather(1, state_path.long()).long()
    out = torch.empty((B, T), dtype=torch.float32, device=ff.device)
    # whole blocks of frames (``ops.tiles``): no chunk pads its rows' blocks
    step = tiles.BLOCK * max(1, _CONFIDENCE_CHUNK_BYTES // (B * P * 4 * tiles.BLOCK))
    for t0 in range(0, T, step):
        ts = slice(t0, min(T, t0 + step))
        ll = gmm_loglikes(ff[:, ts], W, gconsts)  # (B, t, P)
        selected = ll.gather(2, frame_pdf[:, ts, None])[..., 0]
        out[:, ts] = selected - ll.max(dim=-1).values
    return out


def _emission_kernel_eligible(num_pdfs: int, num_gauss: int) -> bool:
    """Evaluate only each graph state's pdf (kernel K3) once the model is
    large enough that the all-pdf product wastes most of its work; below
    the threshold, all pdfs and a gather. The kernel streams over
    Gaussians, so no cap on G is needed."""
    return num_pdfs * num_gauss >= 16384


def _emit_and_align(
    ff: torch.Tensor,
    frame_lengths: torch.Tensor,
    graph: BatchedGraph,
    gmm: GmmParams,
    acoustic_scale: float,
    band_limits=None,
    use_emission_kernel: bool = False,
):
    """Graph-state emissions -> exact Viterbi (band-sparse when the graph's
    arc offsets fit a band, dense max-plus otherwise). Returns
    (state_path (B, T) int32, best_score (B,))."""
    if use_emission_kernel:
        emit = state_loglikes(ff, graph.state_pdf, gmm.rows, gmm.rows_split)
    else:
        ll = gmm_loglikes(ff, gmm.W, gmm.gconsts)  # (B, T, P)
        emit = select_state_emissions(ll, graph.state_pdf)
    if band_limits is not None:
        lb, ub = band_limits
        band = densify_band(graph, lb, ub)
        return viterbi_align_batch_band(
            emit, frame_lengths, band, graph.start, graph.final, lb, ub,
            acoustic_scale=acoustic_scale,
        )
    return viterbi_align_batch(emit, frame_lengths, graph, acoustic_scale)


class _Batch(NamedTuple):
    """One batch on its way through the device phases."""

    utts: List[int]  # corpus utterance indices, one per row
    flens: np.ndarray  # (B,) int32 frame counts
    garrs: dict  # batch_graphs arrays (host)
    graph: BatchedGraph  # the same on the device
    ff: torch.Tensor  # (B, T, D) final (or adapted) features
    flens_dev: torch.Tensor
    band_limits: Optional[Tuple[int, int]]
    spk_dev: torch.Tensor  # (B,) int64 speaker index


@dataclass
class AlignerConfig:
    """Alignment parameters (the reference package's fields; defaults from
    reference ``alignment/mixins.py:68-95``)."""

    acoustic_scale: float = 0.1
    transition_scale: float = 1.0
    self_loop_scale: float = 0.1
    boost_silence: float = 1.0
    beam: int = 10  # kept for CLI compatibility: the DP is exact
    retry_beam: int = 40
    batch_size: int = 16
    frame_bucket_multiple: int = 256
    fmllr_min_count: float = 100.0
    compute_confidence: bool = False
    # reference --single_speaker: False aligns a SAT model single-pass with
    # its speaker-independent model
    uses_speaker_adaptation: bool = True
    # local devices the batches go to round-robin (default: the aligner's
    # device); reductions meet on the first
    devices: Optional[tuple] = None
    # multi-GPU, only when asked: under a process group of several ranks
    # each rank aligns its own speakers of the corpus every rank was given
    # (shard_corpus_for_host) on its card and every rank returns all the
    # results; in one process, batches round-robin over every local card
    distributed: bool = False
    language: Optional[str] = None
    # what phase A ships to the device: "waves", "features" (float16 MFCCs
    # computed on the host) or "auto" (see resolve_transfer_mode)
    transfer_mode: str = "auto"
    num_loader_threads: int = 8
    # graph-compile processes for context-dependent trees (0 = in-process);
    # monophone graphs take the native core whatever the setting
    num_graph_workers: int = 0


# -- what phase A ships: waves or host features ------------------------------
# int16 waves are about 32 KB an audio second, (T, 13) float16 MFCCs about
# 2.6 KB: 12 times fewer bytes. Where the host-to-device link reads slow,
# phase A computes the MFCCs on the host and ships those. A local card over
# PCIe reads far above the threshold, so "auto" ships waves there.

# the last probe: when, what it chose, its MB/s
_transfer_probe_cache = {"t": 0.0, "mode": None, "rate": None}


def _probe_h2d_MBps(device="cuda") -> float:
    """Marginal host-to-device rate in MB/s: a 4 MB copy from pageable
    numpy timed against a 4 KB one, each synchronised, so the fixed cost
    of a copy cancels out (a link whose every call is slow is not helped by
    fewer bytes)."""
    dev = resolve_device(device)
    small = np.zeros(2 * 1024, np.int16)  # 4 KB
    big = np.zeros(2 * 1024 * 1024, np.int16)  # 4 MB

    def timed(a):
        t0 = time.perf_counter()
        torch.from_numpy(a).to(dev)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    timed(small[:16])  # the copy path warm
    t_small = timed(small)
    t_big = timed(big)
    return (big.nbytes - small.nbytes) / 1e6 / max(t_big - t_small, 1e-9)


def resolve_transfer_mode(requested: str = "auto", ttl_s: float = 120.0,
                          device="cuda") -> str:
    """Pick "waves" or "features" for phase A.

    The variable ``MFA_TPU_TRANSFER_MODE`` forces a mode, then
    ``requested``. "auto" is "waves" on the CPU, which has no link; on a
    card it probes the link (the reading is kept ``ttl_s`` seconds) and
    ships features below ``MFA_TPU_TRANSFER_THRESHOLD_MBPS`` (default 25).
    Callers record the choice: float16 features quantize (about 1e-3
    relative), so alignments can differ from wave shipping at exact ties.
    """
    env = os.environ.get("MFA_TPU_TRANSFER_MODE")
    if env in ("waves", "features"):
        return env
    if requested in ("waves", "features"):
        return requested
    if resolve_device(device).type != "cuda":
        return "waves"
    now = time.monotonic()
    if (_transfer_probe_cache["mode"] is not None
            and now - _transfer_probe_cache["t"] < ttl_s):
        return _transfer_probe_cache["mode"]
    rate = _probe_h2d_MBps(device)
    threshold = float(os.environ.get("MFA_TPU_TRANSFER_THRESHOLD_MBPS", 25.0))
    mode = "features" if rate < threshold else "waves"
    _transfer_probe_cache.update(t=now, mode=mode, rate=rate)
    if mode == "features":
        _logger.warning(
            "host->device link slow (%.0f MB/s < %.0f): shipping float16 "
            "MFCC features computed on the host instead of waves",
            rate, threshold,
        )
    else:
        _logger.debug("h2d probe %.0f MB/s: shipping waves", rate)
    return mode


_SILENCE_INVENTORIES = {1: ["sil"], 2: ["sil", "spn"], 3: ["sil", "sp", "spn"]}


def reconstruct_phone_table(meta: Dict, topo) -> Dict[str, int]:
    """Rebuild ``phones.txt`` for old model archives that omit it.

    Layout (reference ``dictionary/multispeaker.py:1966`` numbering):
    <eps>=0, then silence phones (base + positional variants when position
    dependent), then each non-silence phone's positional variants in sorted
    order. The silence inventory size ``s`` is solved from the topology's
    phone count: position-dependent archives satisfy ``total = 5*s + 4*n``,
    position-independent ones ``total = s + n``. A layout that fits neither
    raises instead of silently mis-mapping phone ids.
    """
    phones = sorted(meta.get("phones", []))
    total = len(topo.phones)
    n = len(phones)
    table = {"<eps>": 0}

    s_pd = total - 4 * n
    if s_pd > 0 and s_pd % 5 == 0 and (s_pd // 5) in _SILENCE_INVENTORIES:
        idx = 1
        for base in sorted(_SILENCE_INVENTORIES[s_pd // 5]):
            table[base] = idx
            idx += 1
            for pos in POSITIONS:
                table[base + pos] = idx
                idx += 1
        for base in phones:
            for pos in POSITIONS:
                table[base + pos] = idx
                idx += 1
    elif (total - n) in _SILENCE_INVENTORIES:
        idx = 1
        for base in sorted(_SILENCE_INVENTORIES[total - n]):
            table[base] = idx
            idx += 1
        for base in phones:
            table[base] = idx
            idx += 1
    else:
        raise ValueError(
            "cannot reconstruct the phone table for this archive: topology "
            f"has {total} phones but meta lists {n} non-silence bases — "
            "neither the position-dependent (5*s + 4*n) nor the "
            "position-independent (s + n) layout fits a standard silence "
            "inventory (1-3 phones). Re-export the model with phones.txt."
        )
    if len(table) - 1 != total:
        raise ValueError(
            f"reconstructed phone table has {len(table) - 1} phones but the "
            f"topology defines {total}; archive layout is non-standard — "
            "re-export the model with phones.txt"
        )
    return table


def _aligner_layout(config: AlignerConfig, device):
    """(mesh, devices) of an aligner: ``devices`` round-robin when given;
    with ``distributed`` a ``parallel.mesh.Mesh``: the rank's card under a
    process group, else every local card of this process."""
    from montreal_forced_aligner_tpu_torch.parallel.mesh import get_mesh

    mesh = get_mesh(config.devices, device=device) if config.distributed else None
    if config.devices:
        devices = [resolve_device(d) for d in config.devices]
    elif mesh is not None:
        devices = list(mesh.devices)
    else:
        devices = [resolve_device(device)]
    return mesh, devices


class PretrainedAligner:
    """Aligns a corpus with a pretrained acoustic model + pronunciation
    dictionary (reference entry point: ``mfa align``) on one device, on
    several local devices round-robin (``AlignerConfig.devices``), or on a
    rank's shard of the corpus (``AlignerConfig.distributed``)."""

    def __init__(
        self,
        acoustic_model_path,
        dictionary_path,
        config: Optional[AlignerConfig] = None,
        g2p_model_path=None,
        rules_path=None,
        device="cuda",
    ):
        self.config = config or AlignerConfig()
        self.mesh, self.devices = _aligner_layout(self.config, device)
        self.device = self.devices[0]
        self.model_path = acoustic_model_path
        self.dictionary_path = dictionary_path
        self.model = AcousticModel.load(acoustic_model_path)
        if not self.model.phone_table:
            self.model.phone_table = reconstruct_phone_table(
                self.model.meta, self.model.transition_model.topo
            )
        self.lexicons, self.speaker_dictionary_map, default_key = (
            load_dictionary_argument(
                dictionary_path, phone_table=self.model.phone_table
            )
        )
        self.default_dictionary_key = default_key or next(iter(self.lexicons))
        self.lexicon = self.lexicons[self.default_dictionary_key]
        # Rules and G2P pronunciations go to every dictionary of a
        # multi-dictionary argument: the reference package changes only the
        # default one, so other speakers' compilers never saw them.
        if rules_path is not None:
            rules = PhonologicalRule.load_rules(rules_path)
            for lex in self.lexicons.values():
                apply_rules_to_lexicon(lex, rules)
        self.g2p = None
        if g2p_model_path is not None:
            self.g2p = G2PGenerator(G2PModel.load(g2p_model_path))
        all_words = set()
        for lex in self.lexicons.values():
            all_words |= set(lex.words)
        self.tokenizer = compose_tokenizer(
            SimpleTokenizer(word_set=all_words),
            get_language_tokenizer(self.config.language, word_set=all_words),
        )
        self.compilers = {
            key: AlignmentGraphCompiler(
                self.model.transition_model,
                self.model.tree,
                lex,
                transition_scale=self.config.transition_scale,
                self_loop_scale=self.config.self_loop_scale,
            )
            for key, lex in self.lexicons.items()
        }
        self.compiler = self.compilers[self.default_dictionary_key]
        feat_meta = self.model.meta.get("features", {})
        # the archive's stored feature configuration drives extraction
        # (reference ``pretrained.py:76-79``, ``models.py:494-586``)
        defaults = MfccConfig()
        self.mfcc_config = MfccConfig(
            sample_rate=int(
                feat_meta.get("sample_frequency", defaults.sample_rate)
            ),
            frame_shift_ms=float(feat_meta.get("frame_shift", 10)),
            frame_length_ms=float(
                feat_meta.get("frame_length", defaults.frame_length_ms)
            ),
            num_coefficients=int(
                feat_meta.get("num_coefficients", defaults.num_coefficients)
            ),
            num_mel_bins=int(
                feat_meta.get("num_mel_bins", defaults.num_mel_bins)
            ),
            low_frequency=float(
                feat_meta.get("low_frequency", defaults.low_frequency)
            ),
            high_frequency=float(
                feat_meta.get("high_frequency", defaults.high_frequency)
            ),
            snip_edges=bool(feat_meta.get("snip_edges", defaults.snip_edges)),
            use_energy=bool(feat_meta.get("use_energy", False)),
        )
        # own archives write "pitch"; reference archives write "use_pitch"
        self.use_pitch = bool(
            feat_meta.get("pitch", feat_meta.get("use_pitch", False))
        )
        self.frame_shift = self.mfcc_config.frame_shift_ms / 1000.0
        # A SAT model (final.mdl, final.alimdl, fMLLR) with speaker adaptation
        # runs two passes: its speaker-independent final.alimdl aligns
        # (si_gmm), the final model's unboosted tensors feed the fMLLR
        # statistics (fmllr), and the final model aligns the adapted
        # features (gmm). Without adaptation (--single_speaker) it aligns
        # single-pass with final.alimdl (reference first-pass-only
        # behaviour, ``alignment/base.py:491-558``); any other model with
        # final.mdl. Each aligning model has its own emission rule.
        sat = self.model.uses_fmllr and self.model.alignment_model is not None
        self.two_pass = sat and self.config.uses_speaker_adaptation
        si_mode = sat and not self.config.uses_speaker_adaptation
        self.gmm = self._ali_params_on() if si_mode else self._prepare_gmm()
        self.use_emission_kernel = _emission_kernel_eligible(
            self.gmm.num_pdfs, self.gmm.num_gauss
        )
        self.si_gmm: Optional[GmmParams] = None
        self.si_use_emission_kernel = False
        self.fmllr: Optional[FmllrParams] = None
        if self.two_pass:
            self.si_gmm = self._ali_params_on()
            self.si_use_emission_kernel = _emission_kernel_eligible(
                self.si_gmm.num_pdfs, self.si_gmm.num_gauss
            )
            gmm = self.model.gmm
            self.fmllr = fmllr_params_from_numpy(
                gmm, silence_pdf_mask(self._silence_pdfs(), gmm.num_pdfs)
            ).to(self.device)
        self._graph_pool_obj = None
        self._per_device = {}
        self.last_transfer_mode: Optional[str] = None
        # statistics and transforms of the last two-pass run
        self.last_fmllr: Optional[FmllrEstimate] = None
        self.last_phase_seconds: Dict[str, float] = {}
        # synchronise the card at every phase mark, so that each phase's
        # seconds include its device work (a measurement switch: it removes
        # the overlap of host and device work)
        self.sync_phases = False

    def _gmm_params(self, gmm) -> GmmParams:
        """One GMM set and the model's LDA on the device. Silence boosting
        applies to whichever model aligns (reference
        ``alignment/mixins.py:193-203``)."""
        lda = (
            self.model.lda_mat
            if (self.model.uses_lda and self.model.lda_mat is not None)
            else None
        )
        return gmm_params_from_numpy(
            gmm.means_invvars,
            gmm.inv_vars,
            gmm.gconsts,
            lda_mat=lda,
            boost_silence=self.config.boost_silence,
            silence_pdfs=self._silence_pdfs(),
        ).to(self.device)

    def _prepare_gmm(self) -> GmmParams:
        """The final model (``final.mdl``) on the device."""
        return self._gmm_params(self.model.gmm)

    def _ali_params_on(self) -> GmmParams:
        """The speaker-independent alignment model (``final.alimdl``) on the
        device."""
        return self._gmm_params(self.model.alignment_model[1])

    def _silence_pdfs(self) -> np.ndarray:
        """pdf-ids of silence-family phones (``gmm-boost-silence``
        semantics, reference ``alignment/mixins.py:193-203``)."""
        sil_names = {
            n
            for n in self.model.phone_table
            if n.split("_")[0] in ("sil", "sp", "spn")
        }
        pdfs = set()
        tree = self.model.tree
        topo = self.model.transition_model.topo
        for name in sil_names:
            pid = self.model.phone_table[name]
            if topo.phone2idx[pid] < 0:
                continue
            for cls in range(topo.num_pdf_classes(pid)):
                for pdf in tree.pdfs_for_phone_pdf_class(pid, cls):
                    pdfs.add(pdf)
        return np.array(sorted(pdfs), dtype=np.int32)

    def _graph_pool(self, num_items: int):
        """Lazily created persistent graph-compile pool, or None when the
        fan-out is off, G2P changes the lexicons during the run (the workers
        hold copies), or the corpus is too small to pay for starting the
        workers."""
        n = self.config.num_graph_workers
        if n <= 0 or self.g2p is not None or num_items < 4 * n:
            return None
        if self._graph_pool_obj is None:
            from montreal_forced_aligner_tpu_torch.graph.parallel import (
                ParallelGraphCompiler,
            )

            self._graph_pool_obj = ParallelGraphCompiler(self.compilers, n)
        return self._graph_pool_obj

    def _add_g2p_pronunciations(self, tokens, lexicon) -> None:
        """Give ``lexicon`` a G2P pronunciation for each of ``tokens`` it
        lacks, where every generated phone is in the model (reference online
        align, ``online/alignment.py:44-75``). A word that G2P gives no usable
        pronunciation stays out of vocabulary."""
        known_phones = set()
        for name in self.model.phone_table:
            base = name
            for pos in POSITIONS:
                if base.endswith(pos):
                    base = base[: -len(pos)]
            known_phones.add(base)
        for tok in tokens:
            if tok in lexicon.words:
                continue
            for phones, _score in self.g2p.generate(tok, num_pronunciations=1):
                if all(p in known_phones for p in phones):
                    lexicon.add_pronunciation(
                        tok, Pronunciation(phones=tuple(phones))
                    )

    def _on(self, name: str, dev: torch.device):
        """The device tensors ``name`` (``gmm``, ``si_gmm`` or ``fmllr``) on
        ``dev``: the aligner's own on its first device, a copy made once on
        every other (``Module.to`` moves a module in place: copy it first)."""
        value = getattr(self, name)
        if value is None or (dev.type == self.device.type
                             and (dev.index or 0) == (self.device.index or 0)):
            return value
        key = (name, dev)
        if key not in self._per_device:
            self._per_device[key] = copy.deepcopy(value).to(dev)
        return self._per_device[key]

    # -- pipeline ------------------------------------------------------------
    def _fmllr_second_pass_feats(self, prepared, num_speakers, mark, utt_spk):
        """Pass 1 with the speaker-independent model, per-speaker fMLLR
        statistics on the device, one fetch of their sums, the host solve,
        and the adapted features (reference ``_fmllr_second_pass_feats``,
        two-pass align ``alignment/base.py:491-558``; estimation spec
        ``corpus/features.py:422-548`` with silence_weight=0). Nothing else
        leaves the device between the two passes. ``utt_spk``: each corpus
        utterance's speaker index."""
        # float64 totals on the first device, one utterance at a time in
        # corpus order (the batches are consecutive slices of it)
        stats = zero_fmllr_totals(num_speakers, self.fmllr.means.shape[2],
                                  self.device)
        for b in prepared:
            dev = b.ff.device
            fm = self._on("fmllr", dev)
            state_path, _sc = _emit_and_align(
                b.ff, b.flens_dev, b.graph, self._on("si_gmm", dev),
                self.config.acoustic_scale, band_limits=b.band_limits,
                use_emission_kernel=self.si_use_emission_kernel,
            )
            frame_pdf = b.graph.state_pdf.gather(1, state_path.long())
            accumulate_fmllr_stats(
                b.ff, b.flens, frame_pdf, utt_spk[b.utts],
                nonsilence_weight(frame_pdf, fm.sil_mask),
                fm.means, fm.inv_vars, fm.gconsts, fm.miv, num_speakers,
                totals=stats,
            )
        mark("fmllr_pass1")
        K, G, beta = stats_to_host(*stats)
        mark("fmllr_stats_fetch")
        transforms = estimate_speaker_fmllr(
            K, G, beta, min_count=self.config.fmllr_min_count
        )
        self.last_fmllr = FmllrEstimate(K, G, beta, transforms)
        mark("fmllr_solve")
        trans = torch.from_numpy(transforms)
        trans_on = {d: trans.to(d) for d in {b.ff.device for b in prepared}}
        adapted = [
            b._replace(ff=apply_per_speaker_transform(
                b.ff, b.spk_dev, trans_on[b.ff.device]))
            for b in prepared
        ]
        mark("fmllr_apply")
        return adapted

    def align_corpus(self, corpus: Corpus) -> Dict[int, UtteranceAlignment]:
        """Align every utterance; returns {utterance_id: UtteranceAlignment}.
        Host-clock seconds of each phase are left in ``last_phase_seconds``:
        dispatch times, since the device runs behind the host until the path
        fetch, unless ``sync_phases`` is set.

        With ``distributed`` under several ranks, every rank is given the
        same corpus and aligns its own speakers of it (a speaker's CMVN and
        fMLLR statistics never leave its rank, so no statistic is reduced)
        and the ranks exchange their results: every rank returns every
        utterance's alignment. ``last_shard`` holds the original ids of the
        rank's own utterances."""
        if self.mesh is None or self.mesh.world_size == 1:
            self.last_shard = [u.id for u in corpus.utterances]
            return self._align_local(corpus)
        from montreal_forced_aligner_tpu_torch.parallel.multihost import (
            host_allgather_object,
            shard_corpus,
        )

        sub, ids = shard_corpus(corpus)
        self.last_shard = ids
        local = self._align_local(sub) if ids else {}
        for new_id, old_id in enumerate(ids):
            src, dst = sub.utterances[new_id], corpus.utterances[old_id]
            dst.num_samples, dst.num_frames = src.num_samples, src.num_frames
            dst.normalized_tokens = src.normalized_tokens
        mine = {}
        for new_id, aln in local.items():
            aln.utterance_id = ids[new_id]
            mine[ids[new_id]] = aln
        results = {}
        for part in host_allgather_object(mine):
            results.update(part)
        # this rank's own objects, not their copies
        results.update(mine)
        return dict(sorted(results.items()))

    def _align_local(self, corpus: Corpus) -> Dict[int, UtteranceAlignment]:
        """``align_corpus`` on this process's devices: batches round-robin
        over ``self.devices``, per-speaker CMVN sums and fMLLR statistics
        added on the first, one utterance at a time in corpus order."""
        from montreal_forced_aligner_tpu_torch.online import alignment as online

        cfg = self.config
        dev = self.device
        transfer_mode = resolve_transfer_mode(cfg.transfer_mode,
                                              device=self.device)
        self.last_transfer_mode = transfer_mode
        phase = {}
        t_phase = time.perf_counter()

        def mark(name):
            nonlocal t_phase
            if self.sync_phases and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            phase[name] = now - t_phase
            t_phase = now

        speaker_index = corpus.speaker_index
        num_speakers = len(corpus.speakers)
        waves: List[np.ndarray] = corpus.load_audio_parallel(
            self.mfcc_config.sample_rate, num_workers=cfg.num_loader_threads
        )
        long_set = set()
        for i, (utt, w) in enumerate(zip(corpus.utterances, waves)):
            utt.num_samples = len(w)
            if self.mfcc_config.num_frames(len(w)) > online.LONG_UTTERANCE_FRAMES:
                long_set.add(i)
        mark("audio_load")

        # very long utterances align one at a time through the chunked exact
        # Viterbi, with their own CMVN (the single-utterance semantics):
        # batched, one would pad its whole batch to its length, and its
        # O(T*S) emissions and backpointers outgrow the card
        results: Dict[int, UtteranceAlignment] = {}
        for i in sorted(long_set):
            utt = corpus.utterances[i]
            utt.num_frames = self.mfcc_config.num_frames(len(waves[i]))
            aln = online.align_utterance_online(self, waves[i], utt.text,
                                                utterance_id=i)
            if utt.begin:  # segment-relative times -> file times
                for iv in list(aln.words) + list(aln.phones):
                    iv.begin += utt.begin
                    iv.end += utt.begin
            results[i] = aln
        if long_set:
            mark("long_utterances")

        order = [int(i) for i in np.argsort([len(w) for w in waves], kind="stable")
                 if int(i) not in long_set]
        batches = [
            order[i : i + cfg.batch_size] for i in range(0, len(order), cfg.batch_size)
        ]
        if not batches:
            self.last_phase_seconds = phase
            return results

        # phase A: MFCC + per-speaker CMVN sums, float64 totals on the device
        # added one utterance at a time in corpus order. All batches are
        # dispatched before anything is fetched.
        D = self.mfcc_config.num_coefficients
        spk_total = torch.zeros((num_speakers, D), dtype=torch.float64, device=dev)
        spk_count = np.zeros(num_speakers, dtype=np.float64)
        stashes = []
        for bi, batch in enumerate(batches):
            bdev = self.devices[bi % len(self.devices)]
            wave_list = [waves[i] for i in batch]
            L = _round_up(max(len(w) for w in wave_list), 16000)
            padded, lens = pad_waves_for_mfcc(wave_list, self.mfcc_config, L)
            flens = np.array(
                [self.mfcc_config.num_frames(int(n)) for n in lens], np.int32
            )
            max_frames = self.mfcc_config.num_frames(L)
            spk_idx = np.array(
                [speaker_index[corpus.utterances[i].speaker] for i in batch],
                np.int64,
            )
            flens_dev = torch.from_numpy(flens).to(bdev)
            spk_dev = torch.from_numpy(spk_idx).to(bdev)
            if transfer_mode == "features":
                feats16 = mfcc_host_batch(
                    padded, self.mfcc_config, max_frames
                ).astype(np.float16)
                feats_dev, sums = _feats_and_sums(
                    torch.from_numpy(feats16).to(bdev), flens_dev)
            else:
                feats_dev, sums = _mfcc_and_sums(
                    torch.from_numpy(padded).to(bdev),
                    flens_dev,
                    self.mfcc_config,
                    max_frames,
                )
            add_to_speakers(spk_total, sums, spk_idx)
            # frame counts accumulate on the host in float64
            np.add.at(spk_count, spk_idx, flens.astype(np.float64))
            pitch = None
            if self.use_pitch:
                from montreal_forced_aligner_tpu_torch.ops.pitch import (
                    pitch_for_mfcc_frames,
                )

                wbuf = np.zeros(
                    (len(wave_list), max(len(w) for w in wave_list)), np.float32
                )
                for r, w in enumerate(wave_list):
                    wbuf[r, : len(w)] = w
                pitch = pitch_for_mfcc_frames(
                    wbuf,
                    np.array([len(w) for w in wave_list], np.int32),
                    flens,
                    max_frames,
                    device=bdev,
                )
            stashes.append((batch, feats_dev, flens, pitch, flens_dev, spk_dev))
            for row, i in enumerate(batch):
                corpus.utterances[i].num_frames = int(flens[row])
        mark("phase_a_dispatch")

        # host graph compilation overlaps the device's phase A (the native
        # core for monophone trees, else the worker pool or this process);
        # long utterances compiled their own
        items = []
        item_utts = []
        for i, utt in enumerate(corpus.utterances):
            if i in long_set:
                continue
            tokens = self.tokenizer.tokenize(utt.text)
            utt.normalized_tokens = tokens
            key = self.speaker_dictionary_map.get(
                utt.speaker, self.default_dictionary_key
            )
            if self.g2p is not None:
                self._add_g2p_pronunciations(tokens, self.lexicons[key])
            items.append((key, tokens))
            item_utts.append(i)
        from montreal_forced_aligner_tpu_torch.graph.native_compile import (
            compile_items_native,
        )

        compiled = compile_items_native(self.compilers, items)
        if compiled is None:
            pool = self._graph_pool(len(items))
            if pool is not None:
                compiled = pool.compile_all(items)
            else:
                compiled = [self.compilers[k].compile(t) for k, t in items]
        graphs: List[Optional[CompiledGraph]] = [None] * len(corpus.utterances)
        for i, g in zip(item_utts, compiled):
            graphs[i] = g
        mark("graph_compile")

        spk_mean = cmvn_means(spk_total, torch.from_numpy(spk_count).to(dev))
        spk_mean_on = {}
        prepared = []
        for batch, feats_dev, flens, pitch, flens_dev, spk_dev in stashes:
            bdev = feats_dev.device
            if bdev not in spk_mean_on:
                spk_mean_on[bdev] = spk_mean.to(bdev)
            garrs = batch_graphs([graphs[i] for i in batch])
            graph = ship_graph_to_device(garrs, bdev)
            band_limits = band_limits_from_arcs(garrs)
            ff = _final_feats(
                feats_dev, flens_dev, spk_mean_on[bdev][spk_dev],
                self._on("gmm", bdev).lda,
                None if pitch is None else torch.from_numpy(pitch).to(bdev),
            )
            prepared.append(
                _Batch(batch, flens, garrs, graph, ff, flens_dev, band_limits, spk_dev)
            )
        mark("graph_ship_and_final_feats")

        if self.two_pass:
            utt_spk = np.array([speaker_index[u.speaker] for u in corpus.utterances])
            prepared = self._fmllr_second_pass_feats(prepared, num_speakers, mark,
                                                     utt_spk)

        pending = []
        for b in prepared:
            gmm = self._on("gmm", b.ff.device)
            state_path, scores = _emit_and_align(
                b.ff, b.flens_dev, b.graph, gmm, cfg.acoustic_scale,
                band_limits=b.band_limits,
                use_emission_kernel=self.use_emission_kernel,
            )
            conf = None
            if cfg.compute_confidence:
                conf = _phone_confidence(
                    b.ff, state_path, b.graph, gmm.W, gmm.gconsts
                )
            # halve the path bytes when state indices fit int16
            if b.graph.state_pdf.shape[1] <= 32767:
                state_path = state_path.to(torch.int16)
            pending.append((b.utts, b.flens, b.garrs, state_path, scores, conf))
        mark("emit_and_align_dispatch")

        # pad to a common T and concatenate on the device: every path (and
        # confidence) comes back in ONE device->host copy each
        Tmax = max(p[3].shape[1] for p in pending)

        def pad_cat(xs):
            return torch.cat(
                [torch.nn.functional.pad(x, (0, Tmax - x.shape[1])).to(dev)
                 for x in xs]
            ).cpu().numpy()

        all_sp = pad_cat([p[3] for p in pending])
        all_sc = torch.cat([p[4].to(dev) for p in pending]).cpu().numpy()
        all_cf = pad_cat([p[5] for p in pending]) if cfg.compute_confidence else None
        mark("path_fetch")

        phone_names = self.model.phone_names
        row0 = 0
        for batch, flens, garrs, state_path, _scores, _conf in pending:
            n, T = state_path.shape
            sp = all_sp[row0 : row0 + n, :T].astype(np.int64)
            sc = all_sc[row0 : row0 + n]
            cf = None if all_cf is None else all_cf[row0 : row0 + n]
            row0 += n
            phone_f, word_f, inst_f, _tstate_f = extract_frame_labels_host(
                garrs, sp
            )
            for row, i in enumerate(batch):
                Lf = int(flens[row])
                results[i] = frames_to_alignment(
                    corpus.utterances[i],
                    graphs[i].words,
                    phone_f[row, :Lf],
                    word_f[row, :Lf],
                    inst_f[row, :Lf],
                    float(sc[row]),
                    phone_names,
                    self.frame_shift,
                    confidence=None if cf is None else cf[row, :Lf],
                )
        mark("ctm")
        self.last_phase_seconds = phase
        _logger.debug("align phases (host clock): %s", phase)
        return results

    # -- export --------------------------------------------------------------
    def export_textgrids(
        self,
        corpus: Corpus,
        results: Dict[int, UtteranceAlignment],
        output_directory,
        include_silence: bool = False,
        output_format: str = "long_textgrid",
        include_original_text: bool = False,
    ) -> List[Path]:
        """Write one file per corpus file with word/phone tiers per speaker;
        ``output_format`` is one of long_textgrid (default), short_textgrid,
        json, csv (reference ``textgrid.py:279-560``)."""
        extensions = {
            "long_textgrid": ".TextGrid",
            "short_textgrid": ".TextGrid",
            "json": ".json",
            "csv": ".csv",
        }
        if output_format not in extensions:
            raise ValueError(f"unknown output_format: {output_format}")
        output_directory = Path(output_directory)
        output_directory.mkdir(parents=True, exist_ok=True)
        by_file: Dict[str, List[Utterance]] = {}
        for utt in corpus.utterances:
            by_file.setdefault(utt.file_name, []).append(utt)
        out_paths = []
        for file_name, utts in by_file.items():
            tg = TextGrid()
            tg.xmax = read_wave(corpus.files[file_name]).duration
            speakers = sorted({u.speaker for u in utts})
            for spk in speakers:
                words: List[Interval] = []
                phones: List[Interval] = []
                texts: List[Interval] = []
                for utt in utts:
                    if utt.speaker != spk or utt.id not in results:
                        continue
                    if include_original_text:
                        texts.append(
                            Interval(utt.begin, utt.end or tg.xmax, utt.text)
                        )
                    aln = results[utt.id]
                    for w in aln.words:
                        words.append(Interval(w.begin, w.end, w.label))
                    for p in aln.phones:
                        if not include_silence and p.label in ("sil", "sp"):
                            continue
                        phones.append(Interval(p.begin, p.end, p.label))
                prefix = "" if len(speakers) == 1 else f"{spk} - "
                tg.tiers[f"{prefix}words"] = words
                tg.tiers[f"{prefix}phones"] = phones
                if include_original_text:
                    tg.tiers[f"{prefix}utterances"] = texts
            out = output_directory / f"{file_name}{extensions[output_format]}"
            out.parent.mkdir(parents=True, exist_ok=True)
            if output_format == "json":
                tg.write_json(out)
            elif output_format == "csv":
                tg.write_csv(
                    out, default_speaker=speakers[0] if speakers else "speaker"
                )
            else:
                tg.write(out, output_format=output_format)
            out_paths.append(out)
        return out_paths


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def frames_to_alignment(
    utt: Utterance,
    graph_words: List[str],
    phones: np.ndarray,
    words: np.ndarray,
    instances: np.ndarray,
    score: float,
    phone_names: Dict[int, str],
    frame_shift: float,
    confidence: Optional[np.ndarray] = None,
) -> UtteranceAlignment:
    """Run-length encode frame labels into phone/word intervals (reference
    CTM generation, ``alignment/multiprocessing.py:1573-1741``); with
    per-frame ``confidence``, each phone gets its frames' mean."""
    L = len(phones)
    fs = frame_shift
    offset = utt.begin
    boundaries = np.flatnonzero(np.diff(instances)) + 1
    seg_starts = np.concatenate([[0], boundaries])
    seg_ends = np.concatenate([boundaries, [L]])
    phone_intervals: List[CtmInterval] = []
    word_map: Dict[int, WordCtmInterval] = {}
    for s0, s1 in zip(seg_starts, seg_ends):
        pid = int(phones[s0])
        widx = int(words[s0])
        name = phone_names.get(pid, str(pid))
        base = name
        for pos in POSITIONS:
            if base.endswith(pos):
                base = base[: -len(pos)]
                break
        iv = CtmInterval(offset + s0 * fs, offset + s1 * fs, base, phone_id=pid)
        if confidence is not None:
            iv.confidence = round(float(confidence[s0:s1].mean()), 4)
        phone_intervals.append(iv)
        if widx >= 0:
            if widx not in word_map:
                word_map[widx] = WordCtmInterval(
                    iv.begin, iv.end, graph_words[widx], [iv]
                )
            else:
                word_map[widx].end = iv.end
                word_map[widx].phones.append(iv)
    word_intervals = [word_map[k] for k in sorted(word_map)]
    return UtteranceAlignment(
        utterance_id=utt.id,
        words=word_intervals,
        phones=phone_intervals,
        log_likelihood=score,
        per_frame_log_likelihood=score / max(L, 1),
    )
