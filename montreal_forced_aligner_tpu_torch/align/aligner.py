"""Pretrained-model corpus alignment pipeline, in PyTorch on one device.

Counterpart of ``montreal_forced_aligner_tpu/align/aligner.py``
(``PretrainedAligner._align_corpus_impl``): corpus load → audio load →
phase A, MFCC plus per-speaker CMVN sums (device) → host graph compile →
graph ship → final features, CMVN then deltas or splice+LDA (device) →
graph-state emissions and band Viterbi (device: kernels K3, K1, K2) → one
fetch of every state path → CTM intervals → TextGrid export.

Utterances are bucketed by length so each batch pads little; every batch
is dispatched before any result is fetched, so host work (graph compile,
padding) overlaps the device's.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

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
    load_dictionary_argument,
)
from montreal_forced_aligner_tpu_torch.dictionary.tokenizer import SimpleTokenizer
from montreal_forced_aligner_tpu_torch.graph.compiler import (
    AlignmentGraphCompiler,
    CompiledGraph,
    batch_graphs,
    ship_graph_to_device,
)
from montreal_forced_aligner_tpu_torch.io.textgrid import Interval, TextGrid
from montreal_forced_aligner_tpu_torch.io.wav import read_wave
from montreal_forced_aligner_tpu_torch.models.acoustic_model import AcousticModel
from montreal_forced_aligner_tpu_torch.ops.cuda_emission import state_loglikes
from montreal_forced_aligner_tpu_torch.ops.feats import (
    apply_transform,
    compute_deltas,
    frame_mask,
    splice_frames,
)
from montreal_forced_aligner_tpu_torch.ops.gmm_loglikes import (
    gmm_loglikes,
    select_state_emissions,
)
from montreal_forced_aligner_tpu_torch.ops.mfcc import (
    MfccConfig,
    _mfcc_device,
    pad_waves_for_mfcc,
)
from montreal_forced_aligner_tpu_torch.ops.viterbi import (
    BatchedGraph,
    band_limits_from_arcs,
    densify_band,
    extract_frame_labels_host,
    viterbi_align_batch,
    viterbi_align_batch_band,
)
from montreal_forced_aligner_tpu_torch.params import GmmParams, gmm_params_from_numpy

POSITIONS = ("_B", "_E", "_I", "_S")

# utterances longer than this (10 min) take the chunked long-utterance path
# of the reference (online/alignment.py), which is not ported yet
LONG_UTTERANCE_FRAMES = 60000

_logger = logging.getLogger("mfa_tpu")


def _mfcc_and_spk_stats(
    padded_waves: torch.Tensor,  # (B, L) int16 or float32
    frame_lengths: torch.Tensor,  # (B,) int32
    spk_idx: torch.Tensor,  # (B,) int64 dense speaker index
    cfg: MfccConfig,
    max_frames: int,
    num_speakers: int,
):
    """Phase A: MFCC + per-speaker sums of the valid frames, reduced on the
    device with ``index_add_``: returns (feats (B, T, D), spk_sum (N, D))."""
    feats = _mfcc_device(padded_waves, cfg, max_frames)
    mask = frame_mask(frame_lengths, feats.shape[1])[..., None]
    sums = torch.where(mask, feats, 0.0).sum(dim=1)  # (B, D)
    spk_sum = torch.zeros(
        (num_speakers, feats.shape[2]), dtype=feats.dtype, device=feats.device
    )
    spk_sum.index_add_(0, spk_idx, sums)
    return feats, spk_sum


def _final_feats(feats, frame_lengths, mean_rows, lda=None):
    """CMVN-subtract, then deltas (no LDA) or splice ±3 + LDA."""
    x = feats - mean_rows[:, None, :]
    if lda is None:
        return compute_deltas(x, frame_lengths)
    return apply_transform(splice_frames(x, frame_lengths, 3, 3), lda)


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
        emit = state_loglikes(ff, graph.state_pdf, gmm.rows)
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


@dataclass
class AlignerConfig:
    """Alignment parameters (the reference package's fields; defaults from
    reference ``alignment/mixins.py:68-95``). Fields this port does not
    serve yet raise when set: see :meth:`unsupported`."""

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
    devices: Optional[tuple] = None
    distributed: Optional[bool] = None
    language: Optional[str] = None
    transfer_mode: str = "waves"
    num_loader_threads: int = 8
    num_graph_workers: int = 0

    def unsupported(self) -> List[str]:
        """Settings that name work not ported yet, with its ROADMAP item."""
        out = []
        if self.transfer_mode != "waves":
            out.append(f"transfer_mode={self.transfer_mode!r} (only 'waves' "
                       "exists on a local card)")
        if self.distributed or self.devices:
            out.append("distributed/devices: multi-GPU is ROADMAP.md Queue 1 "
                       "item 15")
        if self.num_graph_workers > 0:
            out.append("num_graph_workers > 0: ROADMAP.md Queue 1 item 16 "
                       "(host extras)")
        if self.compute_confidence:
            out.append("compute_confidence: ROADMAP.md Queue 1 item 11 "
                       "(alignment extras)")
        if self.language is not None:
            out.append("language: ROADMAP.md Queue 1 item 16 (host extras)")
        return out


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


class PretrainedAligner:
    """Aligns a corpus with a pretrained acoustic model + pronunciation
    dictionary on one device (reference entry point: ``mfa align``)."""

    def __init__(
        self,
        acoustic_model_path,
        dictionary_path,
        config: Optional[AlignerConfig] = None,
        g2p_model_path=None,
        rules_path=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.config = config or AlignerConfig()
        bad = self.config.unsupported()
        if g2p_model_path is not None:
            bad.append("g2p_model_path: ROADMAP.md Queue 1 item 16 (host extras)")
        if rules_path is not None:
            bad.append("rules_path: ROADMAP.md Queue 1 item 16 (host extras)")
        if bad:
            raise NotImplementedError("not ported yet: " + "; ".join(bad))
        self.model_path = acoustic_model_path
        self.dictionary_path = dictionary_path
        self.model = AcousticModel.load(acoustic_model_path)
        if not self.model.phone_table:
            self.model.phone_table = reconstruct_phone_table(
                self.model.meta, self.model.transition_model.topo
            )
        if (
            self.model.uses_fmllr
            and self.model.alignment_model is not None
            and self.config.uses_speaker_adaptation
        ):
            raise NotImplementedError(
                "two-pass fMLLR: next slice (ROADMAP.md Queue 1 item 9); "
                "align this SAT model with uses_speaker_adaptation=False "
                "(--single_speaker)"
            )
        self.lexicons, self.speaker_dictionary_map, default_key = (
            load_dictionary_argument(
                dictionary_path, phone_table=self.model.phone_table
            )
        )
        self.default_dictionary_key = default_key or next(iter(self.lexicons))
        self.lexicon = self.lexicons[self.default_dictionary_key]
        all_words = set()
        for lex in self.lexicons.values():
            all_words |= set(lex.words)
        self.tokenizer = SimpleTokenizer(word_set=all_words)
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
        if feat_meta.get("pitch", feat_meta.get("use_pitch", False)):
            raise NotImplementedError(
                "pitch features: ROADMAP.md Queue 1 item 11 (alignment extras)"
            )
        self.frame_shift = self.mfcc_config.frame_shift_ms / 1000.0
        # a SAT model aligns single-pass with its speaker-independent
        # final.alimdl (reference first-pass-only behaviour,
        # ``alignment/base.py:491-558``); any other model with final.mdl
        si_mode = self.model.uses_fmllr and self.model.alignment_model is not None
        self.gmm = self._ali_params_on() if si_mode else self._prepare_gmm()
        self.use_emission_kernel = _emission_kernel_eligible(
            self.gmm.num_pdfs, self.gmm.num_gauss
        )
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

    # -- pipeline ------------------------------------------------------------
    def align_corpus(self, corpus: Corpus) -> Dict[int, UtteranceAlignment]:
        """Align every utterance; returns {utterance_id: UtteranceAlignment}.
        Host-clock seconds of each phase are left in ``last_phase_seconds``:
        dispatch times, since the device runs behind the host until the path
        fetch, unless ``sync_phases`` is set."""
        cfg = self.config
        dev = self.device
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
        for i, (utt, w) in enumerate(zip(corpus.utterances, waves)):
            utt.num_samples = len(w)
            if self.mfcc_config.num_frames(len(w)) > LONG_UTTERANCE_FRAMES:
                raise NotImplementedError(
                    f"utterance {i} is longer than {LONG_UTTERANCE_FRAMES} "
                    "frames: long utterances are ROADMAP.md Queue 1 item 10"
                )
        mark("audio_load")

        order = np.argsort([len(w) for w in waves], kind="stable")
        batches = [
            [int(i) for i in order[i : i + cfg.batch_size]]
            for i in range(0, len(order), cfg.batch_size)
        ]

        # phase A: MFCC + per-speaker CMVN sums, reduced on the device. All
        # batches are dispatched before anything is fetched.
        D = self.mfcc_config.num_coefficients
        spk_total = torch.zeros((num_speakers, D), dtype=torch.float32, device=dev)
        spk_count = np.zeros(num_speakers, dtype=np.float64)
        stashes = []
        for batch in batches:
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
            flens_dev = torch.from_numpy(flens).to(dev)
            spk_dev = torch.from_numpy(spk_idx).to(dev)
            feats_dev, bsum = _mfcc_and_spk_stats(
                torch.from_numpy(padded).to(dev),
                flens_dev,
                spk_dev,
                self.mfcc_config,
                max_frames,
                num_speakers,
            )
            spk_total += bsum
            # frame counts accumulate on the host in float64
            np.add.at(spk_count, spk_idx, flens.astype(np.float64))
            stashes.append((batch, feats_dev, flens, flens_dev, spk_dev))
            for row, i in enumerate(batch):
                corpus.utterances[i].num_frames = int(flens[row])
        mark("phase_a_dispatch")

        # host graph compilation overlaps the device's phase A
        graphs: List[Optional[CompiledGraph]] = []
        for utt in corpus.utterances:
            tokens = self.tokenizer.tokenize(utt.text)
            utt.normalized_tokens = tokens
            key = self.speaker_dictionary_map.get(
                utt.speaker, self.default_dictionary_key
            )
            graphs.append(self.compilers[key].compile(tokens))
        mark("graph_compile")

        spk_mean = spk_total / torch.from_numpy(
            np.maximum(spk_count, 1.0).astype(np.float32)
        ).to(dev)[:, None]
        prepared = []
        for batch, feats_dev, flens, flens_dev, spk_dev in stashes:
            garrs = batch_graphs([graphs[i] for i in batch])
            graph = ship_graph_to_device(garrs, dev)
            band_limits = band_limits_from_arcs(garrs)
            ff = _final_feats(feats_dev, flens_dev, spk_mean[spk_dev], self.gmm.lda)
            prepared.append((batch, flens, garrs, graph, ff, flens_dev, band_limits))
        mark("graph_ship_and_final_feats")

        pending = []
        for batch, flens, garrs, graph, ff, flens_dev, band_limits in prepared:
            state_path, scores = _emit_and_align(
                ff, flens_dev, graph, self.gmm, cfg.acoustic_scale,
                band_limits=band_limits,
                use_emission_kernel=self.use_emission_kernel,
            )
            # halve the path bytes when state indices fit int16
            if graph.state_pdf.shape[1] <= 32767:
                state_path = state_path.to(torch.int16)
            pending.append((batch, flens, garrs, state_path, scores))
        mark("emit_and_align_dispatch")

        # pad to a common T and concatenate on the device: every path comes
        # back in ONE device->host copy
        results: Dict[int, UtteranceAlignment] = {}
        if pending:
            Tmax = max(sp.shape[1] for _b, _f, _g, sp, _s in pending)
            all_sp = torch.cat(
                [
                    torch.nn.functional.pad(sp, (0, Tmax - sp.shape[1]))
                    for _b, _f, _g, sp, _s in pending
                ]
            ).cpu().numpy()
            all_sc = torch.cat([sc for _b, _f, _g, _sp, sc in pending]).cpu().numpy()
        mark("path_fetch")

        phone_names = self.model.phone_names
        row0 = 0
        for batch, flens, garrs, state_path, _scores in pending:
            n = state_path.shape[0]
            sp = all_sp[row0 : row0 + n, : state_path.shape[1]].astype(np.int64)
            sc = all_sc[row0 : row0 + n]
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
) -> UtteranceAlignment:
    """Run-length encode frame labels into phone/word intervals (reference
    CTM generation, ``alignment/multiprocessing.py:1573-1741``)."""
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
