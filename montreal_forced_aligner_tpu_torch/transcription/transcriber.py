"""Speech transcription (decoding against a language model), in PyTorch.

Counterpart of ``montreal_forced_aligner_tpu/transcription/transcriber.py``
(reference ``mfa transcribe``: an HCLG decoding graph from lexicon + ARPA
LM, beam decoding, WER/CER evaluation, phone LMs). Instead of beam search
over a composed HCLG, vocabularies up to ``LVCSR_WORD_THRESHOLD`` words
decode against one dense graph (LM states x word HMM chains with optional
silence), shared by every utterance of a batch, with the alignment path's
exact Viterbi: graph-state emissions through kernel K3 when the model is
large enough (``align.aligner._emission_kernel_eligible``, as the aligner
decides), then the dense max-plus recursion, since a decoding graph fits
no band. Larger vocabularies take the backoff-junction decoders of
``lvcsr.py`` / ``lvcsr_pm.py``. SAT models decode twice: the
speaker-independent model, per-speaker fMLLR, then the final model on the
adapted features.

The pipeline: audio load -> phase A (MFCC and per-speaker CMVN sums on the
device, the aligner's ``_mfcc_and_sums``, or float16 MFCCs from the
host in the "features" transfer mode) -> decoding graph (built
once per LM) -> final features (``_final_feats``) -> [fMLLR first pass] ->
decode -> one fetch of every path -> words.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.align import aligner as _al
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
from montreal_forced_aligner_tpu_torch.data import CtmInterval
from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon
from montreal_forced_aligner_tpu_torch.graph.compiler import (
    AlignmentGraphCompiler,
    _GraphBuilder,
    batch_graphs,
    ship_graph_to_device,
)
from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
    ArpaModel,
    train_lm_from_texts,
)
from montreal_forced_aligner_tpu_torch.ops.feats import (
    add_to_speakers,
    apply_per_speaker_transform,
    cmvn_means,
    nonsilence_weight,
)
from montreal_forced_aligner_tpu_torch.ops.gmm_loglikes import (
    gmm_loglikes,
    select_state_emissions,
)
from montreal_forced_aligner_tpu_torch.ops.mfcc import (
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
    NEG_INF,
    extract_frame_labels_host,
    nbest_backtrace_host,
    nbest_word_events,
    viterbi_nbest_device,
)

logger = logging.getLogger("mfa_tpu")

LN10 = math.log(10.0)


def _lvcsr_emissions(ff: torch.Tensor, gmm, acoustic_scale: float) -> torch.Tensor:
    """(B, T, P) pre-scaled per-pdf emissions of the LVCSR decoders: all
    pdfs (the decoders gather each frame's states from these);
    ``gmm_loglikes`` bounds its (frames, P*G) intermediate by tiles."""
    return gmm_loglikes(ff, gmm.W, gmm.gconsts).mul_(acoustic_scale)


def _state_emissions(ff, state_pdf, gmm, use_emission_kernel: bool):
    """Graph-state emissions (B, T, S) by the aligner's emission rule: K3
    when ``use_emission_kernel``, else all pdfs and a gather."""
    if use_emission_kernel:
        return _al.state_loglikes(ff, state_pdf, gmm.rows, gmm.rows_split)
    return select_state_emissions(gmm_loglikes(ff, gmm.W, gmm.gconsts), state_pdf)


def _emit_and_nbest(ff, frame_lengths, graph, gmm, use_emission_kernel,
                    acoustic_scale, K, word_event, state0_hash):
    """Emissions by the 1-best path's rule, then the determinized K-best
    Viterbi (the N-best counterpart of ``aligner._emit_and_align``)."""
    emit = _state_emissions(ff, graph.state_pdf, gmm, use_emission_kernel)
    return viterbi_nbest_device(
        emit, frame_lengths, graph, acoustic_scale=acoustic_scale, K=K,
        word_event=word_event, state0_hash=state0_hash,
    )


@dataclass
class TranscriptionResult:
    utterance_id: int
    text: str
    words: List[CtmInterval]
    log_likelihood: float
    # N-best alternatives (text, total path score), best first, when
    # decoding with nbest > 1
    alternatives: Optional[List[Tuple[str, float]]] = None
    # True when the LVCSR graph fell back from cross-word to word-internal
    # context at build time; None on dense decodes
    cross_word_fallback: Optional[bool] = None


class _TBatch(NamedTuple):
    """One batch on its way through the decode."""

    utts: List[int]  # corpus utterance indices, one per row
    flens: np.ndarray  # (B,) int32 frame counts
    garrs: Optional[dict]  # the shared graph batched (host); None for LVCSR
    graph: Optional[object]  # the same on the device
    ff: torch.Tensor  # (B, T, D) final (or adapted) features
    flens_dev: torch.Tensor
    spk_dev: torch.Tensor  # (B,) int64 speaker index


class DecodingGraphCompiler:
    """Builds a shared dense decoding graph: a bigram LM over the
    vocabulary with per-word HMM chains and optional silence at word
    boundaries (the reference's HCLG composition as a dense state lattice).

    Context-dependent models are exact: word HMMs are expanded per distinct
    cross-word left/right context through the alignment compiler's
    pdf-tuple-merged branches, and word-to-word arcs connect only
    context-consistent branch pairs. Optional inter-word silence gets one
    contexted copy per (source word, final phone)."""

    EPS = 0

    def __init__(
        self,
        align_compiler: AlignmentGraphCompiler,
        lexicon: Lexicon,
        lm: ArpaModel,
        lm_scale: float = 1.0,
        max_states: int = 12000,
        word_insertion_penalty: float = 0.0,
    ):
        self.compiler = align_compiler
        self.lexicon = lexicon
        self.lm = lm
        self.lm_scale = lm_scale
        self.max_states = max_states
        self.word_insertion_penalty = word_insertion_penalty

    def build(self):
        lex = self.lexicon
        lm = self.lm
        g = _GraphBuilder()
        comp = self.compiler
        EPS = self.EPS
        sil = lex.phone_id(lex.silence_phone, None)
        vocab = [w for w in lm.vocab if w in lex.words]
        if not vocab:
            raise ValueError("no LM words found in the lexicon")

        # pronunciations and cross-word context inventories
        prons: Dict[int, List[Tuple[List[int], float, float]]] = {}
        first_phones, last_phones = set(), set()
        for w_idx, word in enumerate(vocab):
            rows = []
            for pron in lex.words[word]:
                if lex.position_dependent:
                    pids = lex.pronunciation_phone_ids(pron.phones)
                else:
                    pids = [lex.phone_id(p, None) for p in pron.phones]
                prob = pron.probability if pron.probability is not None else 1.0
                pron_lp = (
                    math.log(max(min(prob, 1.0), 1e-5))
                    - self.word_insertion_penalty
                )
                p_sil = (
                    pron.silence_after_probability
                    if pron.silence_after_probability is not None
                    else lex.silence_probability
                )
                rows.append((pids, pron_lp, p_sil))
                first_phones.add(pids[0])
                last_phones.add(pids[-1])
            prons[w_idx] = rows
        left_all = sorted({EPS, sil} | last_phones)
        right_all = sorted({EPS, sil} | first_phones)

        # word branches: (branch, pron_lp, p_sil, first, last) per context
        word_branches: Dict[int, List[Tuple[dict, float, float, int, int]]] = {}
        for w_idx in range(len(vocab)):
            rows = []
            for pids, pron_lp, p_sil in prons[w_idx]:
                for br in comp._expand_variant(
                    g, pids, w_idx, left_all, right_all
                ):
                    rows.append((br, pron_lp, p_sil, pids[0], pids[-1]))
            word_branches[w_idx] = rows
            if len(g.state_pdf) > self.max_states:
                raise ValueError(
                    f"decoding graph exceeds {self.max_states} states; "
                    "vocabulary too large for dense decode"
                )

        # optional-silence copies per (source word, final phone): they keep
        # the LM word history through silence and the silence's context
        sil_rights = sorted({EPS} | first_phones)
        sil_copies: Dict[Tuple[int, int], list] = {}
        for u_idx in range(len(vocab)):
            for last in {r[4] for r in word_branches[u_idx]}:
                sil_copies[(u_idx, last)] = comp._expand_single(
                    g, sil, -1, last, sil_rights
                )
        init_sil = comp._expand_single(g, sil, -1, EPS, sorted(first_phones))

        def entries_for(v_idx: int, left_ctx: int, first_allowed):
            """Entries of word v's branches compatible with the left context
            and (optionally) a right-set constraint on the first phone."""
            for br, pron_lp, _ps, first, _last in word_branches[v_idx]:
                if left_ctx not in br["lset"]:
                    continue
                if first_allowed is not None and first not in first_allowed:
                    continue
                yield br["entry"], pron_lp

        start_lp = math.log(1.0 - lex.initial_silence_probability)
        for rs, sentry, _sexits in init_sil:
            g.add_start(sentry, math.log(lex.initial_silence_probability))
        for v_idx, v in enumerate(vocab):
            lm_lp = self.lm_scale * lm.log_prob(v, ("<s>",)) * LN10
            for entry, pron_lp in entries_for(v_idx, EPS, None):
                g.add_start(entry, start_lp + lm_lp + pron_lp)
            for rs, _sentry, sexits in init_sil:
                for entry, pron_lp in entries_for(v_idx, sil, rs):
                    for s, wgt, tid in sexits:
                        g.add_arc(
                            s, entry, wgt + lm_lp + pron_lp, tid, event=v_idx
                        )

        # word-to-word, word-to-silence and finals
        for u_idx, u in enumerate(vocab):
            eos_lp = self.lm_scale * lm.log_prob("</s>", (u,)) * LN10
            lm_cache = {
                v_idx: self.lm_scale * lm.log_prob(v, (u,)) * LN10
                for v_idx, v in enumerate(vocab)
            }
            for br, _plp, p_sil, _first, last in word_branches[u_idx]:
                rset = br["rset"]
                skip_lp = math.log(max(1.0 - p_sil, 1e-5))
                sil_lp = math.log(max(p_sil, 1e-5))
                for s, wgt, tid in br["exits"]:
                    if EPS in rset:
                        g.add_final(s, wgt + skip_lp + eos_lp, tid)
                    if sil in rset:
                        for _rs, sentry, _se in sil_copies[(u_idx, last)]:
                            g.add_arc(s, sentry, wgt + sil_lp, tid)
                    for v_idx in range(len(vocab)):
                        for entry, pron_lp in entries_for(v_idx, last, rset):
                            g.add_arc(
                                s,
                                entry,
                                wgt + skip_lp + lm_cache[v_idx] + pron_lp,
                                tid,
                                event=v_idx,
                            )
            # out of this word's silence copies
            for (su_idx, last), groups in sil_copies.items():
                if su_idx != u_idx:
                    continue
                for rs, _sentry, sexits in groups:
                    for s, wgt, tid in sexits:
                        if EPS in rs:
                            g.add_final(s, wgt + eos_lp, tid)
                        for v_idx in range(len(vocab)):
                            for entry, pron_lp in entries_for(v_idx, sil, rs):
                                g.add_arc(
                                    s,
                                    entry,
                                    wgt + lm_cache[v_idx] + pron_lp,
                                    tid,
                                    event=v_idx,
                                )

        graph = g.finish(vocab)
        return graph, vocab


class Transcriber:
    """Transcribe a corpus with an acoustic model and an LM (reference
    entry point: ``mfa transcribe``). ``device`` is ``"cuda"`` by default
    and raises without a card; pass ``"cpu"`` for the plain versions."""

    # above this vocabulary size the dense graph's O(V^2) LM wiring loses to
    # the backoff-junction decoder
    LVCSR_WORD_THRESHOLD = 150

    # device record budget of one LVCSR decode; rows beyond it split into
    # sub-batches. None = ``lvcsr._REC_BUDGET`` (MFA_TPU_LVCSR_REC_BYTES),
    # which also gates the cross-word build
    LVCSR_REC_BYTES: Optional[float] = None

    # record itemsizes of the K-best decoders (the split estimates)
    _I16, _I32, _F32 = 2, 4, 4

    def __init__(
        self,
        acoustic_model_path,
        dictionary_path,
        lm: Optional[ArpaModel] = None,
        lm_order: int = 3,
        acoustic_scale: float = 1.0 / 12,
        batch_size: int = 16,
        lm_scale: float = 1.0,
        word_insertion_penalty: float = 0.0,
        device="cuda",
    ):
        """``lm_scale`` and ``word_insertion_penalty`` are the reference's
        ``--language_model_weight`` / ``--word_insertion_penalties``; the
        penalty is charged per word entry in natural-log space."""
        self.aligner = _al.PretrainedAligner(
            acoustic_model_path,
            dictionary_path,
            _al.AlignerConfig(batch_size=batch_size, acoustic_scale=acoustic_scale),
            device=device,
        )
        self.device = self.aligner.device
        self.lm = lm
        self.lm_order = lm_order
        self.acoustic_scale = acoustic_scale
        self.lm_scale = lm_scale
        self.word_insertion_penalty = word_insertion_penalty
        self._reset_graph()
        # host-clock seconds of each phase of the last transcribe_corpus;
        # with sync_phases the card is synchronised at every mark
        self.last_phase_seconds: Dict[str, float] = {}
        self.sync_phases = False
        self.last_fmllr: Optional[FmllrEstimate] = None
        # the 1-best state path (frames of the utterance) of each utterance
        # of the last 1-best transcribe_corpus
        self.last_state_paths: Dict[int, np.ndarray] = {}
        # what the last transcribe_corpus's phase A shipped (waves, features)
        self.last_transfer_mode: Optional[str] = None

    def _reset_graph(self):
        self._graph = None
        self._vocab = None
        self._lvcsr = None
        self._lvcsr_legacy = None
        self._lvcsr_dev_cache = {}
        self._graph_device_cache = {}
        # the utterance length (frames) the cross-word gate was run for
        self._gate_frames: Optional[int] = None

    def train_lm_from_corpus(self, corpus: Corpus) -> ArpaModel:
        texts = []
        for utt in corpus.utterances:
            tokens = self.aligner.tokenizer.tokenize(utt.text)
            texts.append(" ".join(tokens))
        if not any(texts):
            from montreal_forced_aligner_tpu_torch.exceptions import (
                LanguageModelError,
            )

            raise LanguageModelError(
                "The corpus carries no transcripts to train a decoding "
                "language model from (untranscribed corpora load with "
                "empty-text utterances for transcription workflows). "
                "Pass --language_model_path with a trained LM (ARPA or "
                "MFA LanguageModel zip)."
            )
        self.lm, _counter = train_lm_from_texts(texts, order=self.lm_order)
        return self.lm

    def _ensure_graph(self, nominal_frames: Optional[int] = None):
        """Build the decoding graph once per LM. A cross-word LVCSR graph
        gated for shorter utterances than ``nominal_frames`` is rebuilt, so
        the gate runs again for the longer ones (the JAX package keeps the
        stale graph)."""
        frames = nominal_frames or 3000
        if (isinstance(self._lvcsr, _lvcsr_mod().LvcsrXwGraph)
                and self._gate_frames is not None and frames > self._gate_frames):
            logger.info("re-gating the cross-word LVCSR graph for %d frames "
                        "(built for %d)", frames, self._gate_frames)
            self._reset_graph()
        if self._graph is None and self._lvcsr is None:
            vocab_size = sum(
                1 for w in self.lm.vocab if w in self.aligner.lexicon.words
            )
            try:
                if vocab_size > self.LVCSR_WORD_THRESHOLD:
                    raise ValueError("vocabulary too large for dense decode")
                builder = DecodingGraphCompiler(
                    self.aligner.compiler, self.aligner.lexicon, self.lm,
                    lm_scale=self.lm_scale,
                    word_insertion_penalty=self.word_insertion_penalty,
                )
                self._graph, self._vocab = builder.build()
                logger.info(
                    "decoding graph: %d states over %d words (exact dense)",
                    self._graph.num_states, len(self._vocab),
                )
            except ValueError:
                # too large for the dense graph: the backoff-junction decoder
                self._lvcsr = _lvcsr_mod().LvcsrGraphCompiler(
                    self.aligner.compiler, self.aligner.lexicon, self.lm,
                    lm_scale=self.lm_scale,
                    word_insertion_penalty=self.word_insertion_penalty,
                    nominal_frames=nominal_frames,
                ).build()
                self._gate_frames = frames
                self._vocab = self._lvcsr.words
                logger.info(
                    "LVCSR decoding graph: %d states over %d words",
                    self._lvcsr.num_states, len(self._vocab),
                )
        return self._graph

    @property
    def cross_word_fallback(self) -> bool:
        """True when a cross-word LVCSR build fell back to word-internal
        context (also on each result)."""
        return bool(getattr(self._lvcsr, "cross_word_fallback", False))

    def _shared_graph_on_device(self, graph, B: int):
        """The decoding graph batched to B rows and shipped once per row
        count, reused across batches and calls (validated by identity)."""
        if graph is None:
            return None, None
        hit = self._graph_device_cache.get(B)
        if hit is None or hit[0] is not graph:
            garrs = batch_graphs([graph] * B)
            hit = self._graph_device_cache[B] = (
                graph, garrs, ship_graph_to_device(garrs, self.device))
        return hit[1], hit[2]

    # -- the pipeline ---------------------------------------------------------
    def transcribe_corpus(
        self,
        corpus: Corpus,
        nbest: int = 1,
        rescore_lm: Optional[ArpaModel] = None,
        rescore_weight: float = 1.0,
    ) -> Dict[int, TranscriptionResult]:
        """Decode every utterance against the shared graph. With ``nbest >
        1`` the K-best Viterbi gives rank-ordered distinct hypotheses (the
        reference's lattice); ``rescore_lm`` replaces the decoding LM's
        contribution on each with the bigger model's and re-ranks (the
        reference's ConstArpaLm lattice rescoring)."""
        if not corpus.utterances:
            return {}
        al = self.aligner
        if al.use_pitch:
            raise NotImplementedError(
                "transcription with a pitch model: the JAX package's "
                "transcriber has no pitch features either")
        dev = self.device
        phase: Dict[str, float] = {}
        t_phase = time.perf_counter()

        def mark(name):
            nonlocal t_phase
            if self.sync_phases and dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            phase[name] = now - t_phase
            t_phase = now

        if self.lm is None:
            self.train_lm_from_corpus(corpus)
        self.last_state_paths = {}
        cfg = al.mfcc_config
        waves = corpus.load_audio_parallel(
            cfg.sample_rate, num_workers=al.config.num_loader_threads
        )
        for utt, w in zip(corpus.utterances, waves):
            utt.num_samples = len(w)
        mark("audio_load")
        # the corpus's longest utterance gates the cross-word LVCSR build
        graph = self._ensure_graph(
            nominal_frames=cfg.num_frames(max(len(w) for w in waves)))
        mark("decoding_graph")
        speaker_index = corpus.speaker_index
        num_speakers = len(corpus.speakers)
        order = np.argsort([len(w) for w in waves], kind="stable")
        batches = [
            [int(i) for i in order[i : i + al.config.batch_size]]
            for i in range(0, len(order), al.config.batch_size)
        ]

        # phase A: MFCC and per-speaker CMVN sums on the device (or float16
        # MFCCs from the host in the "features" transfer mode), every batch
        # dispatched before anything is fetched
        transfer_mode = _al.resolve_transfer_mode(al.config.transfer_mode,
                                                  device=dev)
        self.last_transfer_mode = transfer_mode
        D = cfg.num_coefficients
        spk_total = torch.zeros((num_speakers, D), dtype=torch.float64, device=dev)
        spk_count = np.zeros(num_speakers, dtype=np.float64)
        stashes = []
        for batch in batches:
            wave_list = [waves[i] for i in batch]
            L = _al._round_up(max(len(w) for w in wave_list), 16000)
            padded, lens = pad_waves_for_mfcc(wave_list, cfg, L)
            flens = np.array([cfg.num_frames(int(n)) for n in lens], np.int32)
            spk_idx = np.array(
                [speaker_index[corpus.utterances[i].speaker] for i in batch],
                np.int64,
            )
            flens_dev = torch.from_numpy(flens).to(dev)
            spk_dev = torch.from_numpy(spk_idx).to(dev)
            if transfer_mode == "features":
                feats16 = mfcc_host_batch(padded, cfg, cfg.num_frames(L)).astype(
                    np.float16)
                feats, sums = _al._feats_and_sums(
                    torch.from_numpy(feats16).to(dev), flens_dev)
            else:
                feats, sums = _al._mfcc_and_sums(
                    torch.from_numpy(padded).to(dev), flens_dev, cfg,
                    cfg.num_frames(L),
                )
            add_to_speakers(spk_total, sums, spk_idx)
            np.add.at(spk_count, spk_idx, flens.astype(np.float64))
            stashes.append((batch, flens, feats, flens_dev, spk_dev))
        mark("phase_a_dispatch")
        spk_mean = cmvn_means(spk_total, torch.from_numpy(spk_count).to(dev))
        prepared = []
        for batch, flens, feats, flens_dev, spk_dev in stashes:
            ff = _al._final_feats(feats, flens_dev, spk_mean[spk_dev], al.gmm.lda)
            garrs, bgraph = self._shared_graph_on_device(graph, len(batch))
            prepared.append(
                _TBatch(batch, flens, garrs, bgraph, ff, flens_dev, spk_dev))
        mark("graph_ship_and_final_feats")

        if self._lvcsr is not None:
            # split before the fMLLR first pass too: its LVCSR decode holds
            # the same records as the final decode
            prepared = self._lvcsr_split_rows(prepared, nbest)
        if al.two_pass:
            utt_spk = np.array([speaker_index[u.speaker] for u in corpus.utterances])
            prepared = self._fmllr_decode_feats(prepared, num_speakers, mark,
                                                utt_spk)
        if self._lvcsr is not None:
            results = self._transcribe_prepared_lvcsr(
                prepared, corpus, al.frame_shift, nbest, rescore_lm,
                rescore_weight, mark,
            )
        else:
            results = self._transcribe_prepared_dense(
                prepared, corpus, al.frame_shift, nbest, rescore_lm,
                rescore_weight, mark,
            )
        self.last_phase_seconds = phase
        logger.debug("transcribe phases (host clock): %s", phase)
        return results

    def _transcribe_prepared_dense(self, prepared, corpus, fs, nbest,
                                   rescore_lm, rescore_weight, mark):
        al = self.aligner
        results: Dict[int, TranscriptionResult] = {}
        pending = []
        if nbest <= 1:
            for b in prepared:
                state_path, scores = _al._emit_and_align(
                    b.ff, b.flens_dev, b.graph, al.gmm, self.acoustic_scale,
                    use_emission_kernel=al.use_emission_kernel,
                )
                if b.graph.state_pdf.shape[1] <= 32767:
                    state_path = state_path.to(torch.int16)
                pending.append((state_path, scores))
            mark("decode_dispatch")
            # one device->host copy of every path
            Tmax = max(sp.shape[1] for sp, _s in pending)
            all_sp = torch.cat([
                torch.nn.functional.pad(sp, (0, Tmax - sp.shape[1]))
                for sp, _s in pending
            ]).cpu().numpy().astype(np.int64)
            all_scores = torch.cat([s for _sp, s in pending]).cpu().numpy()
            mark("path_fetch")
        r0 = 0
        for bi, b in enumerate(prepared):
            garrs, flens = b.garrs, b.flens
            if nbest <= 1:
                n, T = pending[bi][0].shape
                sp = all_sp[r0 : r0 + n, :T][:, None]  # (B, 1, T)
                scores_h = all_scores[r0 : r0 + n][:, None]
                r0 += n
                _ph1, wf1, if1, _ts1 = extract_frame_labels_host(garrs, sp[:, 0])
                rank_labels = [(wf1, if1)]
                events_h = self._path_events_1best(garrs, sp[:, 0], wf1, if1)[
                    :, None
                ]
            else:
                word_event, state0_hash = nbest_word_events(garrs)
                fscores, bps = _emit_and_nbest(
                    b.ff, b.flens_dev, b.graph, al.gmm, al.use_emission_kernel,
                    self.acoustic_scale, nbest,
                    torch.from_numpy(word_event).to(self.device),
                    torch.from_numpy(state0_hash.astype(np.int64)).to(self.device),
                )
                # backpointers are arc_slot * K + rank: int16 when they fit
                if garrs["in_src"].shape[2] * nbest <= 32767:
                    bps = bps.to(torch.int16)
                sp, scores_h, events_h = nbest_backtrace_host(
                    garrs, fscores.cpu().numpy(), bps.cpu().numpy(), flens, nbest
                )
                rank_labels = [
                    extract_frame_labels_host(garrs, sp[:, r])[1:3]
                    for r in range(sp.shape[1])
                ]
            for row, i in enumerate(b.utts):
                utt = corpus.utterances[i]
                Lf = int(flens[row])
                if nbest <= 1:
                    self.last_state_paths[i] = sp[row, 0, :Lf]
                # hypotheses per rank, deduplicated by word sequence
                hyps: List[Tuple[str, float, List[CtmInterval]]] = []
                seen = set()
                for r in range(sp.shape[1]):
                    if scores_h[row, r] <= -1e29:
                        continue
                    word_f, inst_f = rank_labels[r]
                    ev_row = events_h[row, r, :Lf]
                    if nbest > 1 and "in_event" not in garrs:
                        ev_row = self._events_from_instances(
                            word_f[row, :Lf], inst_f[row, :Lf]
                        )
                    words = self._decode_words(
                        word_f[row, :Lf], ev_row, utt.begin, fs
                    )
                    text = " ".join(w.label for w in words)
                    if text in seen:
                        continue
                    seen.add(text)
                    hyps.append((text, float(scores_h[row, r]), words))
                if rescore_lm is not None and len(hyps) > 1:
                    hyps = self._rescore_hypotheses(hyps, rescore_lm, rescore_weight)
                if not hyps:
                    hyps = [("", float(scores_h[row, 0]), [])]
                best_text, best_score, best_words = hyps[0]
                results[i] = TranscriptionResult(
                    utterance_id=i,
                    text=best_text,
                    words=best_words,
                    log_likelihood=best_score,
                    alternatives=[(t, s) for t, s, _w in hyps]
                    if sp.shape[1] > 1
                    else None,
                )
        mark("words" if nbest <= 1 else "nbest_decode_and_words")
        return results

    # -- LVCSR ---------------------------------------------------------------
    def _rec_budget(self) -> float:
        if self.LVCSR_REC_BYTES is not None:
            return float(self.LVCSR_REC_BYTES)
        return float(_lvcsr_mod()._REC_BUDGET)

    def _lvcsr_rec_bytes_per_row(self, T: int, nbest: int = 1) -> int:
        """Device bytes of one batch row's decode at T frames: records,
        checkpoints and the resident pdf emissions. The cross-word 1-best
        estimate is ``lvcsr.xw_ckpt_bytes_per_row``, the build gate's own
        (the JAX package's split leaves out its per-chunk transient
        records)."""
        lv = _lvcsr_mod()
        from montreal_forced_aligner_tpu_torch.transcription.lvcsr_pm import (
            _PM_TC,
            LvcsrPmGraph,
        )

        g = self._lvcsr_graph_for(nbest)
        K = max(1, nbest)
        P_pdf = int(np.max(np.asarray(g.state_pdf))) + 1
        emit = self._F32 * P_pdf
        emit2 = 2 * self._F32 * P_pdf
        if isinstance(g, LvcsrPmGraph):
            # one float32 alpha checkpoint per _PM_TC frames over the grid
            return T * ((self._F32 * g.Pmax * g.C) // _PM_TC + emit)
        S = int(g.num_states)
        if isinstance(g, lv.LvcsrXwGraph):
            Ne = len(g.entry_state)
            Nc = g.cell_exit_idx.shape[0]
            RG, F = g.rg_mask.shape
            if K > 1:
                # cand_sel i16 (S,K), ent_sel i32 (Ne,K), bo2_sel i32
                # (P*RG,K), exit_sel i32 (Nc,K) a frame
                return T * (K * (self._I16 * S + self._I32 * Ne
                                 + self._I32 * g.num_p * RG + self._I32 * Nc)
                            + emit2)
            return lv.xw_ckpt_bytes_per_row(S, Ne, Nc, P_pdf, g.num_p, F, RG, T)
        U = g.exit_idx.shape[0]
        V = g.p1.shape[0]
        if K == 1:
            # the checkpointed chain-major decode (the JAX package's route
            # for a plain graph, which LvcsrGraphCompiler.build never
            # returns): one float32 alpha checkpoint per _EMIT_TC frames,
            # the junction records (ent_src i32 (V), exit_arg u8 (U),
            # bo_arg i32) a frame and the resident pdf emissions its
            # backtrace recomputes from
            return T * ((self._F32 * S) // lv._EMIT_TC + self._I32 * V + U
                        + self._I32 + emit)
        # cand_sel i16 (S,K), ent_sel i32 (V,K), bo_sel i32 (K,), exit_sel
        # i16 (U,K) a frame
        return T * (K * (self._I16 * S + self._I32 * V + self._I32
                         + self._I16 * U) + emit2)

    def _lvcsr_split_rows(self, prepared, nbest: int = 1):
        """Split prepared batches into row chunks whose device decode
        records fit :meth:`_rec_budget`. The split changes no result."""
        out = []
        budget = self._rec_budget()
        for b in prepared:
            T = int(b.ff.shape[1])
            per_row = self._lvcsr_rec_bytes_per_row(T, nbest)
            max_rows = max(1, int(budget // max(per_row, 1)))
            if max_rows == 1 and per_row > budget:
                logger.warning(
                    "one LVCSR decode row needs %.1f GB of records (T=%d), "
                    "over the %.1f GB budget even unsplit; segment long audio "
                    "first or raise MFA_TPU_LVCSR_REC_BYTES.",
                    per_row / 1e9, T, budget / 1e9,
                )
            if len(b.utts) <= max_rows:
                out.append(b)
                continue
            logger.info(
                "LVCSR records would need %.1f GB at B=%d; splitting into "
                "chunks of %d rows", per_row * len(b.utts) / 1e9,
                len(b.utts), max_rows,
            )
            for i in range(0, len(b.utts), max_rows):
                sl = slice(i, i + max_rows)
                out.append(_TBatch(b.utts[sl], b.flens[sl], b.garrs, b.graph,
                                   b.ff[sl], b.flens_dev[sl], b.spk_dev[sl]))
        return out

    def _lvcsr_graph_for(self, nbest: int = 1):
        """The graph a decode with this ``nbest`` runs on: the production
        graph for 1-best; for K-best on a position-major graph, the
        chain-major one, built lazily."""
        from montreal_forced_aligner_tpu_torch.transcription.lvcsr_pm import (
            LvcsrPmGraph,
        )

        g = self._lvcsr
        if nbest > 1 and isinstance(g, LvcsrPmGraph):
            return self._legacy_flat_graph()
        return g

    def _legacy_flat_graph(self):
        """The chain-major word-internal graph of the K-best junction,
        built once."""
        if self._lvcsr_legacy is None:
            self._lvcsr_legacy = _lvcsr_mod().LvcsrGraphCompiler(
                self.aligner.compiler, self.aligner.lexicon, self.lm,
                lm_scale=self.lm_scale,
                word_insertion_penalty=self.word_insertion_penalty,
                cross_word=False,
            ).build_word_internal_legacy()
        return self._lvcsr_legacy

    def _lvcsr_dev(self, g=None):
        """The LVCSR graph's tensors on the device, shipped once per graph
        (validated by identity)."""
        from montreal_forced_aligner_tpu_torch.transcription.lvcsr_pm import (
            PM_DEVICE_NAMES,
            LvcsrPmGraph,
        )

        lv = _lvcsr_mod()
        if g is None:
            g = self._lvcsr
        hit = self._lvcsr_dev_cache.get(id(g))
        if hit is not None and hit[0] is g:
            return hit[1]
        if isinstance(g, LvcsrPmGraph):
            names = PM_DEVICE_NAMES
        elif isinstance(g, lv.LvcsrXwGraph):
            names = lv.XW_DEVICE_NAMES
        else:
            names = (
                "state_pdf", "band", "start", "exit_idx", "exit_w",
                "entry_idx", "entry_word", "entry_w", "p1", "bo", "big_pred",
                "big_w", "eos", "entry_slot_of_state", "state_word",
                "state0_hash",
            )
        dev = lv.graph_tensors(g, names, self.device)
        self._lvcsr_dev_cache[id(g)] = (g, dev)
        return dev

    def _lvcsr_decode_device(self, ff, flens_dev, gmm):
        """The forward pass of one batch: (kind, alpha_T, ckpts, ep), ``ep``
        the chunked emissions (a chain-major graph's: its junction records
        and the emissions)."""
        from montreal_forced_aligner_tpu_torch.transcription import lvcsr_pm as pm

        lv = _lvcsr_mod()
        g = self._lvcsr
        d = self._lvcsr_dev()
        emit_pdf = _lvcsr_emissions(ff, gmm, self.acoustic_scale)
        if isinstance(g, pm.LvcsrPmGraph):
            # chunk once and drop emit_pdf: one emission copy stays resident
            e0, ep = lv.split_emissions(emit_pdf, pm._PM_TC)
            del emit_pdf
            alpha_T, ckpts = pm.lvcsr_pm_decode_ckpt_device(
                e0, ep, d, flens_dev, g.lbp, g.ubp)
            return ("pm_ckpt", alpha_T, ckpts, ep)
        if isinstance(g, lv.LvcsrXwGraph):
            e0, ep = lv.split_emissions(emit_pdf, lv._XW_TC)
            del emit_pdf
            alpha_T, ckpts = lv.lvcsr_xw_decode_ckpt_device(
                e0, ep, d, flens_dev, g.lb, g.ub, g.num_p)
            return ("xw_ckpt", alpha_T, ckpts, ep)
        # a plain chain-major graph (the JAX package's route; no graph that
        # LvcsrGraphCompiler.build returns takes it): the checkpointed
        # chain-major pair, which keeps the junction records and recomputes
        # from emit_pdf
        alpha_T, ckpts, recs = lv.lvcsr_decode_ckpt_device(
            emit_pdf, d["state_pdf"], flens_dev, d["band"], d["start"],
            d["exit_idx"], d["exit_w"], d["entry_idx"], d["entry_word"],
            d["entry_w"], d["p1"], d["bo"], d["big_pred"], d["big_w"],
            g.lb, g.ub, cache=d)
        return ("flat_ckpt", alpha_T, ckpts, (recs, emit_pdf))

    def _lvcsr_backtrace_device_dispatch(self, handle, flens_dev, T: int):
        """The backtrace of a forward pass: device (path (B, T), word_at
        (B, T), score (B,)). ``T`` cuts the emission chunks' padding."""
        from montreal_forced_aligner_tpu_torch.transcription import lvcsr_pm as pm

        kind, alpha_T, ckpts, ep = handle
        g = self._lvcsr
        d = self._lvcsr_dev()
        if kind == "pm_ckpt":
            return pm.lvcsr_pm_backtrace_ckpt_device(
                alpha_T, ckpts, ep, d, flens_dev, g.lbp, g.ubp, T)
        if kind == "xw_ckpt":
            return _lvcsr_mod().lvcsr_xw_backtrace_ckpt_device(
                alpha_T, ckpts, ep, d, flens_dev, g.lb, g.ub, g.num_p, T)
        recs, emit_pdf = ep
        return _lvcsr_mod().lvcsr_backtrace_ckpt_device(
            alpha_T, ckpts, recs, emit_pdf, d["state_pdf"], flens_dev,
            d["band"], d["exit_idx"], d["exit_w"], d["eos"], d["entry_idx"],
            d["entry_word"], d["entry_w"], d["p1"], d["bo"], d["big_pred"],
            d["big_w"], d["entry_slot_of_state"], d["state_word"], g.lb, g.ub,
            T, cache=d)

    @staticmethod
    def _lvcsr_rows(bt, flens):
        """Host rows [(path (T,), score, events)] from a device backtrace;
        events are the ascending (frame, word) junction crossings."""
        path_h, word_h, score_h = (x.cpu().numpy() for x in bt)
        rows = []
        for b in range(path_h.shape[0]):
            L = int(flens[b])
            wrow = word_h[b, :L]
            events = [(int(t), int(w)) for t, w in enumerate(wrow) if w >= 0]
            rows.append((path_h[b], float(score_h[b]), events))
        return rows

    def _lvcsr_decode(self, b: _TBatch, gmm):
        """Decode one batch to host rows [(path, score, events)]."""
        handle = self._lvcsr_decode_device(b.ff, b.flens_dev, gmm)
        return self._lvcsr_rows(
            self._lvcsr_backtrace_device_dispatch(
                handle, b.flens_dev, int(b.ff.shape[1])),
            b.flens,
        )

    def _lvcsr_nbest_decode(self, b: _TBatch, gmm, nbest):
        """K-best junction decode of one batch: per-row hypothesis lists
        [(path, score, events)], best first, and the graph they index."""
        lv = _lvcsr_mod()
        g = self._lvcsr_graph_for(nbest)
        d = self._lvcsr_dev(g)
        T = int(b.ff.shape[1])
        emit_pdf = _lvcsr_emissions(b.ff, gmm, self.acoustic_scale)
        if isinstance(g, lv.LvcsrXwGraph):
            ka = {k: torch.from_numpy(v).to(self.device)
                  for k, v in g.kbest_arrays().items()}
            ka["seg_cells"] = ka["seg_cells"].long()
            ka["ebo_seg"] = ka["ebo_seg"].long()
            alpha_T, hist_T, recs = lv.lvcsr_xw_nbest_device(
                emit_pdf, d["state_pdf"], b.flens_dev, d["band"], d["start"],
                d["state0_hash"], d["cell_exit_idx"], d["cell_exit_w"],
                d["bo_cell"], ka["seg_cells"], ka["seg_pad"], d["entry_state"],
                d["entry_word"], d["entry_w"], d["p1e"], d["se_cell"],
                d["se_w"], ka["ebo_seg"], ka["ebo_seg_pad"], g.lb, g.ub, nbest,
            )
            rows = lv.lvcsr_xw_nbest_backtrace_host(
                g, alpha_T.cpu().numpy(), hist_T.cpu().numpy(),
                [r.cpu().numpy() for r in recs], b.flens, nbest, T=T,
            )
            return rows, g
        alpha_T, hist_T, recs = lv.lvcsr_nbest_device(
            emit_pdf, d["state_pdf"], b.flens_dev, d["band"], d["start"],
            d["state0_hash"], d["exit_idx"], d["exit_w"], d["entry_idx"],
            d["entry_word"], d["entry_w"], d["p1"], d["bo"], d["big_pred"],
            d["big_w"], g.lb, g.ub, nbest,
        )
        # the per-frame records stay on the device; only the (B, H) final
        # selections and the (B, H, T) paths come back
        scores_d, s0_d, rk0_d = lv.lvcsr_nbest_final_select_device(
            alpha_T, hist_T, d["exit_idx"], d["exit_w"], d["eos"], nbest)
        path_d, word_d = lv.lvcsr_nbest_backtrace_device(
            s0_d, rk0_d, recs, b.flens_dev, d["entry_word"],
            d["entry_slot_of_state"], d["big_pred"], d["exit_idx"],
            d["state_word"], g.lb, g.ub, nbest, T=T,
        )
        scores = scores_d.cpu().numpy()
        paths = path_d.cpu().numpy()
        words = word_d.cpu().numpy()
        rows = []
        for r in range(paths.shape[0]):
            L = int(b.flens[r])
            hyps = []
            for h in range(paths.shape[1]):
                sc = float(scores[r, h])
                if sc <= NEG_INF / 2:
                    continue
                wrow = words[r, h, :L]
                events = [(int(t), int(w)) for t, w in enumerate(wrow) if w >= 0]
                hyps.append((paths[r, h], sc, events))
            rows.append(hyps)
        return rows, g

    def _lvcsr_words(self, g, path, events, L: int, begin: float, fs
                     ) -> List[CtmInterval]:
        words: List[CtmInterval] = []
        wf = g.state_word[path[:L]]
        for e_idx, (t0, v) in enumerate(events):
            t1 = events[e_idx + 1][0] if e_idx + 1 < len(events) else L
            span = np.nonzero(wf[t0:t1] == v)[0]
            end = t0 + (int(span[-1]) + 1 if len(span) else t1 - t0)
            words.append(CtmInterval(begin + t0 * fs, begin + end * fs, g.words[v]))
        return words

    def _transcribe_prepared_lvcsr(self, prepared, corpus, fs, nbest,
                                   rescore_lm, rescore_weight, mark):
        al = self.aligner
        results: Dict[int, TranscriptionResult] = {}
        if nbest <= 1:
            # decode then backtrace each batch before the next decode, so
            # one batch's checkpoints are alive at a time
            bts = []
            for b in prepared:
                handle = self._lvcsr_decode_device(b.ff, b.flens_dev, al.gmm)
                bts.append(self._lvcsr_backtrace_device_dispatch(
                    handle, b.flens_dev, int(b.ff.shape[1])))
                del handle
            mark("decode_dispatch")
            host = [self._lvcsr_rows(bt, b.flens) for bt, b in zip(bts, prepared)]
            mark("path_fetch")
        for bi, b in enumerate(prepared):
            if nbest <= 1:
                g_used = self._lvcsr
                rows = [[trace] for trace in host[bi]]
            else:
                rows, g_used = self._lvcsr_nbest_decode(b, al.gmm, nbest)
            for row, i in enumerate(b.utts):
                utt = corpus.utterances[i]
                L = int(b.flens[row])
                if nbest <= 1:
                    self.last_state_paths[i] = rows[row][0][0][:L]
                hyps: List[Tuple[str, float, List[CtmInterval]]] = []
                for path, score, events in rows[row]:
                    words = self._lvcsr_words(g_used, path, events, L,
                                              utt.begin, fs)
                    hyps.append((" ".join(w.label for w in words), score, words))
                if rescore_lm is not None and len(hyps) > 1:
                    hyps = self._rescore_hypotheses(hyps, rescore_lm, rescore_weight)
                if not hyps:  # no finite complete path (utterance too short)
                    hyps = [("", float(NEG_INF), [])]
                best_text, best_score, best_words = hyps[0]
                results[i] = TranscriptionResult(
                    utterance_id=i,
                    text=best_text,
                    words=best_words,
                    log_likelihood=best_score,
                    alternatives=[(t, s) for t, s, _w in hyps]
                    if len(hyps) > 1
                    else None,
                    cross_word_fallback=self.cross_word_fallback,
                )
        mark("words" if nbest <= 1 else "nbest_decode_and_words")
        return results

    # -- SAT two-pass ----------------------------------------------------------
    def _fmllr_decode_feats(self, prepared, num_speakers, mark, utt_spk):
        """Two-pass SAT decoding: a first-pass decode with the
        speaker-independent model, per-speaker fMLLR from the first-pass
        labels (silence weighted), then adapted features for the final
        decode (reference ``transcription/transcriber.py:1120-1198``). The
        statistics are float64 totals on the device, each utterance added
        to its speaker's in corpus order (``utt_spk``: each corpus
        utterance's speaker index), fetched once."""
        al = self.aligner
        fm = al.fmllr
        stats = zero_fmllr_totals(num_speakers, fm.means.shape[2], self.device)
        for b in prepared:
            if self._lvcsr is not None:
                traces = self._lvcsr_decode(b, al.si_gmm)
                sp = np.stack([t[0] for t in traces]).astype(np.int64)
                frame_pdf = torch.from_numpy(
                    self._lvcsr.state_pdf[sp].astype(np.int64)).to(self.device)
            else:
                state_path, _sc = _al._emit_and_align(
                    b.ff, b.flens_dev, b.graph, al.si_gmm, self.acoustic_scale,
                    use_emission_kernel=al.si_use_emission_kernel,
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
            K, G, beta, min_count=al.config.fmllr_min_count
        )
        self.last_fmllr = FmllrEstimate(K, G, beta, transforms)
        mark("fmllr_solve")
        trans_dev = torch.from_numpy(transforms).to(self.device)
        adapted = [
            b._replace(ff=apply_per_speaker_transform(b.ff, b.spk_dev, trans_dev))
            for b in prepared
        ]
        mark("fmllr_apply")
        return adapted

    def transcribe_corpus_per_speaker(
        self, corpus: Corpus, lm_order: int = 3, **kwargs
    ) -> Dict[int, TranscriptionResult]:
        """Decode each speaker's utterances against an LM trained on that
        speaker's own transcripts (the reference's per-speaker-LM check,
        ``PerSpeakerDecodeFunction``; ``mfa validate
        --test_transcriptions``)."""
        results: Dict[int, TranscriptionResult] = {}
        by_speaker: Dict[str, List[int]] = {}
        for utt in corpus.utterances:
            by_speaker.setdefault(utt.speaker, []).append(utt.id)
        for speaker, utt_ids in by_speaker.items():
            texts = [
                " ".join(self.aligner.tokenizer.tokenize(corpus.utterances[i].text))
                for i in utt_ids
            ]
            self._reset_graph()  # rebuilt for this speaker's LM
            self.lm, _ = train_lm_from_texts(texts, order=lm_order)
            sub = corpus.subset(utt_ids)
            sub_results = self.transcribe_corpus(sub, **kwargs)
            for local_id, res in sub_results.items():
                orig = utt_ids[local_id]
                res.utterance_id = orig
                results[orig] = res
        return results

    # -- words -----------------------------------------------------------------
    def _rescore_hypotheses(
        self,
        hyps: List[Tuple[str, float, List[CtmInterval]]],
        rescore_lm: ArpaModel,
        rescore_weight: float,
    ) -> List[Tuple[str, float, List[CtmInterval]]]:
        """Swap the decoding LM's score for the rescoring LM's on each
        hypothesis and re-rank (N-best lattice rescoring: subtract G_small,
        add G_big)."""
        rescored = []
        for text, score, words in hyps:
            seq = text.split()
            old_lm = self.lm_scale * self.lm.sentence_log_prob(seq) * LN10
            new_lm = rescore_weight * rescore_lm.sentence_log_prob(seq) * LN10
            rescored.append((text, score - old_lm + new_lm, words))
        rescored.sort(key=lambda h: -h[1])
        return rescored

    def _path_events_1best(self, garrs, sp, word_f, inst_f) -> np.ndarray:
        """(B, T) word-entry events of densified 1-best paths, inferred from
        the states: a move into a word-entry state begins a word. A one-state
        word's immediate repeat with no silence stays merged here (the
        N-best path resolves it through per-arc events)."""
        B, T = sp.shape
        if "in_event" in garrs:
            is_entry = (garrs["in_event"] >= 0).any(axis=2)  # (B, S)
            b = np.arange(B)[:, None]
            entry_f = is_entry[b, sp]
            moved = np.ones((B, T), bool)
            moved[:, 1:] = sp[:, 1:] != sp[:, :-1]
            fire = entry_f & moved
        else:
            fire = np.zeros((B, T), bool)
            fire[:, 1:] = inst_f[:, 1:] != inst_f[:, :-1]
            fire[:, 0] = True
        fire[:, 0] = True
        return np.where(fire & (word_f >= 0), word_f, -1).astype(np.int32)

    def _events_from_instances(self, word_f, inst_f) -> np.ndarray:
        """Instance-crossing word events for graphs without arc events."""
        fire = np.empty(len(word_f), bool)
        fire[0] = True
        fire[1:] = inst_f[1:] != inst_f[:-1]
        return np.where(fire & (word_f >= 0), word_f, -1).astype(np.int32)

    def _decode_words(self, word_f, events, offset, fs) -> List[CtmInterval]:
        """Per-frame word labels and word-entry events -> word intervals: a
        new interval at every event; frames continuing the same word with no
        event extend the current one."""
        words: List[CtmInterval] = []
        cur: Optional[CtmInterval] = None
        cur_w = -1
        for t in range(len(word_f)):
            w = int(word_f[t])
            if w < 0:
                cur = None
                continue
            if cur is not None and cur_w == w and events[t] < 0:
                cur.end = offset + (t + 1) * fs
            else:
                cur = CtmInterval(offset + t * fs, offset + (t + 1) * fs,
                                  self._vocab[w])
                words.append(cur)
                cur_w = w
        return words

    def evaluate(self, corpus: Corpus,
                 results: Dict[int, TranscriptionResult]) -> dict:
        """WER/CER against the corpus transcripts (reference
        ``transcriber.py:127-512``)."""
        from montreal_forced_aligner_tpu_torch.evaluation import (
            score_cer,
            score_wer,
        )

        wers, cers = [], []
        for utt in corpus.utterances:
            if utt.id not in results:
                continue
            ref = self.aligner.tokenizer.tokenize(utt.text)
            hyp = results[utt.id].text.split()
            wers.append(score_wer(ref, hyp))
            cers.append(score_cer(" ".join(ref), " ".join(hyp)))
        return {
            "wer": float(np.mean(wers)) if wers else 1.0,
            "cer": float(np.mean(cers)) if cers else 1.0,
            "num_utterances": len(wers),
        }


def _lvcsr_mod():
    from montreal_forced_aligner_tpu_torch.transcription import lvcsr

    return lvcsr


def train_phone_lm(results, order: int = 4) -> ArpaModel:
    """A phone LM from aligned phone sequences (reference
    ``train_phone_lm``, ``transcription/transcriber.py:737-760``)."""
    texts = []
    for aln in results.values():
        texts.append(" ".join(p.label for p in aln.phones))
    model, _counter = train_lm_from_texts(texts, order=order)
    return model
