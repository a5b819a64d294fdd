#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

What it does, in order; any failure exits non-zero with no result line:

1. prints the card's name and power limit as ``nvidia-smi`` gives them;
2. builds the port's native code, the CUDA kernels of
   ``montreal_forced_aligner_tpu_torch/csrc`` and the host C++ of
   ``native/`` (the fMLLR solver, the graph assembly, the FLAC decoder;
   one compiler per source, all started together);
3. builds, with the port's own modules, a synthetic acoustic model at SAT
   scale (random weights from a seed: 40 phones, about 5k pdfs, 32
   Gaussians per pdf, a 40-dim LDA over +-3 spliced 13-dim MFCCs, and a
   speaker-independent alignment model), a corpus of 64 utterances of 2-30
   s over 8 speakers, two small corpora and one utterance of 10.5 minutes;
4. main path **sat-2pass**: aligns the corpus through
   ``PretrainedAligner.align_corpus`` with speaker adaptation (the fMLLR
   two-pass; batch 32) with every launch count set to 0 just before,
   exports TextGrids, and requires every kernel to have been launched
   twice per batch and every utterance to have an alignment and at least
   one speaker to have passed ``fmllr_min_count``; every call of the three
   kernel wrappers in that run, and again in the first warm run, is timed
   with CUDA events, and each batch's fMLLR statistics are replayed under
   the profiler for the card's busy time in them; five warm runs give the steady throughput (their
   median), one with the card synchronised at each phase the phase
   breakdown, and one more under ``torch.profiler`` the card's busy share
   and its time by kernel (the kernels' own symbols beside the events);
5. main path **sat-si**: the same corpus single-pass with the
   speaker-independent model, counted again from 0, three warm runs, one
   synchronised and one profiled;
6. aligns small corpora on the card and on the CPU (the plain PyTorch
   versions), speaker-independent and two-pass, and holds each pair to the
   JAX package's parity bar; then **speaker_stats_invariance**: the first
   pass's inputs of sat-2pass rebatched at 1, 8 and 32 give bit-identical
   per-speaker fMLLR totals and the same MFCC rows bit-identical CMVN
   sums, and each batching's own MFCC rows, CMVN means, LDA rows,
   fMLLR-applied rows and all-pdf log-likelihood rows are bit-identical
   (the transforms' largest differences between batch sizes reported);
7. holds each kernel against its plain version on the real inputs of the
   first batch of sat-si and of sat-2pass's second pass (adapted features,
   final model): K1 backpointers and K2 states bit-identical, K1 alpha
   within 1e-4, K3 within rtol 1e-5 / atol 1e-3; times both, K2 also on
   the last batch's (``last_batch``), and for K3 two yardsticks: the
   all-pdf emission path, and the gathered rows through ``torch.matmul``
   and ``torch.logsumexp``; K2's line adds its chain floor, the longest
   row's steps times one shared-memory load (``SMEM_LOAD_CYCLES``) at
   ``clocks.max.sm``;
8. aligns the 10.5-minute utterance through ``align_corpus`` (the
   single-utterance two-pass and the chunked exact Viterbi), then on its
   final features holds ``viterbi_align_long`` against one
   whole-utterance emit and align (identical state path, score within
   1e-3), times each sweep, checks the path's launches exactly, and holds
   K3, K1 and K2 on one chunk against their plain versions;
9. holds the native fMLLR solve against its numpy sweep on sat-2pass's own
   statistics (atol 2e-4) and times both (before step 8, whose own
   two-pass replaces the aligner's estimate);
10. main path **train-mono**: ``TrainableAligner`` on the 64-utterance
    corpus with ``bench.py``'s train workload (one monophone stage of 4
    iterations to 64 Gaussians, batch 32, chain topology: flat start, equal
    alignment, the realignments of its schedule), launch counts set to 0
    just before: K1 and K2 must launch once per banded batch and
    alignment, K3 as the emission rule says; one cold and three warm runs
    (throughput: the warm median), one with the card synchronised at each
    phase, one profiled for the card's busy share;
11. main path **train-recipe**: the same corpus through mono -> tri -> LDA
    -> SAT -> pron_prob at the default recipe's Gaussian and leaf counts,
    iterations cut (each stage still realigns, LDA estimates MLLT and SAT
    fMLLR more than once), counted from 0: per stage the wall seconds,
    leaves, Gaussians, K3 eligibility, launches and log-likelihood per
    iteration (finite, the last above the first); K1, K2 and K3 held to
    their plain versions on the LDA stage's first realignment that runs
    all three; the final archive aligns the corpus two-pass on the card,
    every utterance;
12. **train-reference**: the JAX package's training-test tone corpus and
    its ``TINY_RECIPE`` trained on the card twice (bit-identical models),
    once more under ``torch.use_deterministic_algorithms``, and once on the
    CPU (mono log-likelihoods within 1e-3); both devices' models hold the
    JAX test's alignment bar;
13. main path **adapt**: ``MapAdapter.adapt`` (MAP with ``mapping_tau``
    20 on the SAT-scale model: the fMLLR two-pass with K3, K1 and K2 in
    both passes, then the means of the final and the speaker-independent
    model) on the corpus, counted from 0: launches equal to batches times
    passes, K1-K3 held to their plain versions on adapt's first batch; three
    warm runs (the first bit-identical to the counted one), one synchronised
    at each phase; the card against the CPU on the 8-utterance corpus (means
    within rtol 1e-5 of each tensor's largest value); the adapted archive
    aligns the corpus two-pass, every utterance;
14. **graph compile**: train-mono's graphs from the native core
    (``native/graph_assembly.cc``) bit-identical to the Python compiler's,
    and sat-si's triphone graphs through a pool of 4 processes identical to
    serial ones, each timed;
15. **pitch**: one cold train-mono with ``use_pitch``, the corpus's pitch
    features timed, and pitch on the card against the CPU on 4 utterances;
16. **fine-tune**: sat-si's alignments refined at 1 ms, timed, and the
    card against the CPU on 4 utterances (boundaries within 1 ms);
17. main path **transcribe-dense**: ``Transcriber.transcribe_corpus`` on
    the corpus against a bigram over 30 of the dictionary's words, the SAT
    two-pass decode, batch 16, counted from 0: K3 launched exactly twice a
    batch (the dense max-plus Viterbi is plain PyTorch), every utterance
    decoded; K3 held to its plain version on the decode's first batch of
    pass 2 (rtol 1e-5 / atol 1e-3); the graph's S and K, one cold and two
    warm walls (the first synchronised at each phase, the second under the
    profiler for the card's busy share), peak card memory;
18. **transcribe-nbest**: the same LM on the 4-utterance corpus at N-best
    8, rescored with a trigram over the same words (K3 twice a batch),
    synchronised at each phase;
19. main path **transcribe-lvcsr**: an LM trained on the corpus's own
    transcripts (200 words), so the cross-word LVCSR decoder runs (no
    fallback, no kernel: plain PyTorch, each checkpoint chunk replayed as
    a CUDA graph), two-pass; cold and warm walls, phases, peak memory;
20. **transcribe-lvcsr-20k**: ``bench.py``'s LVCSR recipe (20,000 junk
    words over the model's phones, a bigram over 6-word texts) on the 16
    shortest utterances: the graph build (host Python, run in a spawned
    worker on the CPU while steps 17-19 run on the card), its S and
    fallback flag, a cold run, peak memory;
21. **phone-transcribe**: ``align --use_phone_model`` through the CLI and
    ``transcribe --output_type alignment``, both on the 8-utterance corpus,
    each counted from 0 (K1, K2 and K3 all launched);
22. **card against CPU** on the 4-utterance corpus for dense 1-best, dense
    N-best (4 ranks, a bigram over 12 words) and LVCSR (the corpus LM of
    step 19): identical words and ranked lists, >= 99.9% of frames on the
    same state, scores within 5 nats (the CPU halves run in a second worker
    beside steps 17-21);
23. main path **train-ivector**: ``cli train_ivector`` at the command's
    defaults (256 Gaussians, 192 dimensions, 10 iterations, batch 16,
    PLDA) on a corpus of 8 tone speakers x 48 utterances of 4-14 s
    (``tests/test_ivector.py``'s recipe, formant shift 1 + 0.06 a
    speaker), counted from 0 (no kernel launches): the cold wall, one warm
    run synchronised at each phase (features, ubm, stats, em, plda, save)
    whose model is bit-identical to the command's, its peak card memory,
    and one profiled run for the card's busy share;
24. **diarize**: ``cli diarize_speakers`` with that model three times
    (agglomerative cosine with ``--evaluate``, PLDA k-means, ``--classify``),
    each counted from 0: wall, purity and adjusted Rand index;
25. **vad**: ``cli create_segments_vad`` on 8 files of 120 s (tone bursts
    of 0.5-8 s between pauses of 0.1-2.0 s of low noise) in
    ``long_textgrid`` and ``csv``, counted from 0: walls, the median
    boundary error against the true pauses, the share of true pauses of
    at least 0.5 s found;
26. main path **create-segments**: ``cli create_segments`` with the
    SAT-scale model on the 10.5-minute utterance, counted from 0: launches
    exactly as the chunked long path's formula gives, the segments' words
    joined equal to the transcript; K3, K1 and K2 held to their plain
    versions on the final pass's last chunk;
27. **card against CPU** for the slice (the CPU half in a worker beside
    steps 23-26): ``train_ivector_model`` at the default width on 32
    utterances (the UBM's Gaussian count equal, its arrays and T within
    1e-3 of each array's largest magnitude, i-vector cosines >= 0.999,
    cluster and classify labels identical), the VAD set (voiced frames
    identical but those within 1e-4 of the threshold, segment lists
    identical) and ``create_segments`` of a 43-s file (the 8-utterance
    corpus joined with 0.5 s pauses: the same texts, boundaries within one
    frame);
28. main path **g2p-align**: the corpus's audio rewritten as FLAC by the
    seeded writer below (every subframe type, one stereo file), a spelled
    dictionary of 400 words over the 40 phones (a spelling determines its
    phones) of which 100 are held out, three phonological rules, and ``cli
    train_g2p`` on the dictionary (the pair-ngram engine), timed; the G2P
    word accuracy on the held-out words; every file decoded natively, bit for
    bit the samples written, MD5 verified; then ``cli align`` with
    ``--g2p_model_path``, ``--rules_path`` and ``--language english``
    (batch 32), counted from 0: K1, K2 and K3 launched, every utterance
    aligned, the held-out tokens aligned with G2P pronunciations; cold,
    warm and synchronised walls, a profiled run's busy share, the G2P
    lookups' seconds, peak card memory; K1-K3 held to their plain versions on the first batch of pass
    2 (band (16, 64): the rules' variants widen the graphs);
29. **train-g2p**: a monophone stage at ``TINY_RECIPE``'s widths and a
    pron_prob stage with ``train_g2p`` on train-reference's tone corpus,
    with a rule: two card runs regenerate the same lexicon and train
    bit-identical models, and the CPU regenerates the same lexicon;
30. **card against CPU** for g2p-align on its 8 shortest files (the parity
    bar, the same G2P entries) and the plain Python FLAC decoder on every
    file (the native decode's samples), the CPU halves in workers beside
    the card's run of those files and step 29;
31. multi-GPU on the one card (the machine has one; ranks that share it
    measure the protocol, not scaling): **W = 1 on NCCL** in this process
    (a real ``init_process_group("nccl")`` over a file store): sat-2pass
    and sat-si through ``align_corpus`` with ``distributed`` identical to
    the plain runs (intervals, scores), train-mono through
    ``TrainableAligner(distributed=True)`` (its statistics through NCCL's
    all_reduce) bit-identical to the plain run; **W = 2 over gloo**, ranks
    spawned by ``parallel.multihost.run_ranks``: sat-si intervals identical,
    sat-2pass at the parity bar with identical phone sequences, train-mono
    at the JAX distributed test's bars and two W = 2 trainings
    bit-identical, TF32 off in every rank; ``python -m
    torch.distributed.run --nproc_per_node 2 -m ...cli align ...
    --distributed`` (gloo): the ranks' TextGrids against the plain export
    (the same files and phone sequences, the parity bar's frames and
    boundaries), each rank's wall, launches and peak memory; the dry run
    ``parallel.dryrun.dryrun_multichip(2)`` (mono -> tri -> SAT, align,
    fine-tune, adapt over the ranks); K1-K3 launched on every rank of every
    path (K1 and K2 for the monophone models, whose size K3's rule does not
    take);
32. **MFA**: ``wrapper.MFA`` on the card against the CPU (a worker) on the
    4-utterance corpus plus one in-memory record: the parity bar;
33. **parity harness**: ``parity.harness.compare_corpus_sat``, the card's
    sat-2pass against the independent numpy two-pass decoder, on the 4
    shortest utterances (frame and boundary agreement reported);
34. main path **whisper** (in a spawned process without the
    deterministic cuBLAS workspace): a random-weight Whisper checkpoint at
    ``openai/whisper-large-v3-turbo``'s published widths and depth (about
    809M parameters, float16 safetensors, a synthetic vocabulary in the
    published layout) transcribes the 4-utterance corpus through ``cli
    transcribe_whisper`` on the card, counted from 0 (no K1-K3 on this
    path); the load seconds, encoder ms per utterance, decoder ms per
    token, tokens, warm audio seconds per second and peak memory; the card
    against the port's CPU path (a worker) on 2 utterances: log-mel within
    1e-4, encoder output within 1e-4, greedy ids of the first 32 steps
    equal up to the CPU's first near-tie (top two within 1e-4), logits
    within 1e-4; then, in the same process, main path **whisper-settings**:
    the checkpoint under a second generation config (``WHISPER_SETTINGS``:
    timestamps, conditioning on earlier windows, 4 beams, no repeated
    trigram), ``cli transcribe_whisper`` on 2 utterances counted from 0, a
    warm run (decoder ms a beam step, beam steps, windows, peak memory,
    the phase's seconds, the card's name and power limit), and the card
    against the CPU worker over the first 32 steps: every beam's
    log-probabilities within 1e-4, the running beams equal up to the CPU's
    first near-tie (best candidates, or the two sides of the
    timestamp-versus-text rule, within 1e-4), at least one beam step
    compared, the chosen hypothesis equal when no near-tie came;
35. **speechbrain-paths**: ``transcribe_speechbrain``, ``create_segments_vad
    --speechbrain_model_path`` and ``diarize_speakers speechbrain`` through
    ``tests/torch_mock_speechbrain.py`` on the card and the CPU: the same
    texts, segments and labels; parameters and inputs on the card;
36. prints one ``{"kernels": [...]}`` line (sat-2pass's launches and
    second-pass checks; each row's ``launches_by_path`` adds the training,
    adapt, transcription, segmentation, g2p-align and multi-GPU paths'
    launches (a list by rank where ranks share the card),
    ``train_recipe_check`` the LDA-stage check, ``adapt_check`` adapt's,
    ``transcribe_dense_check`` K3's on the dense decode and
    ``g2p_align_check`` g2p-align's), then as the last line
    ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

PKG = "montreal_forced_aligner_tpu_torch"

# NVIDIA H100 SXM data sheet: HBM rate, float32 rate outside the tensor
# cores and TF32 rate on them (dense), at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# load-to-use latency of a dependent shared-memory load on Hopper, in SM
# cycles: a round figure taken for K2's chain floor, not measured here
SMEM_LOAD_CYCLES = 30


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# perf_counter at the start of main(): each result line but the kernels
# line and the last carries "t_s", the seconds since then
_T_START = None


def _emit(obj, stamp=True) -> None:
    if stamp and _T_START is not None:
        obj = {**obj, "t_s": time.perf_counter() - _T_START}
    print(json.dumps(obj), flush=True)


# -- fixture -----------------------------------------------------------------


def build_sat_scale_model(
    tmp: Path,
    num_phones: int = 40,
    gauss_per_pdf: int = 32,
    dim: int = 40,
    num_words: int = 200,
    seed: int = 0,
):
    """Synthetic model at SAT-triphone scale with random parameters: a
    triphone tree of about num_phones x 3 x (num_phones + 2) leaves, a final
    and a speaker-independent GMM, and a random LDA over 13 x 7 spliced
    MFCCs. Returns (model_path, dict_path, words)."""
    from montreal_forced_aligner_tpu_torch.models.acoustic_model import (
        AcousticModel,
    )
    from montreal_forced_aligner_tpu_torch.models.gmm import DiagGmmSet
    from montreal_forced_aligner_tpu_torch.models.transition_model import (
        HmmTopology,
        TransitionModel,
    )
    from montreal_forced_aligner_tpu_torch.models.tree import (
        KPDF_CLASS,
        ConstantEventMap,
        ContextDependency,
        TableEventMap,
    )

    rng = np.random.RandomState(seed)
    sil = 1
    phones = [sil] + [2 + i for i in range(num_phones)]
    topo = HmmTopology.standard(phones, silence_phones=[sil])
    max_phone = max(phones)
    pdf = 0
    center_table = [None] * (max_phone + 1)
    for phone in phones:
        class_maps = []
        for _cls in range(topo.num_pdf_classes(phone)):
            if phone == sil:
                class_maps.append(ConstantEventMap(pdf))
                pdf += 1
                continue
            left_table = []
            for _l in range(max_phone + 1):
                left_table.append(ConstantEventMap(pdf))
                pdf += 1
            class_maps.append(TableEventMap(0, left_table))
        center_table[phone] = TableEventMap(KPDF_CLASS, class_maps)
    tree = ContextDependency(N=3, P=1, to_pdf=TableEventMap(1, center_table))
    tm = TransitionModel.from_topology_and_tree(topo, tree)
    num_pdfs = tree.num_pdfs

    def random_gmm():
        means = rng.randn(num_pdfs, gauss_per_pdf, dim).astype(np.float32) * 2.0
        inv_vars = (
            1.0 / np.maximum(rng.gamma(4.0, 0.25, (num_pdfs, gauss_per_pdf, dim)), 0.1)
        ).astype(np.float32)
        return DiagGmmSet.from_lists(
            weights_list=[np.full(gauss_per_pdf, 1.0 / gauss_per_pdf, np.float32)]
            * num_pdfs,
            miv_list=[(means[i] * inv_vars[i]) for i in range(num_pdfs)],
            iv_list=[inv_vars[i] for i in range(num_pdfs)],
        )

    gmm = random_gmm()
    si_gmm = random_gmm()
    spliced = 13 * 7
    lda_mat = (rng.randn(dim, spliced) / np.sqrt(spliced)).astype(np.float32)
    phone_table = {"<eps>": 0, "sil": 1}
    names = {}
    for i in range(num_phones):
        names[2 + i] = f"p{i:02d}"
        phone_table[names[2 + i]] = 2 + i
    model = AcousticModel(
        transition_model=tm,
        gmm=gmm,
        tree=tree,
        meta={
            "version": "0.1.0",
            "architecture": "gmm-hmm",
            "phones": sorted(names.values()),
            "features": {
                "type": "mfcc",
                "deltas": False,
                "lda": True,
                "fmllr": True,
                "frame_shift": 10,
                "splice_left_context": 3,
                "splice_right_context": 3,
            },
        },
        phone_table=phone_table,
        lda_mat=lda_mat,
        alignment_model=(tm, si_gmm),
    )
    model_path = tmp / "sat_scale_model.zip"
    model.save(model_path)
    dict_path = tmp / "sat_scale.dict"
    words = []
    with open(dict_path, "w") as f:
        for w in range(num_words):
            n = rng.randint(2, 7)
            ph = [names[2 + rng.randint(num_phones)] for _ in range(n)]
            words.append(f"word{w:03d}")
            f.write(f"{words[-1]}\t{' '.join(ph)}\n")
    return model_path, dict_path, words


def build_corpus(tmp: Path, words, num_utts: int, min_s=2.0, max_s=30.0,
                 seed=0, name="corpus", sr=16000, num_speakers=8):
    """Utterances of min_s-max_s seconds over ``num_speakers`` speakers:
    noise plus three tones each, and 2.5 random words per second. Returns
    (dir, seconds)."""
    from montreal_forced_aligner_tpu_torch.io.wav import write_wave

    rng = np.random.RandomState(seed)
    corp = tmp / name
    words = sorted(words)
    total = 0.0
    for u in range(num_utts):
        d = corp / f"spk{u % num_speakers}"
        d.mkdir(parents=True, exist_ok=True)
        seconds = float(rng.uniform(min_s, max_s))
        n = int(seconds * sr)
        wave = (rng.randn(n) * 800).astype(np.float32)
        t = np.arange(n) / sr
        for f in rng.choice([220, 440, 880, 1760], 3, replace=False):
            wave += 2000 * np.sin(2 * np.pi * f * t + rng.rand())
        write_wave(d / f"utt{u}.wav", wave.astype(np.float32), sr)
        n_words = max(2, int(seconds * 2.5))
        (d / f"utt{u}.lab").write_text(" ".join(rng.choice(words, n_words)))
        total += seconds
    return corp, total


def build_voiced_corpus(tmp: Path, dict_path, num_utts: int, min_s=2.0, max_s=30.0,
                        seed=0, name="voiced", sr=16000, num_speakers=8):
    """Utterances that say their transcripts, for pitch models: every phone
    of the lexicon a sound of its own (made from a fixed seed, so corpora
    of one lexicon share them), 50-150 ms of it a phone. Four phones in
    five are voiced, a harmonic complex under two formants; the others
    are coloured noise. The voice's pitch glides over each word around its
    speaker's own (90-260 Hz), and quiet noise pauses lie at both ends and
    between some words. Over the stationary tones of :func:`build_corpus`
    the normalized log-pitch and delta-pitch are 0 and the voicing
    probability nearly constant, so the pitch columns carry nothing and a
    per-speaker fMLLR on them is ill-posed. Returns (dir, seconds)."""
    from montreal_forced_aligner_tpu_torch.io.wav import write_wave

    lexicon = [line.split("\t") for line in Path(dict_path).read_text().splitlines()]
    lexicon = [(w, p.split()) for w, p in lexicon]
    inventory = sorted({p for _w, ps in lexicon for p in ps})
    prng = np.random.RandomState(12345)
    sounds = {}
    for k, p in enumerate(inventory):
        if k % 5 == 4:
            sounds[p] = ("noise", float(prng.uniform(-0.9, 0.9)))
        else:
            sounds[p] = ("voiced", float(prng.uniform(300, 900)),
                         float(prng.uniform(900, 2500)))
    rng = np.random.RandomState(seed)
    spk_f0 = rng.uniform(90.0, 260.0, num_speakers)
    corp = tmp / name
    total = 0.0

    def pause(lo, hi):
        return (rng.randn(int(rng.uniform(lo, hi) * sr)) * 30.0).astype(np.float32)

    for u in range(num_utts):
        spk = u % num_speakers
        d = corp / f"spk{spk}"
        d.mkdir(parents=True, exist_ok=True)
        target = float(rng.uniform(min_s, max_s))
        pieces, said = [pause(0.15, 0.3)], []
        t = len(pieces[0]) / sr
        while t < target - 0.3 or len(said) < 2:
            word, phones = lexicon[rng.randint(len(lexicon))]
            said.append(word)
            lens = [int(rng.uniform(0.05, 0.15) * sr) for _ in phones]
            n = sum(lens)
            glide = np.linspace(*rng.uniform(0.85, 1.15, 2), n)
            f0 = spk_f0[spk] * glide
            phase = 2 * np.pi * np.cumsum(f0) / sr + rng.rand() * 2 * np.pi
            at = 0
            for p, m in zip(phones, lens):
                sound = sounds[p]
                if sound[0] == "noise":
                    e = rng.randn(m + 1)
                    x = (e[1:] + sound[1] * e[:-1]) * 1200.0
                else:
                    ph, f = phase[at : at + m], float(f0[at : at + m].mean())
                    x = np.zeros(m)
                    for h in range(1, int(6000 / f) + 1):
                        amp = (np.exp(-(((h * f - sound[1]) / 150.0) ** 2))
                               + np.exp(-(((h * f - sound[2]) / 200.0) ** 2)) + 0.05)
                        x += amp * np.sin(h * ph)
                    x = x * (3000.0 / max(np.sqrt(np.mean(x * x)), 1e-9))
                    x += rng.randn(m) * 30.0
                pieces.append(x.astype(np.float32))
                at += m
            t += n / sr
            if rng.rand() < 0.3:
                pieces.append(pause(0.05, 0.2))
                t += len(pieces[-1]) / sr
        pieces.append(pause(0.15, 0.3))
        wave = np.concatenate(pieces)
        write_wave(d / f"utt{u}.wav", wave, sr)
        (d / f"utt{u}.lab").write_text(" ".join(said))
        total += len(wave) / sr
    return corp, total


# -- FLAC fixture --------------------------------------------------------------
#
# A small seeded FLAC writer, so the corpus of the g2p-align path arrives as
# FLAC without an encoder library. It writes 16-bit PCM (other depths by
# their STREAMINFO codes) with every subframe type: CONSTANT where a block
# is constant, VERBATIM for one chosen frame, FIXED of order 0-4, and LPC of
# order 1-8 with coefficients made from the seed (an LPC subframe decodes
# exactly with any integer coefficients, because its residual is computed
# with those same coefficients, so there is no coefficient search). Stereo
# frames cycle through independent, left/side, right/side and mid/side
# channels. Residuals are Rice-coded with the parameter that minimises each
# partition's bits; STREAMINFO carries the samples' MD5, each frame header
# its CRC-8 and each frame its CRC-16. Bits are packed with numpy, a frame
# at a time, and the CRC-16s of all frames of all files are computed in one
# pass over byte positions.

FLAC_BLOCK = 4096
_FLAC_RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
                    24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
_FLAC_DEPTH_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
# stereo channel assignments the writer cycles through, frame by frame:
# independent, left/side, right/side, mid/side
_FLAC_STEREO_MODES = (1, 8, 9, 10)


def _crc_table(poly: int, width: int) -> np.ndarray:
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = np.zeros(256, dtype=np.int64)
    for b in range(256):
        c = b << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if c & top else (c << 1)
        table[b] = c & mask
    return table


_CRC8 = _crc_table(0x07, 8)
_CRC16 = _crc_table(0x8005, 16)


def flac_crc8(data: bytes) -> int:
    """FLAC's frame-header CRC-8 (polynomial x^8 + x^2 + x + 1)."""
    c = 0
    for b in data:
        c = int(_CRC8[c ^ b])
    return c


def flac_crc16(data: bytes) -> int:
    """FLAC's frame CRC-16 (polynomial x^16 + x^15 + x^2 + 1), one byte at a
    time: the plain version of :func:`_crc16_many`."""
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ int(_CRC16[(c >> 8) ^ b])
    return c


def _crc16_many(chunks):
    """CRC-16 of every byte string in ``chunks``, all in one pass over byte
    positions (each step a table lookup across all strings)."""
    lens = np.array([len(c) for c in chunks], dtype=np.int64)
    buf = np.zeros((len(chunks), int(lens.max(initial=0))), dtype=np.uint8)
    for i, c in enumerate(chunks):
        buf[i, :len(c)] = np.frombuffer(c, dtype=np.uint8)
    crc = np.zeros(len(chunks), dtype=np.int64)
    for j in range(buf.shape[1]):
        step = ((crc << 8) & 0xFFFF) ^ _CRC16[(crc >> 8) ^ buf[:, j]]
        crc = np.where(j < lens, step, crc)
    return [int(c) for c in crc]


def _pack_bits(values, nbits) -> bytes:
    """Big-endian bit fields (``values[i]`` in its low ``nbits[i]`` bits,
    two's complement for negatives) packed into bytes, the last padded with
    zero bits. A field may be wider than 64 bits only if its value is 1 (a
    unary code)."""
    nbits = np.asarray(nbits, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    values = np.where(nbits < 63, values & ((1 << np.minimum(nbits, 62)) - 1),
                      values).astype(np.uint64)
    idx = np.repeat(np.arange(len(nbits)), nbits)
    pos = np.arange(len(idx)) - np.repeat(np.cumsum(nbits) - nbits, nbits)
    shift = np.minimum(nbits[idx] - 1 - pos, 63).astype(np.uint64)
    return np.packbits(((values[idx] >> shift) & np.uint64(1)).astype(np.uint8)
                       ).tobytes()


def _rice_fields(resid: np.ndarray, partition_order: int, block_size: int,
                 order: int):
    """(values, nbits) of a Rice-coded residual (method 0: 4-bit
    parameters) in ``2**partition_order`` partitions, the first short by the
    predictor ``order``, each with the parameter that minimises its bits."""
    part_len = block_size >> partition_order
    u = (resid << 1) ^ (resid >> 63)  # zigzag
    ks = np.arange(15, dtype=np.int64)
    vals, bits = [np.array([0, partition_order])], [np.array([2, 4])]
    for p in range(1 << partition_order):
        up = u[max(p * part_len - order, 0):(p + 1) * part_len - order]
        cost = (up[None, :] >> ks[:, None]).sum(axis=1) + len(up) * (ks + 1)
        k = int(np.argmin(cost))
        q = up >> k
        vals += [np.array([k]),
                 np.stack([np.ones_like(q), up & ((1 << k) - 1)], 1).ravel()]
        bits += [np.array([4]), np.stack([q + 1, np.full_like(q, k)], 1).ravel()]
    return np.concatenate(vals), np.concatenate(bits)


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    return np.diff(x, n=order) if order else x.copy()


def _lpc_residual(x: np.ndarray, coeffs, shift: int) -> np.ndarray:
    order = len(coeffs)
    n = len(x)
    pred = np.zeros(n - order, dtype=np.int64)
    for j, c in enumerate(coeffs):
        pred += int(c) * x[order - 1 - j:n - 1 - j]
    return x[order:] - (pred >> shift)


def _subframe_fields(x: np.ndarray, bps: int, kind: str, order: int = 0,
                     coeffs=None, shift: int = 0, precision: int = 15):
    """(values, nbits) of one subframe of ``x`` (int64) at ``bps`` bits."""
    head = {"constant": 0, "verbatim": 1, "fixed": 8 + order,
            "lpc": 31 + order}[kind]
    vals, bits = [np.array([0, head, 0])], [np.array([1, 6, 1])]
    n = len(x)
    if kind == "constant":
        vals.append(x[:1]); bits.append(np.array([bps]))
    elif kind == "verbatim":
        vals.append(x); bits.append(np.full(n, bps))
    else:
        vals.append(x[:order]); bits.append(np.full(order, bps))
        if kind == "lpc":
            vals.append(np.array([precision - 1, shift, *coeffs]))
            bits.append(np.array([4, 5, *([precision] * order)]))
            resid = _lpc_residual(x, coeffs, shift)
        else:
            resid = _fixed_residual(x, order)
        # partition order 2 where the block splits into four partitions
        # longer than the predictor order, else one partition
        porder = 2 if (n % 4 == 0 and n // 4 > order) else 0
        v, b = _rice_fields(resid, porder, n, order)
        vals.append(v); bits.append(b)
    return np.concatenate(vals), np.concatenate(bits)


def _utf8_number(n: int) -> bytes:
    """FLAC's UTF-8-like coding of a frame number (up to 36 bits)."""
    if n < 0x80:
        return bytes([n])
    extra = next(e for e in range(1, 7) if n < 1 << (5 * e + 6))
    first = ((0xFF << (7 - extra)) & 0xFF) | (n >> (6 * extra))
    return bytes([first] + [0x80 | ((n >> (6 * (extra - 1 - i))) & 0x3F)
                            for i in range(extra)])


_FLAC_BLOCK_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8, 512: 9,
                     1024: 10, 2048: 11, 4096: 12, 8192: 13, 16384: 14, 32768: 15}


def _subframe_plan(x: np.ndarray, frame: int, channel: int, verbatim_frame: int,
                   lpc_coeffs):
    """The subframe the writer uses for one channel of one frame."""
    n = len(x)
    if (x == x[0]).all():
        return {"kind": "constant"}
    if frame == verbatim_frame:
        return {"kind": "verbatim"}
    if frame % 6 == 5:
        order = min(1 + (frame // 6 + channel) % 8, n - 1)
        return {"kind": "lpc", "order": order, "coeffs": lpc_coeffs[order],
                "shift": 12}
    return {"kind": "fixed", "order": min((frame + channel) % 5, n - 1)}


def flac_encode(samples, sample_rate: int, bps: int = 16, seed: int = 0,
                verbatim_frame: int = 1, declare_length: bool = True,
                block: int = FLAC_BLOCK):
    """One FLAC stream of ``samples`` ((N,) or (N, C) integers within
    ``bps`` bits): (the bytes before the first frame, the frames without
    their CRC-16). ``declare_length=False`` writes 0 for STREAMINFO's total
    samples (a stream that does not declare its length)."""
    import hashlib

    x = np.asarray(samples, dtype=np.int64)
    if x.ndim == 1:
        x = x[:, None]
    N, C = x.shape
    rng = np.random.RandomState(seed)
    # LPC coefficients for each order: a second-difference predictor plus
    # seeded noise, quantised at shift 12 (any integers decode exactly)
    lpc_coeffs = {}
    for order in range(1, 9):
        base = np.zeros(order)
        base[:2] = [2.0, -1.0][:order] if order > 1 else [1.0]
        lpc_coeffs[order] = [int(c) for c in np.round(
            (base + rng.normal(0.0, 0.05, order)) * 4096)]
    rate_code = _FLAC_RATE_CODES.get(sample_rate, 0)
    depth_code = _FLAC_DEPTH_CODES[bps]
    frames = []
    for f, a in enumerate(range(0, N, block)):
        blk = x[a:a + block]
        n = len(blk)
        if C == 2:
            mode = _FLAC_STEREO_MODES[f % len(_FLAC_STEREO_MODES)]
            left, right = blk[:, 0], blk[:, 1]
            chans, depths = {
                1: ([left, right], [bps, bps]),
                8: ([left, left - right], [bps, bps + 1]),
                9: ([left - right, right], [bps + 1, bps]),
                10: ([(left + right) >> 1, left - right], [bps, bps + 1]),
            }[mode]
        else:
            mode = C - 1
            chans, depths = [blk[:, c] for c in range(C)], [bps] * C
        bs_code = _FLAC_BLOCK_CODES.get(n, 6 if n <= 256 else 7)
        header = bytes([0xFF, 0xF8, (bs_code << 4) | rate_code,
                        (mode << 4) | (depth_code << 1)]) + _utf8_number(f)
        if bs_code == 6:
            header += bytes([n - 1])
        elif bs_code == 7:
            header += (n - 1).to_bytes(2, "big")
        header += bytes([flac_crc8(header)])
        vals, bits = [], []
        for c, (chan, depth) in enumerate(zip(chans, depths)):
            plan = _subframe_plan(chan, f, c, verbatim_frame, lpc_coeffs)
            v, b = _subframe_fields(chan, depth, **plan)
            vals.append(v)
            bits.append(b)
        frames.append(header + _pack_bits(np.concatenate(vals),
                                          np.concatenate(bits)))
    pcm = {8: "<i1", 16: "<i2"}.get(bps)
    md5 = hashlib.md5(x.astype(pcm).tobytes()).digest() if pcm else bytes(16)
    total = N if declare_length else 0
    info = ((sample_rate << 44) | ((C - 1) << 41) | ((bps - 1) << 36) | total)
    streaminfo = (block.to_bytes(2, "big") * 2 + bytes(6)
                  + info.to_bytes(8, "big") + md5)
    head = b"fLaC" + bytes([0x80, 0, 0, len(streaminfo)]) + streaminfo
    return head, frames


def write_flac_files(items) -> None:
    """Write each ``(path, samples, sample_rate, options)`` of ``items`` as
    FLAC (``options``: keyword arguments of :func:`flac_encode`), the frames'
    CRC-16s computed for all files together."""
    encoded = [flac_encode(samples, sr, **opts) for _p, samples, sr, opts in items]
    crcs = iter(_crc16_many([fr for _h, frames in encoded for fr in frames]))
    for (path, *_rest), (head, frames) in zip(items, encoded):
        with open(path, "wb") as f:
            f.write(head)
            for fr in frames:
                f.write(fr + next(crcs).to_bytes(2, "big"))


# -- measurement helpers -----------------------------------------------------


def time_ms(fn, reps: int, device, calls: int = 1) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after one warm-up,
    each run ``calls`` calls back to back, divided by ``calls``: CUDA events
    on the card, the host clock elsewhere."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S):
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over ``flop_per_s`` (the float32 rate unless
    given); and which of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class CallRecorder:
    """Wraps a module-level function for one ``with`` block, calling
    through unchanged: records the arguments of every call (``all_args``;
    ``args`` the first, the first batch's real inputs, and ``last_args`` the
    last) and, on the card, a pair of CUDA events around every call, so
    :meth:`total_ms` gives the time between the events over all calls:
    the card's time in the call, and any time it waited on the host there."""

    def __init__(self, module, name, device):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.timed = device.type == "cuda"
        self.all_args = []
        self.events = []

    @property
    def calls(self):
        return len(self.all_args)

    @property
    def args(self):
        return self.all_args[0] if self.all_args else None

    @property
    def last_args(self):
        return self.all_args[-1] if self.all_args else None

    def __call__(self, *args, **kwargs):
        import torch

        self.all_args.append((args, kwargs))
        if not self.timed:
            return self.orig(*args, **kwargs)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.orig(*args, **kwargs)
        end.record()
        self.events.append((start, end))
        return out

    def total_ms(self):
        """Summed milliseconds of all calls (synchronises the card)."""
        for _, end in self.events:
            end.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def record_kernel_calls(device):
    """One :class:`CallRecorder` per kernel wrapper, under the kernel's
    name, at the module-level names the main path calls."""
    import montreal_forced_aligner_tpu_torch.align.aligner as aligner_mod
    import montreal_forced_aligner_tpu_torch.ops.viterbi as viterbi_mod

    return {
        "state_emission": CallRecorder(aligner_mod, "state_loglikes", device),
        "band_forward": CallRecorder(viterbi_mod, "band_forward", device),
        "band_backtrace": CallRecorder(viterbi_mod, "band_backtrace", device),
    }


def _frame_labels(aln, frame_shift):
    n = int(round(aln.phones[-1].end / frame_shift)) if aln.phones else 0
    labels = np.empty(n, dtype=object)
    starts = []
    for p in aln.phones:
        b, e = int(round(p.begin / frame_shift)), int(round(p.end / frame_shift))
        labels[b:e] = p.label
        starts.append(b)
    return labels, starts


def agreement(got, want, frame_shift):
    """Two alignments' agreement: frames with the same phone, boundaries
    within one frame, the largest score difference, and the utterances
    whose phone sequences are equal."""
    frames = mismatched = b_total = b_within = 0
    worst_score = 0.0
    for key, ref in want.items():
        lg, sg = _frame_labels(got[key], frame_shift)
        lr, sr = _frame_labels(ref, frame_shift)
        _check(len(lg) == len(lr), f"utterance {key}: frame counts differ")
        frames += len(lr)
        mismatched += int((lg != lr).sum())
        sg = np.asarray(sg)
        for s in sr:
            b_total += 1
            b_within += int(np.abs(sg - s).min() <= 1) if len(sg) else 0
        worst_score = max(
            worst_score, abs(got[key].log_likelihood - ref.log_likelihood)
        )
    return {
        "frames": frames,
        "frame_agreement": 1.0 - mismatched / max(frames, 1),
        "boundaries_within_1": b_within,
        "boundaries": b_total,
        "max_score_diff": worst_score,
        "same_phone_sequences": sum(
            [p.label for p in got[k].phones] == [p.label for p in a.phones]
            for k, a in want.items()),
    }


def parity(got, want, frame_shift):
    """The JAX package's parity bar (tests/test_parity_sweep.py): >= 99.9%
    of frames agree, >= 99.5% of boundaries within one frame, scores within
    5 nats."""
    out = agreement(got, want, frame_shift)
    _check(out["frame_agreement"] >= 0.999, f"frame agreement {out}")
    _check(out["boundaries_within_1"] >= 0.995 * out["boundaries"],
           f"boundaries {out}")
    _check(out["max_score_diff"] < 5.0, f"scores {out}")
    return out


def fmllr_summary(aligner):
    """The speakers over ``fmllr_min_count`` in the aligner's last two-pass
    run (at least one, or the run adapted nothing) and its transforms'
    largest deviation from the identity."""
    est = aligner.last_fmllr
    _check(est is not None, "the two-pass run left no fMLLR estimate")
    D = est.transforms.shape[1]
    ident = np.hstack([np.eye(D), np.zeros((D, 1))])
    over = int((est.beta >= aligner.config.fmllr_min_count).sum())
    _check(over >= 1, f"no speaker passed fmllr_min_count: beta {est.beta}")
    return {
        "speakers": int(len(est.beta)),
        "speakers_over_min_count": over,
        "min_count": aligner.config.fmllr_min_count,
        "beta": [float(b) for b in est.beta],
        "max_dev_from_identity": float(np.abs(est.transforms - ident).max()),
    }


def speaker_stats_invariance(model_path, dict_path, corpus_dir, device,
                             batch_sizes=(1, 8, 32)):
    """**speaker_stats_invariance**: a speaker's CMVN and fMLLR statistics,
    and each utterance's features, do not move with the batching. The
    first pass of sat-2pass at batch 32 fixes each utterance's features,
    frame pdfs and weights (the recorded inputs of
    ``accumulate_fmllr_stats``); those utterances, rebatched at each of
    ``batch_sizes`` (consecutive slices of the corpus order, each batch
    padded to its own longest utterance), give per-speaker float64 totals
    bit-identical to one utterance a batch, and so do the CMVN sums
    (``ops.feats.frame_sums``) of the batch-1 MFCC rows rebatched. Each
    batching's own MFCC rows and CMVN means, and its rows through the rest
    of the feature layer (``ops.tiles``: the final features' LDA, one fixed
    set of fMLLR transforms, the all-pdf log-likelihoods of the SAT-scale
    model), are bit-identical to batch 1's. Reported: each batching's
    synchronised seconds in the fMLLR statistics and in the feature
    layer's rows, and each quantity's largest difference from batch 1."""
    import torch

    import montreal_forced_aligner_tpu_torch.align.aligner as aligner_mod
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops.feats import (
        add_to_speakers,
        apply_per_speaker_transform,
        cmvn_means,
        frame_sums,
    )
    from montreal_forced_aligner_tpu_torch.ops.gmm_loglikes import gmm_loglikes
    from montreal_forced_aligner_tpu_torch.ops.mfcc import pad_waves_for_mfcc
    from montreal_forced_aligner_tpu_torch.ops.transforms import (
        accumulate_fmllr_stats,
        estimate_speaker_fmllr,
        stats_to_host,
        zero_fmllr_totals,
    )

    aligner = aligner_mod.PretrainedAligner(
        model_path, dict_path, aligner_mod.AlignerConfig(batch_size=32),
        device=device)
    corpus = Corpus.load(corpus_dir)
    rec = CallRecorder(aligner_mod, "accumulate_fmllr_stats", device)
    with rec:
        aligner.align_corpus(corpus)
    # each utterance's first-pass inputs, in corpus order
    utts = []
    for args, _kw in rec.all_args:
        ff, flens, pdf, spk, weight, *model, num_speakers = args
        for r, n in enumerate(flens):
            utts.append((ff[r, :n], pdf[r, :n], weight[r, :n], int(spk[r])))
    D = utts[0][0].shape[1]

    def rebatch(rows, bs):
        for lo in range(0, len(rows), bs):
            part = rows[lo : lo + bs]
            T = max(int(x[0].shape[0]) for x in part)
            out = [torch.zeros((len(part), T) + tuple(x.shape[1:]), dtype=x.dtype,
                               device=device) for x in part[0][:-1]]
            for r, row in enumerate(part):
                for o, x in zip(out, row[:-1]):
                    o[r, : x.shape[0]] = x
            yield out, [int(x[0].shape[0]) for x in part], [x[-1] for x in part]

    fmllr, seconds = {}, {}
    for bs in batch_sizes:
        totals = zero_fmllr_totals(num_speakers, D, device)
        _sync(device)
        t0 = time.perf_counter()
        for (ff, pdf, weight), flens, spk in rebatch(utts, bs):
            accumulate_fmllr_stats(ff, np.array(flens), pdf, spk, weight, *model,
                                   num_speakers, totals=totals)
        _sync(device)
        seconds[bs] = time.perf_counter() - t0
        fmllr[bs] = totals
    base = batch_sizes[0]
    for bs in batch_sizes[1:]:
        for a, b in zip(fmllr[bs], fmllr[base]):
            _check(torch.equal(a, b), f"fMLLR totals at batch {bs} differ from "
                   f"batch {base} by {(a - b).abs().max().item()}")
    transforms = {bs: estimate_speaker_fmllr(
        *stats_to_host(*t), min_count=aligner.config.fmllr_min_count)
        for bs, t in fmllr.items()}

    # CMVN: each batching's own MFCCs, and the batch-1 rows rebatched
    cfg = aligner.mfcc_config
    waves = corpus.load_audio_parallel(cfg.sample_rate)
    order = [int(i) for i in np.argsort([len(w) for w in waves], kind="stable")]
    spk_of = [corpus.speaker_index[corpus.utterances[i].speaker] for i in order]
    mfcc, means = {}, {}
    for bs in batch_sizes:
        rows, total = [], torch.zeros((num_speakers, cfg.num_coefficients),
                                      dtype=torch.float64, device=device)
        count = np.zeros(num_speakers)
        for lo in range(0, len(order), bs):
            wl = [waves[i] for i in order[lo : lo + bs]]
            L = aligner_mod._round_up(max(len(w) for w in wl), 16000)
            padded, lens = pad_waves_for_mfcc(wl, cfg, L)
            flens = np.array([cfg.num_frames(int(n)) for n in lens], np.int32)
            feats, sums = aligner_mod._mfcc_and_sums(
                torch.from_numpy(padded).to(device), torch.from_numpy(flens).to(device),
                cfg, cfg.num_frames(L))
            add_to_speakers(total, sums, spk_of[lo : lo + bs])
            np.add.at(count, spk_of[lo : lo + bs], flens.astype(np.float64))
            rows += [feats[r, :n] for r, n in enumerate(flens)]
        mfcc[bs] = rows
        means[bs] = cmvn_means(total, torch.from_numpy(count).to(device))
    sums = {}
    for bs in batch_sizes:
        parts = [frame_sums(x, torch.tensor(flens, device=device))
                 for (x,), flens, _s in rebatch([(x, 0) for x in mfcc[base]], bs)]
        sums[bs] = torch.cat(parts)
        _check(torch.equal(sums[bs], sums[base]),
               f"CMVN sums of the same MFCC rows at batch {bs} differ from batch "
               f"{base}")

    # each batching's MFCC rows through the final features (CMVN by its own
    # means, splice, LDA), the base batching's transforms and all pdfs
    gmm = aligner.gmm
    fixed = torch.from_numpy(transforms[base]).to(device, torch.float32)

    def layer_rows(bs):
        for (x,), flens, spk in rebatch(list(zip(mfcc[bs], spk_of)), bs):
            spk_t = torch.tensor(spk, device=device)
            ff = aligner_mod._final_feats(x, torch.tensor(flens, device=device),
                                          means[bs][spk_t], gmm.lda)
            fm = apply_per_speaker_transform(ff, spk_t, fixed)
            ll = gmm_loglikes(fm, gmm.W, gmm.gconsts)
            for r, n in enumerate(flens):
                yield ff[r, :n], fm[r, :n], ll[r, :n]

    layers = ("lda_rows", "fmllr_rows", "all_pdf_loglike_rows")
    _sync(device)
    t0 = time.perf_counter()
    base_rows = list(layer_rows(base))
    _sync(device)
    layer_s = {str(base): time.perf_counter() - t0}
    diffs = {name: {} for name in ("mfcc_rows", "cmvn_means") + layers}
    for bs in batch_sizes[1:]:
        worst = dict.fromkeys(layers, 0.0)
        t0 = time.perf_counter()
        for got, want in zip(layer_rows(bs), base_rows):
            for name, a, b in zip(layers, got, want):
                worst[name] = max(worst[name], float((a - b).abs().max()))
        _sync(device)
        layer_s[str(bs)] = time.perf_counter() - t0
        worst["mfcc_rows"] = max(float((a - b).abs().max())
                                 for a, b in zip(mfcc[bs], mfcc[base]))
        worst["cmvn_means"] = float((means[bs] - means[base]).abs().max())
        for name, v in worst.items():
            diffs[name][str(bs)] = v
            _check(v == 0.0, f"{name} at batch {bs} differ from batch {base} by {v}")
    return {
        "utterances": len(utts), "speakers": num_speakers,
        "batch_sizes": list(batch_sizes), "fmllr_totals_bit_identical": True,
        "cmvn_sums_bit_identical": True,
        "feature_rows_bit_identical": True,
        "fmllr_stats_synced_s": {str(bs): v for bs, v in seconds.items()},
        "feature_rows_synced_s": layer_s,
        "transforms_max_abs_diff": {
            str(bs): float(np.abs(transforms[bs] - transforms[base]).max())
            for bs in batch_sizes[1:]},
        **{f"{name}_max_abs_diff": v for name, v in diffs.items()},
    }


# -- phases ------------------------------------------------------------------


def run_main_path(model_path, dict_path, corpus_dir, out_dir, device,
                  batch_size=32, warm_runs=5, adaptation=True):
    """One counted run of a main path (``adaptation``: the fMLLR two-pass,
    else speaker-independent single-pass), then ``warm_runs`` warm runs
    (their median gives the throughput), then one with the card
    synchronised at each phase. The kernel wrappers' calls are timed in the
    counted run and in the first warm run. Returns (report, aligner, the
    counted run's :class:`CallRecorder` by kernel)."""
    import contextlib

    import torch

    import montreal_forced_aligner_tpu_torch.align.aligner as aligner_mod
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    aligner = aligner_mod.PretrainedAligner(
        model_path, dict_path,
        aligner_mod.AlignerConfig(batch_size=batch_size,
                                  uses_speaker_adaptation=adaptation),
        device=device,
    )
    setup_s = time.perf_counter() - t0
    _check(aligner.two_pass == adaptation, "two-pass wiring")
    corpus = Corpus.load(corpus_dir)
    audio_s = sum(
        len(w) / aligner.mfcc_config.sample_rate
        for w in corpus.load_audio_parallel(aligner.mfcc_config.sample_rate)
    )
    counted = record_kernel_calls(device)
    stats_calls = CallRecorder(aligner_mod, "accumulate_fmllr_stats", device)
    with contextlib.ExitStack() as stack:
        for rec in (*counted.values(), stats_calls):
            stack.enter_context(rec)
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        results = aligner.align_corpus(corpus)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    phases = dict(aligner.last_phase_seconds)
    paths = aligner.export_textgrids(corpus, results, out_dir)

    _check(len(results) == corpus.num_utterances,
           f"{len(results)} of {corpus.num_utterances} utterances aligned")
    for key, aln in results.items():
        _check(aln.words and aln.phones, f"utterance {key}: empty alignment")
        _check(np.isfinite(aln.log_likelihood) and aln.log_likelihood > -1e29,
               f"utterance {key}: score {aln.log_likelihood}")
    _check(len(paths) == len(corpus.files), "TextGrid count")
    for p in paths:
        _check(p.stat().st_size > 0, f"empty TextGrid {p}")
    n_batches = -(-corpus.num_utterances // batch_size)
    per_kernel = n_batches * (2 if adaptation else 1)
    if device.type == "cuda":
        for name, n in launches.items():
            _check(n == per_kernel,
                   f"kernel {name}: {n} launches on the main path, not {per_kernel}")
    fmllr = None
    if adaptation:
        fmllr = fmllr_summary(aligner)
        _check(stats_calls.calls == n_batches, "one fMLLR accumulation a batch")
        if device.type == "cuda":
            # the card's busy time in each batch's statistics, on its own
            fmllr["stats_device_ms"] = [
                device_busy_ms(lambda a=a: stats_calls.orig(*a[0], **a[1]))
                for a in stats_calls.all_args]
    del stats_calls

    # warm: CUDA context, cuFFT plans, kernel libraries and the graph
    # compiler's caches are in place from the first run
    warm_walls = []
    warm = record_kernel_calls(device)
    for i in range(warm_runs):
        with contextlib.ExitStack() as stack:
            if i == 0:
                for rec in warm.values():
                    stack.enter_context(rec)
            t0 = time.perf_counter()
            aligner.align_corpus(corpus)
            if device.type == "cuda":
                torch.cuda.synchronize()
            warm_walls.append(time.perf_counter() - t0)
    warm_wall = statistics.median(warm_walls)
    aligner.sync_phases = True
    t0 = time.perf_counter()
    aligner.align_corpus(corpus)
    synced_wall = time.perf_counter() - t0
    synced = dict(aligner.last_phase_seconds)
    aligner.sync_phases = False
    report = {
        "path": "sat-2pass" if adaptation else "sat-si",
        "utterances": corpus.num_utterances,
        "audio_s": audio_s,
        "batches": n_batches,
        "setup_s": setup_s,
        "wall_s": wall,
        "audio_s_per_s": audio_s / wall,
        "peak_memory_bytes": peak,
        "launches": launches,
        "kernel_calls": {k: r.calls for k, r in counted.items()},
        "kernel_ms": {k: r.total_ms() for k, r in counted.items()},
        "warm_kernel_ms": {k: r.total_ms() for k, r in warm.items()},
        "phases_dispatch_s": phases,
        "warm_walls_s": warm_walls,
        "warm_median_wall_s": warm_wall,
        "warm_audio_s_per_s": audio_s / warm_wall,
        "synced_wall_s": synced_wall,
        "phases_synced_s": synced,
        "textgrids": len(paths),
        "fmllr": fmllr,
    }
    return report, aligner, counted


def batch_inputs(counted, first_call: int):
    """The recorded inputs of one batch's kernel calls (call ``first_call``
    of each wrapper), with K2's last call beside them under
    ``band_backtrace_last``."""
    out = {k: r.all_args[first_call] for k, r in counted.items()}
    out["band_backtrace_last"] = counted["band_backtrace"].last_args
    return out


def busy_seconds(prof):
    """Seconds in the union of the card's busy intervals (its kernels and
    copies) that a ``torch.profiler`` run saw. Read from the profiler's raw
    events: building its event tree (``prof.events()``) took 44-92 s of
    host time for transcribe-dense's profiled run on an H100 machine."""
    import torch

    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA)
    _check(spans, "the profiler saw no work on the card")
    busy, (cur_start, cur_end) = 0, spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return (busy + cur_end - cur_start) / 1e9


# the symbols of the port's kernels, as the profiler names them
KERNEL_SYMBOLS = {
    "band_forward": "band_forward_kernel",
    "band_backtrace": "band_backtrace_kernel",
    "state_emission": "state_emission_kernel",
}


def profile_warm_run(aligner, corpus_dir, top=8):
    """One more warm run under ``torch.profiler``: the union of the card's
    busy intervals against the wall time (the device's busy share), the
    card's time by kernel name, and each port kernel's summed device time
    under its own symbol."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    corpus = Corpus.load(corpus_dir)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        aligner.align_corpus(corpus)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_seconds(prof)
    by_name = {}
    by_kernel = {k: 0.0 for k in KERNEL_SYMBOLS}
    for e in events:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        name = e.name.split("(")[0][:60]
        by_name[name] = by_name.get(name, 0.0) + ms
        for k, sym in KERNEL_SYMBOLS.items():
            if sym in e.name:
                by_kernel[k] += ms
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_s": wall,
        "device_busy_s": busy,
        "device_busy_share": busy / wall,
        "device_ms_by_kernel": dict(ranked),
        "device_ms_by_port_kernel": by_kernel,
    }


def reference_check(model_path, dict_path, corpus_dir, device, adaptation=False):
    """The card's alignment of a small corpus against the plain PyTorch
    path on the CPU; with ``adaptation`` the two-pass, whose transforms are
    compared too."""
    import torch

    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    cfg = AlignerConfig(batch_size=4, uses_speaker_adaptation=adaptation)
    got = PretrainedAligner(model_path, dict_path, cfg, device=device)
    want = PretrainedAligner(model_path, dict_path, cfg,
                             device=torch.device("cpu"))
    r_got = got.align_corpus(Corpus.load(corpus_dir))
    r_want = want.align_corpus(Corpus.load(corpus_dir))
    out = parity(r_got, r_want, got.frame_shift)
    if adaptation:
        out["fmllr"] = fmllr_summary(got)
        out["transforms_max_abs_diff"] = float(np.abs(
            got.last_fmllr.transforms - want.last_fmllr.transforms).max())
    return out


def k3_work(feats, state_pdf, G, d2p):
    """K3's (bytes, operations): each input and the (B, T, S) output once,
    and the 3xTF32 products (three tensor-core products per multiply-add),
    for ``bound_ms(..., TF32_FLOP_PER_S)``."""
    import torch

    B, T, Df = feats.shape
    S = state_pdf.shape[1]
    n_pdfs_used = int(torch.unique(state_pdf).numel())
    nbytes = (feats.numel() * 4 + state_pdf.numel() * 4
              + n_pdfs_used * G * d2p * 4 + B * T * S * 4)
    return nbytes, 3 * 2.0 * B * T * S * G * (2 * Df + 2)


def k1_bound(flens, B, S, D):
    """K1's least time: emissions of the real frames, band, start, frame
    counts read once, alpha_T and a backpointer byte per real step written
    once; 2D + 2 operations per state and step."""
    import torch

    steps = int(torch.clamp(flens.long() - 1, min=0).sum().item())
    frames = int(flens.long().sum().item())
    nbytes = (frames * S * 4 + B * S * D * 4 + B * S * 4 + B * 4
              + B * S * 4 + steps * S)
    return bound_ms(nbytes, float(steps) * S * (2 * D + 2))


def k2_bound(flens, T, B):
    """K2's least time: a backpointer byte per step, best states and frame
    counts read once, the (B, T) states written once. Returns (bound, by,
    the longest row's steps)."""
    import torch

    row_steps = torch.clamp(torch.clamp(flens.long(), max=T) - 1, min=0)
    steps = int(row_steps.sum().item())
    return (*bound_ms(steps * 1 + B * 4 * 2 + B * T * 4, 0.0),
            int(row_steps.max().item()))


def k3_term_scale(feats, state_pdf, rows, chunk=128):
    """(B, T, S): for each emission, the largest over the state's real
    Gaussians of sum_k |xx_k * row_k|, the magnitude of the terms of its dot
    product before they cancel (a float32 dot product of either kind errs
    by at most a fixed share of it)."""
    import torch

    from montreal_forced_aligner_tpu_torch.ops import cuda_emission as CE

    B, T, D = feats.shape
    S = state_pdf.shape[1]
    xx = CE.quad_features(feats, rows.shape[2]).abs()[:, None]  # (B, 1, T, D2p)
    # padded Gaussians (gconst NEG_INF) take no part in the sum
    real = (rows[:, :, 2 * D] > CE.NEG_INF / 2)[..., None]
    rows = torch.where(real, rows.abs(), 0.0)
    out = torch.empty((B, T, S), dtype=torch.float32, device=feats.device)
    for s0 in range(0, S, chunk):
        r = rows[state_pdf[:, s0 : s0 + chunk].long()]  # (B, c, G, D2p)
        q = torch.matmul(xx, r.permute(0, 2, 3, 1))  # (B, G, T, c)
        out[:, :, s0 : s0 + chunk] = q.amax(dim=1)
    return out


def k3_float64_rtol(d2p: int) -> float:
    """Share of :func:`k3_term_scale` by which K3 may miss the exact (float64)
    emission: 3 * 2^-22 for the 3xTF32 split (each product misses
    lo(a)*lo(b), and each operand's hi + lo misses it by up to 2^-22), 2^-24
    for x*x rounded to float32 before the split, and 2^-23 for each of the
    3 * d2p / 8 tensor-core steps that add into one accumulator (a step's
    float32 sum truncates, so these errors add up rather than cancel)."""
    return 3 * 2.0 ** -22 + 2.0 ** -24 + 3 * (d2p // 8) * 2.0 ** -23


def k3_term_rtol(d2p: int) -> float:
    """Share of :func:`k3_term_scale` by which K3 and its plain version may
    differ: K3's own (:func:`k3_float64_rtol`) and the plain float32 dot
    product's, (d2p + 1) * 2^-24 (the classical n * u of its d2p terms and
    x*x's rounding)."""
    return k3_float64_rtol(d2p) + (d2p + 1) * 2.0 ** -24


def k3_float64_check(got, want, feats, state_pdf, rows, scale, chunk=256):
    """K3 (``got``) and its plain version (``want``) against the emissions
    computed in float64, over every state in chunks of ``chunk``: K3 must
    come within 1e-3 + 1e-5 |exact| + :func:`k3_float64_rtol` times
    ``scale`` (:func:`k3_term_scale`) of exact. Returns each one's largest
    error, largest error as a share of ``scale``, and K3's largest share of
    its bar."""
    from montreal_forced_aligner_tpu_torch.ops import cuda_emission as CE

    rtol = k3_float64_rtol(rows.shape[2])
    feats64, rows64 = feats.double(), rows.double()
    out = {"states": int(state_pdf.shape[1]), "rtol": rtol,
           "kernel_max_abs_err": 0.0, "plain_max_abs_err": 0.0,
           "kernel_max_err_share_of_scale": 0.0,
           "plain_max_err_share_of_scale": 0.0, "kernel_worst_share_of_bar": 0.0}
    for s0 in range(0, state_pdf.shape[1], chunk):
        sl = slice(s0, s0 + chunk)
        exact = CE.state_loglikes_plain(feats64, state_pdf[:, sl].contiguous(), rows64)
        sc = scale[:, :, sl].double().clamp(min=1e-30)
        for name, val in (("kernel", got), ("plain", want)):
            err = (val[:, :, sl].double() - exact).abs()
            out[f"{name}_max_abs_err"] = max(out[f"{name}_max_abs_err"],
                                             err.max().item())
            out[f"{name}_max_err_share_of_scale"] = max(
                out[f"{name}_max_err_share_of_scale"], (err / sc).max().item())
            if name == "kernel":
                bar = 1e-3 + 1e-5 * exact.abs() + rtol * sc
                out["kernel_worst_share_of_bar"] = max(
                    out["kernel_worst_share_of_bar"], (err / bar).max().item())
        del exact, sc, err, bar
    _check(out["kernel_worst_share_of_bar"] <= 1.0,
           f"K3 is further from the float64 emissions than its bar: {out}")
    return out


def k3_check(call, gmm, device, reps=5, term_bound=False):
    """K3 against its plain version on one recorded call, with its times,
    bound and yardsticks. The bar is 1e-3 + 1e-5 |plain|; with
    ``term_bound``, plus :func:`k3_term_rtol` times :func:`k3_term_scale`,
    for a trained model whose terms cancel (narrow Gaussians: two float32
    dot products differ there by a share of the terms, not of the result),
    and K3 is also held against a float64 product (:func:`k3_float64_check`)."""
    import torch

    from montreal_forced_aligner_tpu_torch.ops import cuda_emission as CE
    from montreal_forced_aligner_tpu_torch.ops.gmm_loglikes import (
        gmm_loglikes,
        select_state_emissions,
    )

    (feats, state_pdf, rows, rows_split), _ = call
    B, T, Df = feats.shape
    S = state_pdf.shape[1]
    P, G, d2p = rows.shape
    got = CE.state_loglikes(feats, state_pdf, rows, rows_split)
    want = CE.state_loglikes_plain(feats, state_pdf, rows)
    err = (got - want).abs()
    _check(bool(torch.isfinite(got).all()), "K3: non-finite emissions")
    bar = 1e-3 + 1e-5 * want.abs()
    over_fixed_bar = float((err > bar).float().mean().item())
    term_scale_max = term_rtol = f64 = None
    if term_bound:
        scale = k3_term_scale(feats, state_pdf, rows)
        term_scale_max = float(scale.max().item())
        term_rtol = k3_term_rtol(d2p)
        bar = bar + term_rtol * scale
        f64 = k3_float64_check(got, want, feats, state_pdf, rows, scale)
        del scale
    ok = bool((err <= bar).all())
    _check(ok, f"K3 disagrees with its plain version: max abs {err.max().item()}")
    worst_share = (err / bar).max().item()

    def library():
        # the all-pdf product and a gather, in row chunks that fit memory
        for b in range(B):
            ll = gmm_loglikes(feats[b : b + 1], gmm.W, gmm.gconsts)
            select_state_emissions(ll, state_pdf[b : b + 1])

    xx = CE.quad_features(feats, d2p)[:, None]  # (B, 1, T, D2p)
    gathered_out = torch.empty_like(want)

    def gathered(chunk=128):
        # each state's own rows, gathered, through one float32 matmul per
        # chunk of states (TF32 off) and a logsumexp over Gaussians
        for s0 in range(0, S, chunk):
            r = rows[state_pdf[:, s0 : s0 + chunk].long()]  # (B, c, G, D2p)
            q = torch.matmul(xx, r.permute(0, 2, 3, 1))  # (B, G, T, c)
            gathered_out[:, :, s0 : s0 + chunk] = torch.logsumexp(q, dim=1)

    torch.backends.cuda.matmul.allow_tf32 = False
    gathered()
    g_err = (gathered_out - want).abs()
    _check(bool((g_err <= bar).all()),
           f"K3 gathered yardstick differs by {g_err.max().item()}")
    g_err = g_err.max().item()

    nbytes, flops = k3_work(feats, state_pdf, G, d2p)
    bnd, by = bound_ms(nbytes, flops, TF32_FLOP_PER_S)
    out = {
        "shape": {"B": B, "T": T, "S": S, "P": P, "G": G, "D": Df},
        "max_abs_err": err.max().item(),
        "worst_err_share_of_bar": worst_share,
        "bar_term_rtol": term_rtol,
        "term_scale_max": term_scale_max,
        "share_over_fixed_bar": over_fixed_bar,
        "against_float64": f64,
        "ms": time_ms(lambda: CE.state_loglikes(feats, state_pdf, rows, rows_split),
                      reps, device),
        "plain_ms": time_ms(lambda: CE.state_loglikes_plain(feats, state_pdf, rows),
                            3, device),
        "bound_ms": bnd,
        "bound_by": by,
        "fp32_cuda_core_bound_ms": bound_ms(nbytes, flops / 3)[0],
        "library_ms": time_ms(library, 3, device),
        "gathered_matmul_ms": time_ms(gathered, 3, device),
        "gathered_max_abs_err": g_err,
    }
    del got, want, err, bar, xx, gathered_out
    return out


def kernel_checks(captured, gmm, device, reps=5, sm_clock_mhz=None,
                  k3_term_bound=False, k1_plain_reps=3):
    """Each kernel against its plain version on one batch's recorded
    inputs (:func:`batch_inputs`), with times and bounds; K2 also on the
    last batch's, with the chain floor at ``sm_clock_mhz`` (none without
    it). K3 (:func:`k3_check`, ``k3_term_bound`` its ``term_bound``) only
    where it was recorded. K1's plain version, a loop over frames, is timed
    over ``k1_plain_reps`` runs after a warm-up, or with 0 on the check's
    own call alone (it takes seconds at a wide band)."""
    import torch

    from montreal_forced_aligner_tpu_torch.ops import cuda_viterbi as CV

    out = {}
    if captured.get("state_emission") is not None:
        out["state_emission"] = k3_check(captured["state_emission"], gmm, device,
                                         reps, k3_term_bound)

    # K1: band forward
    (emit, flens, band, start, lb, ub, scale), _ = captured["band_forward"]
    B, T, S = emit.shape
    D = lb + ub + 1
    aT_k, bp_k = CV.band_forward(emit, flens, band, start, lb, ub, scale)
    _sync(device)
    t0 = time.perf_counter()
    aT_p, bp_p = CV.band_forward_plain(emit, flens, band, start, lb, ub, scale)
    _sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    if k1_plain_reps:
        plain_ms = time_ms(lambda: CV.band_forward_plain(
            emit, flens, band, start, lb, ub, scale), k1_plain_reps, device)
    within = torch.arange(T, device=emit.device)[:, None] < flens[None, :]
    within[0] = False
    _check(torch.equal(bp_k[within], bp_p[within]),
           "K1 backpointers differ from the plain version")
    a_err = (aT_k - aT_p).abs().max().item()
    _check(a_err <= 1e-4, f"K1 alpha_T differs by {a_err}")
    bnd, by = k1_bound(flens, B, S, D)
    out["band_forward"] = {
        "shape": {"B": B, "T": T, "S": S, "lb": lb, "ub": ub},
        "max_abs_err": a_err,
        "ms": time_ms(lambda: CV.band_forward(emit, flens, band, start, lb, ub,
                                              scale), reps, device),
        "plain_ms": plain_ms,
        "plain_calls_timed": k1_plain_reps or 1,
        "bound_ms": bnd,
        "bound_by": by,
        "library_ms": None,
    }

    # K2: band backtrace, on the main path's own backpointers of the first
    # batch and of the last (the longer half, S > 1024)
    def backtrace_check(call):
        (bp, flens2, best, lb2), _ = call
        st_k = CV.band_backtrace(bp, flens2, best, lb2)
        st_p = CV.band_backtrace_plain(bp, flens2, best, lb2)
        _check(torch.equal(st_k, st_p), "K2 states differ from the plain version")
        T2, B2, S2 = bp.shape
        bnd, by, longest = k2_bound(flens2, T2, B2)
        # reckoned, not measured: the longest row's chain of dependent
        # shared-memory loads at the card's highest SM clock
        chain_floor = (longest * SMEM_LOAD_CYCLES / (sm_clock_mhz * 1e3)
                       if sm_clock_mhz else None)
        return {
            "shape": {"B": B2, "T": T2, "S": S2},
            "plan": CV.band_backtrace_plan(S2)._asdict(),
            "max_abs_err": float((st_k - st_p).abs().max().item()),
            # one launch, timed as K1's and K3's are; K2 takes tens of
            # microseconds, about what the host takes to launch it, so the
            # mean of 20 launches back to back is a second reading beside it
            "ms": time_ms(lambda: CV.band_backtrace(bp, flens2, best, lb2), reps,
                          device),
            "back_to_back_ms": time_ms(
                lambda: CV.band_backtrace(bp, flens2, best, lb2), reps, device,
                calls=20),
            "plain_ms": time_ms(lambda: CV.band_backtrace_plain(
                bp, flens2, best, lb2), 3, device),
            "bound_ms": bnd,
            "bound_by": by,
            "chain_floor_ms": chain_floor,
            "chain_floor_ms_is": "reckoned",
        }

    out["band_backtrace"] = {
        **backtrace_check(captured["band_backtrace"]),
        "library_ms": None,
        "last_batch": backtrace_check(captured["band_backtrace_last"]),
    }
    return out


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def long_utterance_phase(aligner, corpus_dir, device, reps=3):
    """A corpus of one long utterance through ``align_corpus`` (over
    ``LONG_UTTERANCE_FRAMES``, so the single-utterance path, two-pass for a
    SAT model); then, on the final pass's features, ``viterbi_align_long``
    sweep by sweep against one whole-utterance emit and align (identical
    state path, score within 1e-3), the path's launches counted exactly, and
    K3, K1 and K2 on the last chunk (frames from the one before it, emission
    row 0 zeroed, started from its checkpoint) against their plain versions
    (K3 rtol 1e-5 / atol 1e-3, K1 and K2 bit-identical)."""
    import torch

    import montreal_forced_aligner_tpu_torch.online.alignment as online_mod
    from montreal_forced_aligner_tpu_torch.align.aligner import _emit_and_align
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.ops import long_viterbi as LV

    corpus = Corpus.load(corpus_dir)
    _check(corpus.num_utterances == 1, "one long utterance")
    rec = CallRecorder(online_mod, "viterbi_align_long", device)
    with rec:
        _sync(device)
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        results = aligner.align_corpus(corpus)
        _sync(device)
        wall = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
    (aln,) = results.values()
    _check(aln.words and np.isfinite(aln.log_likelihood)
           and aln.log_likelihood > -1e29, "long utterance: empty alignment")
    _check(rec.calls == (2 if aligner.two_pass else 1),
           f"long utterance: {rec.calls} chunked decodes")
    out = {
        "align_corpus_s": wall,
        "phases_s": dict(aligner.last_phase_seconds),
        "launches": launches,
        "words": len(aln.words),
        "fmllr": fmllr_summary(aligner) if aligner.two_pass else None,
    }

    (feats, garrs, gmm), kw = rec.last_args  # the final pass
    scale, use_k = kw["acoustic_scale"], kw["use_emission_kernel"]
    chunk = kw.get("chunk") or LV.CHUNK_FRAMES
    T = feats.shape[0]
    lg = LV.prepare_long_graph(garrs, feats.device)
    _check(lg.band_limits is not None, "long graph outside the band buckets")
    lb, ub = lg.band_limits
    S = int(lg.graph.state_pdf.shape[1])
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    checkpoints, best, score = LV.long_forward_sweep(feats, lg, gmm, scale, chunk,
                                                     use_k)
    _sync(device)
    fwd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    path = LV.long_backward_sweep(feats, lg, gmm, scale, chunk, use_k,
                                  checkpoints, best)
    _sync(device)
    bwd_s = time.perf_counter() - t0
    chunked_peak = (torch.cuda.max_memory_allocated() / 2**30
                    if device.type == "cuda" else None)
    t0 = time.perf_counter()
    flens = torch.tensor([T], dtype=torch.int32, device=feats.device)
    whole_path, whole_score = _emit_and_align(
        feats[None], flens, lg.graph, gmm, scale, band_limits=lg.band_limits,
        use_emission_kernel=use_k,
    )
    _sync(device)
    whole_s = time.perf_counter() - t0
    whole_peak = (torch.cuda.max_memory_allocated() / 2**30
                  if device.type == "cuda" else None)
    _check(torch.equal(path, whole_path[0]),
           "viterbi_align_long: state path differs from the whole-utterance run")
    score_diff = abs(float(score[0]) - float(whole_score[0]))
    _check(score_diff <= 1e-3, f"viterbi_align_long: score differs by {score_diff}")
    del whole_path
    out.update({
        "T": T, "S": S, "band": [lb, ub], "chunk": chunk,
        "chunks": len(checkpoints), "forward_sweep_s": fwd_s,
        "backward_sweep_s": bwd_s, "whole_run_s": whole_s,
        "score": float(score[0]), "score_diff": score_diff,
        "paths_identical": True, "chunked_peak_gib": chunked_peak,
        "whole_run_peak_gib": whole_peak,
    })

    # the path's launches: each pass, every chunk through K3 and K1 in both
    # sweeps and through K2 in the backward one (none on the CPU, where every
    # wrapper takes its plain version)
    per_pass = (len(checkpoints) if device.type == "cuda" else 0) * (
        2 if aligner.two_pass else 1)
    want_launches = {"band_forward": 2 * per_pass, "band_backtrace": per_pass,
                     "state_emission": 2 * per_pass}
    _check(use_k, "long utterance: the final model does not take K3")
    _check(launches == want_launches,
           f"long utterance: launches {launches}, expected {want_launches}")

    out["last_chunk"] = last_chunk_checks(feats, lg, gmm, scale, chunk, use_k,
                                          checkpoints, best, path, reps, device)
    return out


def last_chunk_checks(feats, lg, gmm, scale, chunk, use_k, checkpoints, best, path,
                      reps, device):
    """K3, K1 and K2 on the last chunk of a long utterance's final pass
    (frames from the one before it, emission row 0 zeroed, started from its
    checkpoint) against their plain versions: K3 rtol 1e-5 / atol 1e-3, K1
    and K2 bit-identical, K2's walk equal to the sweep's ``path``; each
    timed, with its bound."""
    import torch

    from montreal_forced_aligner_tpu_torch.ops import cuda_emission as CE
    from montreal_forced_aligner_tpu_torch.ops import cuda_viterbi as CV
    from montreal_forced_aligner_tpu_torch.ops import long_viterbi as LV

    T = feats.shape[0]
    lb, ub = lg.band_limits
    S = int(lg.graph.state_pdf.shape[1])
    c = len(checkpoints) - 1
    lo = c * chunk
    emit = LV.chunk_emissions(feats, lo, T, lg.graph.state_pdf, gmm, use_k,
                              lead_row=c > 0)
    f = feats[lo - 1 if c > 0 else lo :][None].contiguous()
    want = CE.state_loglikes_plain(f, lg.graph.state_pdf, gmm.rows)
    if c > 0:
        want[:, 0] = 0.0
    _check(bool(torch.isfinite(emit).all()), "long chunk: K3 non-finite emissions")
    k3_err = (emit - want).abs()
    _check(bool((k3_err <= 1e-3 + 1e-5 * want.abs()).all()),
           f"long chunk: K3 differs from its plain version by {k3_err.max().item()}")
    k3_err = k3_err.max().item()
    del want
    n = torch.tensor([emit.shape[1]], dtype=torch.int32, device=feats.device)
    start = checkpoints[c]
    aT_k, bp_k = CV.band_forward(emit, n, lg.band, start, lb, ub, scale)
    aT_p, bp_p = CV.band_forward_plain(emit, n, lg.band, start, lb, ub, scale)
    _check(torch.equal(bp_k[1:], bp_p[1:]), "long chunk: K1 backpointers differ")
    _check(torch.equal(aT_k, aT_p), "long chunk: K1 alpha differs")
    k1_err = (aT_k - aT_p).abs().max().item()
    st_k = CV.band_backtrace(bp_k, n, best, lb)
    st_p = CV.band_backtrace_plain(bp_p, n, best, lb)
    _check(torch.equal(st_k, st_p), "long chunk: K2 states differ")
    _check(torch.equal(st_k[0, 1:], path[lo:]), "long chunk: walk differs from the sweep")
    k2_err = float((st_k - st_p).abs().max().item())
    k3 = bound_ms(*k3_work(f, lg.graph.state_pdf, gmm.num_gauss, gmm.rows.shape[2]),
                  TF32_FLOP_PER_S)
    k1 = k1_bound(n, 1, S, lb + ub + 1)
    k2 = k2_bound(n, int(n[0]), 1)[:2]
    return {
        "frames": int(emit.shape[1]), "S": S,
        "state_emission_bound_ms": k3[0], "state_emission_bound_by": k3[1],
        "band_forward_bound_ms": k1[0], "band_forward_bound_by": k1[1],
        "band_backtrace_bound_ms": k2[0], "band_backtrace_bound_by": k2[1],
        "state_emission_ms": time_ms(lambda: LV.chunk_emissions(
            feats, lo, T, lg.graph.state_pdf, gmm, use_k, lead_row=c > 0),
            reps, device),
        "state_emission_plain_ms": time_ms(lambda: CE.state_loglikes_plain(
            f, lg.graph.state_pdf, gmm.rows), 1, device),
        "band_forward_ms": time_ms(lambda: CV.band_forward(
            emit, n, lg.band, start, lb, ub, scale), reps, device),
        "band_forward_plain_ms": time_ms(lambda: CV.band_forward_plain(
            emit, n, lg.band, start, lb, ub, scale), 1, device),
        "band_backtrace_ms": time_ms(lambda: CV.band_backtrace(bp_k, n, best, lb),
                                     reps, device),
        "band_backtrace_plain_ms": time_ms(lambda: CV.band_backtrace_plain(
            bp_p, n, best, lb), 1, device),
        "state_emission_max_abs_err": k3_err,
        "band_forward_max_abs_err": k1_err,
        "band_backtrace_max_abs_err": k2_err,
    }


def device_busy_ms(fn):
    """The card's busy milliseconds (union of its kernels' and copies'
    intervals) in one call of ``fn`` under ``torch.profiler``, after one
    warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return busy_seconds(prof) * 1e3


def native_solve_check(aligner):
    """The native fMLLR solve against its numpy sweep on the speakers over
    ``fmllr_min_count`` of the aligner's last two-pass run (atol 2e-4, the
    JAX package's bar for its native solver), each timed once on the
    host."""
    from montreal_forced_aligner_tpu_torch.ops import transforms as TR

    est = aligner.last_fmllr
    ok = est.beta >= aligner.config.fmllr_min_count
    K, G, beta = est.K[ok], est.G[ok], est.beta[ok]
    t0 = time.perf_counter()
    native = TR.solve_fmllr_batched(K, G, beta)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = TR._solve_fmllr_batched_numpy(K, G, beta)
    numpy_s = time.perf_counter() - t0
    err = float(np.abs(native - plain).max())
    _check(err <= 2e-4, f"native fMLLR solve differs from numpy by {err}")
    _check(np.array_equal(native, est.transforms[ok]),
           "the run's transforms are not the native solve's")
    return {"speakers": int(ok.sum()), "max_abs_err": err,
            "native_s": native_s, "numpy_s": numpy_s}


# -- training phases -----------------------------------------------------------


def profiled_run(fn, device):
    """One call of ``fn`` under ``torch.profiler``, tracing the card only:
    its wall seconds and the union of the card's busy intervals (the
    device's busy share)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = time.perf_counter() - t0
    busy = busy_seconds(prof)
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall}


def _loglikes(trainer):
    return [e["loglike_per_frame"] for e in trainer.iteration_log]


def train_mono_phase(corpus_dir, dict_path, audio_s, device, warm_runs=3,
                     batch_size=32, sm_clock_mhz=None, keep=None):
    """``bench.py``'s train workload through ``TrainableAligner``: one
    counted cold run, ``warm_runs`` warm runs (throughput: audio seconds
    over their median wall), one synchronised run for the phase seconds and
    one profiled run for the busy share. K1 and K2 are recorded in the cold
    run and held against their plain versions on the equal alignment's
    first and last batch and on the first realignment's. Returns (report,
    those checks by alignment); a ``keep`` dict gets the cold run's trainer
    and corpus."""
    import contextlib

    from montreal_forced_aligner_tpu_torch.align.aligner import (
        _emission_kernel_eligible,
    )
    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    iterations = 4

    def make():
        return TrainableAligner(
            corpus_dir, dict_path,
            recipe=[StageConfig("monophone", "mono", iterations, 64)],
            batch_size=batch_size, variable_length_topology=False, device=device,
        )

    ta = make()
    recs = record_kernel_calls(device)
    with contextlib.ExitStack() as stack:
        for r in recs.values():
            stack.enter_context(r)
        _sync(device)
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        ta.train()
        _sync(device)
        cold = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
    trainer = ta.trainers["monophone"]
    if keep is not None:
        keep.update(trainer=trainer, corpus=ta.corpus)
    batches = ta.pipeline.batches
    banded = sum(fb.band_limits is not None for fb in batches)
    realigns = [i for i in trainer.realignment_iterations if i <= iterations]
    alignments = 1 + len(realigns)  # the equal alignment, then the schedule's
    gmm = trainer._mirror.align_gmm()
    use_k = _emission_kernel_eligible(*gmm.params.gconsts.shape)
    # on the CPU every wrapper takes its plain version: no launches
    on_card = device.type == "cuda"
    want = {"band_forward": banded * alignments * on_card,
            "band_backtrace": banded * alignments * on_card,
            "state_emission": banded * len(realigns) * on_card if use_k else 0}
    _check(launches == want, f"train-mono launches {launches}, expected {want}")
    # the equal alignment (position priors at acoustic scale 1.0) makes the
    # first `banded` calls of each wrapper, the first realignment the next
    fwd, back = recs["band_forward"], recs["band_backtrace"]
    _check(fwd.calls == back.calls == banded * alignments,
           f"train-mono wrapper calls {fwd.calls}/{back.calls}")
    checks = {}
    for label, first in (("train_mono_equal_align", 0),
                         ("train_mono_realign", banded)):
        checks[label] = kernel_checks(
            {"band_forward": fwd.all_args[first],
             "band_backtrace": back.all_args[first],
             "band_backtrace_last": back.all_args[first + banded - 1]},
            None, device, sm_clock_mhz=sm_clock_mhz, k1_plain_reps=0)
    del recs, fwd, back
    lls = _loglikes(trainer)
    _check(all(np.isfinite(lls)) and lls[-1] > lls[0], f"train-mono loglikes {lls}")
    warm = []
    for _ in range(warm_runs):
        t0 = time.perf_counter()
        make().train()
        _sync(device)
        warm.append(time.perf_counter() - t0)
    synced = make()
    synced.sync_phases = True
    t0 = time.perf_counter()
    synced.train()
    synced_wall = time.perf_counter() - t0
    median = statistics.median(warm)
    return {
        "path": "train-mono",
        "audio_s": audio_s,
        "batches": len(batches),
        "banded_batches": banded,
        "alignments": alignments,
        "realignment_iterations": realigns,
        "launches": launches,
        "emission_kernel_eligible": use_k,
        "pdfs_x_gauss": list(gmm.params.gconsts.shape),
        "loglike_per_frame": lls,
        "cold_wall_s": cold,
        "cold_audio_s_per_s": audio_s / cold,
        "warm_walls_s": warm,
        "warm_median_wall_s": median,
        "warm_audio_s_per_s": audio_s / median,
        "synced_wall_s": synced_wall,
        "phases_synced_s": dict(synced.phase_seconds),
        "profiled_warm_run": (profiled_run(lambda: make().train(), device)
                              if on_card else None),
    }, checks


# the default recipe's first four stages at their Gaussian and leaf counts
# (training/trainer.py DEFAULT_RECIPE), iterations cut so each stage still
# realigns on its schedule (tri/LDA/SAT at iteration 10), LDA estimates
# MLLT at 2, 4, 6 and SAT fMLLR at 2, 4, 6; then the pronunciation stage
TRAIN_RECIPE = [
    ("monophone", "mono", 4, 1000, 0),
    ("triphone", "tri", 11, 10000, 2000),
    ("lda", "lda", 11, 15000, 2500),
    ("sat_1", "sat", 11, 15000, 2500),
    ("pron_prob_1", "pron_prob", 0, 0, 0),
]


def train_recipe_phase(corpus_dir, dict_path, out_dir, device, recipe=TRAIN_RECIPE,
                       batch_size=32):
    """The staged recipe on the card, counted from 0; K1-K3 recorded on the
    LDA stage's first realignment that launches all three. Returns
    (report, the recorded calls, the model they used)."""
    import contextlib

    import torch

    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
        _emission_kernel_eligible,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.training import lda as lda_mod
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    captured = {}
    orig = lda_mod.LdaTrainer._realign_batches

    def recording(self, pipeline, equal):
        if captured or equal:
            return orig(self, pipeline, equal)
        self._ensure_mirror(pipeline)
        gmm = self._mirror.align_gmm()
        if not gmm.use_emission_kernel:
            return orig(self, pipeline, equal)
        recs = record_kernel_calls(device)
        with contextlib.ExitStack() as stack:
            for r in recs.values():
                stack.enter_context(r)
            out = orig(self, pipeline, equal)
        captured.update(calls=recs, gmm=gmm.params)
        return out

    ta = TrainableAligner(
        corpus_dir, dict_path,
        recipe=[StageConfig(n, k, it, g, num_leaves=lv)
                for n, k, it, g, lv in recipe],
        batch_size=batch_size, device=device,
    )
    lda_mod.LdaTrainer._realign_batches = recording
    try:
        _sync(device)
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        final = ta.train()
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        lda_mod.LdaTrainer._realign_batches = orig
    launches = dict(cuda_build.LAUNCHES)
    _check(captured, "the LDA stage never launched K1, K2 and K3 in one realignment")
    stages = {}
    for name, kind, iters, gauss, leaves in recipe:
        if kind == "pron_prob":
            stages[name] = {"wall_s": ta.stage_seconds[name]}
            continue
        tr = ta.trainers[name]
        P, G = tr.gmm.gconsts.shape
        lls = _loglikes(tr)
        _check(len(lls) == iters and all(np.isfinite(lls)),
               f"{name}: log-likelihoods {lls}")
        _check(lls[-1] > lls[0], f"{name}: last log-likelihood {lls[-1]} not above "
               f"the first {lls[0]}")
        stages[name] = {
            "wall_s": ta.stage_seconds[name],
            "tree_leaves": int(P),
            "max_gaussians": gauss,
            "final_gaussians": int(tr.gmm.total_gauss),
            "padded_gauss": int(G),
            "emission_kernel_eligible": _emission_kernel_eligible(P, G),
            "launches": ta.stage_launches[name],
            "loglike_per_frame": lls,
        }
    if device.type == "cuda":
        # every stage realigns through K1 and K2; the triphone stages'
        # models are past K3's threshold
        for name, kind, *_ in recipe:
            if kind == "pron_prob":
                continue
            n = stages[name]["launches"]
            _check(n["band_forward"] > 0 and n["band_backtrace"] > 0,
                   f"{name}: K1/K2 never ran: {n}")
            _check(kind not in ("lda", "sat") or n["state_emission"] > 0,
                   f"{name}: K3 never ran")
    model_path = out_dir / "train_recipe.zip"
    final.save(model_path)
    aligner = PretrainedAligner(model_path, dict_path,
                                AlignerConfig(batch_size=batch_size), device=device)
    _check(aligner.two_pass, "the trained SAT model does not align two-pass")
    corpus = Corpus.load(corpus_dir)
    t0 = time.perf_counter()
    results = aligner.align_corpus(corpus)
    _sync(device)
    align_s = time.perf_counter() - t0
    _check(len(results) == corpus.num_utterances,
           f"trained model aligned {len(results)} of {corpus.num_utterances}")
    for key, aln in results.items():
        _check(aln.words and aln.phones and np.isfinite(aln.log_likelihood)
               and aln.log_likelihood > -1e29, f"utterance {key}: bad alignment")
    report = {
        "path": "train-recipe",
        "wall_s": wall,
        "stages": stages,
        "phases_dispatch_s": dict(ta.phase_seconds),
        "launches": launches,
        "excluded_utterances": len(ta._excluded),
        "align_two_pass_s": align_s,
        "aligned_utterances": len(results),
        "fmllr": fmllr_summary(aligner),
    }
    return report, captured


SR = 16000
TONES = {"aa": 330.0, "bb": 1800.0}
WORD_PHONES = {"ab": ["aa", "bb"], "ba": ["bb", "aa"], "a": ["aa"], "b": ["bb"]}


def make_tone_corpus(tmp: Path, n_utts=14, seed=3):
    """The JAX package's training-test corpus (tests/test_training.py
    ``make_training_corpus``): two tones as phones between noise silences,
    2-3 words an utterance over two speakers. Returns (dir, truths)."""
    from montreal_forced_aligner_tpu_torch.io.wav import write_wave

    rng = np.random.RandomState(seed)
    corpus_dir = tmp / "train_corpus"
    truths = {}
    for u in range(n_utts):
        spk = f"spk{u % 2}"
        d = corpus_dir / spk
        d.mkdir(parents=True, exist_ok=True)
        words = [
            ["ab", "ba", "a", "b"][rng.randint(4)] for _ in range(rng.randint(2, 4))
        ]
        pieces = []
        segs = []
        t = 0.0

        def add(phone, dur):
            nonlocal t
            n = int(dur * SR)
            tt = np.arange(n) / SR
            if phone == "sil":
                x = rng.randn(n) * 10.0
            else:
                x = 6000 * np.sin(2 * np.pi * TONES[phone] * tt) + rng.randn(n) * 10.0
            pieces.append(x.astype(np.float32))
            segs.append((phone, t, t + dur))
            t += dur

        add("sil", 0.3 + 0.2 * rng.rand())
        for w in words:
            for ph in WORD_PHONES[w]:
                add(ph, 0.25 + 0.3 * rng.rand())
        add("sil", 0.3 + 0.2 * rng.rand())
        write_wave(d / f"utt{u}.wav", np.concatenate(pieces), SR)
        (d / f"utt{u}.lab").write_text(" ".join(words))
        truths[f"utt{u}"] = segs
    return corpus_dir, truths


def tone_alignment_bar(results, corpus, truths):
    """The JAX training test's bar: labels equal to the truth, median
    boundary error under 30 ms. Returns the median."""
    errors = []
    for utt in corpus.utterances:
        full = truths[utt.file_name]
        truth = [(ph, b, e) for ph, b, e in full if ph != "sil"]
        got = [p for p in results[utt.id].phones if p.label not in ("sil", "spn")]
        _check([p.label for p in got] == [ph for ph, _b, _e in truth],
               f"{utt.file_name}: labels differ from the truth")
        nonsil = [i for i, (ph, _b, _e) in enumerate(full) if ph != "sil"]
        for j, ((ph, b, e), p) in enumerate(zip(truth, got)):
            i = nonsil[j]
            if i == 0 or full[i - 1][0] != ph:
                errors.append(abs(p.begin - b))
            if i == len(full) - 1 or full[i + 1][0] != ph:
                errors.append(abs(p.end - e))
    median = float(np.median(errors))
    _check(median < 0.03, f"median boundary error {median}")
    return median


TINY_RECIPE = [  # tests/test_full_training.py
    ("monophone", "mono", 6, 40, 0),
    ("triphone", "tri", 4, 64, 48),
    ("lda", "lda", 5, 64, 48),
    ("pron_prob", "pron_prob", 0, 0, 0),
    ("sat", "sat", 5, 64, 48),
]


def _model_arrays(ta, model):
    """Every array the trained recipe leaves: the final model's, the
    alignment model's, the speaker transforms."""
    out = {
        "tm": model.transition_model.log_probs,
        "weights": model.gmm.weights, "miv": model.gmm.means_invvars,
        "iv": model.gmm.inv_vars, "gconsts": model.gmm.gconsts,
        "lda": model.lda_mat,
        "ali_miv": model.alignment_model[1].means_invvars,
        "ali_iv": model.alignment_model[1].inv_vars,
        "transforms": ta.trainers["sat"].speaker_transforms,
    }
    for name, tr in ta.trainers.items():
        out[f"loglikes_{name}"] = np.asarray(_loglikes(tr))
    return out


def train_reference_phase(tmp: Path, device):
    """TINY_RECIPE on the tone corpus: twice on the card (bit-identical),
    once more under deterministic algorithms, once on the CPU."""
    import torch

    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    tmp.mkdir(parents=True, exist_ok=True)
    corpus_dir, truths = make_tone_corpus(tmp)
    dict_path = tmp / "tone.dict"
    dict_path.write_text(
        "".join(f"{w}\t{' '.join(p)}\n" for w, p in WORD_PHONES.items()))

    def run(dev):
        ta = TrainableAligner(
            corpus_dir, dict_path,
            recipe=[StageConfig(n, k, it, g, num_leaves=lv)
                    for n, k, it, g, lv in TINY_RECIPE],
            base_config=TrainerConfig(boost_silence=1.0), batch_size=4,
            variable_length_topology=False, device=dev,
        )
        t0 = time.perf_counter()
        model = ta.train()
        _sync(dev)
        return ta, model, time.perf_counter() - t0

    cpu = torch.device("cpu")
    runs = {"card_1": run(device), "card_2": run(device)}
    torch.use_deterministic_algorithms(True)
    try:
        runs["card_deterministic"] = run(device)
    finally:
        torch.use_deterministic_algorithms(False)
    runs["cpu"] = run(cpu)
    arrays = {k: _model_arrays(ta, m) for k, (ta, m, _w) in runs.items()}
    ref = arrays["card_1"]

    def identical(other):
        return [k for k in ref if not np.array_equal(ref[k], other[k])]

    differ = identical(arrays["card_2"])
    _check(not differ, f"two card runs differ in {differ}")
    differ_det = identical(arrays["card_deterministic"])
    _check(not differ_det, f"the deterministic-algorithms run differs in {differ_det}")
    card_ll = ref["loglikes_monophone"]
    cpu_ll = arrays["cpu"]["loglikes_monophone"]
    rel = float(np.max(np.abs(card_ll - cpu_ll) / np.abs(cpu_ll)))
    _check(rel <= 1e-3, f"mono log-likelihoods card vs CPU differ by {rel}")
    medians = {}
    for key, dev in (("card_1", device), ("cpu", cpu)):
        ta, model, _w = runs[key]
        path = tmp / f"tone_{key}.zip"
        model.save(path)
        aligner = PretrainedAligner(path, dict_path, AlignerConfig(batch_size=4),
                                    device=dev)
        corpus = Corpus.load(corpus_dir)
        medians[key] = tone_alignment_bar(aligner.align_corpus(corpus), corpus,
                                          truths)
    return {
        "path": "train-reference",
        "walls_s": {k: w for k, (_ta, _m, w) in runs.items()},
        "card_runs_identical": True,
        "deterministic_run_identical": True,
        "mono_loglike_max_rel_diff_card_cpu": rel,
        "sat_leaves": {k: ta.models["sat"].gmm.num_pdfs
                       for k, (ta, _m, _w) in runs.items()},
        "median_boundary_error_s": medians,
    }


def _gmm_arrays(gmm):
    return {k: getattr(gmm, k) for k in ("means_invvars", "inv_vars", "weights",
                                         "gconsts", "num_gauss")}


def _means_rel_err(got, want):
    """Largest difference of two GMM sets' means over the larger of
    ``want``'s means (finite entries)."""
    a = got.get_means().astype(np.float64)
    b = want.get_means().astype(np.float64)
    fin = np.isfinite(b)
    _check(np.array_equal(fin, np.isfinite(a)), "adapted means: padding differs")
    return float(np.abs(a[fin] - b[fin]).max() / np.abs(b[fin]).max())


class PitchCompare:
    """The pitch features of a card run against the CPU run of the same
    work, call by call: ``record()`` keeps what each call of
    ``ops.pitch.pitch_for_mfcc_frames`` returns on the card, ``compare()``
    measures the CPU's calls against those in the same order. Each run
    uses its own pitch (``pitch_phase`` holds pitch itself). No-op for a
    model without pitch."""

    def __init__(self):
        self.outputs = []
        self.max_abs_diff = 0.0

    @contextlib.contextmanager
    def _patched(self, fn):
        import montreal_forced_aligner_tpu_torch.align.fine_tune as FT
        import montreal_forced_aligner_tpu_torch.ops.pitch as PP

        real = PP.pitch_for_mfcc_frames
        PP.pitch_for_mfcc_frames = FT.pitch_for_mfcc_frames = fn(real)
        try:
            yield self
        finally:
            PP.pitch_for_mfcc_frames = FT.pitch_for_mfcc_frames = real

    def record(self):
        def wrap(real):
            def recorded(*a, **k):
                out = real(*a, **k)
                self.outputs.append(out)
                return out
            return recorded
        return self._patched(wrap)

    def compare(self):
        calls = iter(self.outputs)

        def wrap(real):
            def compared(*a, **k):
                own = real(*a, **k)
                self.max_abs_diff = max(self.max_abs_diff,
                                        float(np.abs(own - next(calls)).max()))
                return own
            return compared
        return self._patched(wrap)

    def report(self):
        return {"pitch_calls": len(self.outputs),
                "pitch_cpu_max_abs_diff": self.max_abs_diff}


def _map_adapter(model_path, dict_path, batch_size, device):
    """A ``MapAdapter`` that keeps its fMLLR transforms (``transforms``)
    and, with ``forced`` set, aligns pass 2 with those instead."""
    from montreal_forced_aligner_tpu_torch.align.aligner import AlignerConfig
    from montreal_forced_aligner_tpu_torch.training.adapt import MapAdapter

    class Adapter(MapAdapter):
        forced = None

        def _estimate_fmllr(self, pipeline, gmm):
            self.transforms = super()._estimate_fmllr(pipeline, gmm)
            return self.transforms if self.forced is None else self.forced

    return Adapter(model_path, dict_path, 20.0,
                   AlignerConfig(batch_size=batch_size), device=device)


@contextlib.contextmanager
def _fmllr_statistics(out):
    """Keep the (K, G, beta) each ``ops.transforms.estimate_speaker_fmllr``
    call solves in ``out``."""
    import montreal_forced_aligner_tpu_torch.ops.transforms as TR

    real = TR.estimate_speaker_fmllr

    def kept(K, G, beta, *a, **k):
        out.append((np.array(K), np.array(G), np.array(beta)))
        return real(K, G, beta, *a, **k)

    TR.estimate_speaker_fmllr = kept
    try:
        yield out
    finally:
        TR.estimate_speaker_fmllr = real


def adapt_card_vs_cpu(model_path, dict_path, subset_dir, device, batch_size=32):
    """``MapAdapter`` of a SAT model on the card against the CPU on
    ``subset_dir``, each run with its own pitch (a pitch model's, compared
    call by call, :class:`PitchCompare`) and its own alignments; the CPU
    run aligns pass 2 with the card's fMLLR transforms, so the means
    compare the MAP update under one alignment (within 1e-5 of each
    tensor's largest value, ``tests/test_torch_adapt.py``'s bar); the
    pass-2 paths equal, the CPU's own transforms within 1e-3 of the
    card's. Reports the fMLLR statistics' difference over their largest
    entry and the largest condition number of a row's statistics ``G``
    (how far the solve amplifies that difference)."""
    import torch

    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    pitch = PitchCompare()
    card = _map_adapter(model_path, dict_path, batch_size, device)
    stats = {"card": [], "cpu": []}
    with pitch.record(), _fmllr_statistics(stats["card"]):
        card_model = card.adapt(subset_dir)
    cpu = _map_adapter(model_path, dict_path, batch_size, torch.device("cpu"))
    cpu.forced = card.transforms
    t0 = time.perf_counter()
    with pitch.compare(), _fmllr_statistics(stats["cpu"]):
        cpu_model = cpu.adapt(subset_dir)
    cpu_s = time.perf_counter() - t0
    stats_rel = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                    for x, y in zip(stats["card"], stats["cpu"])
                    for a, b in zip(x, y))
    g_cond = max(float(np.linalg.cond(G.astype(np.float64)).max())
                 for _K, G, _b in stats["card"])
    paths_equal = all(
        np.array_equal(a.host_state_path(), b.host_state_path())
        for a, b in zip(card.pipeline.batches, cpu.pipeline.batches))
    _check(paths_equal, "adapt: pass-2 paths on the card and the CPU differ")
    rel = {"final": _means_rel_err(card_model.gmm, cpu_model.gmm),
           "speaker_independent": _means_rel_err(card_model.alignment_model[1],
                                                 cpu_model.alignment_model[1])}
    _check(max(rel.values()) <= 1e-5, f"adapt: card against CPU means {rel}")
    t_err = float(np.abs(card.transforms - cpu.transforms).max())
    _check(t_err <= 1e-3, f"adapt: fMLLR transforms differ by {t_err} "
           f"(statistics {stats_rel} apart, G's condition up to {g_cond})")
    return {"utterances": Corpus.load(subset_dir).num_utterances,
            "means_rel_err": rel, "fmllr_stats_rel_err": stats_rel,
            "fmllr_G_cond_max": g_cond, "transforms_max_abs_diff": t_err,
            "transforms_max_abs": float(np.abs(card.transforms).max()),
            "pass2_paths_equal": paths_equal, "cpu_wall_s": cpu_s,
            **pitch.report()}


def adapt_phase(model_path, dict_path, corpus_dir, subset_dir, out_dir, audio_s,
                device, warm_runs=3, batch_size=32, sm_clock_mhz=None):
    """Main path **adapt**: ``MapAdapter.adapt`` (the fMLLR two-pass with
    K3, K1 and K2 in both passes, then MAP on the final and the
    speaker-independent model) on the corpus, counted from 0, every kernel
    call recorded; ``warm_runs`` more runs (the first held bit-identical to
    the counted one), one synchronised at each phase; the card against the
    CPU on ``subset_dir`` (the CPU run takes the card's fMLLR transforms, so
    the means compare the MAP update under one alignment; the transforms are
    compared beside it); the adapted archive saved, loaded and aligned
    two-pass. Returns (report, the kernels held on adapt's first batch)."""
    import contextlib

    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
        _emission_kernel_eligible,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.params import gmm_params_from_numpy

    def make():
        return _map_adapter(model_path, dict_path, batch_size, device)

    adapter = make()
    model = adapter.aligner.model
    _check(model.uses_fmllr and model.alignment_model is not None,
           "adapt needs a SAT model")
    recs = record_kernel_calls(device)
    with contextlib.ExitStack() as stack:
        for r in recs.values():
            stack.enter_context(r)
        _sync(device)
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        first = adapter.adapt(corpus_dir)
        _sync(device)
        first_wall = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
    batches = adapter.pipeline.batches
    banded = sum(fb.band_limits is not None for fb in batches)
    si = model.alignment_model[1]
    use_k = [_emission_kernel_eligible(g.num_pdfs, g.max_gauss)
             for g in (si, model.gmm)]
    on_card = device.type == "cuda"
    want = {"band_forward": 2 * banded * on_card,
            "band_backtrace": 2 * banded * on_card,
            "state_emission": sum(use_k) * len(batches) * on_card}
    _check(launches == want, f"adapt launches {launches}, expected {want}")
    _check(recs["band_forward"].calls == 2 * banded,
           f"adapt K1 wrapper calls {recs['band_forward'].calls}")
    # adapt's own first batch: pass 1, the speaker-independent model
    si_params = gmm_params_from_numpy(si.means_invvars, si.inv_vars,
                                      si.gconsts).to(device)
    checks = kernel_checks(batch_inputs(recs, 0), si_params, device,
                           sm_clock_mhz=sm_clock_mhz, k1_plain_reps=0)
    del recs, si_params
    first_arrays = [_gmm_arrays(first.gmm), _gmm_arrays(first.alignment_model[1])]
    warm, identical = [], None
    for i in range(warm_runs):
        a = make()
        t0 = time.perf_counter()
        m = a.adapt(corpus_dir)
        _sync(device)
        warm.append(time.perf_counter() - t0)
        if i == 0:
            again = [_gmm_arrays(m.gmm), _gmm_arrays(m.alignment_model[1])]
            identical = all(np.array_equal(x[k], y[k])
                            for x, y in zip(first_arrays, again) for k in x)
        del a, m
    _check(identical, "two adapt runs on the card gave different models")
    synced = make()
    synced.sync_phases = True
    t0 = time.perf_counter()
    synced.adapt(corpus_dir)
    synced_wall = time.perf_counter() - t0
    phases = dict(synced.phase_seconds)
    del synced
    # the card against the CPU on the subset, under the card's transforms
    card_vs_cpu = adapt_card_vs_cpu(model_path, dict_path, subset_dir, device,
                                    batch_size)
    # the adapted archive aligns two-pass
    path = out_dir / "adapted.zip"
    first.save(path)
    aligner = PretrainedAligner(path, dict_path, AlignerConfig(batch_size=batch_size),
                                device=device)
    _check(aligner.two_pass, "the adapted archive does not align two-pass")
    corpus = Corpus.load(corpus_dir)
    t0 = time.perf_counter()
    results = aligner.align_corpus(corpus)
    _sync(device)
    align_s = time.perf_counter() - t0
    _check(len(results) == corpus.num_utterances,
           f"adapted model aligned {len(results)} of {corpus.num_utterances}")
    for key, aln in results.items():
        _check(aln.words and aln.phones and np.isfinite(aln.log_likelihood)
               and aln.log_likelihood > -1e29, f"utterance {key}: bad alignment")
    median = statistics.median(warm)
    return {
        "path": "adapt",
        "audio_s": audio_s,
        "batches": len(batches),
        "banded_batches": banded,
        "emission_kernel_eligible": {"si": use_k[0], "final": use_k[1]},
        "pdfs_x_gauss": [int(model.gmm.num_pdfs), int(model.gmm.max_gauss)],
        "launches": launches,
        "first_wall_s": first_wall,
        "warm_walls_s": warm,
        "warm_median_wall_s": median,
        "warm_audio_s_per_s": audio_s / median,
        "two_runs_identical": identical,
        "synced_wall_s": synced_wall,
        "phases_synced_s": phases,
        "card_vs_cpu": card_vs_cpu,
        "adapted_align_two_pass_s": align_s,
        "aligned_utterances": len(results),
    }, checks


_GRAPH_FIELDS = ("state_pdf", "state_phone", "state_word", "state_hmm_pos",
                 "state_tstate", "state_instance", "in_src", "in_weight", "in_tid",
                 "start", "final", "final_tid")


def _graphs_identical(got, want) -> bool:
    return len(got) == len(want) and all(
        g.words == w.words and all(
            getattr(g, k).dtype == getattr(w, k).dtype
            and np.array_equal(getattr(g, k), getattr(w, k)) for k in _GRAPH_FIELDS)
        for g, w in zip(got, want))


def graph_compile_phase(mono_trainer, mono_corpus, model_path, dict_path, corpus_dir,
                        device, workers=4):
    """train-mono's graphs from the native core against the Python
    compiler's (bit-identical; each timed on a fresh compiler, then again
    with its caches warm), and sat-si's triphone graphs through a pool of
    ``workers`` processes against serial compilation (identical; the pool's
    start-up, first and second call timed, serial cold and warm)."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.graph.native_compile import (
        compile_batch_native,
    )
    from montreal_forced_aligner_tpu_torch.graph.parallel import (
        ParallelGraphCompiler,
    )

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    tokens = [u.normalized_tokens for u in mono_corpus.utterances]
    comp = mono_trainer.make_compiler()
    native, native_cold = timed(lambda: compile_batch_native(comp, tokens))
    _n, native_warm = timed(lambda: compile_batch_native(comp, tokens))
    comp = mono_trainer.make_compiler()
    python, python_cold = timed(lambda: [comp.compile(t) for t in tokens])
    _p, python_warm = timed(lambda: [comp.compile(t) for t in tokens])
    _check(_graphs_identical(native, python),
           "native monophone graphs differ from the Python compiler's")
    mono = {"utterances": len(tokens), "identical": True,
            "native_cold_s": native_cold, "native_warm_s": native_warm,
            "python_cold_s": python_cold, "python_warm_s": python_warm}

    aligner = PretrainedAligner(
        model_path, dict_path,
        AlignerConfig(batch_size=32, uses_speaker_adaptation=False), device=device)
    _check(aligner.compiler.tree.N == 3, "sat-si's tree is not triphone")
    corpus = Corpus.load(corpus_dir)
    items = [(aligner.speaker_dictionary_map.get(u.speaker,
                                                 aligner.default_dictionary_key),
              aligner.tokenizer.tokenize(u.text)) for u in corpus.utterances]
    pool, start_s = timed(lambda: ParallelGraphCompiler(aligner.compilers, workers))
    try:
        pooled, pool_first = timed(lambda: pool.compile_all(items))
        _g, pool_second = timed(lambda: pool.compile_all(items))
    finally:
        pool.close(wait=True)
    serial, serial_cold = timed(
        lambda: [aligner.compilers[k].compile(t) for k, t in items])
    _s, serial_warm = timed(
        lambda: [aligner.compilers[k].compile(t) for k, t in items])
    _check(_graphs_identical(pooled, serial), "pooled graphs differ from serial ones")
    return {
        "train_mono_native": mono,
        "sat_si_pool": {"utterances": len(items), "workers": workers,
                        "identical": True, "pool_start_s": start_s,
                        "pool_first_s": pool_first, "pool_second_s": pool_second,
                        "serial_cold_s": serial_cold, "serial_warm_s": serial_warm},
    }


def padded_waves(waves):
    """Waves of any lengths in one zero-padded float32 buffer, and their
    lengths."""
    lens = np.array([len(w) for w in waves], np.int32)
    buf = np.zeros((len(waves), int(lens.max())), np.float32)
    for r, w in enumerate(waves):
        buf[r, : len(w)] = w
    return buf, lens


def pitch_phase(corpus_dir, dict_path, small_dir, audio_s, device, batch_size=32):
    """One cold train-mono with ``use_pitch`` (synchronised at each phase:
    pitch is part of its features phase), the pitch features of the corpus
    timed by batch, and pitch on the card against the CPU on ``small_dir``:
    NCCF within atol 1e-4, lag paths, and the features within atol 1e-4 of
    every utterance whose lag path agrees."""
    import torch

    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import pitch as PP
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    ta = TrainableAligner(
        corpus_dir, dict_path, recipe=[StageConfig("monophone", "mono", 4, 64)],
        batch_size=batch_size, variable_length_topology=False, use_pitch=True,
        device=device)
    ta.sync_phases = True
    _sync(device)
    t0 = time.perf_counter()
    ta.train()
    _sync(device)
    wall = time.perf_counter() - t0
    trainer = ta.trainers["monophone"]
    lls = _loglikes(trainer)
    _check(all(np.isfinite(lls)) and lls[-1] > lls[0], f"pitch train-mono {lls}")
    _check(trainer.feature_meta()["pitch"] and ta.pipeline.feature_dim == 48,
           "train-mono with pitch: no pitch in its features")

    waves = Corpus.load(corpus_dir).load_audio_parallel(16000)
    order = np.argsort([len(w) for w in waves], kind="stable")
    _sync(device)
    t0 = time.perf_counter()
    for i in range(0, len(order), batch_size):
        buf, lens = padded_waves([waves[j] for j in order[i : i + batch_size]])
        PP.compute_pitch_batch(buf, lens, device=device)
    corpus_pitch_s = time.perf_counter() - t0

    cfg = PP.PitchConfig()
    buf, lens = padded_waves(Corpus.load(small_dir).load_audio_parallel(16000))
    ds, ds_len = PP._resample_batch(buf, lens, cfg)
    shift = int(cfg.resample_rate * cfg.frame_shift_ms / 1000)
    window = int(cfg.resample_rate * cfg.frame_length_ms / 1000)
    T = int(((ds_len - window) // shift + 1).max())
    cpu = torch.device("cpu")
    nccf = [PP._nccf(torch.from_numpy(ds).to(d), torch.from_numpy(ds_len).to(d),
                     window, shift, T, int(cfg.lags.max()), cfg.nccf_ballast)
            for d in (device, cpu)]
    nccf_err = float((nccf[0].cpu() - nccf[1]).abs().max())
    _check(nccf_err <= 1e-4, f"pitch: NCCF card against CPU {nccf_err}")
    feats = {}
    paths = {}
    real = PP._viterbi_lags

    def keep_path(*args):
        out = real(*args)
        paths[args[0].device.type] = out
        return out

    PP._viterbi_lags = keep_path
    try:
        for d in (device, cpu):
            feats[d.type] = PP.compute_pitch_batch(buf, lens, cfg, device=d)
    finally:
        PP._viterbi_lags = real
    (fg, ng), (fc, nc) = feats[device.type], feats["cpu"]
    _check(np.array_equal(ng, nc), "pitch: frame counts differ")
    pg, pc = paths[device.type], paths["cpu"]
    mask = np.arange(pg.shape[1])[None, :] < ng[:, None]
    agree = float((pg == pc)[mask].mean())
    _check(agree >= 0.995, f"pitch: lag paths agree on {agree} of frames")
    same_rows = [r for r in range(len(ng)) if np.array_equal(pg[r], pc[r])]
    row_err = [float(np.abs(fg[r] - fc[r]).max()) for r in same_rows]
    _check(max(row_err, default=0.0) <= 1e-4, f"pitch features differ {row_err}")
    return {
        "train_mono_pitch": {
            "cold_wall_s": wall, "audio_s": audio_s,
            "cold_audio_s_per_s": audio_s / wall,
            "phases_synced_s": dict(ta.phase_seconds),
            "loglike_per_frame": lls, "feature_dim": ta.pipeline.feature_dim,
        },
        "corpus_pitch_s": corpus_pitch_s,
        "card_vs_cpu": {"utterances": len(ng), "nccf_max_abs_diff": nccf_err,
                        "lag_path_agreement": agree,
                        "rows_with_equal_paths": len(same_rows),
                        "features_max_abs_diff_equal_paths": max(row_err, default=0.0),
                        "features_max_abs_diff": float(np.abs(fg - fc).max())},
    }


def _fine_tune_run(model_path, dict_path, dev, corpus_path, batch_size):
    """A single-pass alignment and its fine-tune: (the 10 ms phones' labels
    and begins by utterance, the fine-tuned results, the fine-tune's
    seconds)."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.align.fine_tune import (
        fine_tune_alignments,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    aligner = PretrainedAligner(
        model_path, dict_path,
        AlignerConfig(batch_size=batch_size, uses_speaker_adaptation=False),
        device=dev)
    corpus = Corpus.load(corpus_path)
    results = aligner.align_corpus(corpus)
    base = {k: [(p.label, p.begin) for p in a.phones] for k, a in results.items()}
    _sync(dev)
    t0 = time.perf_counter()
    tuned = fine_tune_alignments(aligner, corpus, results)
    _sync(dev)
    return base, tuned, time.perf_counter() - t0


def _fine_tune_card_vs_cpu(model_path, dict_path, small_dir, device):
    """The fine-tune on the card against the CPU on ``small_dir``, each
    with its own pitch (a pitch model's, compared call by call,
    :class:`PitchCompare`): the same 10 ms alignment, then fine-tuned
    boundaries within 1 ms. Returns (the card's run, the largest boundary
    difference in seconds, the pitch comparison)."""
    import torch

    pitch = PitchCompare()
    with pitch.record():
        got = _fine_tune_run(model_path, dict_path, device, small_dir, 4)
    with pitch.compare():
        want = _fine_tune_run(model_path, dict_path, torch.device("cpu"), small_dir,
                              4)
    _check(got[0] == want[0], "fine-tune: the card's 10 ms alignment differs")
    worst = 0.0
    for key, aln in want[1].items():
        g = [p.begin for p in got[1][key].phones]
        w = [p.begin for p in aln.phones]
        _check(len(g) == len(w), f"utterance {key}: fine-tuned phone counts differ")
        worst = max(worst, float(np.abs(np.array(g) - np.array(w)).max()))
    _check(worst <= 0.001 + 1e-9, f"fine-tune: boundaries differ by {worst} s")
    return got, worst, pitch.report()


def fine_tune_phase(model_path, dict_path, corpus_dir, small_dir, device,
                    batch_size=32):
    """sat-si with ``--fine_tune``: the corpus aligned single-pass and its
    boundaries refined at 1 ms, timed; on ``small_dir`` the card against the
    CPU: the same 10 ms alignment, then fine-tuned boundaries within 1 ms."""
    base, tuned, seconds = _fine_tune_run(model_path, dict_path, device, corpus_dir,
                                          batch_size)
    boundaries = sum(len(v) - 1 for v in base.values())
    moved = sum(int(round(p.begin * 1000)) % 10 != 0
                for a in tuned.values() for p in a.phones)
    for key, aln in tuned.items():
        _check(aln.phones and all(np.isfinite(p.begin) and p.end > p.begin
                                  for p in aln.phones),
               f"utterance {key}: an empty or non-finite fine-tuned phone")
    _check(moved > 0, "fine-tune moved no boundary off the 10 ms grid")
    got, worst, _pitch = _fine_tune_card_vs_cpu(model_path, dict_path, small_dir,
                                                device)
    return {"utterances": len(tuned), "boundaries": boundaries,
            "moved_off_grid": moved, "fine_tune_s": seconds,
            "card_vs_cpu": {"utterances": len(got[1]),
                            "max_boundary_diff_s": worst}}


# -- work on the host's CPU beside the card's phases --------------------------


def _cpu_task(root, name, args, out_path, threads):
    """Entry of a spawned worker: ``name``, a function of this script, run
    with ``args`` on ``threads`` CPU threads, its result pickled to
    ``out_path``."""
    sys.path.insert(0, root)
    import torch

    torch.set_num_threads(threads)
    out = globals()[name](*args)
    with open(out_path, "wb") as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)


class CpuTask:
    """A function of this script run in a spawned process while the card's
    phases go on (host work that the card would otherwise wait for);
    :meth:`result` joins it and fails if it failed. ``drop_env`` names
    variables the process starts without; a process that is to spawn its
    own tasks is not a daemon (``daemon=False``)."""

    def __init__(self, name, args, out_path, threads=4, daemon=True, drop_env=()):
        import multiprocessing

        self.name, self.out_path = name, Path(out_path)
        root = str(Path(__file__).resolve().parent)
        self.proc = multiprocessing.get_context("spawn").Process(
            target=_cpu_task, args=(root, name, args, str(out_path), threads),
            daemon=daemon)
        self.t0 = time.perf_counter()
        kept = {k: os.environ.pop(k) for k in drop_env if k in os.environ}
        try:
            self.proc.start()
        finally:
            os.environ.update(kept)

    def result(self, timeout=900.0):
        self.proc.join(timeout)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        _check(self.proc.exitcode == 0,
               f"CPU task {self.name} exited {self.proc.exitcode}")
        with open(self.out_path, "rb") as f:
            out = pickle.load(f)
        self.out_path.unlink()
        return out


# -- transcription phases ----------------------------------------------------

TRANSCRIBE_WORDS = 30


def transcription_lms(words, n_words=TRANSCRIBE_WORDS):
    """The dense decode's LMs: a bigram and, for N-best rescoring, a trigram
    over the dictionary's first ``n_words`` words, trained on 200 sentences
    of 8 words drawn from seed 0."""
    from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
        train_lm_from_texts,
    )

    rng = np.random.RandomState(0)
    vocab = sorted(words)[:n_words]
    texts = [" ".join(rng.choice(vocab, 8)) for _ in range(200)]
    return (train_lm_from_texts(texts, order=2)[0],
            train_lm_from_texts(texts, order=3)[0])


def corpus_lm(model_path, dict_path, corpus_dir, order=3):
    """The LM ``Transcriber.train_lm_from_corpus`` trains on the corpus's
    own transcripts (the LVCSR phases' LM), on the host."""
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.transcription.transcriber import (
        Transcriber,
    )

    tr = Transcriber(model_path, dict_path, lm_order=order, device="cpu")
    return tr.train_lm_from_corpus(Corpus.load(corpus_dir))


def _transcripts_ok(results, corpus):
    """Every utterance decoded to a finite score; some to words."""
    _check(len(results) == corpus.num_utterances,
           f"{len(results)} of {corpus.num_utterances} utterances transcribed")
    for key, r in results.items():
        _check(np.isfinite(r.log_likelihood) and r.log_likelihood > -1e29,
               f"utterance {key}: score {r.log_likelihood}")
    _check(any(r.text for r in results.values()), "every transcript is empty")


def _peak_gib(device):
    import torch

    return (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)


def _reset_peak(device):
    import torch

    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _counted_transcribe(tr, corpus_dir, device, record=False, **kw):
    """One ``transcribe_corpus`` with every launch count set to 0 just
    before (and, with ``record``, every kernel wrapper call recorded):
    (results, wall, launches, peak GiB, recorders or None)."""
    import contextlib

    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build

    corpus = Corpus.load(corpus_dir)
    recs = record_kernel_calls(device) if record else {}
    with contextlib.ExitStack() as stack:
        for r in recs.values():
            stack.enter_context(r)
        _reset_peak(device)
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        results = tr.transcribe_corpus(corpus, **kw)
        _sync(device)
        wall = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
    _transcripts_ok(results, corpus)
    return results, wall, launches, _peak_gib(device), (recs or None)


def _warm_runs(tr, corpus_dir, device, runs, **kw):
    """``runs`` warm transcriptions, the first with the card synchronised
    at each phase: (walls, its synchronised phases)."""
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    walls, phases = [], None
    for i in range(runs):
        tr.sync_phases = i == 0
        t0 = time.perf_counter()
        tr.transcribe_corpus(Corpus.load(corpus_dir), **kw)
        _sync(device)
        walls.append(time.perf_counter() - t0)
        if i == 0:
            phases = dict(tr.last_phase_seconds)
    tr.sync_phases = False
    return walls, phases


def transcribe_dense_phase(model_path, dict_path, corpus_dir, audio_s, lm, device,
                           batch_size=16, warm_runs=2, reps=5):
    """Main path **transcribe-dense**: ``Transcriber.transcribe_corpus`` on
    the corpus with a bigram over 30 words, the SAT two-pass (K3 in both
    passes, the dense Viterbi), counted from 0: K3 launches equal to 2 x
    batches, every utterance transcribed; one cold and ``warm_runs`` warm
    walls (the first synchronised at each phase, the last, on the card,
    under the profiler for the busy share), peak card memory. Returns
    (report, K3 held on the decode's first batch, pass 2)."""
    from montreal_forced_aligner_tpu_torch.transcription.transcriber import (
        Transcriber,
    )

    t0 = time.perf_counter()
    tr = Transcriber(model_path, dict_path, lm=lm, batch_size=batch_size,
                     device=device)
    setup_s = time.perf_counter() - t0
    _check(tr.aligner.two_pass, "transcribe-dense needs a SAT model")
    results, wall, launches, peak, recs = _counted_transcribe(
        tr, corpus_dir, device, record=True)
    _check(tr._graph is not None and tr._lvcsr is None,
           "transcribe-dense did not take the dense graph")
    n_batches = -(-len(results) // batch_size)
    on_card = device.type == "cuda"
    want = {"band_forward": 0, "band_backtrace": 0,
            "state_emission": 2 * n_batches * on_card}
    _check(tr.aligner.use_emission_kernel and tr.aligner.si_use_emission_kernel,
           "transcribe-dense: the SAT-scale model should take K3")
    _check(launches == want, f"transcribe-dense launches {launches}, not {want}")
    _check(recs["state_emission"].calls == 2 * n_batches, "K3 wrapper calls")
    # the decode's first batch of pass 2 (adapted features, final model)
    checks = {"state_emission": k3_check(
        recs["state_emission"].all_args[n_batches], tr.aligner.gmm, device,
        reps=reps)}
    del recs
    cold_phases = dict(tr.last_phase_seconds)
    # the last warm run is the profiled one on the card
    walls, synced = _warm_runs(tr, corpus_dir, device, warm_runs - on_card)
    report = {
        "path": "transcribe-dense",
        "utterances": len(results),
        "audio_s": audio_s,
        "batches": n_batches,
        "graph": {"S": int(tr._graph.num_states), "K": int(tr._graph.max_in_arcs),
                  "words": len(tr._vocab)},
        "setup_s": setup_s,
        "launches": launches,
        "cold_wall_s": wall,
        "cold_phases_dispatch_s": cold_phases,
        "warm_walls_s": walls,
        "warm_audio_s_per_s": audio_s / statistics.median(walls),
        "phases_synced_s": synced,
        "peak_card_gib": peak,
        "texts": [results[i].text for i in sorted(results)[:3]],
    }
    if on_card:
        from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

        run = profiled_run(lambda: tr.transcribe_corpus(Corpus.load(corpus_dir)),
                           device)
        report["profiled_warm_run"] = run
        report["warm_walls_s"].append(run["wall_s"])
    return report, checks


def transcribe_nbest_phase(model_path, dict_path, corpus_dir, lms, device,
                           nbest=8, batch_size=16):
    """**transcribe-nbest**: the dense decode with ``nbest`` ranks on a small
    corpus, rescored with the trigram at ``rescore_weight`` 1.0, counted from
    0 (K3: 2 x batches), the card synchronised at each phase."""
    from montreal_forced_aligner_tpu_torch.transcription.transcriber import (
        Transcriber,
    )

    bigram, trigram = lms
    tr = Transcriber(model_path, dict_path, lm=bigram, batch_size=batch_size,
                     device=device)
    tr.sync_phases = True
    kw = dict(nbest=nbest, rescore_lm=trigram, rescore_weight=1.0)
    results, wall, launches, peak, _ = _counted_transcribe(tr, corpus_dir,
                                                            device, **kw)
    n_batches = -(-len(results) // batch_size)
    want = 2 * n_batches * (device.type == "cuda")
    _check(launches["state_emission"] == want,
           f"transcribe-nbest K3 launches {launches}, not {want}")
    alts = [len(r.alternatives or []) for r in results.values()]
    _check(max(alts) >= 2, "transcribe-nbest gave no alternatives")
    for r in results.values():
        scores = [s for _t, s in (r.alternatives or [])]
        _check(scores == sorted(scores, reverse=True), "N-best not ranked")
    return {"path": "transcribe-nbest", "utterances": len(results),
            "nbest": nbest, "launches": launches, "cold_wall_s": wall,
            "phases_synced_s": dict(tr.last_phase_seconds),
            "peak_card_gib": peak, "alternatives_per_utterance": alts}


def transcribe_lvcsr_phase(model_path, dict_path, corpus_dir, audio_s, device,
                           batch_size=16, warm_runs=1):
    """**transcribe-lvcsr**: an LM trained on the corpus's own transcripts
    (all 200 words: above the dense decoder's 150), so the cross-word LVCSR
    decoder runs, two-pass; counted from 0 (no kernel launches: the LVCSR
    path is plain PyTorch); cold and warm walls, phases, peak memory.
    Returns (report, the transcriber, whose LM the card-against-CPU check
    compares with its own)."""
    from montreal_forced_aligner_tpu_torch.transcription import lvcsr as LV
    from montreal_forced_aligner_tpu_torch.transcription.transcriber import (
        Transcriber,
    )

    tr = Transcriber(model_path, dict_path, batch_size=batch_size, device=device)
    results, wall, launches, peak, _ = _counted_transcribe(tr, corpus_dir, device)
    _check(isinstance(tr._lvcsr, LV.LvcsrXwGraph) and not tr.cross_word_fallback,
           f"transcribe-lvcsr took {type(tr._lvcsr).__name__}, "
           f"fallback {tr.cross_word_fallback}")
    _check(sum(launches.values()) == 0, f"LVCSR launched kernels: {launches}")
    cold_phases = dict(tr.last_phase_seconds)
    walls, synced = _warm_runs(tr, corpus_dir, device, warm_runs)
    g = tr._lvcsr
    report = {
        "path": "transcribe-lvcsr", "utterances": len(results),
        "audio_s": audio_s, "words": len(g.words),
        "graph": {"S": int(g.num_states), "band": [g.lb, g.ub],
                  "entry_slots": int(len(g.entry_state)),
                  "cells": int(g.cell_exit_idx.shape[0])},
        "cross_word_fallback": tr.cross_word_fallback,
        "launches": launches, "cold_wall_s": wall,
        "cold_phases_dispatch_s": cold_phases, "warm_walls_s": walls,
        "warm_audio_s_per_s": audio_s / statistics.median(walls),
        "phases_synced_s": synced, "peak_card_gib": peak,
    }
    return report, tr


def lvcsr_20k_fixture(dict_path, corpus_dir, out_dir, num_words=20000, shortest=16):
    """``bench.py``'s LVCSR recipe: the dictionary plus ``num_words`` junk
    words over its phones (``RandomState(11)``, 4-9 phones each), a bigram
    over 6-word texts of the junk words, and a corpus of the ``shortest``
    shortest utterances. Returns (dict path, LM, corpus dir, audio s)."""
    import shutil

    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
        train_lm_from_texts,
    )

    rng = np.random.RandomState(11)
    text = Path(dict_path).read_text(encoding="utf-8")
    phones = sorted({p for line in text.splitlines() for p in line.split()[1:]})
    lv_dict = out_dir / "lvcsr_dict.txt"
    junk = []
    with open(lv_dict, "w", encoding="utf-8") as f:
        f.write(text)
        for j in range(num_words):
            junk.append(f"junk{j}")
            f.write(f"junk{j}\t{' '.join(rng.choice(phones, rng.randint(4, 10)))}\n")
    lm, _ = train_lm_from_texts(
        [" ".join(junk[i : i + 6]) for i in range(0, num_words, 6)], order=2)
    corpus = Corpus.load(corpus_dir)
    waves = corpus.load_audio_parallel(16000)
    order = np.argsort([len(w) for w in waves], kind="stable")[:shortest]
    sub = out_dir / "lvcsr_short"
    for i in order:
        u = corpus.utterances[int(i)]
        d = sub / u.speaker
        d.mkdir(parents=True, exist_ok=True)
        shutil.copy(u.file_path, d / u.file_path.name)
        shutil.copy(u.file_path.with_suffix(".lab"), d / f"{u.file_path.stem}.lab")
    return lv_dict, lm, sub, float(sum(len(waves[int(i)]) for i in order) / 16000)


def lvcsr_20k_graph(model_path, dict_path, corpus_dir, out_dir, num_words=20000):
    """The host half of transcribe-lvcsr-20k, on the CPU: the fixture
    (:func:`lvcsr_20k_fixture`) and its LVCSR decoding graph, built by
    ``Transcriber._ensure_graph`` for the corpus's longest utterance, timed."""
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.transcription.transcriber import (
        Transcriber,
    )

    lv_dict, lm, sub, audio_s = lvcsr_20k_fixture(dict_path, corpus_dir, out_dir,
                                                  num_words)
    tr = Transcriber(model_path, lv_dict, lm=lm, device="cpu")
    waves = Corpus.load(sub).load_audio_parallel(16000)
    frames = tr.aligner.mfcc_config.num_frames(max(len(w) for w in waves))
    t0 = time.perf_counter()
    tr._ensure_graph(nominal_frames=frames)
    return {"dict": lv_dict, "lm": lm, "corpus": sub, "audio_s": audio_s,
            "frames": frames, "graph": tr._lvcsr,
            "graph_build_s": time.perf_counter() - t0}


def transcribe_lvcsr_20k_phase(built, model_path, device, batch_size=16):
    """**transcribe-lvcsr-20k**: ``bench.py``'s LVCSR recipe on the SAT-scale
    model, batch 16, on the graph ``built`` by :func:`lvcsr_20k_graph` (in a
    worker beside the earlier phases): one cold run, counted from 0 (the
    warm run is cut, for the script's time budget)."""
    from montreal_forced_aligner_tpu_torch.transcription.transcriber import (
        Transcriber,
    )

    g, sub = built["graph"], built["corpus"]
    _check(g is not None, "transcribe-lvcsr-20k did not route to LVCSR")
    tr = Transcriber(model_path, built["dict"], lm=built["lm"],
                     batch_size=batch_size, device=device)
    tr._lvcsr, tr._vocab, tr._gate_frames = g, g.words, built["frames"]
    results, wall, launches, peak, _ = _counted_transcribe(tr, sub, device)
    _check(tr._lvcsr is g, "the 20k graph was rebuilt")
    return {"path": "transcribe-lvcsr-20k", "utterances": len(results),
            "audio_s": built["audio_s"], "words": len(g.words),
            "S": int(g.num_states), "graph_type": type(g).__name__,
            "cross_word_fallback": tr.cross_word_fallback,
            "graph_build_s": built["graph_build_s"], "launches": launches,
            "cold_wall_s": wall, "cold_phases_dispatch_s": dict(tr.last_phase_seconds),
            "peak_card_gib": peak}


def _cli(argv):
    """The port's CLI in this process, its printed lines captured."""
    import contextlib
    import io

    from montreal_forced_aligner_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(a) for a in argv])
    _check(rc == 0, f"cli {argv[0]} exited {rc}: {buf.getvalue()[-2000:]}")
    return buf.getvalue().splitlines()


def phone_transcribe_phase(model_path, dict_path, corpus_dir, small_dir, out_dir,
                           device, batch_size=16):
    """**phone-transcribe**: ``align --use_phone_model`` through the CLI on
    ``corpus_dir`` (the two-pass alignment, then the free phone decode
    against a phone LM from the alignments, and its evaluation), and
    ``transcribe --output_type alignment`` of ``small_dir``; each counted
    from 0."""
    from montreal_forced_aligner_tpu_torch.ops import cuda_build

    out = {}
    dev = ["--device", device.type]
    for name, argv, check in (
        ("align --use_phone_model",
         ["align", corpus_dir, dict_path, model_path, out_dir / "phone_align",
          "--use_phone_model", "--batch_size", batch_size] + dev,
         "Phone-transcript evaluation"),
        ("transcribe --output_type alignment",
         ["transcribe", small_dir, dict_path, model_path, out_dir / "tr_align",
          "--output_type", "alignment", "--evaluate"] + dev, "WER:"),
    ):
        _reset_peak(device)
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        lines = _cli(argv)
        _sync(device)
        wall = time.perf_counter() - t0
        line = next((l for l in lines if l.startswith(check)), None)
        _check(line is not None, f"{name}: no {check!r} line")
        out[name] = {"wall_s": wall, "launches": dict(cuda_build.LAUNCHES),
                     "report": line, "peak_card_gib": _peak_gib(device)}
    csv = out_dir / "phone_align" / "phone_transcript_evaluation.csv"
    rows = csv.read_text().strip().splitlines()
    _check(len(rows) > 1, "phone_transcript_evaluation.csv is empty")
    out["align --use_phone_model"]["evaluated_utterances"] = len(rows) - 1
    tgs = list((out_dir / "tr_align").glob("**/*.TextGrid"))
    _check(tgs and all("phones" in p.read_text() for p in tgs),
           "transcribe --output_type alignment wrote no phone tiers")
    if device.type == "cuda":
        a = out["align --use_phone_model"]["launches"]
        _check(min(a.values()) > 0, f"--use_phone_model launches {a}")
        t = out["transcribe --output_type alignment"]["launches"]
        _check(min(t.values()) > 0, f"--output_type alignment launches {t}")
    return out


def _path_agreement(got, want):
    frames = same = 0
    for key, w in want.items():
        g = got[key]
        _check(len(g) == len(w), f"utterance {key}: path lengths differ")
        frames += len(w)
        same += int((np.asarray(g) == np.asarray(w)).sum())
    return same / max(frames, 1), frames


def _small_decode(model_path, dict_path, small_dir, lm, dev, kw):
    """One transcription of the small corpus on ``dev``: (results, 1-best
    state paths, wall, LVCSR graph or None)."""
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.transcription.transcriber import (
        Transcriber,
    )

    tr = Transcriber(model_path, dict_path, lm=lm, batch_size=4, device=dev)
    t0 = time.perf_counter()
    res = tr.transcribe_corpus(Corpus.load(small_dir), **kw)
    _sync(dev)
    return res, dict(tr.last_state_paths), time.perf_counter() - t0, tr._lvcsr


def card_vs_cpu_decodes(nbest=4):
    """The three decodes of the card-against-CPU check: (name, kwargs)."""
    return (("dense", {}), ("nbest", {"nbest": nbest}), ("lvcsr", {}))


def transcribe_cpu_references(model_path, dict_path, small_dir, lms, nbest=4):
    """The CPU half of :func:`transcribe_card_vs_cpu` (plain versions): the
    three decodes of the small corpus, by name, with ``lms`` the dense, the
    N-best and the LVCSR LM."""
    import torch

    return {name: _small_decode(model_path, dict_path, small_dir, lm,
                                torch.device("cpu"), kw)[:3]
            for (name, kw), lm in zip(card_vs_cpu_decodes(nbest), lms)}


def transcribe_card_vs_cpu(model_path, dict_path, small_dir, lms, device, nbest=4,
                           cpu_runs=None):
    """The card against the CPU (the plain versions) on a small corpus, for
    dense 1-best, dense N-best and cross-word LVCSR, two-pass each, with
    ``lms`` the three decodes' LMs (the N-best one over 12 words: the plain
    K-best Viterbi costs minutes on the CPU at 30): identical words (ranked
    lists for N-best), >= 99.9% of frames on the same state, scores within
    5 nats. ``cpu_runs``, from :func:`transcribe_cpu_references` (run in a
    worker), or made here."""
    if cpu_runs is None:
        cpu_runs = transcribe_cpu_references(model_path, dict_path, small_dir,
                                             lms, nbest)
    out = {}
    for (name, kw), lm in zip(card_vs_cpu_decodes(nbest), lms):
        got, gp, g_s, g_lv = _small_decode(model_path, dict_path, small_dir, lm,
                                           device, kw)
        want, wp, w_s = cpu_runs[name]
        if name == "lvcsr":
            _check(g_lv is not None, "card-vs-CPU LVCSR took the dense graph")
        row = {"card_s": g_s, "cpu_s": w_s, "utterances": len(want)}
        worst = 0.0
        for key, w in want.items():
            g = got[key]
            _check(g.text == w.text, f"{name} utterance {key}: {g.text!r} on the "
                   f"card, {w.text!r} on the CPU")
            if name == "nbest":
                ga = [t for t, _s in (g.alternatives or [])]
                wa = [t for t, _s in (w.alternatives or [])]
                _check(ga == wa, f"nbest utterance {key}: ranked lists differ")
                for (_t, gs), (_u, ws) in zip(g.alternatives or [], w.alternatives or []):
                    worst = max(worst, abs(gs - ws))
            worst = max(worst, abs(g.log_likelihood - w.log_likelihood))
        _check(worst < 5.0, f"{name}: scores differ by {worst}")
        row["max_score_diff"] = worst
        if name != "nbest":
            agree, frames = _path_agreement(gp, wp)
            _check(agree >= 0.999, f"{name}: state paths agree on {agree:.5f}")
            row.update(frames=frames, state_path_agreement=agree)
        out[name] = row
    return out

# -- i-vectors, diarization and segmentation ----------------------------------

# tests/test_ivector.py's inventory of "phones": tone chords
CHORDS = [[300, 2200], [550, 1700], [850, 2700], [400, 1200], [700, 3200]]


def make_speaker_wave(rng, spk: int, dur: float, shift_step=0.06, sr=16000):
    """``tests/test_ivector.py``'s tone speaker: chords of the shared
    inventory in random order, non-stationary like speech, plus noise, with
    the speaker's formant shift ``1 + shift_step * spk`` (at 0.06 the
    highest chord of speaker 7 stays under 4.6 kHz)."""
    shift = 1.0 + shift_step * spk
    pieces = []
    t_total = 0.0
    while t_total < dur:
        seg = 0.15 + 0.15 * rng.rand()
        t = np.arange(int(seg * sr)) / sr
        chord = CHORDS[rng.randint(len(CHORDS))]
        pieces.append(sum(
            3000 * np.sin(2 * np.pi * f * shift * (1 + 0.003 * rng.randn()) * t)
            for f in chord))
        t_total += seg
    wave = np.concatenate(pieces)
    return (wave + rng.randn(len(wave)) * 200).astype(np.float32)


def build_speaker_corpus(tmp: Path, num_speakers=8, per_speaker=48, min_s=4.0,
                         max_s=14.0, seed=21, name="speakers", sr=16000):
    """``num_speakers`` tone speakers of ``per_speaker`` utterances of
    min_s-max_s seconds each, in one directory a speaker (the speaker
    labels that PLDA, ``--classify`` and ``--evaluate`` read). Returns
    (dir, seconds)."""
    from montreal_forced_aligner_tpu_torch.io.wav import write_wave

    rng = np.random.RandomState(seed)
    corp = tmp / name
    total = 0.0
    for spk in range(num_speakers):
        d = corp / f"spk{spk}"
        d.mkdir(parents=True, exist_ok=True)
        for u in range(per_speaker):
            wave = make_speaker_wave(rng, spk, float(rng.uniform(min_s, max_s)), sr=sr)
            write_wave(d / f"u{u}.wav", wave, sr)
            (d / f"u{u}.lab").write_text("speech")
            total += len(wave) / sr
    return corp, total


def subset_corpus(src: Path, dst: Path, per_speaker: int) -> Path:
    """The first ``per_speaker`` utterances of each speaker of ``src``,
    linked into ``dst``."""
    for spk_dir in sorted(p for p in src.iterdir() if p.is_dir()):
        (dst / spk_dir.name).mkdir(parents=True, exist_ok=True)
        for u in range(per_speaker):
            for ext in (".wav", ".lab"):
                os.symlink(spk_dir / f"u{u}{ext}", dst / spk_dir.name / f"u{u}{ext}")
    return dst


def build_vad_set(tmp: Path, num_files=8, seconds=120.0, seed=31, name="vad",
                  sr=16000):
    """Files of about ``seconds`` s: pauses of 0.1-2.0 s of low noise
    (randn * 20) between speech bursts of 0.5-8 s from the tone speakers.
    Returns (dir, {file stem: [(pause begin, pause end), ...]}, seconds)."""
    from montreal_forced_aligner_tpu_torch.io.wav import write_wave

    rng = np.random.RandomState(seed)
    d = tmp / name
    d.mkdir(parents=True, exist_ok=True)
    pauses, total = {}, 0.0
    for i in range(num_files):
        pieces, spans, n = [], [], 0
        while n < seconds * sr:
            pause = rng.randn(int(rng.uniform(0.1, 2.0) * sr)) * 20
            spans.append((n / sr, (n + len(pause)) / sr))
            burst = make_speaker_wave(rng, rng.randint(8), rng.uniform(0.5, 8.0), sr=sr)
            pieces += [pause, burst]
            n += len(pause) + len(burst)
        pause = rng.randn(int(rng.uniform(0.1, 2.0) * sr)) * 20
        spans.append((n / sr, (n + len(pause)) / sr))
        pieces.append(pause)
        wave = np.concatenate(pieces).astype(np.float32)
        write_wave(d / f"file{i}.wav", wave, sr)
        pauses[f"file{i}"] = spans
        total += len(wave) / sr
    return d, pauses, total


def build_joined_utterance(corpus_dir: Path, tmp: Path, name="joined", sr=16000,
                           seed=41):
    """One file of ``corpus_dir``'s utterances in corpus order with 0.5 s of
    low noise between them, its transcript their texts joined. Returns
    (dir, seconds)."""
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.io.wav import write_wave

    rng = np.random.RandomState(seed)
    corpus = Corpus.load(corpus_dir)
    pieces, texts = [], []
    for utt in corpus.utterances:
        pieces += [rng.randn(sr // 2) * 20, corpus.load_audio(utt).samples]
        texts.append(utt.text)
    pieces.append(rng.randn(sr // 2) * 20)
    wave = np.concatenate(pieces).astype(np.float32)
    d = tmp / name / "spk0"
    d.mkdir(parents=True, exist_ok=True)
    write_wave(d / "joined.wav", wave, sr)
    (d / "joined.lab").write_text(" ".join(texts))
    return tmp / name, len(wave) / sr


def _extractor_arrays(ex):
    return {"weights": ex.ubm.weights, "means": ex.ubm.means,
            "variances": ex.ubm.variances, "T": ex.T, "plda_mean": ex.plda.mean,
            "plda_transform": ex.plda.transform, "plda_psi": ex.plda.psi}


def _counted(device, fn):
    """``fn()`` with every launch count set to 0 just before: (its result,
    its wall seconds, the launches read just after)."""
    from montreal_forced_aligner_tpu_torch.ops import cuda_build

    _sync(device)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0, dict(cuda_build.LAUNCHES)


def _no_launches(path, launches):
    _check(not any(launches.values()), f"{path}: kernel launches {launches}")


def train_ivector_phase(corpus_dir, out_dir, audio_s, device, num_gauss=256,
                        ivector_dim=192, num_iterations=10):
    """Main path **train-ivector**: ``cli train_ivector`` at the command's
    defaults (UBM, T-matrix, PLDA), counted from 0 (no kernel launches);
    then one warm run synchronised at each phase (its peak card memory,
    and a model bit-identical to the command's) and one profiled."""
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ivector.extractor import IvectorExtractor
    from montreal_forced_aligner_tpu_torch.ivector.pipeline import train_ivector_model
    from montreal_forced_aligner_tpu_torch.tracing import PhaseClock

    model = Path(out_dir) / "ivector.npz"
    widths = ["--num_gauss", num_gauss, "--ivector_dim", ivector_dim,
              "--num_iterations", num_iterations]
    lines, cold, launches = _counted(device, lambda: _cli(
        ["train_ivector", corpus_dir, model, "--device", device.type] + widths))
    _no_launches("train-ivector", launches)
    _check(any(l.startswith("Trained PLDA over") for l in lines),
           f"train-ivector: no PLDA in {lines}")
    corpus = Corpus.load(corpus_dir, require_transcripts=False)

    def train(clock=None):
        return train_ivector_model(corpus, num_gauss=num_gauss,
                                   ivector_dim=ivector_dim,
                                   num_iterations=num_iterations, device=device,
                                   clock=clock)

    clock = PhaseClock(device, sync=True)
    _reset_peak(device)
    t0 = time.perf_counter()
    ex = train(clock)
    with clock("save"):
        ex.save(Path(out_dir) / "ivector_warm.npz")
    warm = time.perf_counter() - t0
    peak = _peak_gib(device)
    first = _extractor_arrays(IvectorExtractor.load(model))
    second = _extractor_arrays(IvectorExtractor.load(Path(out_dir) / "ivector_warm.npz"))
    identical = all(np.array_equal(first[k], second[k]) for k in first)
    _check(identical, "train-ivector: two card runs differ")
    report = {
        "path": "train-ivector", "utterances": corpus.num_utterances,
        "speakers": len(corpus.speakers), "audio_s": audio_s,
        "num_gauss": int(ex.ubm.num_gauss), "ivector_dim": ivector_dim,
        "num_iterations": num_iterations, "launches": launches, "cold_wall_s": cold,
        "warm_synced_wall_s": warm, "phases_synced_s": dict(clock.seconds),
        "peak_gib": peak, "two_runs_identical": identical,
    }
    if device.type == "cuda":
        report["profiled_warm_run"] = profiled_run(train, device)
    return report, model


def _purity_ari(out_dir):
    from montreal_forced_aligner_tpu_torch.diarization.clustering import (
        adjusted_rand_index,
        cluster_purity,
    )

    rows = [l.split("\t") for l in
            (Path(out_dir) / "utt2spk.tsv").read_text().splitlines()]
    truth = [r[0].split("/")[0] for r in rows]
    labels = [r[3] for r in rows]
    return len(rows), cluster_purity(truth, labels), adjusted_rand_index(truth, labels)


DIARIZE_RUNS = {
    "cluster-cosine": ["--expected_num_speakers", 8, "--evaluate"],
    "cluster-plda-kmeans": ["--metric", "plda", "--cluster_type", "kmeans",
                            "--expected_num_speakers", 8],
    "classify": ["--classify"],
}


def diarize_phase(corpus_dir, model, out_dir, device, runs=DIARIZE_RUNS):
    """**diarize**: ``cli diarize_speakers`` with ``model``, once per run,
    each counted from 0 (no kernel launches): wall, purity and adjusted
    Rand index against the corpus's speakers."""
    report = {"path": "diarize", "runs": {}}
    total = {}
    for name, args in runs.items():
        out = Path(out_dir) / name
        lines, wall, launches = _counted(device, lambda: _cli(
            ["diarize_speakers", corpus_dir, model, out, "--device", device.type]
            + args))
        _no_launches(f"diarize {name}", launches)
        n, purity, ari = _purity_ari(out)
        report["runs"][name] = {"wall_s": wall, "utterances": n, "purity": purity,
                                "ari": ari, "output": lines[-1]}
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    report["launches"] = total
    return report


def _segments_of(textgrid_path):
    from montreal_forced_aligner_tpu_torch.io.textgrid import TextGrid

    return [(i.begin, i.end) for i in TextGrid.read(textgrid_path).tiers["segments"]
            if i.label]


def vad_scores(segments, pauses, duration, min_pause=0.5):
    """Segment boundaries against the true pauses: each boundary's distance
    to the nearest true pause edge (median), and the share of true pauses
    of at least ``min_pause`` s that some gap between detected segments
    overlaps."""
    edges = np.array(sorted({e for p in pauses for e in p}))
    bounds = [b for s in segments for b in s if 0.0 < b < duration]
    errors = [float(np.abs(edges - b).min()) for b in bounds]
    gaps = [(0.0, duration)]
    if segments:
        gaps = ([(0.0, segments[0][0])]
                + [(a[1], b[0]) for a, b in zip(segments[:-1], segments[1:])]
                + [(segments[-1][1], duration)])
    long = [p for p in pauses if p[1] - p[0] >= min_pause]
    found = [p for p in long
             if any(min(p[1], g[1]) > max(p[0], g[0]) for g in gaps)]
    return errors, len(found), len(long)


def vad_phase(vad_dir, pauses, out_dir, audio_s, device,
              formats=("long_textgrid", "csv")):
    """**vad**: ``cli create_segments_vad`` on the VAD set at its defaults,
    once per format, counted from 0 (no kernel launches): wall, segments,
    and against the true pauses the median boundary error and the share of
    pauses of at least 0.5 s found."""
    from montreal_forced_aligner_tpu_torch.io.wav import read_wave

    report = {"path": "vad", "files": len(pauses), "audio_s": audio_s, "walls_s": {}}
    total = {}
    for fmt in formats:
        out = Path(out_dir) / fmt
        _lines, wall, launches = _counted(device, lambda: _cli(
            ["create_segments_vad", vad_dir, out, "--output_format", fmt,
             "--device", device.type]))
        _no_launches(f"vad {fmt}", launches)
        ext = ".TextGrid" if fmt.endswith("textgrid") else f".{fmt}"
        _check(sorted(p.name for p in out.iterdir())
               == sorted(f"{stem}{ext}" for stem in pauses), f"vad {fmt}: outputs")
        report["walls_s"][fmt] = wall
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    errors, found, long = [], 0, 0
    segments = 0
    for stem, spans in pauses.items():
        segs = _segments_of(Path(out_dir) / "long_textgrid" / f"{stem}.TextGrid")
        duration = read_wave(Path(vad_dir) / f"{stem}.wav").duration
        e, f, n = vad_scores(segs, spans, duration)
        errors += e
        found, long, segments = found + f, long + n, segments + len(segs)
    report.update(launches=total, segments=segments,
                  median_boundary_error_s=float(np.median(errors)),
                  pauses_found=found, pauses_over_0_5_s=long,
                  pauses_found_share=found / max(long, 1))
    return report


def _long_path_launches(recorder, device):
    """Launches the chunked long path makes for the recorded
    ``viterbi_align_long`` calls: per call of T frames in chunks of
    ``chunk``, ceil(T / chunk) chunks through K1 in both sweeps, K2 in the
    backward one, and K3 in both where the model takes it (none on the
    CPU)."""
    from montreal_forced_aligner_tpu_torch.ops import long_viterbi as LV

    want = {"band_forward": 0, "band_backtrace": 0, "state_emission": 0}
    if device.type != "cuda":
        return want
    for (feats, *_rest), kw in recorder.all_args:
        chunks = -(-feats.shape[0] // (kw.get("chunk") or LV.CHUNK_FRAMES))
        want["band_forward"] += 2 * chunks
        want["band_backtrace"] += chunks
        want["state_emission"] += 2 * chunks if kw["use_emission_kernel"] else 0
    return want


def create_segments_phase(model_path, dict_path, long_dir, out_dir, device, reps=3):
    """Main path **create-segments**: ``cli create_segments`` with the
    SAT-scale model on the long utterance (the single-utterance two-pass
    through the chunked path), counted from 0: launches exactly as the long
    path's formula gives, the segments' words joined equal to the
    transcript; then K3, K1 and K2 on the final pass's last chunk against
    their plain versions."""
    import montreal_forced_aligner_tpu_torch.online.alignment as online_mod
    from montreal_forced_aligner_tpu_torch.ops import long_viterbi as LV

    out = Path(out_dir)
    rec = CallRecorder(online_mod, "viterbi_align_long", device)
    with rec:
        lines, wall, launches = _counted(device, lambda: _cli(
            ["create_segments", long_dir, dict_path, model_path, out, "--device",
             device.type]))
    want = _long_path_launches(rec, device)
    _check(launches == want,
           f"create-segments: launches {launches}, expected {want}")
    _check(rec.calls == 2, f"create-segments: {rec.calls} chunked decodes")
    (lab,) = sorted(Path(long_dir).rglob("*.lab"))
    (tg,) = sorted(out.rglob("*.TextGrid"))
    from montreal_forced_aligner_tpu_torch.io.textgrid import TextGrid

    segs = [i for i in TextGrid.read(tg).tiers["segments"] if i.label]
    _check(" ".join(i.label for i in segs) == " ".join(lab.read_text().split()),
           "create-segments: the segments' words differ from the transcript")
    lengths = [i.end - i.begin for i in segs]
    (feats, garrs, gmm), kw = rec.last_args
    scale, use_k = kw["acoustic_scale"], kw["use_emission_kernel"]
    chunk = kw.get("chunk") or LV.CHUNK_FRAMES
    lg = LV.prepare_long_graph(garrs, feats.device)
    _check(lg.band_limits is not None, "create-segments: graph outside the band buckets")
    checkpoints, best, _score = LV.long_forward_sweep(feats, lg, gmm, scale, chunk,
                                                      use_k)
    path = LV.long_backward_sweep(feats, lg, gmm, scale, chunk, use_k, checkpoints,
                                  best)
    return {
        "path": "create-segments", "wall_s": wall, "launches": launches,
        "segments": len(segs), "words": sum(len(i.label.split()) for i in segs),
        "segment_s_min_max": [min(lengths), max(lengths)], "T": int(feats.shape[0]),
        "chunks": len(checkpoints), "output": lines[-1],
        "last_chunk": last_chunk_checks(feats, lg, gmm, scale, chunk, use_k,
                                        checkpoints, best, path, reps, device),
    }


def segmentation_references(subset_dir, vad_dir, joined_dir, model_path, dict_path,
                            device_name, num_gauss=256, ivector_dim=192):
    """The segmentation slice on one device, for the card-against-CPU
    check: ``train_ivector_model`` at the given width on ``subset_dir``, its
    i-vectors, cluster labels (agglomerative, 8 speakers) and classify
    labels; each VAD file's log energies, voiced frames and segments; and
    ``segment_transcribed_file`` of ``joined_dir``'s one file."""
    import torch

    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.diarization.speaker_diarizer import (
        SpeakerDiarizer,
    )
    from montreal_forced_aligner_tpu_torch.io.wav import read_wave
    from montreal_forced_aligner_tpu_torch.ivector.pipeline import (
        corpus_feature_batches,
        train_ivector_model,
    )
    from montreal_forced_aligner_tpu_torch.vad import segmenter as V
    from montreal_forced_aligner_tpu_torch.vad.transcript_segmenter import (
        segment_transcribed_file,
    )

    dev = torch.device(device_name)
    corpus = Corpus.load(subset_dir, require_transcripts=False)
    ex = train_ivector_model(corpus, num_gauss=num_gauss, ivector_dim=ivector_dim,
                             device=dev)
    batches, order = corpus_feature_batches(corpus, device=dev)
    diarizer = SpeakerDiarizer(ex, plda=ex.plda, device=dev)
    result = diarizer.cluster_utterances(batches, num_speakers=len(corpus.speakers))
    iv = result.ivectors
    enrolled = {s: iv[[p for p, u in enumerate(order)
                       if corpus.utterances[u].speaker == s]].mean(axis=0)
                for s in corpus.speakers}
    feats = np.concatenate([f[b, :n].cpu().numpy() for f, lens in batches
                            for b, n in enumerate(lens)])
    out = {"extractor": _extractor_arrays(ex), "ivectors": iv, "features": feats,
           "cluster": result.labels,
           "classify": diarizer.classify_speakers(batches, enrolled, ivectors=iv),
           "vad": {}}
    cfg = V.SegmenterConfig()
    for wav in sorted(Path(vad_dir).glob("*.wav")):
        log_e = V.frame_log_energy(read_wave(wav).samples, device=dev)
        threshold = cfg.energy_threshold + cfg.energy_mean_scale * log_e.mean()
        voiced = log_e > threshold
        out["vad"][wav.stem] = (log_e, float(threshold), voiced,
                                V.segments_from_vad(voiced, cfg))
    aligner = PretrainedAligner(model_path, dict_path, AlignerConfig(), device=dev)
    joined = Corpus.load(joined_dir)
    (utt,) = joined.utterances
    out["segments"] = [(s.begin, s.end, s.text) for s in segment_transcribed_file(
        aligner, joined.load_audio(utt).samples, utt.text)]
    return out


def segmentation_card_vs_cpu(card, cpu, frame_s=0.01):
    """Each deviation of the card's segmentation slice from the CPU's,
    beside its bar: the UBM's Gaussian count equal; weights, means,
    variances and T within 1e-3 of each array's largest magnitude; every
    i-vector's cosine with its CPU twin >= 0.999; cluster and classify
    labels identical; VAD voiced frames identical except those within 1e-4
    of the threshold, segment lists identical; the transcript segments'
    texts identical, boundaries within one frame."""
    feats_err = float(np.abs(card["features"] - cpu["features"]).max())
    ce, pe = card["extractor"], cpu["extractor"]
    _check(len(ce["weights"]) == len(pe["weights"]),
           f"UBM Gaussians: card {len(ce['weights'])}, CPU {len(pe['weights'])}")
    rel = {}
    for k in ("weights", "means", "variances", "T"):
        rel[k] = float(np.abs(ce[k] - pe[k]).max() / np.abs(pe[k]).max())
        _check(rel[k] <= 1e-3, f"card vs CPU: {k} differs by {rel[k]} of its largest")
    a, b = card["ivectors"], cpu["ivectors"]
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    _check(cos.min() >= 0.999, f"card vs CPU: an i-vector's cosine is {cos.min()}")
    _check(np.array_equal(card["cluster"], cpu["cluster"]), "card vs CPU: cluster labels")
    _check(card["classify"] == cpu["classify"], "card vs CPU: classify labels")
    worst_e, near, frames = 0.0, 0, 0
    for stem, (log_e, thr, voiced, segs) in cpu["vad"].items():
        c_log_e, _c_thr, c_voiced, c_segs = card["vad"][stem]
        worst_e = max(worst_e, float(np.abs(c_log_e - log_e).max()))
        differ = c_voiced != voiced
        _check(np.all(np.abs(log_e[differ] - thr) < 1e-4),
               f"VAD {stem}: voiced frames differ away from the threshold")
        near += int(differ.sum())
        frames += len(voiced)
        _check(c_segs == segs, f"VAD {stem}: segment lists differ")
    cs, ps = card["segments"], cpu["segments"]
    _check([s[2] for s in cs] == [s[2] for s in ps],
           "create_segments: segment texts differ between the card and the CPU")
    worst_b = max(max(abs(x[0] - y[0]), abs(x[1] - y[1])) for x, y in zip(cs, ps))
    _check(worst_b <= frame_s + 1e-9, f"create_segments: boundaries differ by {worst_b}")
    return {
        "ivector": {"utterances": len(a), "num_gauss": len(pe["weights"]),
                    "features_max_abs_diff": feats_err,
                    "features_max_abs": float(np.abs(cpu["features"]).max()),
                    "rel_err": rel, "rel_err_bar": 1e-3,
                    "min_cosine": float(cos.min()), "min_cosine_bar": 0.999,
                    "cluster_labels_identical": True,
                    "classify_labels_identical": True},
        "vad": {"files": len(cpu["vad"]), "frames": frames,
                "log_energy_max_abs_diff": worst_e,
                "voiced_frames_differing_near_threshold": near,
                "near_threshold_bar": 1e-4, "segment_lists_identical": True},
        "create_segments": {"segments": len(ps), "texts_identical": True,
                            "max_boundary_diff_s": worst_b, "bar_s": frame_s},
    }


# -- G2P, rules, language and FLAC: the g2p-align and train-g2p paths ---------


def phone_spellings(phones):
    """A prefix-free spelling of each phone: the first 20 by one letter
    (a-t), the others by two, headed by one of the other six letters
    (u-z), so a word's spelling determines its phones."""
    singles = "abcdefghijklmnopqrst"
    return {p: singles[i] if i < 20 else "uvwxyz"[(i - 20) % 6] + singles[(i - 20) // 6]
            for i, p in enumerate(phones)}


def build_spelled_lexicon(tmp: Path, phones, num_words=400, held_out=100, seed=0):
    """``num_words`` spelled words of 2-7 phones drawn from the seed; all but
    ``held_out`` of them go to the alignment dictionary. Returns (dictionary
    path, {word: phones}, the held-out words)."""
    rng = np.random.RandomState(seed)
    spell = phone_spellings(phones)
    words = {}
    while len(words) < num_words:
        ph = [phones[k] for k in rng.randint(len(phones), size=rng.randint(2, 8))]
        words.setdefault("".join(spell[p] for p in ph), ph)
    held = sorted(rng.choice(sorted(words), held_out, replace=False))
    dict_path = tmp / "spelled.dict"
    dict_path.write_text("".join(f"{w}\t{' '.join(words[w])}\n"
                                 for w in sorted(words) if w not in set(held)))
    return dict_path, words, held


def g2p_rules_yaml(phones) -> str:
    """Three context rules over ``phones`` in the reference schema: a
    word-initial substitution of either of two phones, a deletion after a
    phone, and a word-final substitution."""
    p = [phones[i % len(phones)] for i in (7, 8, 9, 12, 3, 5, 6)]
    return ("rules:\n"
            f"  - segment: {p[0]}|{p[1]}\n    preceding_context: ^\n"
            f"    replacement: {p[2]}\n"
            f"  - segment: {p[3]}\n    preceding_context: {p[4]}\n"
            "    replacement: ''\n"
            f"  - segment: {p[5]}\n    following_context: $\n"
            f"    replacement: {p[6]}\n")


def _digest(samples) -> str:
    import hashlib

    a = np.asarray(samples, dtype="<i8")
    return hashlib.sha1(np.ascontiguousarray(a.reshape(len(a), -1)).tobytes()
                        ).hexdigest()


def build_flac_corpus(wav_dir: Path, tmp: Path, words, seed=5, name="flac",
                      words_per_s=2.5):
    """The WAV corpus of :func:`build_corpus` rewritten as FLAC with new
    transcripts (``words_per_s`` words a second drawn from ``words``). The
    first block of every file is zeroed (digital silence, so CONSTANT
    subframes), and the first file is stereo: its second channel is half the
    first plus seeded noise, and the corpus reads the first. Returns (dir,
    audio seconds, {flac path: digest of the samples written})."""
    from montreal_forced_aligner_tpu_torch.io.wav import read_wave

    rng = np.random.RandomState(seed)
    words = sorted(words)
    out = tmp / name
    items, total = [], 0.0
    for i, wav in enumerate(sorted(Path(wav_dir).rglob("*.wav"))):
        dst = (out / wav.relative_to(wav_dir)).with_suffix(".flac")
        dst.parent.mkdir(parents=True, exist_ok=True)
        x = read_wave(wav, native=True).samples.astype(np.int64)
        x[:FLAC_BLOCK] = 0
        if i == 0:
            x = np.stack([x, np.clip(x // 2 + rng.randint(-64, 64, len(x)),
                                     -32768, 32767)], 1)
        items.append((dst, x, SR, {"seed": i}))
        seconds = len(x) / SR
        n_words = max(2, int(seconds * words_per_s))
        dst.with_suffix(".lab").write_text(" ".join(rng.choice(words, n_words)))
        total += seconds
    write_flac_files(items)
    return out, total, {str(p): _digest(x) for p, x, _sr, _o in items}


def build_g2p_fixture(tmp: Path, phones, wav_dir: Path, subset=8, num_words=400,
                      held_out=100):
    """The g2p-align path's inputs: the spelled dictionary and its held-out
    words, the rules, the FLAC corpus, and a copy of its ``subset``
    shortest files for the card-against-CPU check. The G2P model is trained
    by :func:`g2p_align_phase`."""
    import shutil

    tmp.mkdir(parents=True, exist_ok=True)
    dict_path, words, held = build_spelled_lexicon(tmp, phones, num_words, held_out)
    rules_path = tmp / "rules.yaml"
    rules_path.write_text(g2p_rules_yaml(phones))
    t0 = time.perf_counter()
    flac_dir, audio_s, written = build_flac_corpus(wav_dir, tmp, list(words))
    writer_s = time.perf_counter() - t0
    small_dir = tmp / "flac_small"
    for path in sorted(written, key=lambda p: Path(p).stat().st_size)[:subset]:
        src = Path(path)
        dst = small_dir / src.relative_to(flac_dir)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, dst)
        shutil.copy(src.with_suffix(".lab"), dst.with_suffix(".lab"))
    return {"dict_path": dict_path, "words": words, "held_out": held,
            "rules_path": rules_path, "flac_dir": flac_dir, "small_dir": small_dir,
            "audio_s": audio_s, "written": written, "writer_s": writer_s,
            "g2p_path": tmp / "g2p_model.zip"}


def g2p_prepare(tmp: Path, phones, wav_dir: Path):
    """:func:`build_g2p_fixture`, then ``cli train_g2p`` on its dictionary
    (the pair-ngram engine), timed."""
    fx = build_g2p_fixture(tmp, phones, wav_dir)
    t0 = time.perf_counter()
    _cli(["train_g2p", fx["dict_path"], fx["g2p_path"]])
    fx["g2p_train_s"] = time.perf_counter() - t0
    return fx


def flac_plain_decode(paths):
    """Each FLAC file through the plain Python frame decoder: {path:
    (digest of the samples, md5_ok)}. ``decode_flac`` is pointed at the
    Python decoder for the call and restored after."""
    from montreal_forced_aligner_tpu_torch.io import flac

    native = flac._decode_frames_native
    flac._decode_frames_native = flac._decode_frames_python
    try:
        out = {}
        for p in paths:
            st = flac.decode_flac(p)
            out[str(p)] = (_digest(st.samples), st.md5_ok)
        return out
    finally:
        flac._decode_frames_native = native


def g2p_aligner(model_path, fx, device, batch_size=32):
    """A :class:`PretrainedAligner` of the g2p-align path: the spelled
    dictionary with the rules, the G2P model and the English tokenizer."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )

    return PretrainedAligner(
        model_path, fx["dict_path"],
        AlignerConfig(batch_size=batch_size, language="english"),
        g2p_model_path=fx["g2p_path"], rules_path=fx["rules_path"], device=device)


def g2p_align_run(model_path, fx, corpus_dir, device, batch_size=32):
    """One aligner of the g2p-align path on ``corpus_dir``: (results, the
    held-out words' generated pronunciations)."""
    import torch

    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    aligner = g2p_aligner(model_path, fx, torch.device(device), batch_size)
    results = aligner.align_corpus(Corpus.load(corpus_dir))
    lex = aligner.lexicon.words
    return results, {w: [p.phones for p in lex[w]] for w in fx["held_out"]
                     if w in lex}


def g2p_align_phase(model_path, fx, out_dir, device, batch_size=32, warm_runs=3,
                    sm_clock_mhz=None):
    """Main path **g2p-align** on :func:`g2p_prepare`'s fixture and G2P
    model: the model's word accuracy on the held-out words; every FLAC file
    decoded natively (the writer's samples bit for bit, MD5 verified); then
    ``cli align`` with ``--g2p_model_path``, ``--rules_path`` and
    ``--language english`` on the FLAC corpus, counted from 0, every kernel
    call recorded and the G2P lookups timed; then the same aligner through
    the API: its first run (held-out tokens aligned with G2P
    pronunciations), ``warm_runs`` warm runs, one synchronised at each
    phase and, on the card, one profiled. Returns (report, the kernels held
    on the first batch of pass 2)."""
    import contextlib

    import montreal_forced_aligner_tpu_torch.align.aligner as aligner_mod
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.g2p.generator import (
        G2PGenerator,
        evaluate_g2p,
    )
    from montreal_forced_aligner_tpu_torch.g2p.trainer import G2PModel
    from montreal_forced_aligner_tpu_torch.io.flac import decode_flac

    words, held = fx["words"], fx["held_out"]
    accuracy = evaluate_g2p(G2PGenerator(G2PModel.load(fx["g2p_path"])),
                            [(w, words[w]) for w in held])

    t0 = time.perf_counter()
    stereo = 0
    for path, digest in fx["written"].items():
        st = decode_flac(path)
        _check(st.md5_ok is True, f"{path}: the STREAMINFO MD5 does not match")
        _check(_digest(st.samples) == digest,
               f"{path}: the native decode differs from the samples written")
        stereo += st.num_channels == 2
    native_decode_s = time.perf_counter() - t0
    _check(stereo == 1, f"{stereo} stereo files in the FLAC corpus")

    g2p_s = [0.0]
    add_g2p = aligner_mod.PretrainedAligner._add_g2p_pronunciations

    def timed_add(self, *args):
        t = time.perf_counter()
        try:
            return add_g2p(self, *args)
        finally:
            g2p_s[0] += time.perf_counter() - t

    argv = ["align", fx["flac_dir"], fx["dict_path"], model_path, out_dir,
            "--g2p_model_path", fx["g2p_path"], "--rules_path", fx["rules_path"],
            "--language", "english", "--batch_size", batch_size,
            "--device", device.type]
    counted = record_kernel_calls(device)
    _reset_peak(device)
    with contextlib.ExitStack() as stack:
        for rec in counted.values():
            stack.enter_context(rec)
        aligner_mod.PretrainedAligner._add_g2p_pronunciations = timed_add
        stack.callback(setattr, aligner_mod.PretrainedAligner,
                       "_add_g2p_pronunciations", add_g2p)
        _lines, cold_wall, launches = _counted(device, lambda: _cli(argv))
    peak = _peak_gib(device)
    corpus = Corpus.load(fx["flac_dir"])
    n_utts = corpus.num_utterances
    n_batches = -(-n_utts // batch_size)
    textgrids = len(list(Path(out_dir).rglob("*.TextGrid")))
    _check(textgrids == len(corpus.files), f"{textgrids} TextGrids written")
    on_card = device.type == "cuda"
    for name, n in launches.items():
        _check(n > 0 or not on_card, f"g2p-align: kernel {name} never launched")
    bands = sorted({(a[0][4], a[0][5]) for a in counted["band_forward"].all_args})

    aligner = g2p_aligner(model_path, fx, device, batch_size)
    lex = aligner.lexicon.words
    rule_variants = sum(len(prons) - 1 for prons in lex.values())
    _check(rule_variants > 0, "the rules added no pronunciation variant")
    t0 = time.perf_counter()
    results = aligner.align_corpus(corpus)
    _sync(device)
    first_wall = time.perf_counter() - t0
    _check(len(results) == n_utts, f"{len(results)} of {n_utts} utterances aligned")
    for key, aln in results.items():
        _check(aln.words and aln.phones and np.isfinite(aln.log_likelihood)
               and aln.log_likelihood > -1e29, f"utterance {key}: bad alignment")
    held_set = set(held)
    held_tokens = sum(t in held_set for u in corpus.utterances
                      for t in u.normalized_tokens)
    aligned_g2p = sum(w.label in held_set for a in results.values() for w in a.words)
    oov_tokens = sum(w.label == aligner.lexicon.oov_word
                     for a in results.values() for w in a.words)
    _check(aligned_g2p > 0, "no held-out token aligned with a G2P pronunciation")
    warm = []
    for _ in range(warm_runs):
        t0 = time.perf_counter()
        aligner.align_corpus(corpus)
        _sync(device)
        warm.append(time.perf_counter() - t0)
    aligner.sync_phases = True
    t0 = time.perf_counter()
    aligner.align_corpus(corpus)
    synced_wall = time.perf_counter() - t0
    phases = dict(aligner.last_phase_seconds)
    aligner.sync_phases = False
    profiled = profile_warm_run(aligner, fx["flac_dir"]) if on_card else None
    # K1's plain version takes seconds at this path's band (16, 64): its
    # check's own call gives its time
    checks = kernel_checks(batch_inputs(counted, n_batches), aligner.gmm, device,
                           sm_clock_mhz=sm_clock_mhz, k1_plain_reps=0)
    del counted, aligner
    audio_s = fx["audio_s"]
    median = statistics.median(warm)
    return {
        "path": "g2p-align",
        "utterances": n_utts,
        "audio_s": audio_s,
        "flac_files": len(fx["written"]),
        "flac_writer_s": fx["writer_s"],
        "flac_native_decode_s": native_decode_s,
        "g2p_train_s": fx["g2p_train_s"],
        "g2p_held_out_word_accuracy": accuracy["word_accuracy"],
        "g2p_held_out_phone_error_rate": accuracy["phone_error_rate"],
        "dictionary_words": len(words) - len(held),
        "rule_variants": rule_variants,
        "batches": n_batches,
        "band_buckets": [list(b) for b in bands],
        "launches": launches,
        "expected_launches": {k: 2 * n_batches * on_card for k in launches},
        "cold_wall_s": cold_wall,
        "cold_audio_s_per_s": audio_s / cold_wall,
        "add_g2p_pronunciations_s": g2p_s[0],
        "peak_gib": peak,
        "first_api_wall_s": first_wall,
        "held_out_tokens": held_tokens,
        "held_out_tokens_aligned_by_g2p": aligned_g2p,
        "oov_tokens": oov_tokens,
        "warm_walls_s": warm,
        "warm_median_wall_s": median,
        "warm_audio_s_per_s": audio_s / median,
        "synced_wall_s": synced_wall,
        "phases_synced_s": phases,
        "profiled_warm_run": profiled,
    }, checks


def g2p_card_vs_cpu(card, cpu, frame_shift=0.01):
    """g2p-align's card run on the subset against the CPU's: the same G2P
    entries, and the JAX package's parity bar."""
    (r_card, g_card), (r_cpu, g_cpu) = card, cpu
    _check(g_card == g_cpu, "G2P entries differ between the card and the CPU")
    return {"utterances": len(r_cpu), "g2p_words": len(g_cpu),
            **parity(r_card, r_cpu, frame_shift)}


def flac_plain_check(fx, plain):
    """The plain Python decoder's digests (:func:`flac_plain_decode`, in
    workers) against the samples written, file by file."""
    _check(set(plain) == set(fx["written"]), "plain decode: files differ")
    for path, (digest, md5_ok) in plain.items():
        _check(md5_ok is True, f"{path}: plain decode MD5 does not match")
        _check(digest == fx["written"][path],
               f"{path}: the plain decode differs from the native one")
    return {"files": len(plain), "identical": True}


TRAIN_G2P_RULES = ("rules:\n  - segment: aa\n    preceding_context: bb\n"
                   "    following_context: $\n    replacement: ''\n")


def train_g2p_phase(tmp: Path, device, n_utts=14):
    """A ``TrainableAligner`` with a monophone stage at TINY_RECIPE's widths
    and a pron_prob stage with ``train_g2p`` on train-reference's tone
    corpus, with rules: twice on the card (the same regenerated lexicon,
    bit-identical models) and once on the CPU (the same lexicon)."""
    import torch

    import montreal_forced_aligner_tpu_torch.training.pronunciation as pron_mod
    from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    tmp.mkdir(parents=True, exist_ok=True)
    corpus_dir, _truths = make_tone_corpus(tmp, n_utts=n_utts)
    dict_path = tmp / "tone.dict"
    dict_path.write_text(
        "".join(f"{w}\t{' '.join(p)}\n" for w, p in WORD_PHONES.items()))
    rules_path = tmp / "tone_rules.yaml"
    rules_path.write_text(TRAIN_G2P_RULES)
    name, kind, iters, gauss, _leaves = TINY_RECIPE[0]
    recipe = [StageConfig(name, kind, iters, gauss),
              StageConfig("pron_prob", "pron_prob", 0, 0, train_g2p=True)]
    train_lexicon = pron_mod.train_g2p_lexicon

    def run(dev):
        g2p_s = [0.0]

        def timed(*args, **kwargs):
            t = time.perf_counter()
            try:
                return train_lexicon(*args, **kwargs)
            finally:
                g2p_s[0] += time.perf_counter() - t

        ta = TrainableAligner(
            corpus_dir, dict_path, recipe=recipe,
            base_config=TrainerConfig(boost_silence=1.0), batch_size=4,
            variable_length_topology=False, rules_path=rules_path, device=dev)
        pron_mod.train_g2p_lexicon = timed
        try:
            t0 = time.perf_counter()
            model = ta.train()
            _sync(dev)
            wall = time.perf_counter() - t0
        finally:
            pron_mod.train_g2p_lexicon = train_lexicon
        _check(len(getattr(ta, "g2p_models", {})) == 1, "no G2P model trained")
        lexicon = {w: [(p.phones, p.probability) for p in prons]
                   for w, prons in ta.lexicon.words.items()}
        gmm = model.gmm
        arrays = [model.transition_model.log_probs, gmm.weights,
                  gmm.means_invvars, gmm.inv_vars, gmm.gconsts]
        return {"lexicon": lexicon, "arrays": arrays, "wall_s": wall,
                "stage_s": dict(ta.stage_seconds), "train_g2p_lexicon_s": g2p_s[0]}

    runs = {"card_1": run(device), "card_2": run(device),
            "cpu": run(torch.device("cpu"))}
    ref = runs["card_1"]
    _check(ref["lexicon"] == runs["card_2"]["lexicon"],
           "two card runs regenerated different lexicons")
    _check(all(np.array_equal(a, b) for a, b in
               zip(ref["arrays"], runs["card_2"]["arrays"])),
           "two card runs trained different models")
    _check(ref["lexicon"] == runs["cpu"]["lexicon"],
           "the card and the CPU regenerated different lexicons")
    stage = ref["stage_s"]["pron_prob"]
    return {
        "path": "train-g2p",
        "utterances": n_utts,
        "walls_s": {k: r["wall_s"] for k, r in runs.items()},
        "stage_s": {k: r["stage_s"] for k, r in runs.items()},
        "pron_prob_stage_s": stage,
        "train_g2p_lexicon_s": ref["train_g2p_lexicon_s"],
        "g2p_share_of_stage": ref["train_g2p_lexicon_s"] / stage,
        "lexicon_words": len(ref["lexicon"]),
        "lexicon_pronunciations": sum(len(v) for v in ref["lexicon"].values()),
        "card_runs_identical": True,
        "card_cpu_lexicon_identical": True,
    }


KERNELS = [
    ("band_forward", "montreal_forced_aligner_tpu_torch/csrc/band_viterbi.cu",
     "montreal_forced_aligner_tpu/ops/pallas_viterbi.py:151"),
    ("band_backtrace", "montreal_forced_aligner_tpu_torch/csrc/band_viterbi.cu",
     "montreal_forced_aligner_tpu/ops/pallas_viterbi.py:244"),
    ("state_emission", "montreal_forced_aligner_tpu_torch/csrc/state_emission.cu",
     "montreal_forced_aligner_tpu/ops/pallas_emission.py:147"),
]


# -- multi-GPU phases ----------------------------------------------------------
#
# The script needs one card, so the ranks of these phases are one rank on
# NCCL (in this process) or two ranks sharing the card over gloo (spawned,
# or launched by torch.distributed.run): they measure the protocol, not
# scaling.

MONO_STAGE = ("monophone", "mono", 4, 64)  # bench.py's train workload


def _mono_trainer(corpus_dir, dict_path, device, batch_size=32, **kw):
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    return TrainableAligner(
        corpus_dir, dict_path, recipe=[StageConfig(*MONO_STAGE)],
        batch_size=batch_size, variable_length_topology=False, device=device,
        **kw)


def _mono_summary(ta, model):
    """A trained monophone model's arrays and its iteration log."""
    gmm = model.gmm
    return {
        "arrays": {"tm": np.asarray(model.transition_model.log_probs),
                   "weights": gmm.weights, "miv": gmm.means_invvars,
                   "iv": gmm.inv_vars, "gconsts": gmm.gconsts},
        "loglikes": _loglikes(ta.trainers["monophone"]),
        "gaussians": [e["num_gaussians"]
                      for e in ta.trainers["monophone"].iteration_log],
        "utterances": ta.corpus.num_utterances,
    }


def _same_arrays(a, b) -> bool:
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def _train_bars(got, want):
    """The JAX package's test_training_matches_single_device bars: the same
    Gaussian counts per iteration, log-likelihood per frame within 2e-3,
    transition log-probabilities within 1e-4."""
    _check(got["gaussians"] == want["gaussians"],
           f"Gaussians {got['gaussians']} != {want['gaussians']}")
    ll = float(np.max(np.abs(np.subtract(got["loglikes"], want["loglikes"]))))
    tm = float(np.max(np.abs(got["arrays"]["tm"] - want["arrays"]["tm"])))
    _check(ll <= 2e-3, f"log-likelihood per frame differs by {ll}")
    _check(tm <= 1e-4, f"transition log-probabilities differ by {tm}")
    return {"max_loglike_diff": ll, "max_log_prob_diff": tm}


def _aligned(model_path, dict_path, corpus_dir, device, adaptation,
             distributed=False, batch_size=32):
    """One counted ``align_corpus``: (results, wall, launches, aligner)."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build

    al = PretrainedAligner(model_path, dict_path, AlignerConfig(
        batch_size=batch_size, uses_speaker_adaptation=adaptation,
        distributed=distributed), device=device)
    corpus = Corpus.load(corpus_dir)
    _sync(device)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    res = al.align_corpus(corpus)
    _sync(device)
    wall = time.perf_counter() - t0
    _check(len(res) == corpus.num_utterances, "not every utterance aligned")
    return res, wall, dict(cuda_build.LAUNCHES), al


def _identical(got, want):
    """Intervals and scores identical, utterance by utterance."""
    def key(a):
        return ([(p.label, p.begin, p.end) for p in a.phones],
                [(w.label, w.begin, w.end) for w in a.words], a.log_likelihood)

    _check(sorted(got) == sorted(want), "different utterances")
    bad = [i for i in want if key(got[i]) != key(want[i])]
    _check(not bad, f"utterances {bad[:5]} differ")
    return True


def _intervals_identical(got, want):
    def key(a):
        return ([(p.label, p.begin, p.end) for p in a.phones],
                [(w.label, w.begin, w.end) for w in a.words])

    bad = [i for i in want if key(got[i]) != key(want[i])]
    _check(sorted(got) == sorted(want) and not bad,
           f"intervals differ in utterances {bad[:5]}")
    return {"utterances": len(want),
            "max_score_diff": max(abs(got[i].log_likelihood - want[i].log_likelihood)
                                  for i in want)}


def _two_pass_bar(got, want, frame_shift=0.01):
    """sat-2pass across rank counts: the parity bar and identical phone
    sequences (the JAX test_sat_model_distributed_two_pass)."""
    out = parity(got, want, frame_shift)
    bad = [i for i in want if [p.label for p in got[i].phones]
           != [p.label for p in want[i].phones]]
    _check(not bad, f"phone sequences differ in utterances {bad[:5]}")
    return out


def _require_kernels(path, launches, on_card, names=("band_forward",
                                                     "band_backtrace",
                                                     "state_emission")):
    """Every kernel in ``names`` launched on the card; on the CPU (the
    rehearsal) none, since each wrapper takes its plain version there."""
    for name in names:
        _check((launches.get(name, 0) > 0) == on_card,
               f"{path}: {name} launched {launches.get(name, 0)} times")


def nccl_one_rank_phase(model_path, dict_path, corpus_dir, tmp, device):
    """**align-distributed / train-distributed, W = 1 on NCCL**: a real
    ``init_process_group("nccl")`` of one rank in this process, then
    ``align_corpus`` with ``distributed`` (sat-2pass and sat-si) and
    ``train --distributed``'s ``TrainableAligner`` (train-mono, its
    statistics through NCCL's all_reduce) against the same runs without a
    process group: intervals, scores and the model identical. Each is timed
    in turns, plain, distributed, distributed, plain (the first distributed
    training sets NCCL's communicator up)."""
    import torch

    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.parallel import multihost

    paths = (("sat-2pass", True), ("sat-si", False))

    def train(**kw):
        ta = _mono_trainer(corpus_dir, dict_path, device, **kw)
        _sync(device)
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        summary = _mono_summary(ta, ta.train())
        _sync(device)
        return (summary, time.perf_counter() - t0, dict(cuda_build.LAUNCHES), ta)

    def plain_runs():
        for path, adaptation in paths:
            res, wall, _l, _a = _aligned(model_path, dict_path, corpus_dir,
                                         device, adaptation)
            plain.setdefault(path, []).append((res, wall))
        plain.setdefault("train-mono", []).append(train()[:2])

    plain, dist = {}, {}
    plain_runs()
    on_card = device.type == "cuda"
    # NCCL carries card tensors only: the CPU rehearsal runs one gloo rank
    backend = "nccl" if on_card else "gloo"
    rank, world = multihost.initialize_multihost(
        f"file://{tmp / 'nccl_store'}", world_size=1, rank=0, backend=backend,
        device=device.type)
    try:
        _check(torch.distributed.get_backend() == backend and world == 1,
               f"the process group is not one rank on {backend}")
        for _ in range(2):
            for path, adaptation in paths:
                res, wall, launches, al = _aligned(
                    model_path, dict_path, corpus_dir, device, adaptation,
                    distributed=True)
                _check(al.mesh is not None and al.mesh.world_size == 1,
                       "the aligner has no one-rank mesh")
                _require_kernels(f"{path} (W = 1, NCCL)", launches, on_card)
                dist.setdefault(path, []).append((res, wall, launches))
            _reset_peak(device)
            summary, wall, launches, ta = train(distributed=True)
            _check(ta.mesh is not None and ta.mesh.world_size == 1,
                   "no train mesh")
            _require_kernels("train-mono (W = 1, NCCL)", launches, on_card,
                             ("band_forward", "band_backtrace"))
            dist.setdefault("train-mono", []).append((summary, wall, launches))
    finally:
        multihost.shutdown_multihost()
    plain_runs()
    out = {}
    for path, _adaptation in paths:
        want = plain[path][0][0]
        for run in dist[path] + plain[path][1:]:
            _identical(run[0], want)
        out[path] = {"identical": True, "launches": dist[path][0][2],
                     "walls_s": [r[1] for r in dist[path]],
                     "plain_walls_s": [r[1] for r in plain[path]]}
    want = plain["train-mono"][0][0]
    for run in dist["train-mono"] + plain["train-mono"][1:]:
        _check(_same_arrays(run[0]["arrays"], want["arrays"])
               and run[0]["loglikes"] == want["loglikes"],
               "train-mono on one NCCL rank differs from the plain run")
    out["train-mono"] = {"bit_identical": True,
                         "launches": dist["train-mono"][0][2],
                         "walls_s": [r[1] for r in dist["train-mono"]],
                         "plain_walls_s": [r[1] for r in plain["train-mono"]],
                         "peak_memory_gib": _peak_gib(device)}
    return out


def distributed_rank(rank, world, model_path, dict_path, corpus_dir, train_runs,
                     device="cuda"):
    """One of the ranks sharing the card over gloo: ``align_corpus`` with
    ``distributed`` (sat-2pass, sat-si) and ``train --distributed``'s
    train-mono ``train_runs`` times, each counted from 0."""
    import torch

    from montreal_forced_aligner_tpu_torch.ops import cuda_build

    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device(device))
    out = {"rank": rank, "device": str(dev),
           "tf32": bool(torch.backends.cuda.matmul.allow_tf32),
           "backend": torch.distributed.get_backend()}
    for path, adaptation in (("sat-2pass", True), ("sat-si", False)):
        res, wall, launches, al = _aligned(model_path, dict_path, corpus_dir,
                                           dev, adaptation, distributed=True)
        out[path] = {"results": res, "wall_s": wall, "launches": launches,
                     "utterances": len(al.last_shard)}
    out["train"] = []
    for _ in range(train_runs):
        _reset_peak(dev)
        ta = _mono_trainer(corpus_dir, dict_path, dev, distributed=True)
        _sync(dev)
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        summary = _mono_summary(ta, ta.train())
        _sync(dev)
        summary.update(wall_s=time.perf_counter() - t0,
                       launches=dict(cuda_build.LAUNCHES),
                       peak_memory_gib=_peak_gib(dev))
        out["train"].append(summary)
    return out


def gloo_two_ranks_phase(model_path, dict_path, corpus_dir, device):
    """**align-distributed / train-distributed, W = 2 over gloo on the one
    card** (ranks spawned by ``parallel.multihost.run_ranks``): sat-si
    intervals identical to the plain run, sat-2pass at the parity bar with
    identical phone sequences, train-mono at the JAX distributed test's bars
    against the plain run and bit-identical between two W = 2 trainings;
    K1-K3 launched on every rank."""
    from montreal_forced_aligner_tpu_torch.parallel.multihost import run_ranks

    plain = {path: _aligned(model_path, dict_path, corpus_dir, device, adapt)[0]
             for path, adapt in (("sat-2pass", True), ("sat-si", False))}
    ta = _mono_trainer(corpus_dir, dict_path, device)
    mono_plain = _mono_summary(ta, ta.train())
    t0 = time.perf_counter()
    on_card = device.type == "cuda"
    ranks = run_ranks(distributed_rank, 2,
                      args=(str(model_path), str(dict_path), str(corpus_dir), 2,
                            device.type),
                      backend="gloo", device=device.type, timeout=600.0,
                      threads=0 if on_card else 2)
    spawn_wall = time.perf_counter() - t0
    out = {"spawn_wall_s": spawn_wall, "ranks": []}
    for r in ranks:
        _check(not r["tf32"], f"rank {r['rank']} runs with TF32 on")
        _check(r["backend"] == "gloo", f"rank {r['rank']} backend {r['backend']}")
        for path in ("sat-2pass", "sat-si"):
            _require_kernels(f"{path} (W = 2, gloo, rank {r['rank']})",
                             r[path]["launches"], on_card)
        for run in r["train"]:
            _require_kernels(f"train-mono (W = 2, gloo, rank {r['rank']})",
                             run["launches"], on_card,
                             ("band_forward", "band_backtrace"))
    r0, r1 = ranks
    _check(r0["sat-si"]["utterances"] + r1["sat-si"]["utterances"]
           == len(plain["sat-si"]), "the ranks' shards do not cover the corpus")
    out["sat-si"] = _intervals_identical(r0["sat-si"]["results"], plain["sat-si"])
    out["sat-2pass"] = _two_pass_bar(r0["sat-2pass"]["results"], plain["sat-2pass"])
    for path in ("sat-si", "sat-2pass"):
        _identical(r1[path]["results"], r0[path]["results"])  # every rank has all
    (a, b), (c, d) = r0["train"], r1["train"]
    _check(_same_arrays(a["arrays"], b["arrays"]),
           "two W = 2 trainings are not bit-identical")
    _check(_same_arrays(a["arrays"], c["arrays"]) and _same_arrays(b["arrays"],
                                                                  d["arrays"]),
           "the ranks hold different models")
    out["train-mono"] = {"bars": _train_bars(a, mono_plain),
                         "two_runs_bit_identical": True}
    for r in ranks:
        out["ranks"].append({
            "rank": r["rank"], "device": r["device"],
            **{f"{p}_wall_s": r[p]["wall_s"] for p in ("sat-2pass", "sat-si")},
            **{f"{p}_utterances": r[p]["utterances"] for p in ("sat-2pass", "sat-si")},
            **{f"{p}_launches": r[p]["launches"] for p in ("sat-2pass", "sat-si")},
            "train_walls_s": [t["wall_s"] for t in r["train"]],
            "train_launches": r["train"][0]["launches"],
            "train_utterances": r["train"][0]["utterances"],
            "train_peak_memory_gib": r["train"][-1]["peak_memory_gib"],
        })
    return out


def _tier_labels(path, frame_shift=0.01):
    """A TextGrid's phone tiers as frame labels and boundary frames."""
    from montreal_forced_aligner_tpu_torch.io.textgrid import TextGrid

    tg = TextGrid.read(path)
    out = {}
    for name, ivs in tg.tiers.items():
        if "phones" not in name:
            continue
        n = int(round(max((iv.end for iv in ivs), default=0) / frame_shift))
        lab = np.full(n, "", dtype=object)
        starts = []
        for iv in ivs:
            b, e = int(round(iv.begin / frame_shift)), int(round(iv.end / frame_shift))
            lab[b:e] = iv.label
            starts.append(b)
        out[name] = (lab, starts, [iv.label for iv in ivs])
    return out


def run_group(cmd, timeout, **kw) -> subprocess.CompletedProcess:
    """``cmd`` in a session of its own, its output captured; past
    ``timeout`` seconds the whole session (a launcher and the ranks it
    started) is killed and this raises."""
    import signal

    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True, **kw)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def torchrun_align_phase(model_path, dict_path, corpus_dir, out_dir, device):
    """**align-distributed as users launch it**: ``python -m
    torch.distributed.run --nproc_per_node 2 -m
    montreal_forced_aligner_tpu_torch.cli align ... --distributed`` with
    ``MFA_TPU_TORCH_DIST_BACKEND=gloo`` (the two ranks share the card): each
    rank exports its speakers' TextGrids; their union against the plain
    run's export: the same files, identical phone sequences, >= 99.9% of
    frames and >= 99.5% of boundaries within one frame; each rank's wall,
    launches (K1-K3 on both) and peak memory from its ``rank_summary``."""
    import socket

    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    res, _w, _l, al = _aligned(model_path, dict_path, corpus_dir, device, True)
    want_dir, got_dir = out_dir / "plain", out_dir / "ranks"
    al.export_textgrids(Corpus.load(corpus_dir), res, want_dir)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parent
    env = dict(os.environ, MFA_TPU_TORCH_DIST_BACKEND="gloo",
               PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # each rank's output to its own file: two ranks writing one pipe can
    # interleave their lines
    logs = out_dir / "torchrun_logs"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "localhost", "--master_port", str(port),
           "--log-dir", str(logs), "--redirects", "3",
           "-m", f"{PKG}.cli", "align", str(corpus_dir), str(dict_path),
           str(model_path), str(got_dir), "--batch_size", "32", "--distributed",
           "--device", device.type]
    t0 = time.perf_counter()
    proc = run_group(cmd, cwd=root, env=env, timeout=600)
    wall = time.perf_counter() - t0
    rank_logs = {name: "".join(f.read_text() for f in sorted(logs.rglob(name)))
                 for name in ("stdout.log", "stderr.log")}
    _check(proc.returncode == 0,
           f"torchrun align exited {proc.returncode}: {proc.stderr[-2000:]} "
           f"{rank_logs['stderr.log'][-2000:]}")
    summaries = sorted((json.loads(line.split(" ", 1)[1])
                        for line in rank_logs["stdout.log"].splitlines()
                        if line.startswith("rank_summary ")),
                       key=lambda s: s["rank"])
    _check([s["rank"] for s in summaries] == [0, 1], "missing rank summaries")
    for s in summaries:
        _require_kernels(f"cli align (W = 2, gloo, rank {s['rank']})",
                         s["launches"], device.type == "cuda")
    want = {p.relative_to(want_dir): p for p in want_dir.rglob("*.TextGrid")}
    got = {p.relative_to(got_dir): p for p in got_dir.rglob("*.TextGrid")}
    _check(set(got) == set(want), "the ranks exported other files")
    frames = mismatched = b_total = b_within = 0
    for rel in want:
        tw, tg = _tier_labels(want[rel]), _tier_labels(got[rel])
        _check(set(tw) == set(tg), f"{rel}: tiers differ")
        for tier, (lw, sw, names_w) in tw.items():
            lg, sg, names_g = tg[tier]
            _check(names_g == names_w, f"{rel}: phone sequences differ")
            n = min(len(lw), len(lg))
            frames += len(lw)
            mismatched += int((lw[:n] != lg[:n]).sum()) + abs(len(lw) - len(lg))
            sg = np.asarray(sg)
            for s in sw:
                b_total += 1
                b_within += int(len(sg) > 0 and np.abs(sg - s).min() <= 1)
    agreement = 1.0 - mismatched / max(frames, 1)
    _check(agreement >= 0.999 and b_within >= 0.995 * b_total,
           f"torchrun align: frames {agreement}, boundaries {b_within}/{b_total}")
    return {"files": len(want), "frames": frames, "frame_agreement": agreement,
            "boundaries": b_total, "boundaries_within_1": b_within,
            "launch_wall_s": wall, "ranks": summaries}


def dryrun_phase(device):
    """**dryrun**: ``parallel.dryrun.dryrun_multichip(2)`` on the card, the
    two ranks sharing it over gloo: mono -> tri -> SAT, align, fine-tune and
    adapt over the ranks; the ranks' models agree (the function checks)."""
    from montreal_forced_aligner_tpu_torch.parallel.dryrun import dryrun_multichip

    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    ranks = dryrun_multichip(2, device=device.type, backend="gloo", timeout=600.0,
                             threads=0 if on_card else 2)
    wall = time.perf_counter() - t0
    for r in ranks:
        _require_kernels(f"dryrun rank {r['rank']}", r["launches"], on_card,
                         ("band_forward", "band_backtrace"))
    return {"wall_s": wall, "ranks": [
        {k: r[k] for k in ("rank", "device", "utterances", "num_pdfs", "num_gauss",
                           "aligned", "boundaries", "launches", "train_s",
                           "wall_s")} for r in ranks]}


def _mfa_records(corpus_dir):
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    corpus = Corpus.load(corpus_dir)
    recs = [{"speaker_id": u.speaker, "file_id": u.file_name, "text": u.text,
             "audio_path": str(u.file_path)} for u in corpus.utterances]
    # the last one again, as in-memory samples
    first = corpus.utterances[-1]
    recs.append({"speaker_id": first.speaker, "file_id": "samples",
                 "text": first.text,
                 "samples": corpus.load_audio(first).samples})
    return recs


def mfa_run(model_path, dict_path, corpus_dir, device):
    """``wrapper.MFA(...).align(records)`` on ``device``."""
    from montreal_forced_aligner_tpu_torch.align.aligner import AlignerConfig
    from montreal_forced_aligner_tpu_torch.wrapper import MFA

    t0 = time.perf_counter()
    out = MFA(model_path, dict_path, AlignerConfig(batch_size=32),
              device=device).align(_mfa_records(corpus_dir))
    return out, time.perf_counter() - t0


def mfa_phase(model_path, dict_path, corpus_dir, device, cpu):
    """**MFA**: the batch API on the card against the CPU (``cpu``, from a
    worker) on the 4-utterance corpus and one in-memory record: the parity
    bar (>= 99.9% of frames, >= 99.5% of boundaries within one frame, scores
    within 5 nats) and the same words."""
    from montreal_forced_aligner_tpu_torch.data import CtmInterval, UtteranceAlignment

    got, wall = mfa_run(model_path, dict_path, corpus_dir, device)
    want, cpu_wall = cpu

    def as_alignment(rec):
        phones = [CtmInterval(p["begin"], p["end"], p["phone"]) for p in rec["phones"]]
        n = int(round(phones[-1].end / 0.01)) if phones else 1
        return UtteranceAlignment(utterance_id=0, words=[], phones=phones,
                                  log_likelihood=rec["log_likelihood"] * n,
                                  per_frame_log_likelihood=rec["log_likelihood"])

    for g, w in zip(got, want):
        _check([x["word"] for x in g["words"]] == [x["word"] for x in w["words"]],
               f"MFA {g['file_id']}: words differ")
    rep = parity({i: as_alignment(g) for i, g in enumerate(got)},
                 {i: as_alignment(w) for i, w in enumerate(want)}, 0.01)
    return {"records": len(got), "wall_s": wall, "cpu_wall_s": cpu_wall, **rep}


def parity_harness_phase(model_path, dict_path, corpus_dir, device, n=4):
    """**parity harness**: ``parity.harness.compare_corpus_sat`` (the card's
    sat-2pass against the independent numpy two-pass decoder) on the ``n``
    shortest utterances: frame and boundary agreement, reported."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.parity.harness import compare_corpus_sat

    corpus = Corpus.load(corpus_dir)
    durations = [read_duration(u.file_path) for u in corpus.utterances]
    shortest = sorted(np.argsort(durations, kind="stable")[:n].tolist())
    sub = corpus.subset(shortest)
    al = PretrainedAligner(model_path, dict_path, AlignerConfig(batch_size=32),
                           device=device)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    report = compare_corpus_sat(al, sub)
    wall = time.perf_counter() - t0
    frames = sum(r.num_frames for r in report)
    b_tot = sum(r.boundary_total for r in report)
    return {
        "utterances": len(report), "audio_s": float(np.sum(np.sort(durations)[:n])),
        "frames": frames,
        "frame_agreement": 1 - sum(r.frame_mismatches for r in report) / max(frames, 1),
        "boundaries": b_tot,
        "boundary_exact": sum(r.boundary_exact for r in report),
        "boundary_within_1": sum(r.boundary_within_1 for r in report),
        "max_score_diff": max(abs(r.score_production - r.score_reference)
                              for r in report),
        "launches": dict(cuda_build.LAUNCHES), "wall_s": wall,
    }


# -- the features transfer mode, pitch models on every path, and the
# chain-major LVCSR decoders ---------------------------------------------------


def transfer_bar(r_w, r_f):
    """The JAX package's bar for shipping host features against waves
    (``tests/test_transfer_mode.py``), on a trained model: the same
    utterances and phone labels, every boundary within one frame (0.011 s),
    at least 90% of each utterance's phones exact. Returns the counts."""
    _check(set(r_w) == set(r_f), "features and waves aligned other utterances")
    phones = exact = 0
    worst = 0.0
    for i in r_w:
        pw, pf = r_w[i].phones, r_f[i].phones
        _check([p.label for p in pw] == [p.label for p in pf],
               f"utterance {i}: phone labels differ between features and waves")
        diffs = [max(abs(a.begin - b.begin), abs(a.end - b.end))
                 for a, b in zip(pw, pf)]
        worst = max([worst, *diffs])
        n_exact = sum(d == 0.0 for d in diffs)
        _check(max(diffs, default=0.0) <= 0.011 and n_exact >= int(0.9 * len(pw)),
               f"utterance {i}: {n_exact} of {len(pw)} phones exact, worst "
               f"{max(diffs, default=0.0)} s")
        phones += len(pw)
        exact += n_exact
    return {"utterances": len(r_w), "phones": phones,
            "exact_share": exact / max(phones, 1), "max_boundary_diff_s": worst}


def _set_env(name, value):
    """Set (or, with None, remove) an environment variable; returns the old
    value."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    return old


def _transfer_align(mode, model_path, dict_path, corpus_path, dev, batch_size):
    """One counted ``align_corpus`` shipping ``mode``: (results, wall,
    launches, aligner)."""
    import montreal_forced_aligner_tpu_torch.align.aligner as A
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build

    al = A.PretrainedAligner(model_path, dict_path, A.AlignerConfig(
        batch_size=batch_size, transfer_mode=mode), device=dev)
    corpus = Corpus.load(corpus_path)
    _sync(dev)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    res = al.align_corpus(corpus)
    _sync(dev)
    wall = time.perf_counter() - t0
    _check(al.last_transfer_mode == mode, f"{al.last_transfer_mode} shipped")
    _check(len(res) == corpus.num_utterances, "not every utterance aligned")
    return res, wall, dict(cuda_build.LAUNCHES), al


def _transfer_transcribe(mode, model_path, dict_path, corpus_path, lm, dev):
    """One counted ``transcribe_corpus`` under ``MFA_TPU_TRANSFER_MODE=mode``:
    (results, wall, launches)."""
    from montreal_forced_aligner_tpu_torch.transcription.transcriber import (
        Transcriber,
    )

    prev = _set_env("MFA_TPU_TRANSFER_MODE", mode)
    try:
        tr = Transcriber(model_path, dict_path, lm=lm, batch_size=16, device=dev)
        res, wall, launches, _peak, _r = _counted_transcribe(tr, corpus_path, dev)
    finally:
        _set_env("MFA_TPU_TRANSFER_MODE", prev)
    _check(tr.last_transfer_mode == mode, f"transcribe shipped {tr.last_transfer_mode}")
    return res, wall, launches


def transfer_cpu_references(model_path, dict_path, small_dir, small2_dir, lm):
    """The CPU half of transfer-features' card-against-CPU checks (a worker
    beside the card's phases): sat-2pass shipping features on
    ``small2_dir``, transcribe-dense with features on ``small_dir``."""
    import torch

    cpu = torch.device("cpu")
    return {"align": _transfer_align("features", model_path, dict_path, small2_dir,
                                     cpu, 4)[0],
            "transcribe": _transfer_transcribe("features", model_path, dict_path,
                                               small_dir, lm, cpu)[0]}


def transfer_features_phase(model_path, dict_path, corpus_dir, small_dir,
                            small2_dir, lm, out_dir, device, batch_size=32,
                            cpu_refs=None):
    """**transfer-features**: phase A ships float16 MFCCs computed on the
    host (``ops.mfcc.mfcc_host_batch``) in place of int16 waves. The link
    probe's MB/s and what "auto" resolves to; the bytes a batch ships each
    way and the host MFCC's seconds a batch; sat-2pass and train-mono
    shipping features (``AlignerConfig(transfer_mode="features")`` and
    ``MFA_TPU_TRANSFER_MODE=features``; one cold run, counted from 0, and
    one warm run each), every batch's shipped features within float16
    rounding of the card's own MFCCs, the same launches as waves, the
    agreement with the waves run at 98% of frames and 80% of phone
    sequences (the random-weight model's near ties move with the rounding;
    train: the same Gaussian counts, log-likelihoods within 1e-3
    relative); a monophone trained on the tone corpus aligns it with
    features at the JAX package's transfer bar, as the JAX test holds its
    trained model; sat-2pass features on the card against features on the
    CPU on ``small2_dir`` at the parity bar; transcribe-dense on
    ``small_dir`` with ``MFA_TPU_TRANSFER_MODE=features``: on the card
    against the CPU the same transcripts; against waves scores within 1e-3
    relative, the transcripts that agree reported."""
    import torch

    import montreal_forced_aligner_tpu_torch.align.aligner as A
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.ops.mfcc import (
        MfccConfig,
        _mfcc_device,
        mfcc_host_batch,
        pad_waves_for_mfcc,
    )
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    on_card = device.type == "cuda"
    old = _set_env("MFA_TPU_TRANSFER_MODE", None)
    try:
        auto = A.resolve_transfer_mode("auto", ttl_s=0.0, device=device)
    finally:
        _set_env("MFA_TPU_TRANSFER_MODE", old)
    probe = A._transfer_probe_cache["rate"] if on_card else None
    _check(auto == "waves", f'"auto" resolved to {auto} ({probe} MB/s)')

    # what a batch ships either way, and the host's MFCC time a batch
    cfg = MfccConfig()
    waves = Corpus.load(corpus_dir).load_audio_parallel(cfg.sample_rate)
    order = np.argsort([len(w) for w in waves], kind="stable")
    shipped = []
    for i in range(0, len(order), batch_size):
        batch = [waves[j] for j in order[i : i + batch_size]]
        L = -(-max(len(w) for w in batch) // 16000) * 16000
        padded, lens = pad_waves_for_mfcc(batch, cfg, L)
        t0 = time.perf_counter()
        feats16 = mfcc_host_batch(padded, cfg, cfg.num_frames(L)).astype(np.float16)
        host_s = time.perf_counter() - t0
        # what the mode ships is the card's own MFCC up to float16 rounding
        # (2**-11 of a value) and the float32 bar of the two MFCC programs
        # (rtol 1e-5, atol 1e-4)
        dev = _mfcc_device(torch.from_numpy(padded).to(device), cfg,
                           cfg.num_frames(L)).cpu().numpy()
        ratio = 0.0
        for r, n in enumerate(lens):
            nf = cfg.num_frames(int(n))
            x, y = feats16[r, :nf].astype(np.float64), dev[r, :nf]
            bound = 1e-4 + (2.0**-11 + 1e-5) * np.abs(y)
            ratio = max(ratio, float((np.abs(x - y) / bound).max()))
        _check(ratio <= 1.0, f"shipped features off the card's MFCC by {ratio} "
               "of the float16 bound")
        shipped.append({"B": len(batch), "T": int(feats16.shape[1]),
                        "waves_bytes": int(padded.nbytes),
                        "waves_dtype": str(padded.dtype),
                        "features_bytes": int(feats16.nbytes),
                        "host_mfcc_s": host_s,
                        "max_err_over_f16_bound": ratio})

    if cpu_refs is None:
        cpu_refs = transfer_cpu_references(model_path, dict_path, small_dir,
                                           small2_dir, lm)

    def align(mode, corpus_path, bs=batch_size):
        return _transfer_align(mode, model_path, dict_path, corpus_path, device, bs)

    feats, cold, launches, al = align("features", corpus_dir)
    _check(al.two_pass, "transfer-features: sat-2pass needs the two-pass")
    t0 = time.perf_counter()
    al.align_corpus(Corpus.load(corpus_dir))
    _sync(device)
    warm = time.perf_counter() - t0
    plain, plain_wall, plain_launches, _al = align("waves", corpus_dir)
    n_batches = -(-len(feats) // batch_size)
    want = {k: 2 * n_batches * on_card for k in launches}
    _check(launches == plain_launches == want,
           f"sat-2pass launches: features {launches}, waves {plain_launches}")
    sat = {"launches": launches, "cold_wall_s": cold, "warm_wall_s": warm,
           "waves_wall_s": plain_wall,
           "against_waves": agreement(feats, plain, 0.01),
           "card_vs_cpu": parity(align("features", small2_dir, 4)[0],
                                 cpu_refs["align"], 0.01)}
    # a floor that a wrong features path breaks: on the random-weight
    # model near ties move with float16's rounding of the features (99.12%
    # of frames and 57 of 64 phone sequences the same on the H100), where a
    # wrong feature moves most frames
    aw = sat["against_waves"]
    _check(aw["frame_agreement"] >= 0.98
           and aw["same_phone_sequences"] >= 0.8 * len(feats),
           f"sat-2pass features against waves: {aw}")

    # the JAX test's own setting: a trained model on the tone corpus, each
    # utterance at the bar
    tone_dir, _truths = make_tone_corpus(Path(out_dir) / "transfer_tone")
    tone_dict = Path(out_dir) / "transfer_tone.dict"
    tone_dict.write_text("".join(f"{w}\t{' '.join(p)}\n"
                                 for w, p in WORD_PHONES.items()))
    tone_model = TrainableAligner(
        tone_dir, tone_dict, recipe=[StageConfig("monophone", "mono", 8, 40)],
        batch_size=4, variable_length_topology=False, device=device).train()
    tone_model.save(Path(out_dir) / "transfer_tone.zip")
    tone = {}
    for mode in ("waves", "features"):
        al = A.PretrainedAligner(Path(out_dir) / "transfer_tone.zip", tone_dict,
                                 A.AlignerConfig(batch_size=4, transfer_mode=mode),
                                 device=device)
        tone[mode] = al.align_corpus(Corpus.load(tone_dir))
        _check(al.last_transfer_mode == mode, f"tone: {al.last_transfer_mode}")
    sat["tone_mono_against_waves"] = transfer_bar(tone["waves"], tone["features"])

    def train(mode):
        ta = TrainableAligner(
            corpus_dir, dict_path, recipe=[StageConfig("monophone", "mono", 4, 64)],
            batch_size=batch_size, variable_length_topology=False, device=device)
        prev = _set_env("MFA_TPU_TRANSFER_MODE", mode)
        try:
            _sync(device)
            cuda_build.reset_launch_counts()
            t0 = time.perf_counter()
            ta.train()
            _sync(device)
            wall = time.perf_counter() - t0
        finally:
            _set_env("MFA_TPU_TRANSFER_MODE", prev)
        _check(ta.pipeline.last_transfer_mode == mode, "train-mono shipped "
               f"{ta.pipeline.last_transfer_mode}")
        log = ta.trainers["monophone"].iteration_log
        return (wall, dict(cuda_build.LAUNCHES),
                [e["loglike_per_frame"] for e in log], [e["num_gaussians"] for e in log])

    t_cold, t_launches, ll_f, n_f = train("features")
    t_warm = train("features")[0]
    _w, w_launches, ll_w, n_w = train("waves")
    _check(t_launches == w_launches, f"train-mono launches {t_launches}, waves "
           f"{w_launches}")
    _require_kernels("train-mono (features)", t_launches, on_card,
                     ("band_forward", "band_backtrace"))
    # float16 rounds each feature by up to 2**-11 = 4.9e-4 of its value:
    # log-likelihoods per frame within twice that, relative
    ll_rel = float(np.max(np.abs(np.subtract(ll_f, ll_w)) / np.abs(ll_w)))
    _check(n_f == n_w and ll_rel <= 1e-3,
           f"train-mono features against waves: Gaussians {n_f} / {n_w}, "
           f"log-likelihoods {ll_rel} apart")
    mono = {"launches": t_launches, "cold_wall_s": t_cold, "warm_wall_s": t_warm,
            "loglike_per_frame": ll_f, "loglike_rel_diff_to_waves": ll_rel}

    def transcribe(mode):
        return _transfer_transcribe(mode, model_path, dict_path, small_dir, lm,
                                    device)

    r_f, d_wall, d_launches = transcribe("features")
    r_w, _dw, dw_launches = transcribe("waves")
    r_c = cpu_refs["transcribe"]
    _check(d_launches == dw_launches, f"transcribe-dense launches {d_launches}")
    _require_kernels("transcribe-dense (features)", d_launches, on_card,
                     ("state_emission",))
    # the card and the CPU decode the same float16 features: the same
    # transcripts, scores within the parity bar's 5 nats
    card_cpu = max(abs(r_f[i].log_likelihood - c.log_likelihood)
                   for i, c in r_c.items())
    _check(all(r_f[i].text == c.text for i, c in r_c.items()) and card_cpu <= 5.0,
           f"transcribe features: card against CPU, scores {card_cpu} apart")
    # against waves the random-weight model's decode is a near tie, so the
    # words are reported; each score within 1e-3 relative (float16 rounds a
    # feature by up to 4.9e-4 of its value)
    same_text = sum(r_f[i].text == w.text for i, w in r_w.items())
    rel = max(abs(r_f[i].log_likelihood - w.log_likelihood) / abs(w.log_likelihood)
              for i, w in r_w.items())
    _check(rel <= 1e-3, f"transcribe: features against waves, scores {rel} apart")
    walls = [b["host_mfcc_s"] for b in shipped]
    return {
        "path": "transfer-features",
        "probe_MBps": probe, "auto_resolves_to": auto,
        "batches": shipped,
        "bytes_per_batch_median": {
            "waves": statistics.median(b["waves_bytes"] for b in shipped),
            "features_f16": statistics.median(b["features_bytes"] for b in shipped)},
        "host_mfcc_s_per_batch": {"median": statistics.median(walls),
                                  "max": max(walls), "sum": sum(walls)},
        "sat-2pass": sat, "train-mono": mono,
        "transcribe-dense": {"utterances": len(r_f), "launches": d_launches,
                             "cold_wall_s": d_wall,
                             "card_vs_cpu_max_score_diff": card_cpu,
                             "same_text_as_waves": same_text,
                             "score_rel_diff_to_waves": rel,
                             "texts": [r_f[i].text for i in sorted(r_f)]},
    }


# the pitch recipe mono -> tri -> LDA -> SAT, cut for the time budget:
# iterations 2 / 4 / 4 / 4 (LDA estimates MLLT at 2 and 4, SAT fMLLR at 2
# and 4), 500 leaves a stage (the default recipe's 2000-2500 leaves took
# 60 s of host tree building) with 16000 Gaussians, so that the stages
# and the archive's paths are large enough for K3
PITCH_RECIPE = [
    ("monophone", "mono", 2, 1000, 0),
    ("triphone", "tri", 4, 16000, 500),
    ("lda", "lda", 4, 16000, 500),
    ("sat", "sat", 4, 16000, 500),
]


def _rising(trainer) -> bool:
    """Finite log-likelihoods that rise (or hold) at every iteration that
    does not change the features (MLLT, fMLLR)."""
    ll = _loglikes(trainer)
    changes = set(getattr(trainer, "mllt_iterations", ())) | set(
        getattr(trainer, "fmllr_iterations", ()))
    return bool(np.isfinite(ll).all()) and all(
        ll[i] >= ll[i - 1] - 1e-6 * abs(ll[i - 1])
        for i in range(1, len(ll)) if i not in changes)


def pitch_paths_phase(dict_path, out_dir, device, recipe=PITCH_RECIPE, batch_size=32,
                      require_k3=True, corpus_size=(64, 2.0, 30.0)):
    """**pitch-paths**: a pitch model on every path that takes one, on
    corpora that say their transcripts with a moving pitch
    (:func:`build_voiced_corpus`: ``corpus_size`` utterances of the lexicon
    at ``dict_path`` for the recipe, 4, 8 and 4 more for the checks). The
    recipe mono -> tri -> LDA -> SAT with ``use_pitch`` (with
    ``require_k3`` large enough for K3; ``lda.mat`` 40 x 112: 13 MFCCs and
    3 pitch columns spliced +-3; log-likelihoods finite and rising at every
    iteration that does not change the features); its archive aligns the
    corpus two-pass, every utterance, counted from 0; ``MapAdapter`` of it
    on the card against the CPU on 8 utterances of 2 speakers at the adapt
    cell's bars (``adapt_card_vs_cpu``, counted from 0 on the card);
    ``--fine_tune`` of the corpus, timed with its pitch's share, every
    boundary within the fine-tune window of the 10 ms one, and on 4
    utterances the card against the CPU within 1 ms; the long path on 4
    utterances of one speaker each (so both paths estimate CMVN and fMLLR
    from the same frames) with ``LONG_UTTERANCE_FRAMES`` lowered, against
    the corpus path at ``batch_size``, single- and two-pass at the parity
    bar; launches by the long path's formula; and
    :func:`pitch_batch_invariance` on the corpus and the 8 utterances."""
    import montreal_forced_aligner_tpu_torch.align.fine_tune as FT
    import montreal_forced_aligner_tpu_torch.online.alignment as online_mod
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
        _emission_kernel_eligible,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.models.acoustic_model import AcousticModel
    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.ops import long_viterbi as LV
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    on_card = device.type == "cuda"
    out = Path(out_dir)
    n_utts, min_s, max_s = corpus_size
    corpus_dir, audio_s = build_voiced_corpus(out, dict_path, n_utts, min_s, max_s,
                                              name="pitch_corpus")
    small_dir, _ = build_voiced_corpus(out, dict_path, 4, 2.0, 4.0, seed=1,
                                       name="pitch_small")
    small2_dir, _ = build_voiced_corpus(out, dict_path, 8, 3.0, 6.0, seed=2,
                                        name="pitch_small2", num_speakers=2)
    single_dir, _ = build_voiced_corpus(out, dict_path, 4, 2.0, 4.0, seed=7,
                                        name="pitch_single", num_speakers=4)
    ta = TrainableAligner(
        corpus_dir, dict_path,
        recipe=[StageConfig(n, k, it, g, num_leaves=lv) for n, k, it, g, lv in recipe],
        batch_size=batch_size, variable_length_topology=False, use_pitch=True,
        device=device)
    _sync(device)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    final = ta.train()
    _sync(device)
    train_wall = time.perf_counter() - t0
    train_launches = dict(cuda_build.LAUNCHES)
    lda_name = next(n for n, k, *_ in recipe if k == "lda")
    lda_shape = list(ta.models[lda_name].lda_mat.shape)
    _check(lda_shape == [40, 112], f"pitch recipe: lda.mat {lda_shape}")
    lls = {n: _loglikes(t) for n, t in ta.trainers.items()}
    for name, trainer in ta.trainers.items():
        _check(_rising(trainer), f"pitch recipe {name}: log-likelihoods {lls[name]}")
    path = out / "pitch_sat.zip"
    final.save(path)
    model = AcousticModel.load(path)
    _check(model.lda_mat.shape == (40, 112) and model.meta["features"]["pitch"],
           "the pitch archive lost its pitch or its LDA")

    aligner = PretrainedAligner(path, dict_path, AlignerConfig(batch_size=batch_size),
                                device=device)
    _check(aligner.use_pitch and aligner.two_pass, "the pitch archive: no two-pass")
    corpus = Corpus.load(corpus_dir)
    _sync(device)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    results = aligner.align_corpus(corpus)
    _sync(device)
    align_wall = time.perf_counter() - t0
    align_launches = dict(cuda_build.LAUNCHES)
    _check(len(results) == corpus.num_utterances,
           f"pitch archive aligned {len(results)} of {corpus.num_utterances}")
    for key, aln in results.items():
        _check(aln.words and aln.phones and np.isfinite(aln.log_likelihood)
               and aln.log_likelihood > -1e29, f"utterance {key}: bad alignment")
    n_batches = -(-corpus.num_utterances // batch_size)
    use_k = [_emission_kernel_eligible(g.num_pdfs, g.max_gauss)
             for g in (model.alignment_model[1], model.gmm)]
    _check(not require_k3 or all(use_k), "the pitch archive's models are below "
           f"K3's threshold ({model.gmm.num_pdfs} pdfs x {model.gmm.max_gauss})")
    want = {"band_forward": 2 * n_batches * on_card,
            "band_backtrace": 2 * n_batches * on_card,
            "state_emission": sum(use_k) * n_batches * on_card}
    _check(align_launches == want, f"pitch align launches {align_launches}, "
           f"expected {want}")

    _sync(device)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    adapt = adapt_card_vs_cpu(path, dict_path, small2_dir, device, batch_size)
    adapt["card_and_cpu_wall_s"] = time.perf_counter() - t0
    adapt["launches"] = dict(cuda_build.LAUNCHES)
    _require_kernels("pitch adapt", adapt["launches"], on_card,
                     ("band_forward", "band_backtrace"))

    # the fine-tune of the corpus, and the share of it that computes pitch
    pitch_s = [0.0]
    real_pitch = FT.pitch_for_mfcc_frames

    def timed_pitch(*a, **k):
        t1 = time.perf_counter()
        got = real_pitch(*a, **k)
        pitch_s[0] += time.perf_counter() - t1
        return got

    FT.pitch_for_mfcc_frames = timed_pitch
    try:
        base, tuned, tune_s = _fine_tune_run(path, dict_path, device, corpus_dir,
                                             batch_size)
    finally:
        FT.pitch_for_mfcc_frames = real_pitch
    window = 0.015 + 1e-9  # the fine-tune's window: 1.5 frames either side
    moved = worst = 0
    for key, aln in tuned.items():
        _check([p.label for p in aln.phones] == [lab for lab, _b in base[key]],
               f"utterance {key}: fine-tune changed the phones")
        d = np.abs(np.array([p.begin for p in aln.phones])
                   - np.array([b for _lab, b in base[key]]))
        worst = max(worst, float(d.max()))
        moved += int((np.round(np.array([p.begin for p in aln.phones]) * 1000)
                      % 10 != 0).sum())
    _check(worst <= window and moved > 0,
           f"pitch fine-tune: boundaries moved up to {worst} s, {moved} off the grid")
    _got, tune_diff, tune_pitch = _fine_tune_card_vs_cpu(path, dict_path, small_dir,
                                                        device)

    long_path = {}
    n_single = Corpus.load(single_dir).num_utterances
    for label, adaptation in (("single_pass", False), ("two_pass", True)):
        single = PretrainedAligner(path, dict_path, AlignerConfig(
            batch_size=batch_size, uses_speaker_adaptation=adaptation), device=device)
        want_res = single.align_corpus(Corpus.load(single_dir))
        rec = CallRecorder(online_mod, "viterbi_align_long", device)
        limit, chunk = online_mod.LONG_UTTERANCE_FRAMES, LV.CHUNK_FRAMES
        online_mod.LONG_UTTERANCE_FRAMES, LV.CHUNK_FRAMES = 50, 128
        try:
            with rec:
                _sync(device)
                cuda_build.reset_launch_counts()
                t0 = time.perf_counter()
                got_res = single.align_corpus(Corpus.load(single_dir))
                _sync(device)
                long_wall = time.perf_counter() - t0
                long_launches = dict(cuda_build.LAUNCHES)
            long_want = _long_path_launches(rec, device)
        finally:
            online_mod.LONG_UTTERANCE_FRAMES, LV.CHUNK_FRAMES = limit, chunk
        passes = 2 if adaptation else 1
        _check(rec.calls == passes * n_single,
               f"pitch long path: {rec.calls} chunked decodes")
        _check(long_launches == long_want,
               f"pitch long path launches {long_launches}, expected {long_want}")
        long_path[label] = {"wall_s": long_wall, "launches": long_launches,
                            "against_corpus_path": parity(got_res, want_res, 0.01)}
    t0 = time.perf_counter()
    invariance = pitch_batch_invariance(path, dict_path, corpus_dir, small2_dir,
                                        device, batch_size)
    invariance["wall_s"] = time.perf_counter() - t0
    return {
        "path": "pitch-paths",
        "corpus": {"utterances": n_utts, "audio_s": audio_s},
        "recipe": {"stages": [list(r) for r in recipe], "wall_s": train_wall,
                   "launches": train_launches, "lda_mat": lda_shape,
                   "loglike_per_frame": lls,
                   "pdfs_x_gauss": [int(final.gmm.num_pdfs), int(final.gmm.max_gauss)]},
        "align": {"utterances": len(results), "wall_s": align_wall,
                  "launches": align_launches},
        "adapt": adapt,
        "fine_tune": {"utterances": len(tuned),
                      "boundaries": sum(len(v) - 1 for v in base.values()),
                      "fine_tune_s": tune_s, "pitch_s": pitch_s[0],
                      "max_move_from_10ms_s": worst, "moved_off_grid": moved,
                      "card_vs_cpu_max_boundary_diff_s": tune_diff, **tune_pitch},
        "long_path": {"utterances": n_single, **long_path},
        "batch_invariance": invariance,
    }


def pitch_batch_invariance(model_path, dict_path, corpus_dir, align_dir, device,
                           batch_size=32):
    """**pitch_batch_invariance**: each utterance's pitch is its own,
    whatever is batched beside it. ``compute_pitch_batch`` of the corpus at
    ``corpus_dir`` in batches of ``batch_size`` (corpus order, so lengths
    mix) against one utterance at a time: lag paths equal on every row,
    features within atol 1e-5, the largest difference reported; and the
    pitch archive at ``model_path`` aligning the utterances of
    ``align_dir`` in one batch against one utterance a batch
    (:func:`batch_size_alignment`): intervals equal, single pass scores
    within 0.01 nats, two-pass scores within the single pass's difference
    plus 1e-3 (:func:`two_pass_within_single`)."""
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import pitch as PP

    waves = Corpus.load(corpus_dir).load_audio_parallel(16000)
    paths = []
    real = PP._viterbi_lags

    def keep_path(*args):
        paths.append(real(*args))
        return paths[-1]

    PP._viterbi_lags = keep_path
    try:
        alone = []
        _sync(device)
        t0 = time.perf_counter()
        for w in waves:
            feats, n = PP.compute_pitch_batch(np.asarray(w, np.float32)[None],
                                              np.array([len(w)]), device=device)
            alone.append((feats[0], int(n[0]), paths[-1][0]))
        alone_s = time.perf_counter() - t0
        batched = []
        t0 = time.perf_counter()
        for lo in range(0, len(waves), batch_size):
            buf, lens = padded_waves(waves[lo : lo + batch_size])
            feats, n = PP.compute_pitch_batch(buf, lens, device=device)
            batched += [(feats[r], int(n[r]), paths[-1][r]) for r in range(len(lens))]
        batched_s = time.perf_counter() - t0
    finally:
        PP._viterbi_lags = real
    worst = 0.0
    bad = []
    for i, ((fa, na, pa), (fb, nb, pb)) in enumerate(zip(alone, batched)):
        _check(na == nb and not fb[nb:].any(),
               f"pitch of utterance {i}: {nb} frames in a batch, {na} alone")
        if not np.array_equal(pb[:na], pa):
            bad.append(i)
        worst = max(worst, float(np.abs(fb[:na] - fa).max()))
    _check(not bad, f"pitch: lag paths of utterances {bad[:5]} depend on the batch")
    _check(worst <= 1e-5, f"pitch: features {worst} from their features alone")

    aligned = batch_size_alignment(model_path, dict_path, align_dir, device)
    for label, a in aligned.items():
        _check(a["intervals_differ"] == 0,
               f"pitch align {label}: intervals of {a['intervals_differ']} "
               "utterances depend on the batch")
    single = aligned["single_pass"]["max_score_diff"]
    _check(single <= 0.01, f"pitch align single pass: scores {single} nats apart")
    two_pass_within_single("pitch align", aligned)
    return {
        "pitch": {"utterances": len(waves), "batch_size": batch_size,
                  "frames": sum(n for _f, n, _p in alone),
                  "rows_with_equal_lag_paths": len(alone) - len(bad),
                  "features_max_abs_diff": worst,
                  "one_at_a_time_s": alone_s, "batched_s": batched_s},
        "align": aligned,
    }


def two_pass_within_single(label, aligned):
    """A speaker's fMLLR statistics are float64 sums of its utterances in
    corpus order, so the two-pass moves with the batches only through the
    features, as the single pass does: its largest score difference within
    the single pass's plus 1e-3 nats."""
    two = aligned["two_pass"]["max_score_diff"]
    single = aligned["single_pass"]["max_score_diff"]
    _check(two <= single + 1e-3, f"{label} two-pass: scores {two} nats apart at "
           f"the two batch sizes, the single pass {single}")


def batch_size_alignment(model_path, dict_path, corpus_dir, device):
    """The archive at ``model_path`` aligning the utterances of
    ``corpus_dir`` in one batch against one utterance a batch, two-pass and
    single pass (the speaker-independent model): per mode, the utterances
    whose intervals differ, the largest score difference and the largest
    score's magnitude."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    def intervals(a):
        return ([(p.label, p.begin, p.end) for p in a.phones],
                [(w.label, w.begin, w.end) for w in a.words])

    n = Corpus.load(corpus_dir).num_utterances
    out = {}
    for label, adaptation in (("two_pass", True), ("single_pass", False)):
        runs = {}
        for bs in (n, 1):
            aligner = PretrainedAligner(model_path, dict_path, AlignerConfig(
                batch_size=bs, uses_speaker_adaptation=adaptation), device=device)
            runs[bs] = aligner.align_corpus(Corpus.load(corpus_dir))
        got, want = runs[n], runs[1]
        _check(sorted(got) == sorted(want), "different utterances")
        out[label] = {
            "batch_size": n, "against_batch_size": 1, "utterances": len(want),
            "intervals_differ": sum(intervals(got[i]) != intervals(want[i])
                                    for i in want),
            "max_score_diff": max(abs(got[i].log_likelihood - want[i].log_likelihood)
                                  for i in want),
            "max_score": max(abs(a.log_likelihood) for a in want.values())}
    return out


# the graph arrays of the chain-major decoders, and their arguments after
# (emit_pdf, state_pdf, frame_lengths)
FLAT_NAMES = ("state_pdf", "band", "start", "exit_idx", "exit_w", "entry_idx",
              "entry_word", "entry_w", "p1", "bo", "big_pred", "big_w", "eos",
              "entry_slot_of_state", "state_word", "state0_hash")
FLAT_DECODE = ("band", "start", "exit_idx", "exit_w", "entry_idx", "entry_word",
               "entry_w", "p1", "bo", "big_pred", "big_w")


def _rows_equal(label, dev, host, flens, pron=None):
    """A device backtrace (path, word_at, score) against host rows (path,
    score, events): paths and entered words exact, scores within 1e-4;
    with ``pron`` (word -> pronunciation) the words compare by it and the
    paths not (another graph's numbering)."""
    path, word, score = (x.cpu().numpy() for x in dev)
    worst = 0.0
    for b, (hp, hs, he) in enumerate(host):
        L = int(flens[b])
        events = [(t, int(w)) for t, w in enumerate(word[b, :L]) if w >= 0]
        if pron is None:
            _check(np.array_equal(path[b], hp) and events == he,
                   f"{label}: row {b} path or words differ")
        else:
            _check([(t, pron[w]) for t, w in events]
                   == [(t, pron[w]) for t, w in he], f"{label}: row {b} words differ")
        worst = max(worst, abs(float(score[b]) - hs))
    _check(worst <= 1e-4, f"{label}: scores {worst} apart")
    return worst


def lvcsr_chain_major_phase(model_path, dict_path, small_dir, lm, device,
                            batch_size=4):
    """**lvcsr-chain-major**: transcribe ``small_dir`` (4 utterances) with
    transcribe-lvcsr's LM (cross-word, two-pass) and keep pass 2's
    emissions; on them, the production routes against the reference
    decoders, on the card: the checkpointed cross-word pair against the
    record-based pair with its device and host backtraces (paths, words
    exact, scores within 1e-4); the word-internal position-major pair
    against the chain-major pairs (record-based with its device and host
    backtraces, checkpointed) on the same LM's graphs (scores within 1e-4,
    the same words at the same frames; the chain-major backtraces equal
    each other exactly). No kernel: these decoders are plain PyTorch."""
    import montreal_forced_aligner_tpu_torch.transcription.transcriber as T
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.transcription import lvcsr as LV
    from montreal_forced_aligner_tpu_torch.transcription import lvcsr_pm as PM

    tr = T.Transcriber(model_path, dict_path, lm=lm, batch_size=batch_size,
                       device=device)
    captured = []
    real = T.Transcriber._lvcsr_decode_device

    def spy(self, ff, flens_dev, gmm):
        handle = real(self, ff, flens_dev, gmm)
        captured.append((handle, ff, flens_dev, gmm))
        return handle

    T.Transcriber._lvcsr_decode_device = spy
    try:
        results = tr.transcribe_corpus(Corpus.load(small_dir))
    finally:
        T.Transcriber._lvcsr_decode_device = real
    g = tr._lvcsr
    _check(isinstance(g, LV.LvcsrXwGraph) and tr.aligner.two_pass,
           f"lvcsr-chain-major: {type(g).__name__}")
    handle, ff, flens_dev, gmm = captured[-1]  # pass 2, the final model
    flens = flens_dev.cpu().numpy()
    Tn = int(ff.shape[1])
    emit = T._lvcsr_emissions(ff, gmm, tr.acoustic_scale)
    seconds = {}

    def timed(name, fn):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        seconds[name] = time.perf_counter() - t0
        return out

    cuda_build.reset_launch_counts()
    d = tr._lvcsr_dev()
    prod = timed("xw_ckpt_backtrace", lambda: tr._lvcsr_backtrace_device_dispatch(
        handle, flens_dev, Tn))
    a_T, recs = timed("xw_record_decode", lambda: LV.lvcsr_xw_decode_device(
        emit, d, flens_dev, g.lb, g.ub, g.num_p))
    xw_dev = timed("xw_record_backtrace", lambda: LV.lvcsr_xw_backtrace_device(
        a_T, recs, d, flens_dev, g.lb, Tn))
    xw_host = timed("xw_host_backtrace", lambda: LV.lvcsr_xw_backtrace_host(
        g, a_T.cpu().numpy(), [r.cpu().numpy() for r in recs], flens, T=Tn))
    del a_T, recs
    xw = {"S": int(g.num_states),
          "ckpt_vs_host_score_diff": _rows_equal("cross-word checkpointed", prod,
                                                 xw_host, flens),
          "record_vs_host_score_diff": _rows_equal("cross-word record-based",
                                                   xw_dev, xw_host, flens)}

    comp = LV.LvcsrGraphCompiler(tr.aligner.compiler, tr.aligner.lexicon, lm,
                                 cross_word=False)
    pg, lg = comp.build(), comp.build_word_internal_legacy()
    _check(isinstance(pg, PM.LvcsrPmGraph), f"word-internal: {type(pg).__name__}")
    pd = LV.graph_tensors(pg, PM.PM_DEVICE_NAMES, device)
    e0, ep = LV.split_emissions(emit, PM._PM_TC)
    pm_a, pm_ck = timed("pm_ckpt_decode", lambda: PM.lvcsr_pm_decode_ckpt_device(
        e0, ep, pd, flens_dev, pg.lbp, pg.ubp))
    pm_bt = timed("pm_ckpt_backtrace", lambda: PM.lvcsr_pm_backtrace_ckpt_device(
        pm_a, pm_ck, ep, pd, flens_dev, pg.lbp, pg.ubp, Tn))
    del e0, ep, pm_a, pm_ck
    ld = LV.graph_tensors(lg, FLAT_NAMES, device)
    args = [ld[k] for k in FLAT_DECODE]
    fa, frecs = timed("chain_record_decode", lambda: LV.lvcsr_decode_device(
        emit, ld["state_pdf"], flens_dev, *args, lg.lb, lg.ub))
    f_dev = timed("chain_record_backtrace", lambda: LV.lvcsr_backtrace_device(
        fa, frecs, flens_dev, ld["exit_idx"], ld["exit_w"], ld["eos"],
        ld["entry_word"], ld["entry_slot_of_state"], ld["big_pred"],
        ld["state_word"], lg.lb, Tn))
    f_host = timed("chain_host_backtrace", lambda: LV.lvcsr_backtrace_host(
        lg, fa.cpu().numpy(), [r.cpu().numpy() for r in frecs], flens, T=Tn))
    del fa, frecs
    ca, cck, crecs = timed("chain_ckpt_decode", lambda: LV.lvcsr_decode_ckpt_device(
        emit, ld["state_pdf"], flens_dev, *args, lg.lb, lg.ub, cache=ld))
    c_bt = timed("chain_ckpt_backtrace", lambda: LV.lvcsr_backtrace_ckpt_device(
        ca, cck, crecs, emit, ld["state_pdf"], flens_dev, ld["band"],
        ld["exit_idx"], ld["exit_w"], ld["eos"], ld["entry_idx"], ld["entry_word"],
        ld["entry_w"], ld["p1"], ld["bo"], ld["big_pred"], ld["big_w"],
        ld["entry_slot_of_state"], ld["state_word"], lg.lb, lg.ub, Tn, cache=ld))
    _check(list(pg.words) == list(lg.words), "the word-internal graphs' words differ")
    lex = tr.aligner.lexicon
    pron = {v: tuple(lex.words[w][0].phones) for v, w in enumerate(pg.words)}
    chain = {"S_position_major": int(pg.Pmax * pg.C), "S_chain_major": int(lg.num_states),
             "Kb": int(lg.big_pred.shape[1]),
             "record_vs_host_score_diff": _rows_equal("chain-major record-based",
                                                      f_dev, f_host, flens),
             "ckpt_vs_host_score_diff": _rows_equal("chain-major checkpointed",
                                                    c_bt, f_host, flens),
             "position_major_vs_host_score_diff": _rows_equal(
                 "position-major", pm_bt, f_host, flens, pron)}
    path, _w, _s = (x.cpu().numpy() for x in pm_bt)
    for b, (hp, _hs, _he) in enumerate(f_host):
        L = int(flens[b])
        _check([pron.get(int(v)) for v in pg.state_word[path[b, :L]]]
               == [pron.get(int(v)) for v in lg.state_word[hp[:L]]],
               f"position-major: row {b} per-frame words differ")
    launches = dict(cuda_build.LAUNCHES)
    _check(sum(launches.values()) == 0, f"the LVCSR decoders launched {launches}")
    return {"path": "lvcsr-chain-major", "utterances": len(results),
            "words": len(g.words), "T": Tn, "rows": len(flens),
            "launches": launches, "cross_word": xw, "word_internal": chain,
            "seconds": seconds}


# -- neural backends: Whisper and the SpeechBrain paths -----------------------

# openai/whisper-large-v3-turbo's published config.json: widths and depth
WHISPER_TURBO = {
    "vocab_size": 51866, "num_mel_bins": 128, "d_model": 1280,
    "encoder_layers": 32, "encoder_attention_heads": 20, "encoder_ffn_dim": 5120,
    "decoder_layers": 4, "decoder_attention_heads": 20, "decoder_ffn_dim": 5120,
    "max_source_positions": 1500, "max_target_positions": 448,
}
# its vocabulary's layout: 50,257 byte-level tokens, then <|endoftext|>,
# <|startoftranscript|>, 100 languages, the tasks and control tokens, and
# 1,501 timestamps (<|0.00|> to <|30.00|>)
WHISPER_TURBO_TEXT = {"n_base": 50257, "n_languages": 100, "n_timestamps": 1501}
# the card against the CPU: log-mel, encoder output and step logits
WHISPER_MEL_ATOL = 1e-4
WHISPER_ENCODER_ATOL = 1e-4
WHISPER_LOGITS_ATOL = 1e-4
WHISPER_COMPARE_STEPS = 32
WHISPER_COMPARE_UTTS = 2
# the generation settings the whisper-settings phase writes into a second
# generation config beside the checkpoint: timestamps, each window
# conditioned on the earlier ones, beam search over 4 beams, no repeated
# trigram
WHISPER_SETTINGS = {"return_timestamps": True, "condition_on_prev_tokens": True,
                    "num_beams": 4, "no_repeat_ngram_size": 3}


def whisper_text_layout(n_base, n_languages, n_timestamps, seed=0):
    """A synthetic Whisper vocabulary in the published layout: the 256
    byte characters and seeded letter strings (with and without GPT-2's
    word-initial ``Ġ``) as the byte-level tokens, then the special tokens
    and the timestamps at the published ids (for large-v3's sizes:
    <|endoftext|> 50257, <|startoftranscript|> 50258, languages from 50259,
    <|translate|> 50359, <|transcribe|> 50360, <|startoflm|> 50361,
    <|startofprev|> 50362, <|nospeech|> 50363, <|notimestamps|> 50364,
    <|0.00|> 50365). Returns (vocab, added tokens as (id, text, special),
    the named ids, lang_to_id)."""
    from montreal_forced_aligner_tpu_torch.transcription.whisper.generate import (
        LANGUAGES,
    )
    from montreal_forced_aligner_tpu_torch.transcription.whisper.tokenizer import (
        bytes_to_unicode,
    )

    rng = np.random.RandomState(seed)
    chars = bytes_to_unicode()
    vocab = {chars[b]: b for b in range(256)}
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(vocab) < n_base:
        word = "".join(rng.choice(letters, rng.randint(2, 9)))
        token = ("Ġ" + word) if rng.rand() < 0.6 else word
        vocab.setdefault(token, len(vocab))
    codes = list(LANGUAGES)[:n_languages]
    names = (["<|endoftext|>", "<|startoftranscript|>"]
             + [f"<|{c}|>" for c in codes]
             + ["<|translate|>", "<|transcribe|>", "<|startoflm|>",
                "<|startofprev|>", "<|nospeech|>", "<|notimestamps|>"])
    added = [(n_base + i, t, True) for i, t in enumerate(names)]
    first_ts = n_base + len(names)
    added += [(first_ts + i, f"<|{i * 0.02:.2f}|>", False) for i in range(n_timestamps)]
    ids = {t.strip("<|>"): i for i, t, _ in added[:len(names)]}
    lang_to_id = {f"<|{c}|>": ids[c] for c in codes}
    return vocab, added, ids, lang_to_id


def _whisper_tensor(name, shape, gen, device):
    import torch

    from montreal_forced_aligner_tpu_torch.transcription.whisper.model import sinusoids

    if name.endswith("embed_positions.weight") and ".encoder." in name:
        return sinusoids(*shape)
    if "layer_norm" in name:
        return (torch.ones if name.endswith("weight") else torch.zeros)(shape)
    if name.endswith("bias"):
        return torch.zeros(shape)
    return torch.randn(shape, generator=gen, device=device) * 0.02


def write_whisper_checkpoint(out_dir: Path, dims: dict, text: dict, seed=0,
                             device="cpu", max_length=None) -> Path:
    """A Hugging Face Whisper checkpoint directory at ``dims`` with random
    weights from ``seed`` (drawn on ``device``): weight matrices N(0, 0.02)
    (the config's ``init_std``), LayerNorms 1 and 0, biases 0, the
    encoder's positions sinusoidal; stored as float16 safetensors, as
    published. The vocabulary is :func:`whisper_text_layout`'s; the
    generation config has the published keys (``forced_decoder_ids`` for
    transcribe, ``lang_to_id``, ``suppress_tokens`` of 82 seeded
    byte-level ids and the published control tokens,
    ``begin_suppress_tokens`` of ``Ġ`` and <|endoftext|>, ``max_length`` the
    target positions)."""
    import struct

    import torch

    from montreal_forced_aligner_tpu_torch.transcription.whisper import (
        Whisper,
        WhisperDims,
    )

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    vocab, added, ids, lang_to_id = whisper_text_layout(**text, seed=seed)
    eot, sot = ids["endoftext"], ids["startoftranscript"]
    rng = np.random.RandomState(seed + 1)
    n_suppress = min(82, text["n_base"] // 8)
    suppress = sorted(int(i) for i in rng.choice(np.arange(256, text["n_base"]),
                                                 n_suppress, replace=False))
    suppress += [sot, ids["translate"], ids["transcribe"], ids["startoflm"],
                 ids["startofprev"], ids["nospeech"]]
    begin_suppress = [vocab["Ġ"], eot]
    config = {
        "architectures": ["WhisperForConditionalGeneration"],
        "model_type": "whisper", **dims, "activation_function": "gelu",
        "bos_token_id": eot, "eos_token_id": eot, "pad_token_id": eot,
        "decoder_start_token_id": sot, "begin_suppress_tokens": begin_suppress,
        "scale_embedding": False, "is_encoder_decoder": True, "use_cache": True,
        "torch_dtype": "float16", "init_std": 0.02,
    }
    generation = {
        "begin_suppress_tokens": begin_suppress, "bos_token_id": eot,
        "decoder_start_token_id": sot, "eos_token_id": eot, "pad_token_id": eot,
        "forced_decoder_ids": [[1, None], [2, ids["transcribe"]]],
        "is_multilingual": True, "lang_to_id": lang_to_id,
        "max_initial_timestamp_index": 50,
        "max_length": max_length or dims["max_target_positions"],
        "no_timestamps_token_id": ids["notimestamps"],
        "prev_sot_token_id": ids["startofprev"], "return_timestamps": False,
        "suppress_tokens": suppress,
        "task_to_id": {"transcribe": ids["transcribe"], "translate": ids["translate"]},
    }
    preprocessor = {
        "chunk_length": 30, "feature_extractor_type": "WhisperFeatureExtractor",
        "feature_size": dims["num_mel_bins"], "hop_length": 160, "n_fft": 400,
        "n_samples": 480000, "nb_max_frames": 3000, "padding_side": "right",
        "padding_value": 0.0, "processor_class": "WhisperProcessor",
        "return_attention_mask": False, "sampling_rate": 16000,
    }
    specials = [t for _, t, s in added if s]
    tokenizer = {
        "add_prefix_space": False, "additional_special_tokens": specials,
        "added_tokens_decoder": {
            str(i): {"content": t, "lstrip": False, "normalized": False,
                     "rstrip": False, "single_word": False, "special": s}
            for i, t, s in added},
        "bos_token": "<|endoftext|>", "clean_up_tokenization_spaces": True,
        "eos_token": "<|endoftext|>", "errors": "replace",
        "model_max_length": 1000000000000000019884624838656,
        "pad_token": "<|endoftext|>", "processor_class": "WhisperProcessor",
        "tokenizer_class": "WhisperTokenizer", "unk_token": "<|endoftext|>",
    }
    special_map = {"additional_special_tokens": specials,
                   "bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                   "pad_token": "<|endoftext|>", "unk_token": "<|endoftext|>"}
    for name, data in (("config.json", config), ("generation_config.json", generation),
                       ("preprocessor_config.json", preprocessor),
                       ("tokenizer_config.json", tokenizer),
                       ("special_tokens_map.json", special_map),
                       ("vocab.json", vocab)):
        (out_dir / name).write_text(json.dumps(data, indent=1))
    (out_dir / "merges.txt").write_text("#version: 0.2\n")
    with torch.device("meta"):
        shapes = [(k, tuple(v.shape)) for k, v in
                  Whisper(WhisperDims.from_config(config)).state_dict().items()]
    header, offset = {}, 0
    for name, shape in shapes:
        n = int(np.prod(shape)) * 2
        header[name] = {"dtype": "F16", "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    header["__metadata__"] = {"format": "pt"}
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    gen = torch.Generator(device=device).manual_seed(seed)
    with open(out_dir / "model.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, shape in shapes:
            t = _whisper_tensor(name, shape, gen, device)
            f.write(t.to(torch.float16).cpu().numpy().data)
    return out_dir


def settings_checkpoint(ckpt: Path, out_dir: Path, settings: dict) -> Path:
    """A checkpoint directory beside ``ckpt`` that links its files and holds
    a generation config with ``settings`` set."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in ckpt.iterdir():
        if f.name != "generation_config.json":
            (out_dir / f.name).symlink_to(f.resolve())
    gen = json.loads((ckpt / "generation_config.json").read_text())
    gen.update(settings)
    (out_dir / "generation_config.json").write_text(json.dumps(gen, indent=1))
    return out_dir


def _with_settings(tr, ckpt: Path):
    """The transcriber ``tr`` (its model shared) under ``ckpt``'s
    generation config."""
    import copy

    from montreal_forced_aligner_tpu_torch.transcription.whisper import (
        GenerationSettings,
    )

    out = copy.copy(tr)
    out.generation = GenerationSettings.from_dict(
        json.loads((Path(ckpt) / "generation_config.json").read_text()), False)
    return out


def whisper_cpu_reference(ckpt, waves, steps, settings_ckpt=None):
    """The port's CPU path on each wave: log-mel, encoder output, and the
    greedy decode's prompt, first ``steps`` steps' scores and the language
    detection's scores; with ``settings_ckpt``, also that config's decode
    cut at ``steps`` steps (its prompt, ids, each step's log-probabilities,
    running beams and margins), from the same encoder outputs (run in a
    worker beside the card)."""
    import hashlib

    import torch

    from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
        WhisperTranscriber,
    )

    tr = WhisperTranscriber(ckpt, device="cpu")
    encode, encoded, cache = tr.model.encode, [], {}

    def cached(mel):
        # one encoder run a window, kept for the second config's decode
        key = hashlib.sha1(mel.numpy().tobytes()).hexdigest()
        if key not in cache:
            cache[key] = encode(mel)
        encoded.append(cache[key])
        return cache[key]

    tr.model.encode = cached
    out = []
    with torch.no_grad():
        for wave in waves:
            mel = tr.features(wave)
            encoded.clear()
            d = tr.decode(wave, keep_scores=steps, max_steps=steps)
            enc = encoded[0]  # the first window's
            out.append({"mel": mel.numpy(), "enc": enc.numpy(), "prompt": d.prompt,
                        "scores": torch.stack(d.scores).numpy(),
                        "language_scores": d.language_scores.numpy()})
        if settings_ckpt is not None:
            ts = _with_settings(tr, settings_ckpt)
            for row, wave in zip(out, waves):
                row["settings"] = _beam_record(ts.decode(wave, keep_scores=steps,
                                                         max_steps=steps))
    return out


def _beam_record(d):
    import torch

    return {"prompt": d.prompt, "ids": d.ids, "steps": d.steps,
            "scores": torch.stack(d.scores).numpy(), "tokens": d.beam_tokens,
            "sources": d.beam_sources, "margins": d.beam_margins}


def beam_agreement(cpu, card, atol):
    """Beam steps whose log-probabilities agree within ``atol`` (the same
    entries suppressed) and whose running beams (new token and source beam)
    are equal, up to the first step where the CPU's best candidates, or the
    two sides of its timestamp-versus-text rule, lie within ``atol`` of each
    other (a near-tie the two devices may break apart): (steps compared, the
    step that stopped the comparison or None, the largest finite difference
    over the compared steps)."""
    compared, stopped, worst = 0, None, 0.0
    for i, (c, g) in enumerate(zip(cpu["scores"], card["scores"])):
        if cpu["margins"][i] < atol:
            stopped = i
            break
        finite = np.isfinite(c)
        _check(np.array_equal(finite, np.isfinite(g)),
               f"beam step {i}: the suppressed tokens differ")
        worst = max(worst, float(np.abs(c[finite] - g[finite]).max()))
        _check(card["tokens"][i] == cpu["tokens"][i]
               and card["sources"][i] == cpu["sources"][i],
               f"beam step {i}: the card ran beams {card['tokens'][i]} from "
               f"{card['sources'][i]}, the CPU {cpu['tokens'][i]} from "
               f"{cpu['sources'][i]} (margin {cpu['margins'][i]:.3g})")
        compared += 1
    return compared, stopped, worst


def greedy_agreement(cpu_scores, card_scores, atol):
    """Steps whose arg-max agree, up to the first step where the CPU's top
    two scores lie within ``atol`` (a near-tie the two devices may break
    apart): (steps compared, the step that stopped the comparison or None,
    the largest finite score difference over the compared steps)."""
    compared, stopped, worst = 0, None, 0.0
    for i, (c, g) in enumerate(zip(cpu_scores, card_scores)):
        finite = np.isfinite(c)
        _check(np.array_equal(finite, np.isfinite(g)),
               f"step {i}: the suppressed tokens differ")
        top = np.sort(c[finite])[-2:]
        if top[1] - top[0] < atol:
            stopped = i
            break
        _check(int(np.argmax(c)) == int(np.argmax(g)),
               f"step {i}: the card chose {int(np.argmax(g))}, the CPU "
               f"{int(np.argmax(c))} (margin {top[1] - top[0]:.3g})")
        worst = max(worst, float(np.abs(c[finite] - g[finite]).max()))
        compared += 1
    return compared, stopped, worst


def whisper_phase(tmp: Path, corpus_dir: Path, device, dims=None, text=None):
    """Main path **whisper**: a random-weight checkpoint at
    large-v3-turbo's published widths and depth written as float16
    safetensors, then ``cli transcribe_whisper`` on the card over the
    corpus (counted from 0: no kernel of K1-K3 on this path); one warm
    load and a warm run utterance by utterance (the same texts; decoder ms
    per token is the run's wall less each utterance's encoder, timed
    alone, over the tokens), peak memory; then the
    card against the port's CPU path (a worker started after the write) on
    the first utterances: log-mel and encoder output within their
    tolerances, the language detection and the greedy ids of the first
    steps equal up to the CPU's first near-tie, their logits within
    ``WHISPER_LOGITS_ATOL``. ``dims`` and ``text`` cut the model for a
    rehearsal on the CPU."""
    import torch

    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
        WhisperTranscriber,
        _samples_at_model_rate,
    )

    t0 = time.perf_counter()
    ckpt = write_whisper_checkpoint(tmp / "whisper_turbo", dims or WHISPER_TURBO,
                                    text or WHISPER_TURBO_TEXT, seed=0,
                                    device=device)
    write_s = time.perf_counter() - t0
    settings_dir = settings_checkpoint(ckpt, tmp / "whisper_turbo_settings",
                                       WHISPER_SETTINGS)
    corpus = Corpus.load(corpus_dir, require_transcripts=False)
    waves = [_samples_at_model_rate(corpus.load_audio(u)) for u in corpus.utterances]
    audio_s = sum(min(len(w), 480000) for w in waves) / 16000
    cpu = CpuTask("whisper_cpu_reference",
                  (str(ckpt), waves[:WHISPER_COMPARE_UTTS], WHISPER_COMPARE_STEPS,
                   str(settings_dir)),
                  tmp / "whisper_cpu.pkl", threads=6)
    out_dir = tmp / "whisper_out"
    _reset_peak(device)
    _, cold_s, launches = _counted(device, lambda: _cli(
        ["transcribe_whisper", corpus_dir, ckpt, out_dir, "--device", device.type]))
    _no_launches("whisper", launches)
    cold_peak = _peak_gib(device)
    labs = {p.relative_to(out_dir).as_posix(): p.read_text()
            for p in sorted(out_dir.rglob("*.lab"))}
    _check(len(labs) == len(corpus.files), f"whisper: {len(labs)} transcripts for "
           f"{len(corpus.files)} files")
    t0 = time.perf_counter()
    tr = WhisperTranscriber(ckpt, device=device)
    _sync(device)
    load_s = time.perf_counter() - t0
    _check(all(p.device.type == device.type for p in tr.model.parameters()),
           "whisper: parameters off the device")
    # the warm run, one utterance at a time as transcribe_corpus runs them,
    # and each utterance's encoder once more on its own
    _reset_peak(device)
    enc_ms, utt_s, tokens, windows, texts = [], [], 0, 0, {}
    with torch.no_grad():
        for utt, wave in zip(corpus.utterances, waves):
            _sync(device)
            t0 = time.perf_counter()
            d = tr.decode(wave)
            texts[utt.id] = tr.tokenizer.decode(d.ids).strip()
            _sync(device)
            utt_s.append(time.perf_counter() - t0)
            tokens += d.steps
            windows += d.windows
            mel = tr.features(wave)
            _sync(device)
            t0 = time.perf_counter()
            tr.model.encode(mel)
            _sync(device)
            enc_ms.append(1e3 * (time.perf_counter() - t0))
    warm_s = sum(utt_s)
    warm_peak = _peak_gib(device)
    by_file = {}
    for u in corpus.utterances:
        by_file.setdefault(f"{u.speaker}/{u.file_name}.lab", []).append(texts[u.id])
    _check(by_file.keys() == labs.keys() and all(
        "\n".join(v) + "\n" == labs[k] for k, v in by_file.items()),
        "whisper: the warm run's texts differ from the command's")
    # the card against the CPU
    ref = cpu.result()
    checks = []
    with torch.no_grad():
        for i, r in enumerate(ref):
            mel = tr.features(waves[i])
            enc = tr.model.encode(mel).cpu().numpy()
            d = tr.decode(waves[i], keep_scores=WHISPER_COMPARE_STEPS,
                          max_steps=WHISPER_COMPARE_STEPS)
            mel_err = float(np.abs(mel.cpu().numpy() - r["mel"]).max())
            enc_err = float(np.abs(enc - r["enc"]).max())
            _check(mel_err <= WHISPER_MEL_ATOL, f"whisper log-mel: {mel_err}")
            _check(enc_err <= WHISPER_ENCODER_ATOL, f"whisper encoder: {enc_err}")
            lang_c = r["language_scores"]
            lang_g = d.language_scores.numpy()
            top = np.sort(lang_c[np.isfinite(lang_c)])[-2:]
            lang_close = bool(top[1] - top[0] < WHISPER_LOGITS_ATOL)
            row = {"mel_max_abs_err": mel_err, "encoder_max_abs_err": enc_err,
                   "language_margin": float(top[1] - top[0]),
                   "language_max_abs_err": float(np.abs(
                       lang_c[np.isfinite(lang_c)] - lang_g[np.isfinite(lang_g)]).max())}
            if not lang_close:
                _check(d.prompt == r["prompt"],
                       f"whisper prompt: card {d.prompt}, CPU {r['prompt']}")
                compared, stopped, worst = greedy_agreement(
                    r["scores"], torch.stack(d.scores).numpy(), WHISPER_LOGITS_ATOL)
                _check(worst <= WHISPER_LOGITS_ATOL, f"whisper logits: {worst}")
                row.update(steps_equal=compared, stopped_at_near_tie=stopped,
                           logits_max_abs_err=worst)
            row["language_close"] = lang_close
            checks.append(row)
    settings = whisper_settings_phase(
        tmp, corpus, waves, settings_dir, tr, ref, checks,
        statistics.median(enc_ms), device)
    return {
        "settings": settings,
        "path": "whisper", "dims": dims or WHISPER_TURBO,
        "model": "random weights (seed 0), float16 safetensors",
        "parameters": sum(p.numel() for p in tr.model.parameters()),
        "utterances": len(waves), "audio_s": audio_s,
        "checkpoint_write_s": write_s,
        "checkpoint_bytes": (ckpt / "model.safetensors").stat().st_size,
        "cold_command_s": cold_s, "launches": launches, "cold_peak_gib": cold_peak,
        "load_s": load_s, "warm_s": warm_s, "warm_audio_s_per_s": audio_s / warm_s,
        "warm_peak_gib": warm_peak,
        "encoder_ms_per_utterance": statistics.median(enc_ms),
        "decoder_ms_per_token": (1e3 * warm_s - sum(enc_ms)) / tokens,
        "tokens": tokens,
        "windows": windows, "card_vs_cpu": checks,
        "tolerances": {"mel": WHISPER_MEL_ATOL, "encoder": WHISPER_ENCODER_ATOL,
                       "logits": WHISPER_LOGITS_ATOL},
    }


def _gpu_label():
    """``nvidia-smi``'s name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def whisper_settings_phase(tmp: Path, corpus, waves, settings_dir: Path, tr, ref,
                           greedy_checks, encoder_ms, device):
    """Main path **whisper-settings** (run inside the whisper phase's
    process): the same checkpoint under a second generation config
    (``WHISPER_SETTINGS``: timestamps, conditioning on earlier windows, 4
    beams, no repeated trigram). ``cli transcribe_whisper`` on the card over
    the first 2 utterances (counted from 0: no K1-K3 on this path); a warm
    run of the same two with the loaded model (the same texts; decoder ms a
    beam step is its wall less an encoder run a window, ``encoder_ms``,
    over the steps), peak memory and the phase's seconds; then the card
    against the port's CPU path (``ref``, from the whisper phase's worker)
    over the first ``WHISPER_COMPARE_STEPS`` steps: the prompt equal where
    the language detection is no near-tie, every beam's log-probabilities
    within ``WHISPER_LOGITS_ATOL``, the running beams equal up to the CPU's
    first near-tie (best candidates, or the two sides of the
    timestamp-versus-text rule), at least one beam step compared, and the
    chosen hypothesis equal when no near-tie came."""
    import shutil

    import torch

    t_phase = time.perf_counter()
    utts = corpus.utterances[:WHISPER_COMPARE_UTTS]
    sub = tmp / "whisper_settings_corpus"
    for u in utts:
        d = sub / u.speaker
        d.mkdir(parents=True, exist_ok=True)
        src = Path(u.file_path)
        shutil.copy(src, d / src.name)
    out_dir = tmp / "whisper_settings_out"
    _reset_peak(device)
    _, cold_s, launches = _counted(device, lambda: _cli(
        ["transcribe_whisper", sub, settings_dir, out_dir, "--device", device.type]))
    _no_launches("whisper-settings", launches)
    cold_peak = _peak_gib(device)
    labs = {p.relative_to(out_dir).as_posix(): p.read_text()
            for p in sorted(out_dir.rglob("*.lab"))}
    _check(len(labs) == len(utts), f"whisper-settings: {len(labs)} transcripts "
           f"for {len(utts)} utterances")
    ts = _with_settings(tr, settings_dir)
    _check(ts.generation.num_beams == WHISPER_SETTINGS["num_beams"]
           and ts.generation.return_timestamps, "whisper-settings: config not read")
    _reset_peak(device)
    utt_s, steps, windows, texts = [], 0, 0, {}
    with torch.no_grad():
        for u, wave in zip(utts, waves):
            _sync(device)
            t0 = time.perf_counter()
            d = ts.decode(wave)
            texts[f"{u.speaker}/{u.file_name}.lab"] = ts.tokenizer.decode(d.ids).strip()
            _sync(device)
            utt_s.append(time.perf_counter() - t0)
            steps += d.steps
            windows += d.windows
    warm_peak = _peak_gib(device)
    _check(texts.keys() == labs.keys() and all(
        t + "\n" == labs[k] for k, t in texts.items()),
        "whisper-settings: the warm run's texts differ from the command's")
    checks = []
    with torch.no_grad():
        for i, (r, greedy) in enumerate(zip(ref, greedy_checks)):
            cpu = r["settings"]
            card = _beam_record(ts.decode(waves[i], keep_scores=WHISPER_COMPARE_STEPS,
                                          max_steps=WHISPER_COMPARE_STEPS))
            row = {"language_close": greedy["language_close"]}
            if not greedy["language_close"]:
                _check(card["prompt"] == cpu["prompt"],
                       f"whisper-settings prompt: card {card['prompt']}, CPU "
                       f"{cpu['prompt']}")
                compared, stopped, worst = beam_agreement(cpu, card, WHISPER_LOGITS_ATOL)
                _check(worst <= WHISPER_LOGITS_ATOL, f"whisper-settings log-probs: {worst}")
                if stopped is None:
                    _check(card["ids"] == cpu["ids"], "whisper-settings: the card "
                           f"chose {card['ids']}, the CPU {cpu['ids']}")
                row.update(beam_steps_equal=compared, stopped_at_near_tie=stopped,
                           log_probs_max_abs_err=worst,
                           chosen_equal=card["ids"] == cpu["ids"],
                           chosen_tokens=len(cpu["ids"]))
            checks.append(row)
    _check(any(row.get("beam_steps_equal", 0) >= 1 for row in checks),
           "whisper-settings: no beam step was held against the CPU")
    warm_s = sum(utt_s)
    return {
        "path": "whisper-settings", "settings": WHISPER_SETTINGS,
        "utterances": len(utts), "cold_command_s": cold_s, "launches": launches,
        "cold_peak_gib": cold_peak, "warm_s": warm_s, "warm_peak_gib": warm_peak,
        "beam_steps": steps, "windows": windows,
        "decoder_ms_per_step_4_beams": (1e3 * warm_s - windows * encoder_ms) / steps,
        "phase_s": time.perf_counter() - t_phase,
        "gpu": _gpu_label() if device.type == "cuda" else "not measured (CPU)",
        "card_vs_cpu": checks,
        "tolerances": {"log_probs": WHISPER_LOGITS_ATOL},
    }


def _tg_segments(out_dir: Path):
    from montreal_forced_aligner_tpu_torch.io.textgrid import TextGrid

    return {p.relative_to(out_dir).as_posix():
            [(i.begin, i.end) for i in TextGrid.read(p).tiers["segments"] if i.label]
            for p in sorted(out_dir.rglob("*.TextGrid"))}


def speechbrain_paths_phase(tmp: Path, asr_dir: Path, vad_dir: Path,
                            speaker_dir: Path, num_speakers: int, device):
    """**speechbrain-paths**: the three SpeechBrain commands through the
    port's stand-in package (``tests/torch_mock_speechbrain.py``, whose
    ``from_hparams`` puts the models on ``run_opts["device"]``), on the
    card and on the CPU: ``transcribe_speechbrain`` (the texts),
    ``create_segments_vad --speechbrain_model_path`` (the segments) and
    ``diarize_speakers speechbrain --xvector_model_path`` (the labels),
    each counted from 0 (no kernel launches) and equal across devices;
    each wrapper's model parameters and its last input on the card."""

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_mock_speechbrain

    from montreal_forced_aligner_tpu_torch.diarization.embeddings import XVectorEmbedder
    from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
        SpeechbrainTranscriber,
    )
    from montreal_forced_aligner_tpu_torch.vad.segmenter import SpeechbrainVAD

    torch_mock_speechbrain.install()
    try:
        report = {"path": "speechbrain-paths"}
        runs = {}
        for dev in (device.type, "cpu"):
            ck = tmp / f"sb_{dev}"
            ck.mkdir(exist_ok=True)
            asr_out, vad_out, diar_out = (tmp / f"sb_{n}_{dev}" for n in
                                          ("asr", "vad", "diar"))
            _, asr_s, l1 = _counted(device, lambda: _cli(
                ["transcribe_speechbrain", asr_dir, ck, asr_out, "--device", dev]))
            _, vad_s, l2 = _counted(device, lambda: _cli(
                ["create_segments_vad", vad_dir, vad_out, "--device", dev,
                 "--speechbrain_model_path", ck]))
            _, diar_s, l3 = _counted(device, lambda: _cli(
                ["diarize_speakers", speaker_dir, "speechbrain", diar_out,
                 "--device", dev, "--xvector_model_path", ck,
                 "--expected_num_speakers", num_speakers]))
            for launches in (l1, l2, l3):
                _no_launches("speechbrain-paths", launches)
            runs[dev] = {
                "texts": {p.relative_to(asr_out).as_posix(): p.read_text()
                          for p in sorted(asr_out.rglob("*.lab"))},
                "segments": _tg_segments(vad_out),
                "labels": (diar_out / "utt2spk.tsv").read_text(),
                "walls_s": {"transcribe_speechbrain": asr_s,
                            "create_segments_vad": vad_s, "diarize_speakers": diar_s},
            }
        card, cpu = runs[device.type], runs["cpu"]
        _check(card["texts"] and card["texts"] == cpu["texts"],
               "transcribe_speechbrain: the card's texts differ from the CPU's")
        _check(card["segments"] and card["segments"] == cpu["segments"],
               "create_segments_vad (speechbrain): segments differ")
        _check(card["labels"] == cpu["labels"],
               "diarize_speakers speechbrain: labels differ")
        _, purity, ari = _purity_ari(tmp / f"sb_diar_{device.type}")
        ck = tmp / f"sb_{device.type}"
        wave = np.sin(np.arange(16000) * 0.05).astype(np.float32) * 3000
        on_card = {}
        for name, wrapper, call in (
                ("asr", SpeechbrainTranscriber(ck, device=device),
                 lambda w: w.transcribe(wave)),
                ("vad", SpeechbrainVAD(ck, device=device),
                 lambda w: w.voiced_frames(wave)),
                ("xvector", XVectorEmbedder(ck, device=device),
                 lambda w: w.embed(wave))):
            call(wrapper)
            params = {p.device.type for p in wrapper.model.parameters()} or {
                wrapper.model.device.type}
            on_card[name] = {"parameters": sorted(params),
                             "input": wrapper.model.input_device.type}
            _check(params == {device.type} and on_card[name]["input"] == device.type,
                   f"speechbrain {name}: {on_card[name]}")
        report.update(
            files_transcribed=len(card["texts"]),
            segment_files=len(card["segments"]),
            segments=sum(len(v) for v in card["segments"].values()),
            utterances_diarized=len(card["labels"].splitlines()),
            diarize_purity=purity, diarize_ari=ari, on_card=on_card,
            card_walls_s=card["walls_s"], cpu_walls_s=cpu["walls_s"],
            card_equals_cpu=True)
        return report
    finally:
        torch_mock_speechbrain.uninstall()


def read_duration(path) -> float:
    from montreal_forced_aligner_tpu_torch.io.wav import read_wave

    return read_wave(path).duration


def kernels_line(checks, launches, by_path=None, extra_checks=None):
    """The kernels line: sat-2pass's launches and checks in the contract's
    keys; ``by_path`` adds each path's launches (``launches_by_path``) and
    ``extra_checks`` other paths' checks of the same kernel, by path."""
    rows = []
    for name, source, replaces in KERNELS:
        c = checks[name]
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        }
        if by_path:
            row["launches_by_path"] = {p: l[name] for p, l in by_path.items()}
        for path, ec in (extra_checks or {}).items():
            if name not in ec:
                continue
            e = ec[name]
            row[f"{path}_check"] = {k: e[k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}
        rows.append(row)
    return {"kernels": rows}


def main() -> int:
    global _T_START
    _T_START = time.perf_counter()
    root = Path(__file__).resolve().parent
    if not (root / PKG / "__init__.py").is_file():
        print(f"chip_smoke: the {PKG} package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    # cuBLAS's deterministic workspace, for the deterministic-algorithms run
    # of train-reference (read when cuBLAS starts)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    print(_gpu_label(), flush=True)
    sm_clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0])
    device = torch.device("cuda")

    from montreal_forced_aligner_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    _emit({"build_s": time.perf_counter() - t0})

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmpdir:
        tmp = Path(tmpdir)
        t0 = time.perf_counter()
        model_path, dict_path, words = build_sat_scale_model(tmp)
        corpus_dir, _ = build_corpus(tmp, words, 64)
        small_dir, _ = build_corpus(tmp, words, 4, min_s=2.0, max_s=4.0,
                                    seed=1, name="small")
        small2_dir, _ = build_corpus(tmp, words, 8, min_s=3.0, max_s=6.0,
                                     seed=2, name="small2", num_speakers=2)
        long_dir, long_s = build_corpus(tmp, words, 1, min_s=630.0, max_s=630.0,
                                        seed=3, name="long", num_speakers=1)
        _emit({"fixture_s": time.perf_counter() - t0, "long_utterance_s": long_s})

        reports, aligners, inputs = {}, {}, {}
        for adaptation, warm_runs in ((True, 5), (False, 3)):
            report, aligner, counted = run_main_path(
                model_path, dict_path, corpus_dir, tmp / f"tg{adaptation}",
                device, warm_runs=warm_runs, adaptation=adaptation,
            )
            path = report["path"]
            report["profiled_warm_run"] = profile_warm_run(aligner, corpus_dir)
            _emit({"main_path": report})
            reports[path], aligners[path] = report, aligner
            # sat-2pass: the second pass's first batch; sat-si: the first
            inputs[path] = batch_inputs(counted, report["batches"] if adaptation
                                        else 0)
            del counted
        for adaptation, d in ((False, small_dir), (True, small2_dir)):
            _emit({"reference_check": "sat-2pass" if adaptation else "sat-si",
                   **reference_check(model_path, dict_path, d, device, adaptation)})
        _emit({"speaker_stats_invariance": speaker_stats_invariance(
            model_path, dict_path, corpus_dir, device)})
        checks = {}
        for path in ("sat-si", "sat-2pass"):
            # K1's plain version (seconds a call) is timed over repeated
            # calls only for sat-2pass, whose times the kernels line reports
            checks[path] = kernel_checks(inputs.pop(path), aligners[path].gmm,
                                         device, sm_clock_mhz=sm_clock_mhz,
                                         k1_plain_reps=1 if path == "sat-2pass" else 0)
            rep = reports[path]
            for name, c in checks[path].items():
                _emit({"kernel_check": name, "path": path, **c,
                       "main_path_calls": rep["kernel_calls"][name],
                       "main_path_event_ms": rep["kernel_ms"][name],
                       "warm_main_path_event_ms": rep["warm_kernel_ms"][name],
                       "warm_main_path_profiler_ms":
                           rep["profiled_warm_run"]["device_ms_by_port_kernel"][name]})
        del aligners["sat-si"]
        # before the long utterance's own two-pass replaces the estimate
        _emit({"native_fmllr_solve": native_solve_check(aligners["sat-2pass"])})
        _emit({"long_utterance": long_utterance_phase(
            aligners["sat-2pass"], long_dir, device)})
        del aligners
        audio_s = reports["sat-2pass"]["audio_s"]
        kept = {}
        mono, mono_checks = train_mono_phase(corpus_dir, dict_path, audio_s, device,
                                             sm_clock_mhz=sm_clock_mhz, keep=kept)
        _emit({"main_path": mono})
        for label, cks in mono_checks.items():
            for name, c in cks.items():
                _emit({"kernel_check": name, "path": label, **c})
        recipe, captured = train_recipe_phase(corpus_dir, dict_path, tmp, device)
        _emit({"main_path": recipe})
        calls = captured["calls"]
        recipe_checks = kernel_checks(batch_inputs(calls, 0), captured["gmm"], device,
                                      sm_clock_mhz=sm_clock_mhz,
                                      k3_term_bound=True, k1_plain_reps=0)
        for name, c in recipe_checks.items():
            _emit({"kernel_check": name, "path": "train-recipe (LDA stage)", **c,
                   "calls_in_that_realignment": calls[name].calls})
        del captured, calls
        _emit({"train_reference": train_reference_phase(tmp / "tone", device)})
        adapt, adapt_checks = adapt_phase(model_path, dict_path, corpus_dir,
                                          small2_dir, tmp, audio_s, device,
                                          warm_runs=1, sm_clock_mhz=sm_clock_mhz)
        _emit({"main_path": adapt})
        for name, c in adapt_checks.items():
            _emit({"kernel_check": name, "path": "adapt (pass 1, first batch)", **c})
        _emit({"graph_compile": graph_compile_phase(
            kept["trainer"], kept["corpus"], model_path, dict_path, corpus_dir,
            device)})
        del kept
        _emit({"pitch": pitch_phase(corpus_dir, dict_path, small_dir, audio_s,
                                    device)})
        _emit({"fine_tune": fine_tune_phase(model_path, dict_path, corpus_dir,
                                            small_dir, device)})
        lms = transcription_lms(words)
        nbest_lm = transcription_lms(words, n_words=12)[0]
        # host work beside the card's transcription phases: the 20k graph
        # build and the CPU references of the card-against-CPU check
        graph_20k = CpuTask("lvcsr_20k_graph",
                            (model_path, dict_path, corpus_dir, tmp), tmp / "g20k.pkl")
        lvcsr_lm = corpus_lm(model_path, dict_path, corpus_dir)
        cpu_refs = CpuTask("transcribe_cpu_references",
                           (model_path, dict_path, small_dir,
                            (lms[0], nbest_lm, lvcsr_lm)), tmp / "refs.pkl")
        dense, dense_checks = transcribe_dense_phase(model_path, dict_path,
                                                     corpus_dir, audio_s, lms[0],
                                                     device)
        _emit({"main_path": dense})
        _emit({"kernel_check": "state_emission",
               "path": "transcribe-dense (pass 2, first batch)",
               **dense_checks["state_emission"]})
        nbest = transcribe_nbest_phase(model_path, dict_path, small_dir, lms, device)
        _emit({"main_path": nbest})
        lvcsr, lvcsr_tr = transcribe_lvcsr_phase(model_path, dict_path, corpus_dir,
                                                 audio_s, device)
        _emit({"main_path": lvcsr})
        _check(lvcsr_tr.lm.ngrams == lvcsr_lm.ngrams,
               "the corpus LM differs between two trainings")
        del lvcsr_tr
        _emit({"main_path": transcribe_lvcsr_20k_phase(graph_20k.result(),
                                                       model_path, device)})
        # the 8-utterance corpus for both commands: a depth cut for the
        # script's time budget (the whole corpus took 42 s)
        phone = phone_transcribe_phase(model_path, dict_path, small2_dir, small2_dir,
                                       tmp, device)
        _emit({"phone_transcribe": phone})
        _emit({"transcribe_card_vs_cpu": transcribe_card_vs_cpu(
            model_path, dict_path, small_dir, (lms[0], nbest_lm, lvcsr_lm),
            device, cpu_runs=cpu_refs.result())})
        # i-vectors, diarization and segmentation; the CPU half of their
        # card-against-CPU check runs in a worker beside them
        t0 = time.perf_counter()
        spk_dir, spk_s = build_speaker_corpus(tmp)
        subset_dir = subset_corpus(spk_dir, tmp / "speakers32", 4)
        vad_dir, pauses, vad_s = build_vad_set(tmp)
        joined_dir, joined_s = build_joined_utterance(small2_dir, tmp)
        _emit({"segmentation_fixture_s": time.perf_counter() - t0,
               "speaker_corpus_s": spk_s, "vad_set_s": vad_s, "joined_s": joined_s})
        seg_refs = CpuTask("segmentation_references",
                           (subset_dir, vad_dir, joined_dir, model_path, dict_path,
                            "cpu"), tmp / "seg.pkl")
        ivec, ivec_model = train_ivector_phase(spk_dir, tmp, spk_s, device)
        _emit({"main_path": ivec})
        diar = diarize_phase(spk_dir, ivec_model, tmp / "diarized", device)
        _emit({"main_path": diar})
        vad = vad_phase(vad_dir, pauses, tmp / "vad_out", vad_s, device)
        _emit({"main_path": vad})
        segs = create_segments_phase(model_path, dict_path, long_dir,
                                     tmp / "segments_out", device)
        _emit({"main_path": segs})
        _emit({"segmentation_card_vs_cpu": segmentation_card_vs_cpu(
            segmentation_references(subset_dir, vad_dir, joined_dir, model_path,
                                    dict_path, "cuda"),
            seg_refs.result())})
        # G2P, rules, the English tokenizer and FLAC audio
        g2p_fx = g2p_prepare(tmp / "g2p", [f"p{i:02d}" for i in range(40)],
                             corpus_dir)
        _emit({"flac_writer_s": g2p_fx["writer_s"],
               "g2p_train_s": g2p_fx["g2p_train_s"],
               "flac_audio_s": g2p_fx["audio_s"]})
        g2p, g2p_checks = g2p_align_phase(model_path, g2p_fx, tmp / "g2p_out",
                                          device, sm_clock_mhz=sm_clock_mhz)
        _emit({"main_path": g2p})
        for name, c in g2p_checks.items():
            _emit({"kernel_check": name, "path": "g2p-align (pass 2, first batch)",
                   **c})
        # the CPU halves in workers, beside the card's last runs: the plain
        # Python FLAC decoder on every file, and g2p-align on the subset
        files = sorted(g2p_fx["written"], key=lambda p: -Path(p).stat().st_size)
        plain = [CpuTask("flac_plain_decode", (files[i::6],), tmp / f"flac{i}.pkl",
                         threads=1) for i in range(6)]
        cpu_ref = CpuTask("g2p_align_run", (model_path, g2p_fx, g2p_fx["small_dir"],
                                            "cpu"), tmp / "g2p_cpu.pkl", threads=1)
        g2p_small = g2p_align_run(model_path, g2p_fx, g2p_fx["small_dir"], device)
        _emit({"main_path": train_g2p_phase(tmp / "tone_g2p", device)})
        _emit({"g2p_card_vs_cpu": g2p_card_vs_cpu(g2p_small, cpu_ref.result())})
        _emit({"flac_plain_decode": flac_plain_check(
            g2p_fx, {k: v for task in plain for k, v in task.result().items()})})
        # multi-GPU on the one card; MFA's and transfer-features' CPU halves
        # in workers beside it
        mfa_cpu = CpuTask("mfa_run", (model_path, dict_path, small_dir, "cpu"),
                          tmp / "mfa_cpu.pkl")
        transfer_cpu = CpuTask("transfer_cpu_references",
                               (model_path, dict_path, small_dir, small2_dir, lms[0]),
                               tmp / "transfer_cpu.pkl")
        nccl = nccl_one_rank_phase(model_path, dict_path, corpus_dir, tmp, device)
        _emit({"main_path": {"path": "distributed (W = 1, NCCL)", **nccl}})
        gloo = gloo_two_ranks_phase(model_path, dict_path, corpus_dir, device)
        _emit({"main_path": {"path": "distributed (W = 2, gloo, one card)", **gloo}})
        trun = torchrun_align_phase(model_path, dict_path, corpus_dir,
                                    tmp / "torchrun", device)
        _emit({"main_path": {"path": "align-distributed (torch.distributed.run, "
                                     "W = 2, gloo)", **trun}})
        dry = dryrun_phase(device)
        _emit({"main_path": {"path": "dryrun (W = 2, gloo)", **dry}})
        _emit({"mfa": mfa_phase(model_path, dict_path, small_dir, device,
                                mfa_cpu.result())})
        _emit({"parity_harness": parity_harness_phase(model_path, dict_path,
                                                      corpus_dir, device)})
        # host features in place of waves, pitch models on every path, and
        # the chain-major LVCSR decoders against the production routes
        transfer = transfer_features_phase(model_path, dict_path, corpus_dir,
                                           small_dir, small2_dir, lms[0], tmp,
                                           device, cpu_refs=transfer_cpu.result())
        _emit({"main_path": transfer})
        pitch_paths = pitch_paths_phase(dict_path, tmp, device)
        invariance = pitch_paths.pop("batch_invariance")
        _emit({"main_path": pitch_paths})
        # the same batch sizes without pitch, at the same bars
        no_pitch = batch_size_alignment(model_path, dict_path, small2_dir, device)
        for label, a in no_pitch.items():
            _check(a["intervals_differ"] == 0,
                   f"align without pitch {label}: intervals of "
                   f"{a['intervals_differ']} utterances depend on the batch")
        two_pass_within_single("align without pitch", no_pitch)
        invariance["align_without_pitch"] = no_pitch
        _emit({"pitch_batch_invariance": invariance})
        chain = lvcsr_chain_major_phase(model_path, dict_path, small_dir, lvcsr_lm,
                                        device)
        _emit({"main_path": chain})
        # the neural backends: Whisper at large-v3-turbo's widths, in a
        # process of its own without this one's deterministic cuBLAS
        # workspace (it holds the decoder's matrix-vector products to
        # about a third of their speed: tools/whisper_card.py), and the
        # SpeechBrain commands through the port's stand-in package
        whisper = CpuTask("whisper_phase", (tmp, small_dir, device),
                          tmp / "whisper.pkl", daemon=False,
                          drop_env=("CUBLAS_WORKSPACE_CONFIG",)).result()
        whisper_settings = whisper.pop("settings")
        _emit({"main_path": whisper})
        _emit({"main_path": whisper_settings})
        _emit({"main_path": speechbrain_paths_phase(tmp, small2_dir, vad_dir,
                                                    subset_dir, 8, device)})

        def by_rank(launches):
            return {k: [l[k] for l in launches] for k in launches[0]}
        by_path = {"sat-2pass": reports["sat-2pass"]["launches"],
                   "train-mono": mono["launches"], "train-recipe": recipe["launches"],
                   "adapt": adapt["launches"],
                   "transcribe-dense": dense["launches"],
                   "transcribe-nbest": nbest["launches"],
                   "transcribe-lvcsr": lvcsr["launches"],
                   "phone-transcribe": phone["align --use_phone_model"]["launches"],
                   "transcribe-alignment":
                       phone["transcribe --output_type alignment"]["launches"],
                   "train-ivector": ivec["launches"], "diarize": diar["launches"],
                   "vad": vad["launches"], "create-segments": segs["launches"],
                   "g2p-align": g2p["launches"],
                   "align-distributed (W = 1, NCCL)": nccl["sat-2pass"]["launches"],
                   "align-distributed (W = 2, gloo, ranks 0 and 1)": by_rank(
                       [r["launches"] for r in trun["ranks"]]),
                   "train-distributed (W = 1, NCCL)": nccl["train-mono"]["launches"],
                   "train-distributed (W = 2, gloo, ranks 0 and 1)": by_rank(
                       [r["train_launches"] for r in gloo["ranks"]]),
                   "dryrun (W = 2, gloo, ranks 0 and 1)": by_rank(
                       [r["launches"] for r in dry["ranks"]]),
                   "transfer-features sat-2pass": transfer["sat-2pass"]["launches"],
                   "transfer-features train-mono": transfer["train-mono"]["launches"],
                   "transfer-features transcribe-dense":
                       transfer["transcribe-dense"]["launches"],
                   "pitch-recipe": pitch_paths["recipe"]["launches"],
                   "pitch-align (sat-2pass)": pitch_paths["align"]["launches"],
                   "pitch-adapt": pitch_paths["adapt"]["launches"],
                   "pitch-long-path (two-pass)":
                       pitch_paths["long_path"]["two_pass"]["launches"],
                   "lvcsr-chain-major": chain["launches"],
                   "whisper": whisper["launches"],
                   "whisper-settings": whisper_settings["launches"]}
        extra = {**mono_checks, "train_recipe": recipe_checks,
                 "adapt": adapt_checks, "transcribe_dense": dense_checks,
                 "g2p_align": g2p_checks}
        _emit(stamp=False, obj=kernels_line(
            checks["sat-2pass"], reports["sat-2pass"]["launches"], by_path, extra))

    _emit(stamp=False, obj={"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
