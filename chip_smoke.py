#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

What it does, in order; any failure exits non-zero with no result line:

1. prints the card's name and power limit as ``nvidia-smi`` gives them;
2. builds the port's native code, the CUDA kernels of
   ``montreal_forced_aligner_tpu_torch/csrc`` and the fMLLR solver of
   ``native/`` (one compiler per source, all started together);
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
   JAX package's parity bar;
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
13. prints one ``{"kernels": [...]}`` line (sat-2pass's launches and
    second-pass checks; each row's ``launches_by_path`` adds the training
    paths' launches and ``train_recipe_check`` the LDA-stage check), then as
    the last line
    ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
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


def _emit(obj) -> None:
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


def parity(got, want, frame_shift):
    """The JAX package's parity bar (tests/test_parity_sweep.py): >= 99.9%
    of frames agree, >= 99.5% of boundaries within one frame, scores within
    5 nats."""
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
    agreement = 1.0 - mismatched / max(frames, 1)
    out = {
        "frames": frames,
        "frame_agreement": agreement,
        "boundaries_within_1": b_within,
        "boundaries": b_total,
        "max_score_diff": worst_score,
    }
    _check(agreement >= 0.999, f"frame agreement {out}")
    _check(b_within >= 0.995 * b_total, f"boundaries {out}")
    _check(worst_score < 5.0, f"scores {out}")
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
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        results = aligner.align_corpus(corpus)
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cuda_build.LAUNCHES)
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
    copies) that a ``torch.profiler`` run saw."""
    import torch

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    _check(spans, "the profiler saw no work on the card")
    busy, (cur_start, cur_end) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    return (busy + cur_end - cur_start) / 1e6


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
                  k3_term_bound=False):
    """Each kernel against its plain version on one batch's recorded
    inputs (:func:`batch_inputs`), with times and bounds; K2 also on the
    last batch's, with the chain floor at ``sm_clock_mhz`` (none without
    it). K3 (:func:`k3_check`, ``k3_term_bound`` its ``term_bound``) only
    where it was recorded."""
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
    aT_p, bp_p = CV.band_forward_plain(emit, flens, band, start, lb, ub, scale)
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
        "plain_ms": time_ms(lambda: CV.band_forward_plain(
            emit, flens, band, start, lb, ub, scale), 3, device),
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
    from montreal_forced_aligner_tpu_torch.ops import cuda_emission as CE
    from montreal_forced_aligner_tpu_torch.ops import cuda_viterbi as CV
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

    # K3, K1 and K2 on the last chunk against their plain versions
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
    out["last_chunk"] = {
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
    return out


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
    """One call of ``fn`` under ``torch.profiler``: its wall seconds and the
    union of the card's busy intervals (the device's busy share)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = time.perf_counter() - t0
    busy = busy_seconds(prof)
    return {"wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall}


def _loglikes(trainer):
    return [e["loglike_per_frame"] for e in trainer.iteration_log]


def train_mono_phase(corpus_dir, dict_path, audio_s, device, warm_runs=3,
                     batch_size=32, sm_clock_mhz=None):
    """``bench.py``'s train workload through ``TrainableAligner``: one
    counted cold run, ``warm_runs`` warm runs (throughput: audio seconds
    over their median wall), one synchronised run for the phase seconds and
    one profiled run for the busy share. K1 and K2 are recorded in the cold
    run and held against their plain versions on the equal alignment's
    first and last batch and on the first realignment's. Returns (report,
    those checks by alignment)."""
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
            None, device, sm_clock_mhz=sm_clock_mhz)
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


KERNELS = [
    ("band_forward", "montreal_forced_aligner_tpu_torch/csrc/band_viterbi.cu",
     "montreal_forced_aligner_tpu/ops/pallas_viterbi.py:151"),
    ("band_backtrace", "montreal_forced_aligner_tpu_torch/csrc/band_viterbi.cu",
     "montreal_forced_aligner_tpu/ops/pallas_viterbi.py:244"),
    ("state_emission", "montreal_forced_aligner_tpu_torch/csrc/state_emission.cu",
     "montreal_forced_aligner_tpu/ops/pallas_emission.py:147"),
]


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        print(line, flush=True)
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
        checks = {}
        for path in ("sat-si", "sat-2pass"):
            checks[path] = kernel_checks(inputs.pop(path), aligners[path].gmm,
                                         device, sm_clock_mhz=sm_clock_mhz)
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
        mono, mono_checks = train_mono_phase(corpus_dir, dict_path, audio_s, device,
                                             sm_clock_mhz=sm_clock_mhz)
        _emit({"main_path": mono})
        for label, cks in mono_checks.items():
            for name, c in cks.items():
                _emit({"kernel_check": name, "path": label, **c})
        recipe, captured = train_recipe_phase(corpus_dir, dict_path, tmp, device)
        _emit({"main_path": recipe})
        calls = captured["calls"]
        recipe_checks = kernel_checks(batch_inputs(calls, 0), captured["gmm"], device,
                                      sm_clock_mhz=sm_clock_mhz,
                                      k3_term_bound=True)
        for name, c in recipe_checks.items():
            _emit({"kernel_check": name, "path": "train-recipe (LDA stage)", **c,
                   "calls_in_that_realignment": calls[name].calls})
        del captured, calls
        _emit({"train_reference": train_reference_phase(tmp / "tone", device)})
        by_path = {"sat-2pass": reports["sat-2pass"]["launches"],
                   "train-mono": mono["launches"], "train-recipe": recipe["launches"]}
        _emit(kernels_line(checks["sat-2pass"], reports["sat-2pass"]["launches"],
                           by_path, {**mono_checks, "train_recipe": recipe_checks}))

    _emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
