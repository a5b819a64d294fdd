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
10. prints one ``{"kernels": [...]}`` line (sat-2pass's launches and
    second-pass checks), then as the last line
    ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
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
    _check(events, "the profiler saw no work on the card")
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us = 0.0
    cur_start, cur_end = spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy_us += cur_end - cur_start
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
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
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


def kernel_checks(captured, gmm, device, reps=5, sm_clock_mhz=None):
    """Each kernel against its plain version on one batch's recorded
    inputs (:func:`batch_inputs`), with times and bounds; K2 also on the
    last batch's, with the chain floor at ``sm_clock_mhz`` (none without
    it)."""
    import torch

    from montreal_forced_aligner_tpu_torch.ops import cuda_emission as CE
    from montreal_forced_aligner_tpu_torch.ops import cuda_viterbi as CV
    from montreal_forced_aligner_tpu_torch.ops.gmm_loglikes import (
        gmm_loglikes,
        select_state_emissions,
    )

    out = {}

    # K3: state emissions
    (feats, state_pdf, rows, rows_split), _ = captured["state_emission"]
    B, T, Df = feats.shape
    S = state_pdf.shape[1]
    P, G, d2p = rows.shape
    got = CE.state_loglikes(feats, state_pdf, rows, rows_split)
    want = CE.state_loglikes_plain(feats, state_pdf, rows)
    err = (got - want).abs()
    _check(bool(torch.isfinite(got).all()), "K3: non-finite emissions")
    bar = 1e-3 + 1e-5 * want.abs()
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
    out["state_emission"] = {
        "shape": {"B": B, "T": T, "S": S, "P": P, "G": G, "D": Df},
        "max_abs_err": err.max().item(),
        "worst_err_share_of_bar": worst_share,
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
    return (busy + cur_end - cur_start) / 1e3


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


KERNELS = [
    ("band_forward", "montreal_forced_aligner_tpu_torch/csrc/band_viterbi.cu",
     "montreal_forced_aligner_tpu/ops/pallas_viterbi.py:151"),
    ("band_backtrace", "montreal_forced_aligner_tpu_torch/csrc/band_viterbi.cu",
     "montreal_forced_aligner_tpu/ops/pallas_viterbi.py:244"),
    ("state_emission", "montreal_forced_aligner_tpu_torch/csrc/state_emission.cu",
     "montreal_forced_aligner_tpu/ops/pallas_emission.py:147"),
]


def kernels_line(checks, launches):
    rows = []
    for name, source, replaces in KERNELS:
        c = checks[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        })
    return {"kernels": rows}


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / PKG / "__init__.py").is_file():
        print(f"chip_smoke: the {PKG} package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
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
        _emit(kernels_line(checks["sat-2pass"], reports["sat-2pass"]["launches"]))

    _emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
