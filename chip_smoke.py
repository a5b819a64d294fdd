#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

What it does, in order; any failure exits non-zero with no result line:

1. prints the card's name and power limit as ``nvidia-smi`` gives them;
2. builds the port's CUDA kernels from ``montreal_forced_aligner_tpu_torch/
   csrc`` (one ``nvcc`` per source, all started together);
3. builds, with the port's own modules, a synthetic acoustic model at SAT
   scale (random weights from a seed: 40 phones, about 5k pdfs, 32
   Gaussians per pdf, a 40-dim LDA over +-3 spliced 13-dim MFCCs, and a
   speaker-independent alignment model) and a corpus of 64 utterances of
   2-30 s over 8 speakers;
4. aligns the corpus once through ``PretrainedAligner.align_corpus`` in
   speaker-independent mode (batch 32) with every launch count set to 0
   just before, exports TextGrids, and requires every kernel to have been
   launched and every utterance to have an alignment; five warm runs give
   the steady throughput (their median), one with the card synchronised at
   each phase the phase breakdown, and one more under ``torch.profiler``
   the card's busy share and its time by kernel;
5. aligns 4 short utterances on the card and on the CPU (the plain PyTorch
   versions) and holds the two to the JAX package's parity bar;
6. holds each kernel against its plain version on the first batch's real
   inputs (K1 backpointers and K2 states bit-identical, K1 alpha within
   1e-4, K3 within rtol 1e-5 / atol 1e-3) and times both, and for K3 the
   all-pdf emission path on the same batch;
7. prints one ``{"kernels": [...]}`` line, then as the last line
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

# NVIDIA H100 SXM data sheet: HBM rate and float32 rate outside the tensor
# cores (dense), at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


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
                 seed=0, name="corpus", sr=16000):
    """Utterances of min_s-max_s seconds over 8 speakers: noise plus three
    tones each, and 2.5 random words per second. Returns (dir, seconds)."""
    from montreal_forced_aligner_tpu_torch.io.wav import write_wave

    rng = np.random.RandomState(seed)
    corp = tmp / name
    words = sorted(words)
    total = 0.0
    for u in range(num_utts):
        d = corp / f"spk{u % 8}"
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


def time_ms(fn, reps: int, device) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after one warm-up:
    CUDA events on the card, the host clock elsewhere."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over the float32 rate; and which of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class FirstCall:
    """Records the arguments of the first call of a module-level function
    (the first batch's real inputs), calling through unchanged."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.args = None

    def __call__(self, *args, **kwargs):
        if self.args is None:
            self.args = (args, kwargs)
        return self.orig(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


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


# -- phases ------------------------------------------------------------------


def run_main_path(model_path, dict_path, corpus_dir, out_dir, device,
                  batch_size=32, warm_runs=5):
    """Phase 4: one counted run of the main path, then ``warm_runs`` warm
    runs (their median gives the throughput), then one with the card
    synchronised at each phase. Returns (report, aligner, captured calls)."""
    import torch

    import montreal_forced_aligner_tpu_torch.align.aligner as aligner_mod
    import montreal_forced_aligner_tpu_torch.ops.viterbi as viterbi_mod
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    aligner = aligner_mod.PretrainedAligner(
        model_path, dict_path,
        aligner_mod.AlignerConfig(batch_size=batch_size,
                                  uses_speaker_adaptation=False),
        device=device,
    )
    setup_s = time.perf_counter() - t0
    corpus = Corpus.load(corpus_dir)
    audio_s = sum(
        len(w) / aligner.mfcc_config.sample_rate
        for w in corpus.load_audio_parallel(aligner.mfcc_config.sample_rate)
    )
    with FirstCall(aligner_mod, "state_loglikes") as k3, \
            FirstCall(viterbi_mod, "band_forward") as k1, \
            FirstCall(viterbi_mod, "band_backtrace") as k2:
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
    if device.type == "cuda":
        for name, n in launches.items():
            _check(n > 0, f"kernel {name} was not launched on the main path")

    # warm: CUDA context, cuFFT plans, kernel libraries and the graph
    # compiler's caches are in place from the first run
    warm_walls = []
    for _ in range(warm_runs):
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
        "utterances": corpus.num_utterances,
        "audio_s": audio_s,
        "setup_s": setup_s,
        "wall_s": wall,
        "audio_s_per_s": audio_s / wall,
        "launches": launches,
        "phases_dispatch_s": phases,
        "warm_walls_s": warm_walls,
        "warm_median_wall_s": warm_wall,
        "warm_audio_s_per_s": audio_s / warm_wall,
        "synced_wall_s": synced_wall,
        "phases_synced_s": synced,
        "textgrids": len(paths),
    }
    return report, aligner, {"state_emission": k3.args,
                             "band_forward": k1.args,
                             "band_backtrace": k2.args}


def profile_warm_run(aligner, corpus_dir, top=8):
    """One more warm run under ``torch.profiler``: the union of the card's
    busy intervals against the wall time (the device's busy share), and
    the card's time by kernel name."""
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
    for e in events:
        name = e.name.split("(")[0][:60]
        by_name[name] = by_name.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_ms_by_kernel": dict(ranked),
    }


def reference_check(model_path, dict_path, corpus_dir, device):
    """Phase 5: the card's alignment of a small corpus against the plain
    PyTorch path on the CPU."""
    import torch

    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    cfg = AlignerConfig(batch_size=4, uses_speaker_adaptation=False)
    got = PretrainedAligner(model_path, dict_path, cfg, device=device)
    want = PretrainedAligner(model_path, dict_path, cfg,
                             device=torch.device("cpu"))
    r_got = got.align_corpus(Corpus.load(corpus_dir))
    r_want = want.align_corpus(Corpus.load(corpus_dir))
    return parity(r_got, r_want, got.frame_shift)


def kernel_checks(captured, gmm, device, reps=5):
    """Phase 6: each kernel against its plain version on the first batch's
    inputs, with times and bounds."""
    import torch

    from montreal_forced_aligner_tpu_torch.ops import cuda_emission as CE
    from montreal_forced_aligner_tpu_torch.ops import cuda_viterbi as CV
    from montreal_forced_aligner_tpu_torch.ops.gmm_loglikes import (
        gmm_loglikes,
        select_state_emissions,
    )

    out = {}

    # K3: state emissions
    (feats, state_pdf, rows), _ = captured["state_emission"]
    B, T, Df = feats.shape
    S = state_pdf.shape[1]
    P, G, d2p = rows.shape
    got = CE.state_loglikes(feats, state_pdf, rows)
    want = CE.state_loglikes_plain(feats, state_pdf, rows)
    err = (got - want).abs()
    _check(bool(torch.isfinite(got).all()), "K3: non-finite emissions")
    ok = bool((err <= 1e-3 + 1e-5 * want.abs()).all())
    _check(ok, f"K3 disagrees with its plain version: max abs {err.max().item()}")

    def library():
        # the all-pdf product and a gather, in row chunks that fit memory
        for b in range(B):
            ll = gmm_loglikes(feats[b : b + 1], gmm.W, gmm.gconsts)
            select_state_emissions(ll, state_pdf[b : b + 1])

    n_pdfs_used = int(torch.unique(state_pdf).numel())
    nbytes = (feats.numel() * 4 + state_pdf.numel() * 4
              + n_pdfs_used * G * d2p * 4 + B * T * S * 4)
    flops = 2.0 * B * T * S * G * (2 * Df + 2)
    bnd, by = bound_ms(nbytes, flops)
    out["state_emission"] = {
        "shape": {"B": B, "T": T, "S": S, "P": P, "G": G, "D": Df},
        "max_abs_err": err.max().item(),
        "ms": time_ms(lambda: CE.state_loglikes(feats, state_pdf, rows), reps, device),
        "plain_ms": time_ms(lambda: CE.state_loglikes_plain(feats, state_pdf, rows),
                            3, device),
        "bound_ms": bnd,
        "bound_by": by,
        "library_ms": time_ms(library, 3, device),
    }
    del got, want, err

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
    steps = int(torch.clamp(flens.long() - 1, min=0).sum().item())
    frames = int(flens.long().sum().item())
    nbytes = (frames * S * 4 + B * S * D * 4 + B * S * 4 + B * 4
              + B * S * 4 + steps * S)
    flops = float(steps) * S * (2 * D + 2)
    bnd, by = bound_ms(nbytes, flops)
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

    # K2: band backtrace, on the main path's own backpointers
    (bp, flens2, best, lb2), _ = captured["band_backtrace"]
    st_k = CV.band_backtrace(bp, flens2, best, lb2)
    st_p = CV.band_backtrace_plain(bp, flens2, best, lb2)
    _check(torch.equal(st_k, st_p), "K2 states differ from the plain version")
    T2, B2, _S2 = bp.shape
    steps = int(torch.clamp(flens2.long() - 1, min=0).sum().item())
    nbytes = steps * 1 + B2 * 4 * 2 + B2 * T2 * 4
    bnd, by = bound_ms(nbytes, 0.0)
    out["band_backtrace"] = {
        "shape": {"B": B2, "T": T2},
        "max_abs_err": float((st_k - st_p).abs().max().item()),
        "ms": time_ms(lambda: CV.band_backtrace(bp, flens2, best, lb2), reps, device),
        "plain_ms": time_ms(lambda: CV.band_backtrace_plain(bp, flens2, best, lb2),
                            3, device),
        "bound_ms": bnd,
        "bound_by": by,
        "library_ms": None,
    }
    return out


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
        _emit({"fixture_s": time.perf_counter() - t0})

        report, aligner, captured = run_main_path(
            model_path, dict_path, corpus_dir, tmp / "textgrids", device
        )
        _emit({"main_path": report})
        _emit({"profiled_warm_run": profile_warm_run(aligner, corpus_dir)})
        _emit({"reference_check": reference_check(
            model_path, dict_path, small_dir, device)})
        checks = kernel_checks(captured, aligner.gmm, device)
        for name, c in checks.items():
            _emit({"kernel_check": name, **c})
        _emit(kernels_line(checks, report["launches"]))

    _emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
