"""Alignment jobs: each job is one corpus directory that
``PretrainedAligner.align_corpus`` aligns (the fMLLR two-pass of a SAT
model) and ``export_textgrids`` writes out, as ``mfa align`` does.

The check re-aligns a sample of speakers, drawn from the seed among those
the window aligned, with the plain reference (``reference/gmm_sat.py``)
and compares what the program returned and wrote for them."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from portbench.harness import Check, JobRecord, load_file
from portbench.inputs import corpus as corpus_gen
from portbench.reference import textgrid
from portbench.work import counts


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.model = load_file(ctx.bench_dir / "models" / f"{ctx.config['kind']}.py")
        self.kept = {}  # job index -> the job's last outputs

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from montreal_forced_aligner_tpu_torch.align.aligner import (
            AlignerConfig,
            PretrainedAligner,
        )

        ctx, cfg = self.ctx, self.ctx.config
        model_path, dict_path = self.model.build(cfg, ctx.cache_dir)
        words = [w for w, _ in self.model.draw_lexicon(cfg)]
        self.jobs = corpus_gen.make_jobs(ctx.traffic, words, ctx.seed,
                                         ctx.work_dir / "corpus", ctx.device)
        self.aligner = PretrainedAligner(
            model_path, dict_path,
            AlignerConfig(batch_size=ctx.traffic["batch_size"],
                          acoustic_scale=cfg["acoustic_scale"],
                          transition_scale=cfg["transition_scale"],
                          self_loop_scale=cfg["self_loop_scale"],
                          fmllr_min_count=cfg["fmllr_min_count"]),
            device=ctx.device)
        self.out_dir = ctx.work_dir / "textgrids"
        # a small job of its own once: kernels loaded, cuFFT and cuBLAS
        # plans, the transfer probe; the window's jobs stay unseen
        self._job(corpus_gen.make_warmup(ctx.traffic, words, ctx.seed, ctx.work_dir / "corpus",
                                         ctx.device), keep=False)

    def begin_trace(self) -> None:
        self.aligner.sync_phases = True

    # -- the window ---------------------------------------------------------
    def _job(self, job, keep=True):
        from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

        t0 = time.perf_counter_ns()
        corpus = Corpus.load(job.directory)
        results = self.aligner.align_corpus(corpus)
        t1 = time.perf_counter_ns()
        paths = self.aligner.export_textgrids(corpus, results, self.out_dir / job.directory.name)
        t2 = time.perf_counter_ns()
        failed = sum(1 for u in corpus.utterances
                     if u.id not in results or not results[u.id].words)
        out = None
        if keep:
            fm = self.aligner.last_fmllr
            out = {
                "utts": {Path(u.file_name).name: (u, results.get(u.id))
                         for u in corpus.utterances},
                "fmllr": fm,
                "speaker_index": dict(corpus.speaker_index),
                "textgrids": {p.stem: p for p in paths},
            }
        return corpus, results, out, failed, (t0, t1, t2)

    def run_job(self, i: int) -> JobRecord:
        job = self.jobs[i % len(self.jobs)]
        t_in = time.perf_counter_ns()
        job.prepare()
        t_ready = time.perf_counter_ns()
        corpus, results, out, failed, (t0, t1, t2) = self._job(job)
        self.kept[job.index] = out
        rec = JobRecord(i, job.audio_s, len(corpus.utterances), failed,
                        pauses=[(t_in, t_ready)])
        if self.ctx.trace:
            rec.trace = dict(self.aligner.last_phase_seconds)
            rec.trace["export_textgrids"] = (t2 - t1) / 1e9
            rec.spans = _phase_spans(self.aligner.last_phase_seconds, t0, t1)
            rec.spans.append(("export_textgrids", t1, t2))
            rec.spans.append(("job", t0, t2))
            rec.outputs = job.index
        return rec

    def release(self) -> None:
        import torch

        del self.aligner
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the traced run's numbers ----------------------------------------------
    def trace_summary(self, records, window) -> dict:
        phases = {}
        for r in records:
            for k, v in r.trace.items():
                phases[k] = phases.get(k, 0.0) + v
        cfg = self.ctx.config
        ref = load_file(self.ctx.bench_dir / "reference" / f"{cfg['kind']}.py")
        graphs = ref.GraphCounter(cfg)
        k1 = counts.Work()
        k3 = counts.Work()
        for r in records:
            for u in self.jobs[r.outputs].utterances:
                frames = counts.mfcc_frames(int(round(u.seconds * 16000)))
                states, arcs, pdfs = graphs.count(u.words)
                # two passes, each through K3 and K1
                k3 += counts.k3(frames, pdfs, cfg["gauss_per_pdf"], cfg["dim"]) * 2
                k1 += counts.k1(frames, states, arcs) * 2
        return {"audio_s": window["audio_s"],
                "phases": phases, "work": {"k1": k1.as_dict(), "k3": k3.as_dict()}}

    # -- the check ------------------------------------------------------------
    def judge(self, records, control: bool = False):
        """The compared numbers over a sample of the window's speakers; with
        ``control``, those of the reference computed in TF32 in the
        program's place."""
        import torch

        ctx, cfg = self.ctx, self.ctx.config
        ref = load_file(ctx.bench_dir / "reference" / f"{cfg['kind']}.py")
        m = ref.load_model(cfg, ctx.device)
        rng = np.random.default_rng([ctx.seed, 7])
        done = sorted(self.kept)
        pool = [(j, spk) for j in done
                for spk in sorted({u.speaker for u in self.jobs[j].utterances})]
        n = min(len(pool), ctx.traffic["judge_speakers"])
        picks = [pool[i] for i in sorted(rng.choice(len(pool), n, replace=False))]
        worst = dict.fromkeys(("score_error_per_frame", "score_gap_per_frame",
                               "fmllr_objective_gap", "fmllr_stats_error", "fmllr_solve_gap",
                               "words_wrong", "textgrids_wrong", "gap", "frames"), 0.0)
        for j, spk in picks:
            utts = [u for u in self.jobs[j].utterances if u.speaker == spk]
            waves = [corpus_gen.read_wave(u.path) for u in utts]
            texts = [u.words for u in utts]
            if control:
                answers, estimate = control_answers(ref, m, waves, texts)
            else:
                answers, estimate = self.port_answers(j, spk, utts)
            judge_speaker(ref, m, waves, texts, answers, estimate, worst)
        del m
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        gap, frames = worst.pop("gap"), worst.pop("frames")
        worst["score_gap_per_frame"] = gap / frames if frames else math.inf
        return [Check(k, float(v), float(ctx.limits[k])) for k, v in worst.items()]

    def port_answers(self, j: int, spk: str, utts):
        """What the program returned and wrote for a speaker's utterances,
        as :class:`Answer` s (None where it returned nothing), and the
        speaker's :class:`Estimate`."""
        got = self.kept[j]
        out = []
        for u in utts:
            aln = got["utts"].get(u.name, (None, None))[1]
            if aln is None or not aln.words:
                out.append(None)
                continue
            tg = got["textgrids"].get(u.name)
            out.append(Answer(aln.log_likelihood, port_segments(aln),
                              [w.label for w in aln.words],
                              tg is not None and textgrid.matches(tg, aln)))
        fm = got["fmllr"]
        if fm is None:
            return out, None
        i = got["speaker_index"][spk]
        return out, Estimate(fm.transforms[i], (fm.K[i], fm.G[i], float(fm.beta[i])))


@dataclass
class Answer:
    """One utterance's answer as the check reads it."""

    score: float
    segments: list  # [(key, first frame, end frame)]
    words: list
    textgrid_ok: bool = True


@dataclass
class Estimate:
    """A speaker's fMLLR estimate as the check reads it: the transform
    (D, D+1) and the statistics (K, G, beta) it was solved from."""

    transform: np.ndarray
    stats: tuple


def control_answers(ref, m, waves, texts):
    """The control's answers: the reference computed in TF32."""
    got = ref.align_speaker(m, waves, texts, precision="tf32")
    return ([Answer(r.score, r.segments, r.words) for r in got.utts],
            Estimate(got.transform, got.stats))


def stats_error(mine, theirs) -> float:
    """The largest relative gap of the statistics (K, G, beta): each part's
    Frobenius norm of the difference over the reference's norm."""
    return max(float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))
               for a, b in zip(mine, theirs))


def judge_speaker(ref, m, waves, texts, answers, estimate, worst) -> None:
    """Holds one speaker's answers against the reference.

    The fMLLR estimate, stage by stage: the statistics against the
    reference's own (from its speaker-independent pass), the transform by
    the reference's auxiliary function on the reference's statistics
    against the reference's own transform (one-sided: a better transform
    reads 0), and the solve by the auxiliary function on the answer's own
    statistics, the answer's transform against the reference's solve of
    them. The transform itself is weakly determined on this model (equally
    good transforms differ by 0.1-0.2 an entry), so it is judged by what
    it scores, not entry by entry, and the reference follows the answer's
    transform into the adapted pass: with the speaker's features adapted
    by it, each score against the best, and the best path through each
    answer's segmentation against the best; the words and the TextGrids.
    The worst of each gap, and the sums of the segmentations' gaps and of
    the frames (the mean gap a frame over the sample), go into
    ``worst``."""
    if any(a is None for a in answers) or estimate is None:
        worst["words_wrong"] = math.inf
        return
    got = ref.align_speaker(m, waves, texts, constrain=[a.segments for a in answers],
                            transform=estimate.transform)
    K, G, beta = got.stats
    Km, Gm, bm = estimate.stats
    gaps = {"fmllr_stats_error": stats_error(estimate.stats, got.stats)}
    if beta > 0:
        best = ref.fmllr_objective(got.transform, K, G, beta)
        gaps["fmllr_objective_gap"] = (
            best - ref.fmllr_objective(estimate.transform, K, G, beta)) / beta
    if bm >= m.cfg["fmllr_min_count"]:
        solved = ref.fmllr_solve(Km, Gm, bm, m.cfg["fmllr_iterations"])
        gaps["fmllr_solve_gap"] = (ref.fmllr_objective(solved, Km, Gm, bm)
                                   - ref.fmllr_objective(estimate.transform, Km, Gm, bm)) / bm
    for k, v in gaps.items():
        worst[k] = max(worst[k], v if math.isfinite(v) else math.inf)
    for t, a, r, c in zip(texts, answers, got.utts, got.constrained):
        worst["score_error_per_frame"] = max(worst["score_error_per_frame"],
                                             abs(a.score - r.score) / r.frames)
        worst["gap"] += r.score - c
        worst["frames"] += r.frames
        worst["words_wrong"] += a.words != list(t)
        worst["textgrids_wrong"] += not a.textgrid_ok


def port_segments(aln, frame_s: float = 0.01):
    """An alignment's phones as [(key, first frame, end frame)], keyed as
    the reference's graph keys its instances: (word, position in the
    word), or (-1, 0) for silence before the first word and (-2 - w, 0)
    after word w."""
    member = {}
    for wi, w in enumerate(aln.words):
        for k, p in enumerate(w.phones):
            member[id(p)] = (wi, k)
    out, last_word = [], -1
    for p in aln.phones:
        key = member.get(id(p))
        if key is None:
            key = (-1, 0) if last_word < 0 else (-2 - last_word, 0)
        else:
            last_word = key[0]
        out.append((key, int(round(p.begin / frame_s)), int(round(p.end / frame_s))))
    return out


def _phase_spans(phases: dict, t0: int, t1: int):
    """The job's phases as host spans: ``last_phase_seconds`` runs in
    order from the start of ``align_corpus``."""
    spans, cur = [], t0
    for name, s in phases.items():
        end = cur + int(s * 1e9)
        spans.append((name, cur, min(end, t1)))
        cur = end
    return spans
