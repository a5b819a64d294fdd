"""wav2vec 2.0 CTC transcription jobs: each job is one corpus directory
that ``SpeechbrainTranscriber.transcribe_corpus`` transcribes with a
``Wav2Vec2ForCTC`` checkpoint, as ``mfa transcribe_speechbrain`` with a
wav2vec2 CTC model does, one utterance at a time.

The check reads, for a sample of the window's utterances drawn from the
seed (the longest among them), the plain reference (``reference/wav2vec2.py``)
over each utterance's audio, and holds against it the program's projected
features (``frontend_error``), every frame's log-probabilities
(``logprob_error``) and the reference's log-probability at the program's
argmax (``ctc_gap``, the reference's best less it, a frame); and the text
the program returned against the greedy CTC text of its own argmax
(``texts_wrong``)."""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import Check, JobRecord, load_file
from portbench.inputs import corpus as corpus_gen
from portbench.work import wav2vec2 as work


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.model = load_file(ctx.bench_dir / "models" / f"{ctx.config['kind']}.py")
        # utterance path -> (Utterance, text, frontend, log-probs, ids)
        self.kept = {}
        self.stash = {"extract": [], "log_probs": [], "ids": []}

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        # a program without the model stops here, before any file is written
        from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
            SpeechbrainTranscriber,
        )
        from montreal_forced_aligner_tpu_torch.transcription.wav2vec2 import ctc

        ctx = self.ctx
        self.checkpoint = self.model.build(ctx.config, ctx.cache_dir, ctx.device)
        words = [f"w{i:05d}" for i in range(ctx.traffic["vocabulary"])]
        self.jobs = corpus_gen.make_jobs(ctx.traffic, words, ctx.seed,
                                         ctx.work_dir / "corpus", ctx.device)
        self.tr = SpeechbrainTranscriber(self.checkpoint, device=ctx.device)
        if not self.tr.ctc:
            raise RuntimeError(f"{self.checkpoint} did not load as a CTC checkpoint")
        self.ctc = ctc
        self._greedy_ids = ctc.greedy_ids
        self._record("extract", self.tr.model)
        self._record("log_probs", self.tr.model)
        self._record("ids", ctc, attr="greedy_ids")
        # the warm-up speaker's utterances through the whole path once
        warm = corpus_gen.make_warmup(ctx.traffic, words, ctx.seed, ctx.work_dir / "corpus",
                                      ctx.device)
        self._transcribe(warm.directory)
        self._clear()

    def _record(self, name: str, owner, attr=None) -> None:
        """Keep what ``owner.<attr>`` returns (no copy, no wait)."""
        attr = attr or name
        fn = getattr(owner, attr)

        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            self.stash[name].append(out)
            return out

        setattr(owner, attr, wrapper)

    def _clear(self) -> None:
        for v in self.stash.values():
            v.clear()

    def _transcribe(self, directory):
        from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

        corpus = Corpus.load(directory)
        return corpus, self.tr.transcribe_corpus(corpus)

    def begin_trace(self) -> None:
        """Synchronised timers and host spans around the feature encoder
        ("feature encoder": normalisation, convolutions, projection) and the
        encoder ("encode": positional convolution, blocks, final LayerNorm),
        so each call's device work falls inside its span."""
        import torch

        self.timers = {"feature_encoder_s": 0.0, "encoder_s": 0.0}
        self.spans = []
        dev = self.ctx.device

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def timed(fn, key, span):
            def wrapper(*a, **kw):
                sync()
                t0 = time.perf_counter_ns()
                out = fn(*a, **kw)
                sync()
                t1 = time.perf_counter_ns()
                self.timers[key] += (t1 - t0) / 1e9
                self.spans.append((span, t0, t1))
                return out
            return wrapper

        model = self.tr.model
        model.extract = timed(model.extract, "feature_encoder_s", "feature encoder")
        model.encode = timed(model.encode, "encoder_s", "encode")

    # -- the window ---------------------------------------------------------
    def run_job(self, i: int) -> JobRecord:
        job = self.jobs[i % len(self.jobs)]
        t_in = time.perf_counter_ns()
        job.prepare()
        t0 = time.perf_counter_ns()
        corpus, texts = self._transcribe(job.directory)
        t1 = time.perf_counter_ns()
        failed = sum(1 for u in corpus.utterances if u.id not in texts)
        by_name = {u.name: u for u in job.utterances}
        for k, utt in enumerate(corpus.utterances):
            mine = by_name[utt.file_path.stem]
            self.kept[str(mine.path)] = (mine, texts.get(utt.id), self.stash["extract"][k],
                                         self.stash["log_probs"][k], self.stash["ids"][k])
        self._clear()
        audio = sum(u.seconds for u in job.utterances)
        rec = JobRecord(i, audio, len(corpus.utterances), failed, pauses=[(t_in, t0)])
        rec.spans.append(("transcribe_corpus", t0, t1))
        if self.ctx.trace:
            rec.spans += self.spans
            self.spans = []
        rec.outputs = [str(u.path) for u in job.utterances]
        return rec

    def release(self) -> None:
        import torch

        self.ctc.greedy_ids = self._greedy_ids
        del self.tr
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the traced run's numbers ----------------------------------------------
    def trace_summary(self, records, window) -> dict:
        cfg, sr = self.ctx.config, self.ctx.traffic["sample_rate"]
        fe, enc, head = work.Work(), work.Work(), work.Work()
        utts = frames = 0
        for r in records:
            for path in r.outputs:
                samples = int(round(self.kept[path][0].seconds * sr))
                t = work.frames(cfg, samples)
                fe += work.feature_encoder(cfg, samples)
                enc += work.encoder(cfg, t)
                head += work.ctc_head(cfg, t)
                utts += 1
                frames += t
        return {"audio_s": window["audio_s"], "timers": dict(self.timers),
                "counts": {"utterances": utts, "frames": frames},
                "work": {"feature_encoder": fe.as_dict(), "encoder": enc.as_dict(),
                         "ctc_head": head.as_dict()}}

    # -- the check ------------------------------------------------------------
    def judge(self, records, control: bool = False):
        """The compared numbers over a sample of the window's utterances;
        with ``control``, those of the reference computed in TF32 in the
        program's place (its projected features, log-probabilities, argmax
        and text)."""
        import torch

        ctx = self.ctx
        ref = load_file(ctx.bench_dir / "reference" / f"{ctx.config['kind']}.py")
        m = ref.Model(self.checkpoint, ctx.device)
        paths = sorted(self.kept)
        longest = max(paths, key=lambda p: self.kept[p][0].seconds)
        rest = [p for p in paths if p != longest]
        rng = np.random.default_rng([ctx.seed, 11])
        n = min(len(rest), ctx.traffic["judge_utterances"] - 1)
        picks = [longest] + [rest[i] for i in sorted(rng.choice(len(rest), n, replace=False))]
        worst = {"frontend_error": 0.0, "logprob_error": 0.0, "ctc_gap": 0.0, "texts_wrong": 0}
        for path in picks:
            utt, text, frontend, log_probs, ids = self.kept[path]
            samples = corpus_gen.read_wave(utt.path).astype(np.float32)
            want = m(samples)
            if control:
                got = m(samples, tf32=True)
                frontend, log_probs = got["frontend"][None], got["log_probs"]
                ids = log_probs.argmax(-1)
                text = m.text(ids.tolist())
            worst["frontend_error"] = max(worst["frontend_error"], float(
                (frontend[0] - want["frontend"]).abs().max()))
            worst["logprob_error"] = max(worst["logprob_error"], float(
                (log_probs - want["log_probs"]).abs().max()))
            best = want["log_probs"].max(-1).values
            at = want["log_probs"].gather(1, ids.long()[:, None])[:, 0]
            worst["ctc_gap"] = max(worst["ctc_gap"], float((best - at).max()))
            worst["texts_wrong"] += int(text != m.text(ids.tolist()))
        del m
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return [Check(k, float(v), float(ctx.limits[k])) for k, v in worst.items()]
