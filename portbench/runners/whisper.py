"""Whisper transcription jobs: each job is one corpus directory that
``WhisperTranscriber.transcribe_corpus`` transcribes under the checkpoint's
own generation config, as ``mfa transcribe`` with a Whisper model does.

The check reads, for a sample of the window's utterances drawn from the
seed (the longest among them), the plain reference (``reference/whisper.py``)
over each utterance's audio with the tokens the program served, and holds
the program's log-mel, encoding and served tokens against it."""

from __future__ import annotations

import time

import numpy as np

from portbench.harness import Check, JobRecord, load_file
from portbench.inputs import corpus as corpus_gen
from portbench.work import counts

WINDOW_S = 30.0  # the audio one decoding window reads


class Runner:
    def __init__(self, ctx):
        self.ctx = ctx
        self.model = load_file(ctx.bench_dir / "models" / f"{ctx.config['kind']}.py")
        # utterance path -> (Utterance, Decoded, log-mel, [encoding], [tokens])
        # of each window
        self.kept = {}
        self.stash = {"features": [], "encode": [], "decode": [], "window": []}

    # -- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
            WhisperTranscriber,
        )

        ctx = self.ctx
        self.checkpoint = self.model.build(ctx.config, ctx.cache_dir, ctx.device)
        words = [f"w{i:05d}" for i in range(ctx.traffic["vocabulary"])]
        self.jobs = corpus_gen.make_jobs(ctx.traffic, words, ctx.seed,
                                         ctx.work_dir / "corpus", ctx.device)
        self.tr = WhisperTranscriber(self.checkpoint, device=ctx.device)
        self._record("features", self.tr)
        self._record("decode", self.tr)
        self._record("encode", self.tr.model)
        from montreal_forced_aligner_tpu_torch.transcription.whisper import generate

        self._greedy = generate._greedy_window
        self._record_window(generate)
        # one utterance of its own once: cuBLAS and cuFFT plans, every
        # decoder length
        warm = corpus_gen.make_warmup(ctx.traffic, words, ctx.seed, ctx.work_dir / "corpus",
                                      ctx.device)
        self.tr.transcribe(corpus_gen.read_wave(warm.utterances[0].path))
        self._clear()

    def _record(self, name: str, owner, key=None, attr=None) -> None:
        """Keep what ``owner.<attr>`` returns (no copy, no wait)."""
        attr = attr or name
        fn = getattr(owner, attr)

        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            self.stash[key or name].append(out)
            return out

        setattr(owner, attr, wrapper)

    def _record_window(self, generate) -> None:
        """Keep each greedy window's served tokens."""
        self._record("window", generate, attr="_greedy_window")

    def _clear(self) -> None:
        for v in self.stash.values():
            v.clear()

    def begin_trace(self) -> None:
        """Synchronised timers and host spans around the encoder call
        ("encode") and each window's greedy loop ("greedy loop": decoder
        steps and logits processors), so each call's device work falls
        inside its span."""
        import torch

        from montreal_forced_aligner_tpu_torch.transcription.whisper import generate

        self.timers = {"encoder_s": 0.0, "decoder_s": 0.0}
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

        self.tr.model.encode = timed(self.tr.model.encode, "encoder_s", "encode")
        generate._greedy_window = timed(self._greedy, "decoder_s", "greedy loop")
        self._record_window(generate)

    # -- the window ---------------------------------------------------------
    def run_job(self, i: int) -> JobRecord:
        from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

        job = self.jobs[i % len(self.jobs)]
        t_in = time.perf_counter_ns()
        job.prepare()
        t0 = time.perf_counter_ns()
        corpus = Corpus.load(job.directory)
        texts = self.tr.transcribe_corpus(corpus)
        t1 = time.perf_counter_ns()
        failed = sum(1 for u in corpus.utterances if not texts.get(u.id))
        by_name = {u.name: u for u in job.utterances}
        encs, wins = iter(self.stash["encode"]), iter(self.stash["window"])
        for k, utt in enumerate(corpus.utterances):
            mine = by_name[utt.file_path.stem]
            decoded = self.stash["decode"][k]
            n = decoded.windows
            self.kept[str(mine.path)] = (
                mine, decoded, self.stash["features"][k],
                [next(encs) for _ in range(n)], [next(wins) for _ in range(n)])
        self._clear()
        audio = sum(min(u.seconds, WINDOW_S) for u in job.utterances)
        rec = JobRecord(i, audio, len(corpus.utterances), failed, pauses=[(t_in, t0)])
        rec.spans.append(("transcribe_corpus", t0, t1))
        if self.ctx.trace:
            rec.spans += self.spans
            self.spans = []
        rec.outputs = [str(u.path) for u in job.utterances]
        return rec

    def release(self) -> None:
        import torch

        from montreal_forced_aligner_tpu_torch.transcription.whisper import generate

        generate._greedy_window = self._greedy
        del self.tr
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the traced run's numbers ----------------------------------------------
    def trace_summary(self, records, window) -> dict:
        cfg = self.ctx.config
        d, vocab, pos = cfg["d_model"], cfg["vocab_size"], cfg["max_source_positions"]
        enc = counts.Work()
        cross = counts.Work()
        dec = counts.Work()
        steps = utts = 0
        for r in records:
            for path in r.outputs:
                decoded, windows = self.kept[path][1], self.kept[path][4]
                p = len(decoded.prompt)
                step = counts.whisper_decoder_step
                args = (d, cfg["decoder_layers"], cfg["decoder_ffn_dim"], vocab, pos)
                # language detection once an utterance
                cross += step(*args, past=0, tokens=1)
                for tokens in windows:
                    n = len(tokens)
                    utts += 1
                    steps += n
                    enc += counts.whisper_encoder(d, cfg["encoder_layers"],
                                                  cfg["encoder_ffn_dim"], cfg["num_mel_bins"], pos)
                    cross += counts.whisper_cross_kv(d, cfg["decoder_layers"], pos)
                    # the prompt, then one token a step
                    dec += step(*args, past=0, tokens=p)
                    for j in range(1, n):
                        dec += step(*args, past=p + j - 1, tokens=1)
        return {"audio_s": window["audio_s"], "timers": dict(self.timers),
                "counts": {"encoder_calls": utts, "decoder_steps": steps, "windows": utts},
                "work": {"encoder": enc.as_dict(), "cross_kv": cross.as_dict(),
                         "decoder": dec.as_dict()}}

    # -- the check ------------------------------------------------------------
    def judge(self, records, control: bool = False):
        """The compared numbers over a sample of the window's utterances;
        with ``control``, those of the reference computed in TF32 in the
        program's place (its log-mel, encodings and first tokens)."""
        import torch

        ctx = self.ctx
        ref = load_file(ctx.bench_dir / "reference" / f"{ctx.config['kind']}.py")
        m = ref.Model(ctx.config, self.checkpoint, ctx.device)
        paths = sorted(self.kept)
        longest = max(paths, key=lambda p: self.kept[p][0].seconds)
        rest = [p for p in paths if p != longest]
        rng = np.random.default_rng([ctx.seed, 11])
        n = min(len(rest), ctx.traffic["judge_utterances"] - 1)
        picks = [longest] + [rest[i] for i in sorted(rng.choice(len(rest), n, replace=False))]
        worst = {"logmel_error": 0.0, "encoder_error": 0.0, "token_gap": 0.0}
        for path in picks:
            utt, decoded, mel, encodings, windows = self.kept[path]
            got = ref.gaps(m, corpus_gen.read_wave(utt.path), decoded.prompt, windows, control)
            if control:
                mel, encodings = got["control_mel"][None], [e[None] for e in got["control_encoders"]]
            worst["logmel_error"] = max(worst["logmel_error"],
                                        float((mel[0] - got["mel"]).abs().max()))
            for mine, theirs in zip(encodings, got["encoders"]):
                worst["encoder_error"] = max(worst["encoder_error"],
                                             float((mine[0] - theirs).abs().max()))
            worst["token_gap"] = max(worst["token_gap"], got["token_gap"])
        del m
        if ctx.device.type == "cuda":
            torch.cuda.empty_cache()
        return [Check(k, float(v), float(ctx.limits[k])) for k, v in worst.items()]
