"""The port's spans and counters (``montreal_forced_aligner_tpu_torch/tracing.py``)
on the CPU: nothing recorded and no ``record_function`` opened while
recording is off; under a CPU ``torch.profiler`` the spans among the
profiler's events, nested as recorded, with self times; the one phase
clock; the aligner's phases, the graph compiler's template counters and
Whisper's per-token spans on tiny inputs; the Chrome traces that
``--profile_dir`` writes."""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from montreal_forced_aligner_tpu_torch import tracing
from montreal_forced_aligner_tpu_torch.align.aligner import AlignerConfig, PretrainedAligner
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
from montreal_forced_aligner_tpu_torch.io.wav import write_wave
from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
    SpeechbrainTranscriber,
    WhisperTranscriber,
)
from montreal_forced_aligner_tpu_torch.transcription.whisper.generate import generate

from helpers import (
    build_sat_scale_model,
    build_synthetic_corpus,
    build_synthetic_model,
    build_tiny_wav2vec2_checkpoint,
    build_tiny_whisper_checkpoint,
)

ALIGN_PHASES = ["transfer_mode", "audio_load", "phase_a_dispatch", "graph_compile",
                "graph_ship_and_final_feats"]
FMLLR_PHASES = ["fmllr_pass1", "fmllr_stats_fetch", "fmllr_solve", "fmllr_apply"]
LAST_PHASES = ["emit_and_align_dispatch", "path_fetch", "ctm"]


@pytest.fixture(autouse=True)
def clean_recording():
    tracing.reset()
    yield
    tracing.reset()


def _closed(rec, name):
    return [s for s in rec["spans"] if s.name == name and s.t1_ns is not None]


def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function opened while recording is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.recording()
    assert tracing.span("a") is tracing.span("b")  # the shared no-op
    with tracing.span("a"):
        tracing.count("c", 3)
    clock = tracing.PhaseClock(torch.device("cpu"))
    with clock("phase"):
        pass
    assert clock.seconds["phase"] >= 0.0
    assert tracing.recorded() == {"spans": [], "counters": {}, "self_ns": {}}


def test_collect_records_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function opened without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tracing.collect():
        with tracing.span("outer"):
            tracing.count("n")
            tracing.count("n", 2)
    assert not tracing.recording()
    rec = tracing.recorded()
    assert [s.name for s in rec["spans"]] == ["outer"]
    assert rec["counters"] == {"n": 3}


def test_spans_appear_in_the_profiler_nested_as_recorded():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                torch.ones(64).sum()
            with tracing.span("inner"):
                with tracing.span("leaf"):
                    torch.ones(64).sum()
        tracing.count("things", 2)
    rec = tracing.recorded()
    spans = rec["spans"]
    assert [s.name for s in spans] == ["outer", "inner", "inner", "leaf"]
    assert [s.parent for s in spans] == [None, 0, 0, 2]
    assert len({s.request for s in spans}) == 1
    assert rec["counters"] == {"things": 2}
    took = {i: s.t1_ns - s.t0_ns for i, s in enumerate(spans)}
    assert rec["self_ns"]["outer"] == took[0] - took[1] - took[2]
    assert rec["self_ns"]["inner"] == took[1] + took[2] - took[3]
    assert rec["self_ns"]["leaf"] == took[3]
    events = {}
    for e in prof.events():
        events.setdefault(e.name, []).append(e)
    assert len(events["outer"]) == 1 and len(events["inner"]) == 2
    assert len(events["leaf"]) == 1
    assert all(e.cpu_parent.name == "outer" for e in events["inner"])
    assert events["leaf"][0].cpu_parent.name == "inner"
    # each top-level span starts a request of its own
    with tracing.collect():
        with tracing.span("next"):
            pass
    assert tracing.recorded()["spans"][-1].request != spans[0].request


@pytest.mark.parametrize("card_timeline", [False, True])
def test_spans_are_host_ranges_unless_on_the_card_timeline(card_timeline, tmp_path):
    """Under a profiler a span is a host-side range (``cpu_op``), which
    adds no device event; inside ``on_card_timeline`` (``--profile_dir``) a
    user annotation, which the profiler also lays over its kernels."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.on_card_timeline() if card_timeline else contextlib.nullcontext():
            with tracing.span("outer"):
                with tracing.span("inner"):
                    torch.ones(8).sum()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    cats = {e["name"]: e.get("cat") for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"] if e.get("name") in ("outer", "inner")}
    want = "user_annotation" if card_timeline else "cpu_op"
    assert cats == {"outer": want, "inner": want}


def test_phase_clock_nests_sums_and_runs_contiguous_phases():
    clock = tracing.PhaseClock(torch.device("cpu"))
    with tracing.collect():
        with clock("outer"):
            clock.start("a")
            clock.start("b")
            with clock("inner"):
                pass
            clock.start("a")
        clock.start("c")
        clock.stop()
    assert list(clock.seconds) == ["outer", "a", "b", "inner", "c"]
    ends = {}
    for name, t0, t1 in clock.spans:
        ends.setdefault(name, []).append((t0, t1))
    a1, a2 = ends["a"]
    (b,), (inner,), (outer,) = ends["b"], ends["inner"], ends["outer"]
    assert a1[1] == b[0] and b[1] == a2[0]  # contiguous
    assert b[0] <= inner[0] and inner[1] <= b[1]
    # a repeated name is summed; a phase inside another is charged to itself
    assert clock.seconds["a"] == pytest.approx(
        ((a1[1] - a1[0]) + (a2[1] - a2[0])) / 1e9)
    assert clock.seconds["b"] == pytest.approx((b[1] - b[0] - (inner[1] - inner[0])) / 1e9)
    assert clock.seconds["outer"] == pytest.approx(
        (outer[1] - outer[0] - (a2[1] - a1[0])) / 1e9)
    rec = tracing.recorded()
    assert [s.name for s in rec["spans"]] == ["outer", "a", "b", "inner", "a", "c"]
    assert rec["spans"][3].parent == 2 and rec["spans"][2].parent == 0


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mono")
    corpus_dir, wave = build_synthetic_corpus(tmp)
    model_path, dict_path = build_synthetic_model(tmp, wave=wave)
    return corpus_dir, model_path, dict_path


@pytest.fixture(scope="module")
def sat(tmp_path_factory):
    import chip_smoke

    tmp = tmp_path_factory.mktemp("sat")
    model_path, dict_path = build_sat_scale_model(tmp, num_phones=6, gauss_per_pdf=4,
                                                  num_words=20)
    words = [line.split("\t")[0] for line in dict_path.read_text().splitlines()]
    corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 6, min_s=2.5, max_s=5.0,
                                            num_speakers=2)
    return corpus_dir, model_path, dict_path


@pytest.mark.parametrize("kind", ["mono", "sat"])
def test_align_phases_keep_their_keys_inside_the_align_span(kind, mono, sat, tmp_path):
    corpus_dir, model_path, dict_path = {"mono": mono, "sat": sat}[kind]
    al = PretrainedAligner(model_path, dict_path, AlignerConfig(batch_size=4), device="cpu")
    with tracing.collect():
        corpus = Corpus.load(corpus_dir)
        results = al.align_corpus(corpus)
        al.export_textgrids(corpus, results, tmp_path / "out")
    want = ALIGN_PHASES + (FMLLR_PHASES if kind == "sat" else []) + LAST_PHASES
    assert list(al.last_phase_seconds) == want
    spans = al.last_phase_spans
    assert [s[0] for s in spans] == want
    assert all(a[2] == b[1] for a, b in zip(spans, spans[1:]))
    rec = tracing.recorded()
    (outer,) = _closed(rec, "align_corpus")
    assert outer.t0_ns <= spans[0][1] and spans[-1][2] <= outer.t1_ns
    index = rec["spans"].index(outer)
    phases = [s for s in rec["spans"] if s.parent == index]
    assert [(s.name, s.t0_ns, s.t1_ns) for s in phases] == spans
    (load,) = _closed(rec, "corpus_load")
    assert load.t1_ns <= outer.t0_ns and load.request != outer.request
    (export,) = _closed(rec, "export_textgrids")
    (read,) = _closed(rec, "export_read_durations")
    assert rec["spans"][read.parent] == export and read.request == export.request


def test_align_phases_without_recording(mono):
    corpus_dir, model_path, dict_path = mono
    al = PretrainedAligner(model_path, dict_path, AlignerConfig(batch_size=4), device="cpu")
    al.align_corpus(Corpus.load(corpus_dir))
    assert list(al.last_phase_seconds) == ALIGN_PHASES + LAST_PHASES
    assert all(v >= 0.0 for v in al.last_phase_seconds.values())
    assert tracing.recorded()["spans"] == []


def test_template_cache_counts_lookups_and_builds(sat):
    corpus_dir, model_path, dict_path = sat
    al = PretrainedAligner(model_path, dict_path, AlignerConfig(batch_size=4), device="cpu")
    compiler = al.compilers[al.default_dictionary_key]
    assert compiler.tree.N > 1  # context-dependent: keys hold the neighbours
    tokens = al.tokenizer.tokenize(Corpus.load(corpus_dir).utterances[0].text)
    with tracing.collect():
        first = compiler.compile(tokens)
    rec = tracing.recorded()
    lookups = rec["counters"]["graph_template_lookups"]
    builds = rec["counters"]["graph_template_builds"]
    assert lookups >= builds > 0
    assert len(_closed(rec, "graph_template_build")) == builds
    tracing.reset()
    with tracing.collect():
        second = compiler.compile(tokens)
    rec = tracing.recorded()
    assert rec["counters"]["graph_template_lookups"] == lookups
    assert "graph_template_builds" not in rec["counters"]
    assert _closed(rec, "graph_template_build") == []
    assert np.array_equal(first.in_src, second.in_src)
    assert np.array_equal(first.state_pdf, second.state_pdf)


@pytest.fixture(scope="module")
def whisper_ckpt(tmp_path_factory):
    return Path(build_tiny_whisper_checkpoint(tmp_path_factory.mktemp("w")))


@pytest.fixture(scope="module")
def whisper(whisper_ckpt):
    return WhisperTranscriber(whisper_ckpt, device="cpu")


def _tone(seconds: float) -> np.ndarray:
    t = np.arange(int(seconds * 16000)) / 16000
    return (4000 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)


def _tone_corpus(root: Path, lengths) -> Path:
    (root / "spk").mkdir(parents=True)
    for i, seconds in enumerate(lengths):
        write_wave(root / "spk" / f"u{i}.wav", _tone(seconds), 16000)
    return root


def test_whisper_spans_count_the_decoder_steps(whisper):
    feats = whisper.features(_tone(4.0))
    two_windows = torch.cat([feats, feats], dim=-1)
    with tracing.collect():
        decoded = generate(whisper.model, two_windows, whisper.generation)
    rec = tracing.recorded()
    assert decoded.windows == 2 and decoded.steps > 2
    assert rec["counters"]["whisper.windows"] == decoded.windows
    assert rec["counters"]["whisper.decoder_steps"] == decoded.steps
    for name in ("whisper.decoder_step", "whisper.logits_processors", "whisper.token_fetch"):
        assert len(_closed(rec, name)) == decoded.steps, name
    for name in ("whisper.encode", "whisper.cross_kv", "whisper.greedy_window"):
        assert len(_closed(rec, name)) == decoded.windows, name
    windows = [i for i, s in enumerate(rec["spans"]) if s.name == "whisper.greedy_window"]
    for s in _closed(rec, "whisper.decoder_step"):
        assert s.parent in windows


def test_whisper_transcribe_corpus_is_one_request(whisper, tmp_path):
    corpus = Corpus.load(_tone_corpus(tmp_path, [1.5, 2.5]), require_transcripts=False)
    with tracing.collect():
        whisper.transcribe_corpus(corpus)
    rec = tracing.recorded()
    (top,) = _closed(rec, "transcribe_corpus")
    features = _closed(rec, "whisper.features")
    assert len(features) == 2 and all(s.request == top.request for s in features)
    steps = _closed(rec, "whisper.decoder_step")
    assert len(steps) == rec["counters"]["whisper.decoder_steps"]
    assert all(s.request == top.request for s in steps)


def test_wav2vec2_transcription_spans_and_counters(tmp_path):
    """One CPU transcription with a CTC checkpoint: each utterance opens the
    four spans in order inside ``transcribe_corpus``; the counters hold the
    utterances and the encoder frames by the convolutions' arithmetic."""
    tr = SpeechbrainTranscriber(build_tiny_wav2vec2_checkpoint(tmp_path / "ckpt"),
                                device="cpu")
    lengths = [1.5, 2.5, 0.75]
    corpus = Corpus.load(_tone_corpus(tmp_path / "c", lengths), require_transcripts=False)
    with tracing.collect():
        tr.transcribe_corpus(corpus)
    rec = tracing.recorded()
    (top,) = _closed(rec, "transcribe_corpus")
    names = ["wav2vec2.feature_encoder", "wav2vec2.encode", "wav2vec2.ctc_head", "ctc.decode"]
    spans = [s for s in rec["spans"] if s.name in names]
    assert [s.name for s in spans] == names * len(lengths)
    assert all(s.request == top.request and s.t1_ns is not None for s in spans)
    assert rec["counters"]["wav2vec2.utterances"] == len(corpus.utterances) == len(lengths)
    # kernels (10, 3, 3), strides (5, 2, 2): 24,000 samples -> 4,799 -> 2,399
    # -> 1,199 frames; 40,000 -> 1,999; 12,000 -> 599
    assert rec["counters"]["wav2vec2.frames"] == 1199 + 1999 + 599


def _trace_names(path: Path) -> set:
    return {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}


def test_align_profile_dir_trace_holds_the_spans(mono, tmp_path):
    corpus_dir, model_path, dict_path = mono
    assert cli_main(["align", str(corpus_dir), str(dict_path), str(model_path),
                     str(tmp_path / "tg"), "--device", "cpu",
                     "--profile_dir", str(tmp_path / "prof")]) == 0
    names = _trace_names(tmp_path / "prof" / "align_trace.json")
    assert {"corpus_load", "align_corpus", "audio_load", "graph_compile", "ctm",
            "export_textgrids", "export_read_durations"} <= names


def test_whisper_profile_dir_trace_holds_the_spans(whisper_ckpt, tmp_path):
    assert cli_main(["transcribe_whisper", str(_tone_corpus(tmp_path / "c", [2.0])),
                     str(whisper_ckpt), str(tmp_path / "txt"), "--device", "cpu",
                     "--profile_dir", str(tmp_path / "prof")]) == 0
    names = _trace_names(tmp_path / "prof" / "transcribe_trace.json")
    assert {"corpus_load", "transcribe_corpus", "whisper.features", "whisper.encode",
            "whisper.greedy_window", "whisper.decoder_step", "whisper.token_fetch"} <= names
