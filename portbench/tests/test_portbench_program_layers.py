"""The per-layer readers of the program's own recording
(``montreal_forced_aligner_tpu_torch.tracing``) on hand-made recordings:
None on an empty one and where the program has no such module, and the
hand-worked value otherwise."""

import sys

import pytest

from montreal_forced_aligner_tpu_torch import tracing
from portbench import harness

LAYERS = harness.BENCH_DIR / "layers"
READERS = ["corpus_load_ms_per_min.align", "graph_template_build_ms_per_min.align",
           "graph_template_miss_pct.align", "export_ms_per_min.align",
           "encoder_span_ms_per_window.transcribe", "prelude_ms_per_window.transcribe",
           "decoder_host_ms_per_token.transcribe", "decoder_wait_ms_per_token.transcribe"]
MS = 1_000_000  # ns


def S(name, t0_ms, t1_ms, parent=None, request=0):
    return tracing.Span(name, t0_ms * MS, None if t1_ms is None else t1_ms * MS, parent,
                        request)


# two align jobs (120 s of audio) and two Whisper windows of 3 tokens
SPANS = [
    S("corpus_load", 0, 6), S("corpus_load", 100, 104, request=2),
    S("align_corpus", 6, 90, request=1), S("graph_compile", 20, 50, 2, request=1),
    S("graph_template_build", 21, 24, 3, request=1),
    S("graph_template_build", 30, 32, 3, request=1),
    S("export_textgrids", 90, 99, request=3), S("export_read_durations", 91, 95, 6, request=3),
    S("whisper.features", 200, 203, request=4), S("whisper.encode", 203, 263, request=4),
    S("whisper.cross_kv", 263, 265, request=4), S("whisper.detect_language", 265, 267, request=4),
    S("whisper.encode", 300, 362, request=4), S("whisper.cross_kv", 362, 363, request=4),
    S("whisper.token_fetch", 400, 405, request=4), S("whisper.token_fetch", 410, 413, request=4),
    S("whisper.token_fetch", 420, 421, request=4), S("whisper.token_fetch", 430, None, request=4),
]
RECORDING = {
    "spans": SPANS,
    "counters": {"graph_template_lookups": 40, "graph_template_builds": 2,
                 "whisper.windows": 2, "whisper.decoder_steps": 6},
    "self_ns": {"whisper.decoder_step": 9 * MS, "whisper.logits_processors": 3 * MS,
                "graph_template_build": 5 * MS},
}
TRACE = {"audio_s": 120.0}
WANT = {
    "corpus_load_ms_per_min.align": (6 + 4) / 2.0,
    "graph_template_build_ms_per_min.align": (3 + 2) / 2.0,
    "graph_template_miss_pct.align": 100.0 * 2 / 40,
    "export_ms_per_min.align": 9 / 2.0,
    "encoder_span_ms_per_window.transcribe": (60 + 62) / 2,
    "prelude_ms_per_window.transcribe": (3 + 2 + 2 + 1) / 2,
    "decoder_host_ms_per_token.transcribe": (9 + 3) / 6,
    "decoder_wait_ms_per_token.transcribe": (5 + 3 + 1) / 6,  # the open span not counted
}


def _read(name, trace):
    return harness.load_file(LAYERS / f"{name}.py").read(trace)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_on_an_empty_recording(name, monkeypatch):
    empty = {"spans": [], "counters": {}, "self_ns": {}}
    monkeypatch.setattr(tracing, "recorded", lambda: empty)
    assert _read(name, {}) is None
    assert _read(name, TRACE) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_made_recording(name, monkeypatch):
    monkeypatch.setattr(tracing, "recorded", lambda: RECORDING)
    assert _read(name, TRACE) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_without_the_module(name, monkeypatch):
    """A program without ``tracing`` (as before it had one) reads None."""
    monkeypatch.setitem(sys.modules, "montreal_forced_aligner_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["montreal_forced_aligner_tpu_torch"], "tracing")
    assert _read(name, TRACE) is None


def test_every_program_reader_is_in_the_manifest():
    entries = {m["name"]: m for m in harness.load_json(
        harness.BENCH_DIR.parent / "BENCHMARK.json")["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert m["source"] in ("program_span", "program_counter")
        assert len(m["workloads"]) == 1
