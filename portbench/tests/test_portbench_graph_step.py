"""The reader of ``decoder_graph_step_pct.transcribe`` on hand-made
recordings, and a fault planted in greedy decoding's static-cache step
(a tiny Whisper run on the CPU) coming out not correct."""

import sys

import pytest

from montreal_forced_aligner_tpu_torch import tracing
from portbench import harness

import tiny

NAME = "decoder_graph_step_pct.transcribe"


def _read(monkeypatch, counters):
    monkeypatch.setattr(tracing, "recorded",
                        lambda: {"spans": [], "counters": counters, "self_ns": {}})
    return harness.load_file(harness.BENCH_DIR / "layers" / f"{NAME}.py").read({})


@pytest.mark.parametrize("counters,want", [
    ({"whisper.decoder_steps": 440, "whisper.decoder_graph_replays": 439}, 100.0 * 439 / 440),
    ({"whisper.decoder_steps": 12, "whisper.decoder_graph_replays": 0}, 0.0),
    # no replay counter (a program without the graphed step), or no steps
    ({"whisper.decoder_steps": 12}, None),
    ({}, None),
    ({"whisper.decoder_graph_replays": 0}, None),
])
def test_reader_on_a_hand_made_recording(monkeypatch, counters, want):
    assert _read(monkeypatch, counters) == (want if want is None else pytest.approx(want))


def test_reader_is_none_without_the_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "montreal_forced_aligner_tpu_torch.tracing", None)
    monkeypatch.delattr(sys.modules["montreal_forced_aligner_tpu_torch"], "tracing")
    assert harness.load_file(harness.BENCH_DIR / "layers" / f"{NAME}.py").read({}) is None


def test_reader_is_in_the_manifest():
    (m,) = [m for m in tiny.MANIFEST["per_layer"] if m["name"] == NAME]
    assert m["source"] == "program_counter"
    assert m["workloads"] == ["whisper-turbo-greedy"]


def test_whisper_static_cache_never_written(bench_tmp, monkeypatch):
    """Greedy decoding's static cache keeps the prompt's keys and values
    but never a generated token's."""
    from montreal_forced_aligner_tpu_torch.transcription.whisper import model

    monkeypatch.setattr(model.DecoderLayer, "step", _unwritten_step)
    r = harness.run_cell(tiny.context("whisper-turbo-greedy", bench_tmp, seed=4242))
    assert not r["correct"]
    assert r["compared"]["token_gap"]["value"] > r["compared"]["token_gap"]["limit"]


def _unwritten_step(self, x, pos, cache, length, mask, cross):
    h = self.self_attn_layer_norm(x)
    x = x + self.self_attn(h, (cache[0][:, :, :length], cache[1][:, :, :length]), mask=mask)
    return self._rest(x, cross)
