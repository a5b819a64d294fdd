"""The wav2vec2 CTC cell at a tiny size on the CPU: the runner, reference
and check end to end, faults planted in the program caught, and the work
counts against a hand count."""

import copy
import math
import sys
import tempfile
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.work import wav2vec2 as work

import tiny

CELL = "wav2vec2-large-ctc"
SIZES = dict(name="tiny-wav2vec2", hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128, conv_dim=[32, 32, 32],
             conv_kernel=[10, 3, 3], conv_stride=[5, 2, 2], num_feat_extract_layers=3,
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def tiny_config() -> dict:
    cfg = harness.load_json(harness.BENCH_DIR / "configs" / "wav2vec2-large-960h-lv60-self.json")
    cfg.update(SIZES)
    return cfg


def context(tmp, seed=4242, trace=False, seconds=0.5) -> harness.Context:
    w = next(w for w in tiny.MANIFEST["workloads"] if w["name"] == CELL)
    t = harness.load_json(harness.BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    t.update(speakers=2, utterances_per_speaker=3, jobs=2, judge_utterances=3,
             length_s={"dist": "uniform", "min": 1.5, "max": 3.0})
    limits = harness.load_json(harness.BENCH_DIR / "limits" / f"{CELL}.json")
    work_dir = Path(tempfile.mkdtemp(prefix=f"{CELL}-", dir=tmp))
    return harness.Context(copy.deepcopy(tiny.MANIFEST), w, tiny_config(), t, limits, seed,
                           seconds, trace, torch.device("cpu"), Path(tmp) / "cache", work_dir)


def _run(tmp, **kw):
    return tiny.result_line(harness.run_cell(context(tmp, **kw)))


def test_untraced_run_is_correct(bench_tmp):
    r = _run(bench_tmp)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"transcribe_audio_s_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert set(r["compared"]) == {"frontend_error", "logprob_error", "ctc_gap", "texts_wrong"}
    assert r["compared"]["texts_wrong"]["value"] == 0


def test_traced_run_reads_the_program_spans(bench_tmp):
    from montreal_forced_aligner_tpu_torch import tracing

    tracing.reset()
    r = _run(bench_tmp, seed=777, trace=True)
    assert r["correct"] is True
    want = {m["name"] for m in harness.metrics_for(tiny.MANIFEST, CELL, "per_layer")}
    assert want == {"feature_encoder_ms_per_min.ctc", "encoder_ms_per_min.ctc",
                    "ctc_decode_ms_per_min.ctc", "feature_encoder_roofline.ctc",
                    "encoder_roofline.ctc", "device_idle_pct.ctc", "mfu.ctc"}
    # on the CPU no device operation is seen: the device shares are left out
    assert set(r["metrics"]) == {"feature_encoder_ms_per_min.ctc", "encoder_ms_per_min.ctc",
                                 "ctc_decode_ms_per_min.ctc"}
    for m in r["metrics"].values():
        assert m["value"] > 0 and math.isfinite(m["value"])
    tracing.reset()


def test_readers_find_nothing_without_the_program_spans():
    for name in ("feature_encoder_ms_per_min.ctc", "encoder_ms_per_min.ctc",
                 "ctc_decode_ms_per_min.ctc", "feature_encoder_roofline.ctc",
                 "encoder_roofline.ctc", "device_idle_pct.ctc", "mfu.ctc"):
        reader = harness.load_file(harness.BENCH_DIR / "layers" / f"{name}.py")
        assert reader.read({"audio_s": 60.0, "on_device": True, "window_s": 10.0,
                            "busy_s": 5.0, "work": {}, "span_busy_s": {}}) in (None, 50.0)


def test_a_program_without_the_model_fails_before_writing(bench_tmp, monkeypatch):
    """The parent's program, which has no wav2vec2 module, stops the run at
    set-up before the checkpoint is written."""
    monkeypatch.setitem(sys.modules,
                        "montreal_forced_aligner_tpu_torch.transcription.wav2vec2", None)
    (bench_tmp / "parent").mkdir(exist_ok=True)
    ctx = context(bench_tmp / "parent")
    with pytest.raises(ImportError):
        harness.run_cell(ctx)
    assert not (bench_tmp / "parent" / "cache").exists()


def test_positional_weight_norm_over_the_wrong_dim(bench_tmp, monkeypatch):
    from montreal_forced_aligner_tpu_torch.transcription.wav2vec2 import checkpoint

    real = checkpoint.fold_weight_norm
    monkeypatch.setattr(checkpoint, "fold_weight_norm", lambda g, v, dim: real(g, v, 0))
    r = _run(bench_tmp)
    assert not r["correct"]
    assert r["compared"]["logprob_error"]["value"] > r["compared"]["logprob_error"]["limit"]


def test_final_layer_norm_dropped(bench_tmp, monkeypatch):
    from montreal_forced_aligner_tpu_torch.transcription.wav2vec2 import model

    monkeypatch.setattr(model.Encoder, "forward", lambda self, x: _without_final_norm(self, x))
    r = _run(bench_tmp)
    assert not r["correct"]
    assert r["compared"]["logprob_error"]["value"] > r["compared"]["logprob_error"]["limit"]


def _without_final_norm(enc, x):
    import torch.nn.functional as F

    pos = enc.pos_conv(x.transpose(1, 2))[:, :, :-enc.pos_trim or None]
    x = x + F.gelu(pos).transpose(1, 2)
    for layer in enc.layers:
        x = layer(x)
    return x


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Rounded to TF32's 10 mantissa bits, as the tensor cores read it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_tf32_products(bench_tmp, monkeypatch):
    """The program's linear layers with TF32 operands (emulated on the CPU,
    where the TF32 switch does nothing)."""
    import torch.nn.functional as F

    real = F.linear
    monkeypatch.setattr(F, "linear", lambda x, w, b=None: real(_tf32(x), _tf32(w), b))
    r = _run(bench_tmp)
    assert not r["correct"]
    assert r["compared"]["logprob_error"]["value"] > r["compared"]["logprob_error"]["limit"]


def test_text_not_its_argmax(bench_tmp, monkeypatch):
    from montreal_forced_aligner_tpu_torch.transcription.wav2vec2 import ctc

    real = ctc.decode
    monkeypatch.setattr(ctc, "decode", lambda lp, vocab: real(lp, vocab) + "q")
    r = _run(bench_tmp)
    assert not r["correct"] and r["compared"]["texts_wrong"]["value"] > 0


@pytest.mark.cuda
def test_tf32_on_the_card_and_the_control(bench_tmp):
    """On the card, at a small size: the control fails a compared number,
    and so does the program with TF32 switched on."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    (bench_tmp / "card").mkdir(exist_ok=True)
    ctx = context(bench_tmp / "card", seed=31337)
    ctx.device = torch.device("cuda")
    r = harness.run_cell(ctx, control=True)
    assert r["correct"]
    assert any(r["control"][k] > c["limit"] for k, c in r["compared"].items())
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        ctx = context(bench_tmp / "card", seed=31337)
        ctx.device = torch.device("cuda")
        # the reference sets its own flags; the program runs under these
        assert not harness.run_cell(ctx)["correct"]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def test_work_counts_by_hand():
    cfg = tiny_config()
    samples = 1000
    # (1000 - 10) // 5 + 1 = 199, (199 - 3) // 2 + 1 = 99, (99 - 3) // 2 + 1 = 49
    assert work.conv_lengths(cfg, samples) == [199, 99, 49]
    fe = work.feature_encoder(cfg, samples)
    macs = 199 * 32 * 1 * 10 + 99 * 32 * 32 * 3 + 49 * 32 * 32 * 3 + 49 * 32 * 64
    assert fe.flops == 2 * macs
    weights = (32 * 10 + 32 + 64) + 2 * (32 * 32 * 3 + 32 + 64) + (64 + 32 * 64 + 64)
    assert fe.bytes == 4 * (weights + 1000 + 49 * 64)
    enc = work.encoder(cfg, 49)
    macs = 49 * 64 * 16 * 16 + 2 * (4 * 49 * 64 * 64 + 2 * 49 * 49 * 64 + 2 * 49 * 64 * 128)
    assert enc.flops == 2 * macs
    weights = 64 * 16 * 16 + 64 + 2 * (4 * (64 * 64 + 64) + 2 * 64 * 128 + 128 + 64 + 4 * 64)
    assert enc.bytes == 4 * (weights + 2 * 64 + 2 * 49 * 64)
    head = work.ctc_head(cfg, 49)
    assert head.flops == 2 * 49 * 64 * 32
    assert head.bytes == 4 * (64 * 32 + 32 + 49 * 64 + 49 * 32)


def test_published_parameter_count():
    import numpy as np

    model = harness.load_file(harness.BENCH_DIR / "models" / "wav2vec2.py")
    cfg = harness.load_json(harness.BENCH_DIR / "configs" / "wav2vec2-large-960h-lv60-self.json")
    assert sum(int(np.prod(s)) for _, s, _, _ in model.parameters(cfg)) == cfg["num_parameters"]
    assert cfg["reduced"] == [] and cfg["precision"] == "float32"
