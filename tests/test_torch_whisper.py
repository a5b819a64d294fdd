"""The port's Whisper (``transcription/whisper/``, ``WhisperTranscriber``,
``transcribe_whisper``) against the JAX package's ``transformers`` wrapper
on the same local checkpoints, on the CPU.

Two checkpoints: ``tests/helpers.py``'s ``build_tiny_whisper_checkpoint``
(1+1 layers; its generation config is made from the model config, so the
language hint is dropped on both sides), and one built here with 2+2
layers, 80 mel bins, ``suppress_tokens`` and ``begin_suppress_tokens``,
``forced_decoder_ids`` and three languages, decoded with no language (so
the language is detected) and with one. Log-mel within 1e-5, encoder
states and each step's scores within 1e-4, ids and text equal.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from montreal_forced_aligner_tpu.transcription.torch_models import (
    WhisperTranscriber as JWhisper,
)
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
    WhisperTranscriber as PWhisper,
)
from montreal_forced_aligner_tpu_torch.transcription.whisper import generate as PG
from montreal_forced_aligner_tpu_torch.transcription.whisper import (
    load_checkpoint,
    read_safetensors,
    read_weights,
)

from helpers import build_tiny_whisper_checkpoint
from test_torch_gated import _small_corpus
from torch_port_inputs import growing_greedy_window

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

SR = 16000
# utterance lengths: short, past the 30 s window (cut), and one in between
LENGTHS = (12000, 80000, 520000)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tiny models' products are small, and the
    test workers share the machine's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def build_detecting_checkpoint(tmp_path, timestamps=0, eos_like=None,
                               name="detect_whisper"):
    """2+2 layers, 80 bins, three languages, suppression lists and the
    published ``forced_decoder_ids`` pattern; its generation config is its
    own (not made from the model config), so every Whisper key survives.
    ``timestamps`` adds that many timestamp tokens (``<|0.00|>``, ...)
    after ``<|notimestamps|>``; ``eos_like`` makes the end of text's
    embedding that factor of ``v``'s, so the decoder stops often."""
    from transformers import (
        GenerationConfig,
        WhisperConfig,
        WhisperFeatureExtractor,
        WhisperForConditionalGeneration,
        WhisperProcessor,
        WhisperTokenizer,
    )

    tok_dir = Path(tmp_path) / f"tok_{name}"
    tok_dir.mkdir(parents=True, exist_ok=True)
    specials = ["<|endoftext|>", "<|startoftranscript|>", "<|en|>", "<|de|>",
                "<|fr|>", "<|translate|>", "<|transcribe|>", "<|nospeech|>",
                "<|notimestamps|>"]
    vocab = {}
    for ch in "abcdefghijklmnopqrstuvwxyz":
        vocab[ch] = len(vocab)
    vocab["Ġ"] = len(vocab)
    for s in specials:
        vocab[s] = len(vocab)
    stamps = [f"<|{0.02 * i:.2f}|>" for i in range(timestamps)]
    for s in stamps:
        vocab[s] = len(vocab)
    (tok_dir / "vocab.json").write_text(json.dumps(vocab))
    (tok_dir / "merges.txt").write_text("#version: 0.2\n")
    tok = WhisperTokenizer(str(tok_dir / "vocab.json"), str(tok_dir / "merges.txt"))
    tok.add_special_tokens({"additional_special_tokens": specials,
                            "bos_token": "<|endoftext|>",
                            "eos_token": "<|endoftext|>",
                            "pad_token": "<|endoftext|>"})
    if stamps:
        tok.add_tokens(stamps)
    proc = WhisperProcessor(feature_extractor=WhisperFeatureExtractor(feature_size=80),
                            tokenizer=tok)
    eot, sot = vocab["<|endoftext|>"], vocab["<|startoftranscript|>"]
    cfg = WhisperConfig(
        vocab_size=len(tok), d_model=48, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4,
        encoder_ffn_dim=96, decoder_ffn_dim=96, max_source_positions=1500,
        max_target_positions=48, decoder_start_token_id=sot, eos_token_id=eot,
        pad_token_id=eot, bos_token_id=eot, begin_suppress_tokens=None,
    )
    torch.manual_seed(7)
    model = WhisperForConditionalGeneration(cfg)
    with torch.no_grad():
        # livelier than the 0.02 init, cross-attention far stronger, so the
        # tokens and the detected language follow the input
        for n, p in model.model.named_parameters():
            if "layer_norm" in n or "embed_positions" in n:
                continue
            p.mul_(160.0 if "encoder_attn" in n
                   else 8.0 if n.startswith("encoder.") else 2.0)
        if eos_like is not None:
            emb = model.model.decoder.embed_tokens.weight
            emb[eot] = emb[vocab["v"]] * eos_like
    model.generation_config = GenerationConfig(
        decoder_start_token_id=sot, eos_token_id=eot, pad_token_id=eot,
        bos_token_id=eot, max_length=20,
        suppress_tokens=[vocab["q"], vocab["x"], vocab["<|nospeech|>"]],
        begin_suppress_tokens=[vocab["Ġ"], eot],
        forced_decoder_ids=[[1, None], [2, vocab["<|transcribe|>"]]],
        is_multilingual=True,
        lang_to_id={t: vocab[t] for t in ("<|en|>", "<|de|>", "<|fr|>")},
        task_to_id={"transcribe": vocab["<|transcribe|>"],
                    "translate": vocab["<|translate|>"]},
        no_timestamps_token_id=vocab["<|notimestamps|>"],
    )
    out = Path(tmp_path) / name
    proc.save_pretrained(out)
    model.save_pretrained(out)
    return out


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("whisper")
    return {"tiny": build_tiny_whisper_checkpoint(tmp),
            "detect": build_detecting_checkpoint(tmp)}


CASES = [("tiny", "english"), ("tiny", None), ("detect", None),
         ("detect", "english"), ("detect", "german")]


@pytest.fixture(scope="module")
def pairs(checkpoints):
    cache = {}

    def get(name, language):
        if (name, language) not in cache:
            cache[name, language] = (
                JWhisper(checkpoints[name], language=language),
                PWhisper(checkpoints[name], language=language, device="cpu"))
        return cache[name, language]

    return get


def waves(seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for n in LENGTHS:
        t = np.arange(n) / SR
        out.append((3000 * np.sin(2 * np.pi * (200 + 300 * rng.rand()) * t)
                    + 800 * rng.randn(n)).astype(np.float32))
    return out


def _jax_features(j, wave):
    return j.processor(wave / 32768.0, sampling_rate=SR,
                       return_tensors="pt")["input_features"]


@pytest.mark.parametrize("name", ["tiny", "detect"])
def test_log_mel_matches_processor(pairs, name):
    j, p = pairs(name, None)
    for wave in waves(1):
        want = _jax_features(j, wave)
        got = p.features(wave)
        assert got.shape == want.shape == (1, 80, 3000)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("bins", [80, 128])
def test_mel_filters_match_transformers(bins):
    from transformers import WhisperFeatureExtractor

    from montreal_forced_aligner_tpu_torch.transcription.whisper import mel_filters

    want = WhisperFeatureExtractor(feature_size=bins).mel_filters
    np.testing.assert_allclose(mel_filters(bins), want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("name,language", CASES)
def test_encoder_and_step_scores_match(pairs, name, language):
    """Encoder states, the language detection's scores and every decoder
    step's processed scores (suppressed tokens at -inf on both sides)."""
    j, p = pairs(name, language)
    for wave in waves(2):
        feats = _jax_features(j, wave)
        with torch.no_grad():
            want_enc = j.model.model.encoder(feats).last_hidden_state
            got_enc = p.model.encode(p.features(wave))
        np.testing.assert_allclose(got_enc.numpy(), want_enc.numpy(), atol=1e-4, rtol=0)
        kw = {"language": j.language} if j.language else {}
        out = j.model.generate(feats, return_dict_in_generate=True,
                               output_scores=True, **kw)
        want = torch.cat(out["scores"]).numpy()
        d = p.decode(wave, keep_scores=len(want))
        got = torch.stack(d.scores).numpy()
        assert got.shape == want.shape
        assert np.array_equal(np.isfinite(got), np.isfinite(want))
        finite = np.isfinite(want)
        np.testing.assert_allclose(got[finite], want[finite], atol=1e-4, rtol=0)


@pytest.mark.parametrize("name,language", CASES)
def test_ids_and_text_match(pairs, name, language):
    j, p = pairs(name, language)
    for wave in waves(3):
        kw = {"language": j.language} if j.language else {}
        want = j.model.generate(_jax_features(j, wave), **kw)[0].tolist()
        d = p.decode(wave)
        assert d.ids == want
        assert p.transcribe(wave) == j.transcribe(wave)
    if name == "detect":
        # the prompt: start, the language (detected or given), the forced
        # task and no-timestamps
        lang = p.generation.lang_to_id
        assert d.prompt[0] == p.generation.decoder_start_token_id
        assert d.prompt[1] in lang.values()
        if language == "german":
            assert d.prompt[1] == lang["<|de|>"]
        assert d.prompt[2:] == [p.generation.task_to_id["transcribe"],
                                p.generation.no_timestamps_token_id]


def test_detection_picks_different_languages(pairs):
    """Detection really chooses among the languages: over several inputs
    it gives the same language as transformers each time."""
    j, p = pairs("detect", None)
    got, want = [], []
    t = np.arange(SR) / SR
    for f, a in [(f, a) for f in (100, 300, 700, 1500, 3000, 6000)
                 for a in (300, 3000, 20000)]:
        wave = (a * np.sin(2 * np.pi * f * t)).astype(np.float32)
        feats = _jax_features(j, wave)
        want.append(int(j.model.detect_language(feats)[0]))
        got.append(p.decode(wave, max_steps=1).prompt[1])
    assert got == want
    assert len(set(got)) > 1


def test_generation_settings_follow_from_model_config(checkpoints):
    """A generation config made from the model config keeps only the
    standard keys (``GenerationConfig.__init__``): the tiny checkpoint's
    ``lang_to_id`` is dropped, as ``from_pretrained`` drops it."""
    from transformers import GenerationConfig

    for name in ("tiny", "detect"):
        got = load_checkpoint(checkpoints[name], "cpu").generation
        want = GenerationConfig.from_pretrained(checkpoints[name])
        for key in ("lang_to_id", "task_to_id", "no_timestamps_token_id",
                    "is_multilingual", "suppress_tokens", "begin_suppress_tokens",
                    "forced_decoder_ids", "max_length", "decoder_start_token_id"):
            assert getattr(got, key) == getattr(want, key, None), (name, key)


def test_window_tokens_follow_retrieve_segment():
    """The timestamp-pair rule of ``_retrieve_segment`` on token lists,
    against transformers' own function: the same segments and seek."""
    from transformers.models.whisper.generation_whisper import (
        WhisperGenerationMixin,
    )

    tb, frames = 50, 3000
    rng = np.random.RandomState(0)
    seqs = [[1, 2, 3], [1, 55, 60, 4], [1, 55, 60, 4, 70, 71], [52, 53],
            [4, 60], [60, 61, 5, 62], [7], []]
    seqs += [list(rng.choice([1, 2, 51, 60, 75], rng.randint(1, 12))) for _ in range(60)]
    for seq in seqs:
        t = torch.tensor(seq, dtype=torch.long)
        segs, offset = WhisperGenerationMixin._retrieve_segment(
            seek_sequence=t, seek_outputs=[None], time_offset=torch.zeros(1),
            timestamp_begin=tb, seek_num_frames=torch.tensor([frames]),
            time_precision=0.02, time_precision_features=0.01, input_stride=2,
            prev_idx=0, idx=0, return_token_timestamps=False,
            decoder_input_ids=torch.zeros(1, 3, dtype=torch.long))
        got, got_offset = PG.window_segments([int(x) for x in seq], tb, frames)
        assert got == [s["tokens"].tolist() for s in segs], seq
        assert got_offset == int(offset), seq


def test_max_length_rule():
    from montreal_forced_aligner_tpu_torch.transcription.whisper.checkpoint import (
        GenerationSettings,
    )

    assert PG.max_length(GenerationSettings(), 4, 448) == 24
    assert PG.max_length(GenerationSettings(max_length=448), 4, 448) == 448
    assert PG.max_length(GenerationSettings(max_new_tokens=10), 4, 448) == 14
    with pytest.raises(ValueError, match="max_target_positions"):
        PG.max_length(GenerationSettings(max_new_tokens=446), 4, 448)


def test_cli_writes_the_jax_cli_labs(checkpoints, tmp_path):
    from click.testing import CliRunner

    from montreal_forced_aligner_tpu.cli import cli as jcli

    corp = _small_corpus(tmp_path)
    for name in ("tiny", "detect"):
        ckpt = checkpoints[name]
        port, jax = tmp_path / f"port_{name}", tmp_path / f"jax_{name}"
        assert cli_main(["transcribe_whisper", str(corp), str(ckpt), str(port),
                         "--language", "english", "--device", "cpu"]) == 0
        r = CliRunner().invoke(jcli, ["transcribe_whisper", str(corp), str(ckpt),
                                      str(jax), "--language", "english"],
                               catch_exceptions=False)
        assert r.exit_code == 0, r.output
        want = {p.relative_to(jax).as_posix(): p.read_bytes()
                for p in jax.rglob("*.lab")}
        got = {p.relative_to(port).as_posix(): p.read_bytes()
               for p in port.rglob("*.lab")}
        assert set(want) == {"spk0/utt0.lab", "spk1/utt1.lab"}
        assert got == want


def test_online_whisper_matches_jax(checkpoints):
    from montreal_forced_aligner_tpu.online.transcription import (
        transcribe_utterance_online_whisper as jonline,
    )
    from montreal_forced_aligner_tpu_torch.online.transcription import (
        transcribe_utterance_online_whisper as ponline,
    )

    wave = waves(4)[0]
    for rate in (16000, 22050):
        want = jonline(checkpoints["detect"], wave, rate)
        assert ponline(checkpoints["detect"], wave, rate, device="cpu") == want


def test_bin_checkpoint_loads_like_safetensors(checkpoints, tmp_path):
    from transformers import WhisperForConditionalGeneration

    src = checkpoints["detect"]
    dst = tmp_path / "as_bin"
    shutil.copytree(src, dst)
    (dst / "model.safetensors").unlink()
    WhisperForConditionalGeneration.from_pretrained(src).save_pretrained(
        dst, safe_serialization=False)
    assert (dst / "pytorch_model.bin").exists()
    assert not (dst / "model.safetensors").exists()
    a, b = load_checkpoint(src, "cpu").state_dict, load_checkpoint(dst, "cpu").state_dict
    shared = set(a) & set(b)
    assert set(a) <= shared | {"proj_out.weight"}
    for k in shared:
        assert torch.equal(a[k], b[k]), k
    wave = waves(5)[1]
    pa = PWhisper(src, device="cpu")
    pb = PWhisper(dst, device="cpu")
    assert pa.decode(wave).ids == pb.decode(wave).ids


def test_safetensors_reader_matches_the_package(checkpoints, tmp_path):
    """float32, float16 and bfloat16 tensors read as ``safetensors`` reads
    them."""
    from safetensors.torch import load_file, save_file

    rng = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(3, 5, generator=rng),
               "b": torch.randn(7, generator=rng).half(),
               "c": torch.randn(2, 2, 2, generator=rng).to(torch.bfloat16),
               "d": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    save_file(tensors, tmp_path / "t.safetensors")
    got = read_safetensors(tmp_path / "t.safetensors")
    for k, v in load_file(tmp_path / "t.safetensors").items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    ck = checkpoints["tiny"] / "model.safetensors"
    want = load_file(ck)
    got = read_safetensors(ck)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_entry_points_raise(checkpoints, tmp_path):
    with pytest.raises(FileNotFoundError, match="no local Whisper checkpoint"):
        PWhisper(tmp_path / "missing", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PWhisper(checkpoints["tiny"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_main(["transcribe_whisper", str(tmp_path), str(checkpoints["tiny"]),
                      str(tmp_path / "o")])
        # the checkpoint readers default to the card as well
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_checkpoint(checkpoints["tiny"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            read_weights(checkpoints["tiny"])
    assert load_checkpoint(checkpoints["tiny"], "cpu").state_dict
    assert all(t.device.type == "cpu"
               for t in read_weights(checkpoints["tiny"], "cpu").values())
    p = PWhisper(checkpoints["tiny"], device="cpu")
    with pytest.raises(ValueError, match="16000 Hz"):
        p.transcribe(np.zeros(100, np.float32), sample_rate=8000)


def test_port_run_loads_no_transformers(checkpoints, tmp_path):
    """A port-only transcription imports neither transformers, nor
    safetensors, nor JAX or the JAX package."""
    code = (
        "import sys, numpy as np\n"
        "from montreal_forced_aligner_tpu_torch.transcription.torch_models import "
        "WhisperTranscriber\n"
        "from montreal_forced_aligner_tpu_torch.cli import main\n"
        f"tr = WhisperTranscriber({str(checkpoints['detect'])!r}, device='cpu')\n"
        "print(repr(tr.transcribe(np.ones(16000, np.float32) * 100)))\n"
        f"assert main(['transcribe_whisper', {str(_small_corpus(tmp_path))!r}, "
        f"{str(checkpoints['tiny'])!r}, {str(tmp_path / 'o')!r}, '--device', 'cpu']) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('transformers', "
        "'safetensors', 'jax', 'jaxlib', 'montreal_forced_aligner_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


TINY_TURBO = {
    "vocab_size": 459, "num_mel_bins": 128, "d_model": 64, "encoder_layers": 2,
    "encoder_attention_heads": 4, "encoder_ffn_dim": 128, "decoder_layers": 2,
    "decoder_attention_heads": 4, "decoder_ffn_dim": 128,
    "max_source_positions": 1500, "max_target_positions": 64,
}
TINY_TEXT = {"n_base": 300, "n_languages": 100, "n_timestamps": 51}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    return chip_smoke.write_whisper_checkpoint(
        tmp_path_factory.mktemp("writer") / "w", TINY_TURBO, TINY_TEXT, seed=0)


def test_smoke_writer_loads_in_transformers(written):
    """``chip_smoke.py``'s checkpoint writer at tiny widths: transformers
    loads it, and its ids, text and (over random ids) its tokenizer's
    decode equal the port's."""
    j = JWhisper(written)
    p = PWhisper(written, device="cpu")
    assert j.model.generation_config.lang_to_id == p.generation.lang_to_id
    for wave in waves(6)[:2]:
        ids = j.model.generate(_jax_features(j, wave))[0].tolist()
        assert p.decode(wave).ids == ids
        assert p.transcribe(wave) == j.transcribe(wave)
    rng = np.random.RandomState(0)
    tok = j.processor.tokenizer
    for _ in range(300):
        ids = rng.randint(0, TINY_TURBO["vocab_size"], rng.randint(1, 30)).tolist()
        assert p.tokenizer.decode(ids) == tok.decode(ids, skip_special_tokens=True)


# (checkpoint, bucket width): ``tiny``'s windows end at 8 positions,
# ``detect``'s at 24, ``written``'s at 64
@pytest.mark.parametrize("name,bucket", [("tiny", 3), ("detect", 8), ("written", 8)])
def test_static_cache_steps_match_growing_cache(pairs, written, monkeypatch, name, bucket):
    """Greedy decoding over the static cache, with buckets narrow enough
    that each window crosses several: every step's scores within 1e-5 of
    the growing cache's, and the ids equal."""
    p = PWhisper(written, device="cpu") if name == "written" else pairs(name, None)[1]
    monkeypatch.setattr(PG, "BUCKET", bucket)
    longest = 0
    for wave in waves(8):
        static = p.decode(wave, keep_scores=10 ** 6)
        with monkeypatch.context() as m:
            m.setattr(PG, "_greedy_window", growing_greedy_window)
            growing = p.decode(wave, keep_scores=10 ** 6)
        assert static.ids == growing.ids
        assert static.steps == growing.steps == len(static.scores)
        for got, want in zip(static.scores, growing.scores):
            finite = torch.isfinite(want)
            assert torch.equal(finite, torch.isfinite(got))
            assert (got[finite] - want[finite]).abs().max() <= 1e-5
        longest = max(longest, len(static.prompt) + static.steps // static.windows)
    assert longest > 2 * bucket


def test_graph_never_engages_on_the_cpu(pairs):
    """Off the card the static step runs eagerly: no capture, the replay
    counter present at 0, so the benchmark's reader reads 0 (and None
    where the program keeps no such counter)."""
    from montreal_forced_aligner_tpu_torch import tracing
    from portbench import harness

    reader = harness.load_file(harness.BENCH_DIR / "layers"
                               / "decoder_graph_step_pct.transcribe.py")
    _, p = pairs("detect", None)
    tracing.reset()
    try:
        with tracing.collect():
            d = p.decode(waves(9)[0])
        counters = tracing.recorded()["counters"]
        assert d.steps > 1
        assert counters["whisper.decoder_steps"] == d.steps
        assert counters["whisper.decoder_graph_replays"] == 0
        assert "whisper.decoder_graph_captures" not in counters
        assert not p.model.greedy_step.graphed and p.model.greedy_step.graphs == {}
        assert reader.read({}) == 0.0
        tracing.reset()
        assert reader.read({}) is None
    finally:
        tracing.reset()
