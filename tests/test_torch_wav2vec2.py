"""The port's wav2vec 2.0 CTC model (``transcription/wav2vec2/``, the
``Wav2Vec2ForCTC`` route of ``SpeechbrainTranscriber`` and
``transcribe_speechbrain``) on the CPU, on seeded tiny checkpoints (three
convolutions, 2 blocks of width 64 and 4 heads, a positional convolution of
16 taps in 4 groups): log-probabilities against the plain reference
(``tests/reference_wav2vec2.py``) within 1e-5, the reference against the
installed ``transformers``' ``Wav2Vec2ForCTC`` within 1e-5, both
weight-norm layouts, greedy CTC decoding, the command end to end with no
``speechbrain`` package, and Whisper's encoder block, which the model
shares, unchanged."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import reference_wav2vec2 as reference
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.io.wav import write_wave
from montreal_forced_aligner_tpu_torch.transcription import wav2vec2
from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
    SpeechbrainTranscriber,
)
from montreal_forced_aligner_tpu_torch.transcription.wav2vec2 import ctc
from montreal_forced_aligner_tpu_torch.transcription.whisper import read_weights

from helpers import (
    WAV2VEC2_VOCAB,
    build_tiny_wav2vec2_checkpoint,
    tiny_wav2vec2_config,
)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "montreal_forced_aligner_tpu_torch"
VOCAB = {c: i for i, c in enumerate(WAV2VEC2_VOCAB)}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return build_tiny_wav2vec2_checkpoint(tmp_path_factory.mktemp("w2v"), seed=3)


@pytest.fixture(scope="module")
def model(ckpt):
    c = wav2vec2.load_checkpoint(ckpt, "cpu")
    return wav2vec2.Wav2Vec2ForCTC.from_weights(c.dims, c.state_dict)


def _speech(seconds: float, seed: int) -> np.ndarray:
    """int16-scaled noise and two tones."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = 800 * rng.randn(len(t)) + 3000 * np.sin(2 * np.pi * 220 * t)
    x += 2000 * np.sin(2 * np.pi * 1760 * t + rng.rand())
    return np.round(x).astype(np.float32)


def _frames(cfg, samples: int) -> int:
    """Each convolution's output length, unpadded, in turn."""
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        samples = (samples - k) // s + 1
    return samples


def _port(model, samples):
    with torch.no_grad():
        features = model.extract(torch.from_numpy(samples))
        return features[0], model.log_probs(model.encode(features))


@pytest.mark.parametrize("seconds,seed", [(0.5, 1), (1.7, 2), (3.0, 3)])
def test_port_matches_the_plain_reference(ckpt, model, seconds, seed):
    samples = _speech(seconds, seed)
    frontend, log_probs = _port(model, samples)
    cfg = json.loads((ckpt / "config.json").read_text())
    want = reference.forward(read_weights(ckpt, "cpu"), cfg, samples)
    assert log_probs.shape == (_frames(cfg, len(samples)), len(VOCAB))
    assert (frontend - want["frontend"]).abs().max() < 1e-5
    assert (log_probs - want["log_probs"]).abs().max() < 1e-5


@pytest.mark.parametrize("layout", ["weight_g", "parametrizations"])
def test_reference_matches_transformers(tmp_path, layout):
    transformers = pytest.importorskip("transformers")
    d = build_tiny_wav2vec2_checkpoint(tmp_path, seed=5, layout=layout)
    hf = transformers.Wav2Vec2ForCTC.from_pretrained(str(d)).eval()
    samples = _speech(2.0, 7)
    x = samples.astype(np.float64) / 32768.0
    x = ((x - x.mean()) / np.sqrt(x.var() + 1e-7)).astype(np.float32)
    with torch.no_grad():
        out = hf(torch.from_numpy(x)[None])
    want = F.log_softmax(out.logits[0], dim=-1)
    got = reference.forward(read_weights(d, "cpu"), json.loads((d / "config.json").read_text()),
                            samples)
    assert (got["log_probs"] - want).abs().max() < 1e-5


def test_weight_norm_layouts_fold_identically(tmp_path):
    old = wav2vec2.load_checkpoint(build_tiny_wav2vec2_checkpoint(tmp_path / "a", seed=9), "cpu")
    new = wav2vec2.load_checkpoint(build_tiny_wav2vec2_checkpoint(
        tmp_path / "b", seed=9, layout="parametrizations"), "cpu")
    assert set(old.state_dict) == set(new.state_dict)
    for k in old.state_dict:
        assert torch.equal(old.state_dict[k], new.state_dict[k]), k
    # the fold is torch's own weight norm over dim 2, not the stored direction
    raw = read_weights(tmp_path / "a", "cpu")
    p = "wav2vec2.encoder.pos_conv_embed.conv."
    want = torch._weight_norm(raw[p + "weight_v"], raw[p + "weight_g"], 2)
    assert torch.allclose(old.state_dict["encoder.pos_conv.weight"], want, rtol=1e-6, atol=0)
    assert not torch.allclose(want, raw[p + "weight_v"])
    assert "masked_spec_embed" not in old.state_dict


@pytest.mark.parametrize("tokens,text", [
    ("E E E", "e"),  # a repeat is read once
    ("E <pad> E", "ee"),  # a blank between repeats keeps both
    ("T H E | C A T", "the cat"),
    ("<pad> | T T <pad> | | <pad>", "t"),  # delimiters at the ends are stripped
    ("A | | B", "a b"),
    ("A | <pad> | B", "a  b"),
    ("<pad> <pad>", ""),
    ("", ""),
    ("<s> A </s> <unk> '", "<s>a</s><unk>'"),  # as the tokenizer's defaults keep them
])
def test_ctc_collapse(tokens, text):
    ids = [VOCAB[t] for t in tokens.split()]
    assert ctc.collapse(ids, VOCAB).lower() == text
    log_probs = torch.full((max(len(ids), 1), len(VOCAB)), -5.0)
    log_probs[torch.arange(len(ids)), ids] = -0.1
    if ids:
        assert ctc.decode(log_probs, VOCAB).lower() == text


def test_ctc_collapse_matches_the_tokenizer(tmp_path):
    transformers = pytest.importorskip("transformers")
    (tmp_path / "vocab.json").write_text(json.dumps(VOCAB))
    tok = transformers.Wav2Vec2CTCTokenizer(str(tmp_path / "vocab.json"))
    rng = np.random.RandomState(0)
    for n in range(0, 60, 3):
        ids = rng.choice([0, 0, 0, 4, 4, 5, 6, 7, 27, 1, 2, 3], n).tolist()
        assert ctc.collapse(ids, VOCAB) == tok.decode(ids, clean_up_tokenization_spaces=False)


def _corpus(root: Path, lengths) -> Path:
    for i, seconds in enumerate(lengths):
        d = root / f"spk{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        write_wave(d / f"u{i}.wav", _speech(seconds, 20 + i).astype(np.int16), 16000)
    return root


def test_transcribe_speechbrain_runs_the_ctc_checkpoint(ckpt, model, tmp_path):
    """The command on a ``Wav2Vec2ForCTC`` directory, in a process of its
    own: no ``speechbrain`` module is loaded, each file gets a .lab of the
    greedy decode of the reference's log-probabilities, lowercased."""
    corpus = _corpus(tmp_path / "corpus", [1.2, 2.5, 0.8])
    out = tmp_path / "out"
    code = (
        "import sys, json\n"
        "from montreal_forced_aligner_tpu_torch.cli import main\n"
        f"rc = main(['transcribe_speechbrain', {str(corpus)!r}, {str(ckpt)!r}, {str(out)!r},"
        " '--device', 'cpu'])\n"
        "print(json.dumps([rc, sorted(m for m in sys.modules if m.split('.')[0] == "
        "'speechbrain')]))\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    rc, loaded = json.loads(run.stdout.strip().splitlines()[-1])
    assert rc == 0 and loaded == []
    weights = read_weights(ckpt, "cpu")
    cfg = json.loads((ckpt / "config.json").read_text())
    labs = sorted(p.relative_to(out).as_posix() for p in out.rglob("*.lab"))
    assert labs == ["spk0/u0.lab", "spk0/u2.lab", "spk1/u1.lab"]
    for i, lab in enumerate(["spk0/u0.lab", "spk1/u1.lab", "spk0/u2.lab"]):
        samples = _speech([1.2, 2.5, 0.8][i], 20 + i).astype(np.int16).astype(np.float32)
        want = reference.forward(weights, cfg, samples)["log_probs"].argmax(-1).tolist()
        text = (out / lab).read_text()
        assert text == ctc.collapse(want, VOCAB).lower() + "\n"


def test_transcribe_corpus_in_process(ckpt, tmp_path):
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    tr = SpeechbrainTranscriber(ckpt, device="cpu")
    assert tr.ctc
    corpus = Corpus.load(_corpus(tmp_path / "c", [1.0, 1.4]), require_transcripts=False)
    texts = tr.transcribe_corpus(corpus)
    assert set(texts) == {u.id for u in corpus.utterances}
    assert all(t == t.lower() and t == t.strip() for t in texts.values())
    assert any(texts.values())


def test_other_directories_keep_the_package_route(tmp_path):
    whisper_like = tmp_path / "whisper_like"
    whisper_like.mkdir()
    (whisper_like / "config.json").write_text(json.dumps({"model_type": "whisper"}))
    for d in (tmp_path, whisper_like, tmp_path / "missing"):
        assert not wav2vec2.is_ctc_checkpoint(d)
        with pytest.raises(RuntimeError, match="speechbrain is not available"):
            SpeechbrainTranscriber(d, device="cpu")


def test_other_layouts_are_refused(tmp_path):
    cfg = tiny_wav2vec2_config()
    cfg.update(feat_extract_norm="group", do_stable_layer_norm=False)
    d = build_tiny_wav2vec2_checkpoint(tmp_path, config=cfg)
    with pytest.raises(NotImplementedError, match="feat_extract_norm"):
        SpeechbrainTranscriber(d, device="cpu")


def test_the_card_is_the_default(ckpt):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpeechbrainTranscriber(ckpt)


def test_new_modules_import_no_jax():
    files = sorted((PORT / "transcription" / "wav2vec2").glob("*.py"))
    assert {p.name for p in files} >= {"__init__.py", "checkpoint.py", "model.py", "ctc.py"}
    for path in files + [PORT / "transcription" / "torch_models.py",
                         REPO / "tests" / "reference_wav2vec2.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "montreal_forced_aligner_tpu", "mfa_tpu",
                                    "transformers", "safetensors"), (path, name)
                # the package route keeps its lazy import; the model has none
                if path.name != "torch_models.py":
                    assert root != "speechbrain", (path, name)
                if path.name == "reference_wav2vec2.py":
                    assert root != "montreal_forced_aligner_tpu_torch", (path, name)


def test_model_reuses_whisper_encoder_block(model):
    from montreal_forced_aligner_tpu_torch.transcription.whisper.model import EncoderLayer

    assert all(type(layer) is EncoderLayer for layer in model.encoder.layers)
    assert all(layer.self_attn.k_proj.bias is not None for layer in model.encoder.layers)


def test_whisper_encoder_block_is_unchanged(tmp_path):
    """Whisper's shared block, key bias off, gives bit for bit what the
    block's composition before sharing gave, layer by layer and through
    the tiny checkpoint's whole encoder."""
    pytest.importorskip("transformers")
    from montreal_forced_aligner_tpu_torch.transcription.whisper import (
        Whisper,
        load_checkpoint,
    )

    from helpers import build_tiny_whisper_checkpoint

    c = load_checkpoint(build_tiny_whisper_checkpoint(tmp_path), "cpu")
    whisper = Whisper.from_weights(c.dims, c.state_dict)
    enc = whisper.model.encoder
    assert all(layer.self_attn.k_proj.bias is None for layer in enc.layers)

    def before(layer, x):
        h = layer.self_attn_layer_norm(x)
        x = x + layer.self_attn(h, layer.self_attn.project_kv(h))
        return x + layer.fc2(F.gelu(layer.fc1(layer.final_layer_norm(x))))

    feats = torch.randn(1, c.dims.num_mel_bins, 2 * c.dims.max_source_positions,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        x = F.gelu(enc.conv2(F.gelu(enc.conv1(feats)))).permute(0, 2, 1)
        x = x + enc.embed_positions.weight
        for layer in enc.layers:
            got, x = layer(x), before(layer, x)
            assert torch.equal(got, x)
        assert torch.equal(whisper.encode(feats), enc.layer_norm(x))
