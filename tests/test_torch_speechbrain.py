"""The port's SpeechBrain paths (ASR transcription, neural VAD, x-vector
diarization) against the JAX package's, on the CPU.

Through ``tests/mock_speechbrain.py`` (the JAX package's stand-in, which
ignores ``run_opts``) both packages run on the same corpora as
``tests/test_torch_gated.py`` and give the same texts, segments and
labels; ``tests/torch_mock_speechbrain.py`` (the port's stand-in, which
honours ``run_opts["device"]``) is held to the pinned surface and to the
old stand-in's outputs.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import mock_speechbrain
import torch_mock_speechbrain
from montreal_forced_aligner_tpu.cli import cli as jcli
from montreal_forced_aligner_tpu.io.wav import write_wave
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.io.textgrid import TextGrid
from montreal_forced_aligner_tpu_torch.speechbrain_surface import (
    SPEECHBRAIN_SURFACE,
    check_surface,
)

from test_torch_gated import _small_corpus

SR = 16000
MOCKS = {"old": mock_speechbrain, "port": torch_mock_speechbrain}


@pytest.fixture(params=["old", "port"])
def sb(request):
    mock = MOCKS[request.param]
    mock.install()
    yield request.param
    mock.uninstall()


@pytest.fixture()
def sb_old():
    mock_speechbrain.install()
    yield
    mock_speechbrain.uninstall()


def vad_corpus(tmp_path):
    """``test_speechbrain_vad_segmenter``'s file: speech, pause, speech."""
    corp = tmp_path / "vad_corpus" / "spk0"
    corp.mkdir(parents=True)
    rng = np.random.RandomState(1)
    pieces = []
    for speech in (False, True, False, True, False):
        n = int((0.8 if speech else 0.5) * SR)
        t = np.arange(n) / SR
        x = (6000 * np.sin(2 * np.pi * 440 * t) + rng.randn(n) * 10
             if speech else rng.randn(n) * 3.0)
        pieces.append(x.astype(np.float32))
    write_wave(corp / "long.wav", np.concatenate(pieces), SR)
    return corp.parent


def speaker_corpus(tmp_path):
    """``test_xvector_diarization_cli``'s corpus: two tone speakers filed
    under three wrong labels."""
    corp = tmp_path / "spk_corpus"
    rng = np.random.RandomState(2)
    for u in range(8):
        d = corp / f"orig{u % 3}"
        d.mkdir(parents=True, exist_ok=True)
        t = np.arange(int(1.2 * SR)) / SR
        freq = 330 if u % 2 == 0 else 2400
        wave = 5000 * np.sin(2 * np.pi * freq * t) + rng.randn(len(t)) * 15
        write_wave(d / f"utt{u}.wav", wave.astype(np.float32), SR)
        (d / f"utt{u}.lab").write_text("hello there")
    return corp


def _jax(args):
    r = CliRunner().invoke(jcli, [str(a) for a in args], catch_exceptions=False)
    assert r.exit_code == 0, r.output
    return r.output


def _segments(path):
    return [(i.begin, i.end) for i in TextGrid.read(path).tiers["segments"] if i.label]


def test_transcribe_speechbrain_matches_jax(tmp_path, sb_old):
    corp = _small_corpus(tmp_path)
    ckpt = tmp_path / "sb_asr"
    ckpt.mkdir()
    _jax(["transcribe_speechbrain", corp, ckpt, tmp_path / "jax"])
    assert cli_main(["transcribe_speechbrain", str(corp), str(ckpt),
                     str(tmp_path / "port"), "--device", "cpu",
                     "--language", "english"]) == 0
    want = {p.relative_to(tmp_path / "jax").as_posix(): p.read_bytes()
            for p in (tmp_path / "jax").rglob("*.lab")}
    got = {p.relative_to(tmp_path / "port").as_posix(): p.read_bytes()
           for p in (tmp_path / "port").rglob("*.lab")}
    assert set(want) == {"spk0/utt0.lab", "spk1/utt1.lab"} and got == want
    assert b"mock" in got["spk0/utt0.lab"]


def test_neural_vad_matches_jax(tmp_path, sb_old):
    corp = vad_corpus(tmp_path)
    ckpt = tmp_path / "sb_vad"
    ckpt.mkdir()
    _jax(["create_segments_vad", corp, tmp_path / "jax",
          "--speechbrain_model_path", ckpt])
    assert cli_main(["create_segments_vad", str(corp), str(tmp_path / "port"),
                     "--speechbrain_model_path", str(ckpt), "--device", "cpu"]) == 0
    want = _segments(tmp_path / "jax" / "long.TextGrid")
    got = _segments(tmp_path / "port" / "spk0" / "long.TextGrid")
    assert len(want) >= 2 and got == want


@pytest.mark.parametrize("extra", [["--expected_num_speakers", "2", "--evaluate"],
                                   ["--classify"],
                                   ["--cluster_type", "kmeans",
                                    "--expected_num_speakers", "2"]])
def test_xvector_diarization_matches_jax(tmp_path, sb_old, extra):
    corp = speaker_corpus(tmp_path)
    ckpt = tmp_path / "sb_spk"
    ckpt.mkdir()
    _jax(["diarize_speakers", corp, "speechbrain", tmp_path / "jax",
          "--xvector_model_path", ckpt] + extra)
    assert cli_main(["diarize_speakers", str(corp), "speechbrain",
                     str(tmp_path / "port"), "--xvector_model_path", str(ckpt),
                     "--device", "cpu"] + extra) == 0
    for name in ("utt2spk.tsv", "parameters.yaml"):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text()), name
    labels = {}
    for line in (tmp_path / "port" / "utt2spk.tsv").read_text().splitlines():
        path, _b, _e, spk = line.split("\t")
        labels[path.split("/")[-1]] = spk
    if "--classify" not in extra:
        even = {labels[f"utt{u}"] for u in range(0, 8, 2)}
        odd = {labels[f"utt{u}"] for u in range(1, 8, 2)}
        assert len(even) == 1 and len(odd) == 1 and even != odd


def test_xvector_errors_match_jax(tmp_path, sb_old):
    corp = speaker_corpus(tmp_path)
    with pytest.raises(ValueError, match="--xvector_model_path"):
        cli_main(["diarize_speakers", str(corp), "speechbrain", str(tmp_path / "o"),
                  "--device", "cpu"])
    ckpt = tmp_path / "ck"
    ckpt.mkdir()
    with pytest.raises(ValueError, match="--metric plda is not available"):
        cli_main(["diarize_speakers", str(corp), "speechbrain", str(tmp_path / "o"),
                  "--device", "cpu", "--xvector_model_path", str(ckpt),
                  "--metric", "plda"])


def test_online_speechbrain_matches_jax(sb_old):
    from montreal_forced_aligner_tpu.online.transcription import (
        transcribe_utterance_online_speechbrain as jonline,
    )
    from montreal_forced_aligner_tpu_torch.online.transcription import (
        transcribe_utterance_online_speechbrain as ponline,
    )

    wave = np.random.RandomState(0).randn(40000).astype(np.float32) * 1000
    for rate in (16000, 8000):
        want = jonline("/", wave, rate)
        assert ponline("/", wave, rate, device="cpu") == want
        assert want.split() == ["mock"] * int(len(wave) * 16000 / rate // 16000)


def test_surface_contract_holds_the_port_mock(sb):
    """Both stand-ins provide exactly the pinned surface, and the port's
    wrappers consume nothing outside it."""
    assert not check_surface(importlib.import_module)
    pinned_methods = {m for classes in SPEECHBRAIN_SURFACE.values()
                      for methods in classes.values() for m in methods}
    pinned_classes = {c for classes in SPEECHBRAIN_SURFACE.values() for c in classes}
    root = Path(__file__).parent.parent / "montreal_forced_aligner_tpu_torch"
    for rel in ("transcription/torch_models.py", "vad/segmenter.py",
                "diarization/embeddings.py"):
        src = (root / rel).read_text()
        assert "speechbrain" in src
        for mod, name in re.findall(r"from (speechbrain[\w.]*) import (\w+)", src):
            assert mod in SPEECHBRAIN_SURFACE and name in SPEECHBRAIN_SURFACE[mod], rel
        for cls in pinned_classes:
            for m in re.findall(rf"{cls}\.(\w+)\(", src):
                assert m in pinned_methods, (rel, m)


def test_port_mock_puts_models_on_the_device(tmp_path):
    """The port's stand-in honours ``run_opts["device"]`` and records its
    inputs' device; its outputs equal the old stand-in's."""
    from montreal_forced_aligner_tpu_torch.diarization.embeddings import XVectorEmbedder
    from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
        SpeechbrainTranscriber,
    )
    from montreal_forced_aligner_tpu_torch.vad.segmenter import SpeechbrainVAD

    wave = (np.sin(np.arange(40000) * 0.07) * 4000).astype(np.float32)
    outs = {}
    for name, mock in MOCKS.items():
        mock.install()
        try:
            ck = tmp_path / name
            ck.mkdir()
            asr = SpeechbrainTranscriber(ck, device="cpu")
            vad = SpeechbrainVAD(ck, device="cpu")
            emb = XVectorEmbedder(ck, device="cpu")
            outs[name] = (asr.transcribe(wave), vad.voiced_frames(wave),
                          emb.embed(wave))
            if name == "port":
                for w in (asr, vad, emb):
                    assert w.model.device == torch.device("cpu")
                    assert w.model.input_device == torch.device("cpu")
                assert {p.device.type for p in emb.model.parameters()} == {"cpu"}
        finally:
            mock.uninstall()
    assert outs["old"][0] == outs["port"][0]
    assert np.array_equal(outs["old"][1], outs["port"][1])
    np.testing.assert_array_equal(outs["old"][2], outs["port"][2])


def test_missing_package_and_checkpoint(tmp_path):
    from montreal_forced_aligner_tpu_torch.diarization.embeddings import XVectorEmbedder
    from montreal_forced_aligner_tpu_torch.transcription.torch_models import (
        SpeechbrainTranscriber,
    )
    from montreal_forced_aligner_tpu_torch.vad.segmenter import SpeechbrainVAD

    for cls, msg in ((SpeechbrainTranscriber, "speechbrain is not available"),
                     (SpeechbrainVAD, "speechbrain is not available; neural VAD"),
                     (XVectorEmbedder, "speechbrain is not available; x-vector")):
        with pytest.raises(RuntimeError, match=msg):
            cls(tmp_path, device="cpu")
    torch_mock_speechbrain.install()
    try:
        for cls, msg in ((SpeechbrainTranscriber, "no local SpeechBrain checkpoint"),
                         (SpeechbrainVAD, "no local SpeechBrain VAD checkpoint"),
                         (XVectorEmbedder, "no local SpeechBrain speaker checkpoint")):
            with pytest.raises(FileNotFoundError, match=msg):
                cls(tmp_path / "missing", device="cpu")
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match="no CUDA device"):
                    cls(tmp_path)
    finally:
        torch_mock_speechbrain.uninstall()
