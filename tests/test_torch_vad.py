"""The port's segmentation (``vad/*``, ``create_segments_vad``,
``create_segments``) against the JAX package's, on the CPU.

* The frame log energy within atol 1e-4; voiced masks identical except
  frames within 1e-4 of the threshold; ``segments_from_vad`` identical.
* ``create_segments_vad`` in all four formats: the same files as the JAX
  command's on a flat corpus. Files of one name in two speaker
  directories keep their own outputs in the port (the JAX package writes
  both to one path).
* ``create_segments`` on the "ab a" corpus of ``tests/helpers.py``: the
  same segment texts as the JAX command's, boundaries within one frame.
* The neural VAD (SpeechBrain) through the port's stand-in package: the
  JAX package's segments; its missing-package and checkpoint errors.
"""

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import montreal_forced_aligner_tpu.cli as JCLI
import montreal_forced_aligner_tpu.vad.segmenter as JV
import montreal_forced_aligner_tpu_torch.vad.segmenter as PV
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.io.textgrid import TextGrid
from montreal_forced_aligner_tpu_torch.io.wav import write_wave

from helpers import build_synthetic_corpus, build_synthetic_model
from test_ivector import SR, make_speaker_wave


@pytest.fixture(autouse=True)
def stores(tmp_path, monkeypatch):
    """The JAX CLI's history and temporary stores in this test's directory."""
    monkeypatch.setenv("MFA_TPU_MODEL_ROOT", str(tmp_path / "models"))
    monkeypatch.setenv("MFA_TPU_TEMP_DIR", str(tmp_path / "mfa"))


def vad_wave(rng, total_s):
    """Speech bursts of 0.5-4 s between pauses of 0.1-2.0 s of low noise."""
    pieces, t = [], 0.0
    while t < total_s:
        pause = rng.randn(int((0.1 + 1.9 * rng.rand()) * SR)) * 20
        burst = make_speaker_wave(rng, rng.randint(2), 0.5 + 3.5 * rng.rand())
        pieces += [pause, burst]
        t += (len(pause) + len(burst)) / SR
    return np.concatenate(pieces).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_energy_and_voiced_frames_match_jax(seed):
    import jax.numpy as jnp

    from montreal_forced_aligner_tpu.ops.mfcc import (
        MfccConfig as JMfcc,
        pad_waves_for_mfcc as j_pad,
    )

    wave = vad_wave(np.random.RandomState(seed), 20.0)
    cfg = JMfcc()
    padded, _ = j_pad([wave], cfg)
    T = cfg.num_frames(len(wave))
    want = np.asarray(JV._frame_log_energy(jnp.asarray(padded), cfg, T))[0, :T]
    got = PV.frame_log_energy(wave, device="cpu")
    assert got.shape == want.shape == (T,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    voiced_p = PV.compute_energy_vad(wave, device="cpu")
    voiced_j = JV.compute_energy_vad(wave)
    thr = 5.5 + 0.5 * want.mean()
    differ = voiced_p != voiced_j
    assert np.all(np.abs(want[differ] - thr) < 1e-4)
    assert voiced_p.sum() > 0 and (~voiced_p).sum() > 0
    for kw in ({}, dict(min_pause_duration=0.05, max_segment_length=2.0)):
        pc, jc = PV.SegmenterConfig(**kw), JV.SegmenterConfig(**kw)
        assert PV.segments_from_vad(voiced_j, pc) == JV.segments_from_vad(voiced_j, jc)
    assert PV.segments_from_vad(voiced_p, PV.SegmenterConfig()) == \
        JV.segments_from_vad(voiced_j, JV.SegmenterConfig())


@pytest.fixture(scope="module")
def vad_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("vad") / "corpus"
    root.mkdir()
    rng = np.random.RandomState(4)
    for i in range(3):
        write_wave(root / f"file{i}.wav", vad_wave(rng, 12.0), SR)
    return root


def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("fmt", ["long_textgrid", "short_textgrid", "json", "csv"])
def test_create_segments_vad_matches_jax(vad_corpus, tmp_path, capsys, fmt):
    opts = ["--output_format", fmt, "--min_pause_duration", "0.25"]
    rc = cli_main(["create_segments_vad", str(vad_corpus), str(tmp_path / "port"),
                   "--device", "cpu", "-j", "2"] + opts)
    assert rc == 0
    assert "Wrote 3 segment files" in capsys.readouterr().out
    r = CliRunner().invoke(JCLI.cli, ["create_segments_vad", str(vad_corpus),
                                      str(tmp_path / "jax")] + opts,
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(got) == sorted(want) and len(got) == 3
    for name in want:
        assert got[name] == want[name], name
    # segment_corpus is the command's own work
    paths = PV.VadSegmenter(PV.SegmenterConfig(min_pause_duration=0.25),
                            device="cpu").segment_corpus(
        vad_corpus, tmp_path / "api", output_format=fmt)
    assert [p.read_bytes() for p in paths] == [want[n] for n in sorted(want)]


def test_same_file_names_in_two_speaker_directories(tmp_path):
    """``spk0/u1.wav`` and ``spk1/u1.wav`` get one output each, at their
    corpus-relative paths."""
    rng = np.random.RandomState(8)
    for spk in ("spk0", "spk1"):
        (tmp_path / "c" / spk).mkdir(parents=True)
        write_wave(tmp_path / "c" / spk / "u1.wav", vad_wave(rng, 6.0), SR)
    seg = PV.VadSegmenter(device="cpu")
    paths = seg.segment_corpus(tmp_path / "c", tmp_path / "out")
    rel = sorted(p.relative_to(tmp_path / "out").as_posix() for p in paths)
    assert rel == ["spk0/u1.TextGrid", "spk1/u1.TextGrid"]
    tiers = [TextGrid.read(p).tiers["segments"] for p in paths]
    assert tiers[0] != tiers[1]
    # the JAX package writes both to out/u1.TextGrid
    jpaths = JV.VadSegmenter().segment_corpus(tmp_path / "c", tmp_path / "jout")
    assert len(jpaths) == 2 and len(set(jpaths)) == 1


def test_neural_vad_raises(tmp_path):
    """The neural VAD raises the JAX package's error without the
    speechbrain package, and a missing checkpoint's; through the port's
    stand-in package it runs, with the JAX package's segments; the default
    device raises without a card."""
    import torch_mock_speechbrain

    with pytest.raises(RuntimeError, match="speechbrain is not available; neural VAD"):
        PV.SpeechbrainVAD(tmp_path, device="cpu")
    with pytest.raises(RuntimeError, match="speechbrain is not available; neural VAD"):
        cli_main(["create_segments_vad", str(tmp_path), str(tmp_path / "o"),
                  "--speechbrain_model_path", str(tmp_path), "--device", "cpu"])
    corpus = tmp_path / "c"
    (corpus / "spk0").mkdir(parents=True)
    write_wave(corpus / "spk0" / "u1.wav", vad_wave(np.random.RandomState(3), 6.0), SR)
    ckpt = tmp_path / "sb_vad"
    ckpt.mkdir()
    torch_mock_speechbrain.install()
    try:
        with pytest.raises(FileNotFoundError, match="no local SpeechBrain VAD checkpoint"):
            PV.SpeechbrainVAD(tmp_path / "missing", device="cpu")
        assert cli_main(["create_segments_vad", str(corpus), str(tmp_path / "o"),
                         "--speechbrain_model_path", str(ckpt), "--device", "cpu"]) == 0
        got = [(i.begin, i.end) for i in
               TextGrid.read(tmp_path / "o" / "spk0" / "u1.TextGrid").tiers["segments"]
               if i.label]
        want = JV.SpeechbrainVadSegmenter(ckpt).segment_file(corpus / "spk0" / "u1.wav")
        assert len(want) >= 2
        np.testing.assert_allclose(got, want, atol=1e-9)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                PV.SpeechbrainVadSegmenter(ckpt)
    finally:
        torch_mock_speechbrain.uninstall()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli_main(["create_segments_vad", str(tmp_path), str(tmp_path / "o")])


def test_create_segments_matches_jax(tmp_path, capsys):
    corpus_dir, wave = build_synthetic_corpus(tmp_path, text="ab a")
    model_path, dict_path = build_synthetic_model(tmp_path, wave=wave)
    opts = ["--min_pause_duration", "0.2", "--max_segment_length", "1.0"]
    rc = cli_main(["create_segments", str(corpus_dir), str(dict_path),
                   str(model_path), str(tmp_path / "port"), "--device", "cpu",
                   "-j", "2"] + opts)
    assert rc == 0
    assert "Segmented 1 files into 2 utterances" in capsys.readouterr().out
    r = CliRunner().invoke(JCLI.cli, ["create_segments", str(corpus_dir),
                                      str(dict_path), str(model_path),
                                      str(tmp_path / "jax")] + opts,
                           catch_exceptions=False)
    assert r.exit_code == 0, r.output
    names = sorted(p.name for p in (tmp_path / "jax").glob("*.TextGrid"))
    assert names == sorted(p.name for p in (tmp_path / "port").glob("*.TextGrid"))
    for name in names:
        # the reader fills the gaps between segments with empty intervals
        got = [i for i in TextGrid.read(tmp_path / "port" / name).tiers["segments"]
               if i.label]
        want = [i for i in TextGrid.read(tmp_path / "jax" / name).tiers["segments"]
                if i.label]
        assert [i.label for i in got] == [i.label for i in want] == ["ab", "a"]
        for g, w in zip(got, want):
            assert abs(g.begin - w.begin) <= 0.01 + 1e-9
            assert abs(g.end - w.end) <= 0.01 + 1e-9


@pytest.mark.parametrize("command,positional", [
    ("train_ivector", ["c", "m"]),
    ("diarize_speakers", ["c", "m", "o"]),
    ("create_segments_vad", ["c", "o"]),
    ("create_segments", ["c", "d", "m", "o"]),
])
def test_every_jax_option_parses(command, positional):
    """Every option of the JAX package's command parses in the port's (an
    unknown option makes argparse exit)."""
    import montreal_forced_aligner_tpu_torch.cli as PCLI

    values = {"cluster_type": "kmeans", "metric": "plda", "output_format": "csv",
              "manifold_algorithm": "mds", "xvector_model_path": "x",
              "speechbrain_model_path": "x", "config_path": "x.yaml"}
    parser = PCLI._parser()
    seen = 0
    for param in JCLI.cli.commands[command].params:
        if param.param_type_name != "option":
            continue
        for opt in param.opts + param.secondary_opts:
            argv = [command, *positional, opt]
            if not param.is_flag:
                argv.append(values.get(param.name, "3"))
            args = parser.parse_args(argv)
            assert args.device == "cuda"
            seen += 1
    assert seen >= 4
