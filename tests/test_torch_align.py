"""The PyTorch port's ``align`` slice end to end, against the JAX package,
on the CPU (the port's plain PyTorch versions of its kernels).

* Mono model: phone and word intervals identical to the JAX package's, and
  the same TextGrid text.
* SAT-scale model (reduced) in speaker-independent mode, with the port's
  state-emission path forced on: the JAX package's parity bar
  (``tests/test_parity_sweep.py``: >= 99.9% of frames agree, >= 99.5% of
  boundaries within one frame, scores within 5 nats); with the emission
  path off the port gives the same intervals.
* What the slice does not serve raises; the port never imports JAX.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import montreal_forced_aligner_tpu.align.aligner as JA
import montreal_forced_aligner_tpu_torch.align.aligner as PA
from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
from montreal_forced_aligner_tpu_torch.device import resolve_device
from montreal_forced_aligner_tpu_torch.io.wav import read_wave

from helpers import build_sat_scale_model, build_synthetic_corpus, build_synthetic_model

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

PORT = REPO / "montreal_forced_aligner_tpu_torch"


def _intervals(results):
    return {
        k: (
            [(p.label, round(p.begin, 6), round(p.end, 6)) for p in a.phones],
            [(w.label, round(w.begin, 6), round(w.end, 6)) for w in a.words],
        )
        for k, a in results.items()
    }


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mono")
    corpus_dir, wave = build_synthetic_corpus(tmp)
    model_path, dict_path = build_synthetic_model(tmp, wave=wave)
    return tmp, corpus_dir, model_path, dict_path


@pytest.mark.parametrize("boost", [1.0, 3.0])
def test_mono_slice_matches_jax(mono, boost):
    tmp, corpus_dir, model_path, dict_path = mono
    jal = JA.PretrainedAligner(
        model_path, dict_path, JA.AlignerConfig(batch_size=4, boost_silence=boost)
    )
    jcorp = JCorpus.load(corpus_dir)
    want = jal.align_corpus(jcorp)
    pal = PA.PretrainedAligner(
        model_path, dict_path,
        PA.AlignerConfig(batch_size=4, boost_silence=boost), device="cpu",
    )
    pcorp = PCorpus.load(corpus_dir)
    got = pal.align_corpus(pcorp)
    assert _intervals(got) == _intervals(want)
    assert [w.label for w in got[0].words] == ["ab", "a"]
    assert abs(got[0].log_likelihood - want[0].log_likelihood) < 1e-2
    j_out = jal.export_textgrids(jcorp, want, tmp / f"tg_jax{boost}")
    p_out = pal.export_textgrids(pcorp, got, tmp / f"tg_port{boost}")
    assert [p.name for p in p_out] == [p.name for p in j_out]
    for a, b in zip(p_out, j_out):
        assert a.read_text() == b.read_text()


def test_cli_aligns_on_cpu(mono, tmp_path):
    _tmp, corpus_dir, model_path, dict_path = mono
    out = tmp_path / "out"
    rc = cli_main(["align", str(corpus_dir), str(dict_path), str(model_path),
                   str(out), "--device", "cpu", "--batch_size", "2"])
    assert rc == 0
    tg = out / "utt1.TextGrid"
    assert tg.exists() and '"ab"' in tg.read_text()


@pytest.fixture(scope="module")
def sat(tmp_path_factory):
    """Reduced SAT-scale model and a corpus of short utterances."""
    tmp = tmp_path_factory.mktemp("sat")
    model_path, dict_path = build_sat_scale_model(
        tmp, num_phones=6, gauss_per_pdf=4, num_words=20
    )
    words = [line.split("\t")[0] for line in dict_path.read_text().splitlines()]
    corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 5, min_s=1.5, max_s=4.0)
    return model_path, dict_path, corpus_dir


def test_sat_scale_si_slice_meets_parity_bar(sat):
    model_path, dict_path, corpus_dir = sat
    jal = JA.PretrainedAligner(
        model_path, dict_path,
        JA.AlignerConfig(batch_size=3, uses_speaker_adaptation=False),
    )
    want = jal.align_corpus(JCorpus.load(corpus_dir))
    cfg = PA.AlignerConfig(batch_size=3, uses_speaker_adaptation=False)
    pal = PA.PretrainedAligner(model_path, dict_path, cfg, device="cpu")
    assert not pal.use_emission_kernel  # P*G is below the threshold here
    pal.use_emission_kernel = True
    got = pal.align_corpus(PCorpus.load(corpus_dir))
    report = chip_smoke.parity(got, want, pal.frame_shift)
    assert report["frames"] > 500
    # the all-pdf emission path gives the same alignment
    pal.use_emission_kernel = False
    assert _intervals(pal.align_corpus(PCorpus.load(corpus_dir))) == _intervals(got)


def test_sat_model_with_adaptation_raises(sat):
    model_path, dict_path, _ = sat
    with pytest.raises(NotImplementedError, match="two-pass fMLLR"):
        PA.PretrainedAligner(model_path, dict_path, PA.AlignerConfig(),
                             device="cpu")


def test_emission_rule():
    assert PA._emission_kernel_eligible(5045, 32)
    assert PA._emission_kernel_eligible(512, 32)
    assert not PA._emission_kernel_eligible(150, 4)
    assert PA._emission_kernel_eligible(4, 4096)  # no cap on G


@pytest.mark.parametrize(
    "kwargs",
    [
        {"transfer_mode": "features"},
        {"compute_confidence": True},
        {"num_graph_workers": 2},
        {"distributed": True},
        {"language": "english"},
    ],
    ids=lambda k: next(iter(k)),
)
def test_unserved_settings_raise(mono, kwargs):
    _tmp, _corpus_dir, model_path, dict_path = mono
    with pytest.raises(NotImplementedError, match="ROADMAP|waves"):
        PA.PretrainedAligner(model_path, dict_path, PA.AlignerConfig(**kwargs),
                             device="cpu")


def test_g2p_and_rules_raise(mono):
    _tmp, _corpus_dir, model_path, dict_path = mono
    for kw in ({"g2p_model_path": "g2p.zip"}, {"rules_path": "rules.yaml"}):
        with pytest.raises(NotImplementedError):
            PA.PretrainedAligner(model_path, dict_path, device="cpu", **kw)
    with pytest.raises(NotImplementedError):
        cli_main(["align", "c", str(dict_path), str(model_path), "o",
                  "--device", "cpu", "--language", "english"])


def test_long_utterances_raise(mono, monkeypatch):
    _tmp, corpus_dir, model_path, dict_path = mono
    monkeypatch.setattr(PA, "LONG_UTTERANCE_FRAMES", 50)
    pal = PA.PretrainedAligner(model_path, dict_path, device="cpu")
    with pytest.raises(NotImplementedError, match="long utterances"):
        pal.align_corpus(PCorpus.load(corpus_dir))


def test_compressed_audio_raises(tmp_path):
    for ext in ("flac", "mp3", "opus"):
        with pytest.raises(NotImplementedError):
            read_wave(tmp_path / f"a.{ext}")


def test_cuda_default_raises_without_card(mono):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _tmp, _corpus_dir, model_path, dict_path = mono
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PA.PretrainedAligner(model_path, dict_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PA.PretrainedAligner(model_path, dict_path, device="cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_names_no_jax_in_any_import():
    """Every import statement of the port and of chip_smoke.py, lazy ones
    included."""
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "montreal_forced_aligner_tpu",
                                    "mfa_tpu"), (path, name)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import montreal_forced_aligner_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'montreal_forced_aligner_tpu')]\n"
        "assert not bad, bad\n"
        "assert len(mods) > 25, mods\n"
        "print('ok', len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_fails_without_its_package(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_chip_smoke_phases_run_on_cpu(tmp_path, monkeypatch):
    """The script's phases at a tiny size on the CPU, where every wrapper
    takes its plain version: the fixture, the main path with its checks and
    captures, the reference check, and the kernel lines."""
    monkeypatch.setattr(PA, "_emission_kernel_eligible", lambda P, G: True)
    cpu = torch.device("cpu")
    model_path, dict_path, words = chip_smoke.build_sat_scale_model(
        tmp_path, num_phones=5, gauss_per_pdf=3, num_words=15
    )
    corpus_dir, audio_s = chip_smoke.build_corpus(tmp_path, words, 5, 1.5, 3.0)
    report, aligner, captured = chip_smoke.run_main_path(
        model_path, dict_path, corpus_dir, tmp_path / "tg", cpu, batch_size=3
    )
    assert report["utterances"] == 5 and report["textgrids"] == 5
    assert abs(report["audio_s"] - audio_s) < 1e-3
    assert report["launches"] == {
        "band_forward": 0, "band_backtrace": 0, "state_emission": 0
    }
    assert all(v is not None for v in captured.values())
    assert chip_smoke.reference_check(model_path, dict_path, corpus_dir, cpu)[
        "frame_agreement"] == 1.0
    checks = chip_smoke.kernel_checks(captured, aligner.gmm, cpu, reps=1)
    line = chip_smoke.kernels_line(checks, {k: 2 for k in checks})
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [k["name"] for k in line["kernels"]] == [
        "band_forward", "band_backtrace", "state_emission"]
    for k in line["kernels"]:
        assert set(k) == keys
        assert k["max_abs_err"] == 0.0 and k["bound_ms"] > 0
        assert (REPO / k["source"]).is_file()
        src, lineno = k["replaces"].split(":")
        assert "pallas_call" in (REPO / src).read_text().splitlines()[int(lineno) - 1]
