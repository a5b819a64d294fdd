"""The "features" transfer mode of the port on the CPU: phase A ships
float16 MFCCs computed on the host (``ops.mfcc.mfcc_host_batch``) in
place of int16 waves, in ``align``, training and ``transcribe``.

* ``mfcc_host_batch`` equals the JAX package's bit for bit on the same
  seeded waves; ``_mfcc_host_torch`` is within rtol 1e-5 / atol 1e-4 of
  the JAX package's (another FFT).
* The resolver: the JAX package's forcing rules
  (``tests/test_transfer_mode.py``), and "auto" on a card against the
  threshold variable with the probe replaced.
* Features against waves in the port, at the JAX test's bar: the same
  phone labels, boundaries within 0.011 s (one frame), at least 90% of
  them exact (float16 shipping quantizes about 1e-3 relative, so a
  boundary may move at a tie): ``align``, ``train`` (mono -> tri) and
  ``transcribe``.
* The port's features-mode intervals against the JAX package's, at the
  JAX parity bar.
* ``train --distributed`` at W = 2 (gloo on the CPU) with features, at the
  JAX distributed test's bars against the single features run.
"""

import os

import numpy as np
import pytest
import torch

import montreal_forced_aligner_tpu.align.aligner as JA
import montreal_forced_aligner_tpu.ops.mfcc as JM
import montreal_forced_aligner_tpu_torch.align.aligner as PA
import montreal_forced_aligner_tpu_torch.ops.mfcc as PM
import montreal_forced_aligner_tpu_torch.transcription.transcriber as PT
from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
from montreal_forced_aligner_tpu_torch.parallel.multihost import run_ranks

from helpers import build_synthetic_corpus, build_synthetic_model
from test_torch_distributed import (
    RANK_TIMEOUT,
    _at_bars,
    _summary,
    _train_port,
    _write_dict,
)

import chip_smoke


def jax_transfer_bar(r_w, r_f):
    """The JAX package's bar for features against waves
    (``tests/test_transfer_mode.py``): the same utterances and phone
    labels, every boundary within one frame, at least 90% of each
    utterance's exact."""
    chip_smoke.transfer_bar(r_w, r_f)


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("transfer")
    corpus_dir, wave = build_synthetic_corpus(tmp, text="ab a")
    model_path, dict_path = build_synthetic_model(tmp, wave=wave)
    return tmp, corpus_dir, model_path, dict_path


def _padded_waves(seed, as_int16):
    rng = np.random.RandomState(seed)
    waves = []
    for n in (16000, 9100, 23457):
        w = rng.randn(n) * 3000.0 + 500.0 * np.sin(np.arange(n) * 0.05)
        waves.append(np.round(w).astype(np.int16) if as_int16
                     else w.astype(np.float32))
    cfg = PM.MfccConfig()
    L = 24000
    padded, _lens = PM.pad_waves_for_mfcc(waves, cfg, L)
    return padded, cfg, cfg.num_frames(L)


@pytest.mark.parametrize("as_int16", [True, False])
def test_host_mfcc_matches_jax(as_int16):
    padded, cfg, T = _padded_waves(3, as_int16)
    jcfg = JM.MfccConfig()
    got = PM.mfcc_host_batch(padded, cfg, T)
    want = JM.mfcc_host_batch(padded, jcfg, T)
    assert got.dtype == np.float32 and got.shape == (3, T, 13)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(PM._mfcc_host_torch(padded, cfg, T),
                               JM._mfcc_host_torch(padded, jcfg, T),
                               rtol=1e-5, atol=1e-4)
    # and the device program's features (here the CPU's) agree with it
    dev = PM._mfcc_device(torch.from_numpy(padded), cfg, T).numpy()
    np.testing.assert_allclose(dev, got, rtol=1e-5, atol=1e-4)


def test_resolve_transfer_mode_forcing(monkeypatch):
    """The JAX package's forcing rules: the variable wins, then the
    request; "auto" is waves on the CPU."""
    monkeypatch.setenv("MFA_TPU_TRANSFER_MODE", "features")
    assert PA.resolve_transfer_mode("auto", device="cpu") == "features"
    monkeypatch.setenv("MFA_TPU_TRANSFER_MODE", "waves")
    assert PA.resolve_transfer_mode("features", device="cpu") == "waves"
    monkeypatch.delenv("MFA_TPU_TRANSFER_MODE")
    assert PA.resolve_transfer_mode("features", device="cpu") == "features"
    assert PA.resolve_transfer_mode("waves", device="cpu") == "waves"
    assert PA.resolve_transfer_mode("auto", device="cpu") == "waves"


def test_auto_on_a_card_follows_the_probe_and_the_threshold(monkeypatch):
    """"auto" on a card: features below ``MFA_TPU_TRANSFER_THRESHOLD_MBPS``
    (default 25 MB/s), waves above; the reading is kept ``ttl_s`` seconds.
    The card and the probe are stood in for."""
    monkeypatch.delenv("MFA_TPU_TRANSFER_MODE", raising=False)
    monkeypatch.delenv("MFA_TPU_TRANSFER_THRESHOLD_MBPS", raising=False)
    monkeypatch.setattr(PA, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(PA, "_transfer_probe_cache",
                        {"t": 0.0, "mode": None, "rate": None})
    rate = {"v": 10.0}
    probes = []

    def probe(device="cuda"):
        probes.append(device)
        return rate["v"]

    monkeypatch.setattr(PA, "_probe_h2d_MBps", probe)
    assert PA.resolve_transfer_mode("auto", ttl_s=0.0) == "features"
    rate["v"] = 30.0
    assert PA.resolve_transfer_mode("auto", ttl_s=0.0) == "waves"
    monkeypatch.setenv("MFA_TPU_TRANSFER_THRESHOLD_MBPS", "40")
    assert PA.resolve_transfer_mode("auto", ttl_s=0.0) == "features"
    assert PA._transfer_probe_cache["rate"] == 30.0
    # within the time to live the reading is reused, not taken again
    n = len(probes)
    rate["v"] = 1000.0
    assert PA.resolve_transfer_mode("auto", ttl_s=3600.0) == "features"
    assert len(probes) == n
    # an explicit request never probes
    assert PA.resolve_transfer_mode("waves", ttl_s=0.0) == "waves"
    assert len(probes) == n


def test_align_features_match_waves_and_jax(mono):
    _tmp, corpus_dir, model_path, dict_path = mono
    runs = {}
    for mode in ("waves", "features"):
        al = PA.PretrainedAligner(model_path, dict_path,
                                  PA.AlignerConfig(batch_size=4, transfer_mode=mode),
                                  device="cpu")
        runs[mode] = al.align_corpus(PCorpus.load(corpus_dir))
        assert al.last_transfer_mode == mode
    jax_transfer_bar(runs["waves"], runs["features"])
    jal = JA.PretrainedAligner(model_path, dict_path,
                               JA.AlignerConfig(batch_size=4, transfer_mode="features"))
    want = jal.align_corpus(JCorpus.load(corpus_dir))
    assert jal.last_transfer_mode == "features"
    chip_smoke.parity(runs["features"], want, 0.01)  # raises below the bar


def test_train_features_match_waves(tmp_path, monkeypatch):
    """A mono -> tri recipe trained on host features against one trained
    on waves: the same stages, pdfs and Gaussian counts at every iteration,
    log-likelihoods per frame within 1e-4 relative (the features are
    float16-quantized, about 1e-3 relative of each value), and the two
    models align the corpus at the transfer bar."""
    from test_training import make_training_corpus

    corpus_dir, _truths = make_training_corpus(tmp_path, n_utts=6)
    dict_path = _write_dict(tmp_path / "train.dict")
    out = {}
    for mode in ("waves", "features"):
        monkeypatch.setenv("MFA_TPU_TRANSFER_MODE", mode)
        ta, model = _train_port(corpus_dir, dict_path)
        assert ta.pipeline.last_transfer_mode == mode
        path = tmp_path / f"{mode}.zip"
        model.save(path)
        out[mode] = (_summary(ta, model), path)
    got, want = out["features"][0], out["waves"][0]
    assert got["num_pdfs"] == want["num_pdfs"]
    assert list(got["logs"]) == list(want["logs"])
    for stage in want["logs"]:
        (ll_g, n_g), (ll_w, n_w) = zip(*got["logs"][stage]), zip(*want["logs"][stage])
        assert list(n_g) == list(n_w), stage
        np.testing.assert_allclose(ll_g, ll_w, rtol=1e-4, atol=0)
    aligned = {mode: PA.PretrainedAligner(path, dict_path,
                                          PA.AlignerConfig(batch_size=4),
                                          device="cpu").align_corpus(
                                              PCorpus.load(corpus_dir))
               for mode, (_s, path) in out.items()}
    jax_transfer_bar(aligned["waves"], aligned["features"])


def test_transcribe_features_match_waves(mono, monkeypatch):
    """``MFA_TPU_TRANSFER_MODE=features`` on ``transcribe``: the same
    transcripts, words within one frame of the waves run's."""
    _tmp, corpus_dir, model_path, dict_path = mono
    runs = {}
    for mode in ("waves", "features"):
        monkeypatch.setenv("MFA_TPU_TRANSFER_MODE", mode)
        tr = PT.Transcriber(model_path, dict_path, batch_size=2, device="cpu")
        runs[mode] = tr.transcribe_corpus(PCorpus.load(corpus_dir))
        assert tr.last_transfer_mode == mode
    assert sorted(runs["waves"]) == sorted(runs["features"])
    for i, w in runs["waves"].items():
        f = runs["features"][i]
        assert f.text == w.text and w.text
        assert [x.label for x in f.words] == [x.label for x in w.words]
        for a, b in zip(w.words, f.words):
            assert abs(a.begin - b.begin) <= 0.011 and abs(a.end - b.end) <= 0.011


def _train_rank_features(rank, world, corpus_dir, dict_path):
    os.environ["MFA_TPU_TRANSFER_MODE"] = "features"  # this rank's process
    ta, model = _train_port(corpus_dir, dict_path, distributed=True)
    return ta.pipeline.last_transfer_mode, _summary(ta, model)


def test_distributed_train_with_features(tmp_path, monkeypatch):
    from test_training import make_training_corpus

    corpus_dir, _truths = make_training_corpus(tmp_path, n_utts=10)
    dict_path = _write_dict(tmp_path / "train.dict")
    ranks = run_ranks(_train_rank_features, 2,
                      args=(str(corpus_dir), str(dict_path)),
                      timeout=RANK_TIMEOUT, threads=2)
    monkeypatch.setenv("MFA_TPU_TRANSFER_MODE", "features")
    ta, model = _train_port(corpus_dir, dict_path)
    single = _summary(ta, model)
    (m0, r0), (m1, r1) = ranks
    assert m0 == m1 == "features"
    assert r0["utterances"] + r1["utterances"] == single["utterances"]
    assert r0["logs"] == r1["logs"]
    _at_bars(r0, single)
