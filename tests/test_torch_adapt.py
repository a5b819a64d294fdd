"""The port's MAP adaptation (``training/adapt.py``, ``mfa adapt``) against
the JAX package's ``MapAdapter``, on the CPU.

* Mono model: adapted means within rtol 1e-5 of each tensor's largest
  value of the JAX package's.
* SAT model (fMLLR two-pass): pass-1 state paths equal, per-speaker fMLLR
  transforms within atol 1e-3 (the two packages' solves on float32
  statistics summed in another order), and, with the JAX package's
  transforms, the final and the speaker-independent models' means within
  rtol 1e-5 of each tensor's largest value.
* Both: inverse variances, weights and transitions bit-identical to the
  input model's (only the means update); two runs identical; the adapted
  archive aligns every utterance in both packages, at the JAX package's
  parity bar between them; the ``adapt`` command (with ``-j``) writes an
  archive and TextGrids.
"""

import numpy as np
import pytest

import montreal_forced_aligner_tpu.training.adapt as JAD
import montreal_forced_aligner_tpu_torch.training.adapt as PAD
from montreal_forced_aligner_tpu.align.aligner import (
    AlignerConfig as JConfig,
    PretrainedAligner as JAligner,
)
from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
from montreal_forced_aligner_tpu_torch.align.aligner import (
    AlignerConfig as PConfig,
    PretrainedAligner as PAligner,
)
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
from montreal_forced_aligner_tpu_torch.models.acoustic_model import (
    AcousticModel as PModel,
)

from helpers import build_sat_scale_model, build_synthetic_corpus, build_synthetic_model


def close_to_scale(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    scale = np.abs(want[fin]).max()
    err = np.abs(got[fin] - want[fin]).max()
    assert err <= rtol * scale, (err, scale)


def same_but_means(adapted, original):
    """Only the means moved: inverse variances, weights and Gaussian counts
    bit-identical, means not."""
    np.testing.assert_array_equal(adapted.inv_vars, original.inv_vars)
    np.testing.assert_array_equal(adapted.weights, original.weights)
    np.testing.assert_array_equal(adapted.num_gauss, original.num_gauss)
    assert not np.array_equal(adapted.means_invvars, original.means_invvars)


def same_transitions(a, b):
    np.testing.assert_array_equal(a.transition_model.log_probs,
                                  b.transition_model.log_probs)
    assert a.transition_model.num_transition_ids == b.transition_model.num_transition_ids


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("adapt_mono")
    corpus_dir, wave = build_synthetic_corpus(tmp)
    model_path, dict_path = build_synthetic_model(tmp, wave=wave)
    return tmp, model_path, dict_path, corpus_dir


@pytest.fixture(scope="module")
def sat(tmp_path_factory):
    """The reduced SAT model and 6 utterances over 2 speakers, both passing
    fmllr_min_count; the JAX package's adaptation with its transforms and
    pass-1 paths recorded."""
    import chip_smoke

    tmp = tmp_path_factory.mktemp("adapt_sat")
    model_path, dict_path = build_sat_scale_model(
        tmp, num_phones=6, gauss_per_pdf=4, num_words=20
    )
    words = [line.split("\t")[0] for line in dict_path.read_text().splitlines()]
    corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 6, min_s=2.5, max_s=5.0,
                                            num_speakers=2)
    rec = {}
    real = JAD.MapAdapter._estimate_fmllr

    def recording(self, pipeline, gmm):
        rec["paths"] = [np.asarray(fb.host_state_path()) for fb in pipeline.batches]
        rec["transforms"] = real(self, pipeline, gmm)
        return rec["transforms"]

    JAD.MapAdapter._estimate_fmllr = recording
    try:
        want = JAD.MapAdapter(model_path, dict_path, 20.0,
                              JConfig(batch_size=4)).adapt(corpus_dir)
    finally:
        JAD.MapAdapter._estimate_fmllr = real
    return tmp, model_path, dict_path, corpus_dir, want, rec


def test_mono_adapt_matches_jax(mono):
    _tmp, model_path, dict_path, corpus_dir = mono
    want = JAD.MapAdapter(model_path, dict_path, 20.0,
                          JConfig(batch_size=4)).adapt(corpus_dir)
    adapter = PAD.MapAdapter(model_path, dict_path, 20.0, PConfig(batch_size=4),
                             device="cpu")
    got = adapter.adapt(corpus_dir)
    close_to_scale(got.gmm.get_means(), want.gmm.get_means())
    original = PModel.load(model_path)
    same_but_means(got.gmm, original.gmm)
    same_transitions(got, original)
    assert got.alignment_model is None
    assert {"pass_1", "stats", "map_update"} <= set(adapter.phase_seconds)


def test_sat_adapt_matches_jax(sat, monkeypatch):
    _tmp, model_path, dict_path, corpus_dir, want, rec = sat
    got_rec = {}
    real = PAD.MapAdapter._estimate_fmllr

    def recording(self, pipeline, gmm):
        got_rec["paths"] = [fb.host_state_path() for fb in pipeline.batches]
        got_rec["transforms"] = real(self, pipeline, gmm)
        return rec["transforms"]  # the JAX package's, for the means below

    monkeypatch.setattr(PAD.MapAdapter, "_estimate_fmllr", recording)
    adapter = PAD.MapAdapter(model_path, dict_path, 20.0, PConfig(batch_size=4),
                             device="cpu")
    got = adapter.adapt(corpus_dir)
    for a, b in zip(got_rec["paths"], rec["paths"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got_rec["transforms"], rec["transforms"], atol=1e-3,
                               rtol=0)
    close_to_scale(got.gmm.get_means(), want.gmm.get_means())
    close_to_scale(got.alignment_model[1].get_means(),
                   want.alignment_model[1].get_means())
    original = PModel.load(model_path)
    same_but_means(got.gmm, original.gmm)
    same_but_means(got.alignment_model[1], original.alignment_model[1])
    same_transitions(got, original)
    assert {"pass_1", "fmllr", "pass_2", "stats", "map_update", "si_stats",
            "si_map_update"} <= set(adapter.phase_seconds)
    # the SI statistics read a layout made from the alignment set back on
    # the SI features, not the one cached on the adapted features
    for fb in adapter.pipeline.batches:
        assert fb._layout[0] is fb.frame_pdf


def test_sat_adapt_is_reproducible_and_aligns_in_both(sat, tmp_path):
    _tmp, model_path, dict_path, corpus_dir, _want, _rec = sat
    models = []
    for run in range(2):
        adapted = PAD.MapAdapter(model_path, dict_path, 20.0, PConfig(batch_size=4),
                                 device="cpu").adapt(corpus_dir)
        path = tmp_path / f"adapted{run}.zip"
        adapted.save(path)
        models.append(PModel.load(path))
    for a, b in ((models[0].gmm, models[1].gmm),
                 (models[0].alignment_model[1], models[1].alignment_model[1])):
        for k in ("means_invvars", "inv_vars", "weights", "gconsts"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    import chip_smoke

    path = tmp_path / "adapted0.zip"
    got = PAligner(path, dict_path, PConfig(batch_size=4),
                   device="cpu").align_corpus(PCorpus.load(corpus_dir))
    want = JAligner(path, dict_path, JConfig(batch_size=4)).align_corpus(
        JCorpus.load(corpus_dir))
    assert len(got) == len(want) == 6
    # raises below the parity bar
    report = chip_smoke.parity(got, want, 0.01)
    assert report["frames"] > 500


def test_cli_adapt(mono, tmp_path):
    _tmp, model_path, dict_path, corpus_dir = mono
    out = tmp_path / "adapted.zip"
    tg = tmp_path / "tg"
    assert cli_main(["adapt", str(corpus_dir), str(dict_path), str(model_path),
                     str(out), "--device", "cpu", "-j", "4", "--mapping_tau", "10",
                     "--output_directory", str(tg)]) == 0
    m = PModel.load(out)
    assert not np.array_equal(m.gmm.means_invvars,
                              PModel.load(model_path).gmm.means_invvars)
    assert len(list(tg.rglob("*.TextGrid"))) == 1
