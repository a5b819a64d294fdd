"""Pitch models on every path that takes one, in the port, on the CPU.

The JAX package fails these cases (its LDA stage sizes the spliced
statistics without the pitch columns, its ``adapt``, fine-tune and long
path compute features without pitch), so it is the bar only for the pitch
features themselves. Pitch is pasted after CMVN, and the pasted width is
spliced and LDA-projected (the reference's ``FinalFeatureFunction``).

* The recipe mono -> tri -> LDA -> SAT trains with pitch: ``lda.mat`` is
  40 x 112 (16 raw columns spliced +-3), log-likelihoods are finite and
  rise at every iteration that does not change the features, and the
  archive aligns two-pass at the JAX training test's bar (on its 14
  utterances, as ``test_torch_train_recipe.py`` trains).
* ``MapAdapter`` of a pitch model: its features' pitch columns within atol
  1e-4 of the JAX pipeline's at one utterance a batch (as
  ``test_torch_pitch.py`` holds them), the
  adapted means within rtol 1e-5 of each tensor's largest value of a
  float64 MAP update computed here in numpy from the same features and
  alignment (``test_torch_adapt.py``'s bar), only the means moved, and the
  adapted archive aligns every utterance.
* ``--fine_tune`` on a pitch model: every boundary moves at most the
  fine-tune window (15 ms) from the 10 ms alignment's, some leave the 10 ms
  grid, and the CLI writes every file's TextGrid.
* The long path on a pitch model, with ``LONG_UTTERANCE_FRAMES`` lowered so
  every utterance takes it (and ``CHUNK_FRAMES`` so each takes several
  chunks), against the corpus path at four utterances a batch at the JAX
  parity bar; one utterance a speaker, so both estimate CMVN from the same
  frames (a row's pitch is its own in any batch).
* ``estimate_lda`` on a singular within-class covariance (constant
  spliced pitch columns) adds Kaldi's 1e-3 of the mean variance; the
  voiced corpus of the chip phase moves every pitch column, where the
  stationary tones leave two of them at 0.
"""

import shutil

import numpy as np
import pytest

import montreal_forced_aligner_tpu_torch.ops.long_viterbi as PLV
import montreal_forced_aligner_tpu_torch.online.alignment as PON
import montreal_forced_aligner_tpu_torch.training.adapt as PAD
import montreal_forced_aligner_tpu_torch.training.base as PB
from montreal_forced_aligner_tpu_torch.align.aligner import (
    AlignerConfig as PConfig,
    PretrainedAligner as PAligner,
)
from montreal_forced_aligner_tpu_torch.align.fine_tune import fine_tune_alignments
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon as PLexicon
from montreal_forced_aligner_tpu_torch.models.acoustic_model import (
    AcousticModel as PModel,
)
from montreal_forced_aligner_tpu_torch.training.monophone import MonophoneTrainer

from test_torch_adapt import close_to_scale, same_but_means, same_transitions
from test_torch_pitch import jax_pitch_rows
from test_torch_train import alignment_bar, write_dict
from test_training import make_training_corpus

import chip_smoke

PITCH_RECIPE = [  # mono -> tri -> LDA -> SAT, iterations cut
    ("monophone", "mono", 4, 40, 0),
    ("triphone", "tri", 3, 64, 48),
    ("lda", "lda", 3, 64, 48),
    ("sat", "sat", 5, 64, 48),
]


@pytest.fixture(scope="module")
def mono_pitch(tmp_path_factory):
    """A monophone pitch model trained by the port on the JAX training
    test's tone corpus (8 iterations)."""
    tmp = tmp_path_factory.mktemp("pitch_paths")
    corpus_dir, truths = make_training_corpus(tmp)
    dict_path = write_dict(tmp / "train.dict")
    lexicon = PLexicon.load(dict_path, position_dependent=False)
    pipeline = PB.TrainingPipeline(PCorpus.load(corpus_dir), lexicon, batch_size=4,
                                   use_pitch=True, device="cpu")
    pipeline.prepare_features()
    trainer = MonophoneTrainer(
        lexicon, PB.TrainerConfig(num_iterations=8, max_gaussians=40,
                                  boost_silence=1.0),
        variable_length_topology=False,
    )
    model = trainer.train(pipeline)
    path = tmp / "mono_pitch.zip"
    model.save(path)
    return tmp, corpus_dir, dict_path, path, truths


def test_pitch_recipe_trains_with_a_112_wide_lda(tmp_path):
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    corpus_dir, truths = make_training_corpus(tmp_path, n_utts=14)
    dict_path = write_dict(tmp_path / "train.dict")
    ta = TrainableAligner(
        corpus_dir, dict_path,
        recipe=[StageConfig(n, k, it, g, num_leaves=lv)
                for n, k, it, g, lv in PITCH_RECIPE],
        base_config=PB.TrainerConfig(boost_silence=1.0), batch_size=4,
        variable_length_topology=False, use_pitch=True, device="cpu",
    )
    final = ta.train()
    assert set(ta.models) == {"monophone", "triphone", "lda", "sat"}
    assert ta.models["lda"].lda_mat.shape == (40, 112)
    assert final.lda_mat.shape == (40, 112) and final.uses_fmllr
    for name in ta.models:
        trainer = ta.trainers[name]
        ll = np.array([e["loglike_per_frame"] for e in trainer.iteration_log])
        assert np.isfinite(ll).all(), (name, ll)
        # an iteration that changes the features (MLLT, fMLLR) may lower the
        # log-likelihood; every other one raises it or keeps it
        changes = set(getattr(trainer, "mllt_iterations", ())) | set(
            getattr(trainer, "fmllr_iterations", ()))
        for i in range(1, len(ll)):
            if i not in changes:
                assert ll[i] >= ll[i - 1] - 1e-6 * abs(ll[i - 1]), (name, ll)
        if name != "sat":
            assert ll[-1] > ll[0], (name, ll)
    path = tmp_path / "pitch_sat.zip"
    final.save(path)
    loaded = PModel.load(path)
    assert loaded.lda_mat.shape == (40, 112)
    assert loaded.meta["features"]["pitch"] is True
    aligner = PAligner(path, dict_path, PConfig(batch_size=4), device="cpu")
    assert aligner.use_pitch and aligner.two_pass
    corpus = PCorpus.load(corpus_dir)
    results = aligner.align_corpus(corpus)
    assert len(results) == len(corpus.utterances) == 14
    assert not np.allclose(aligner.last_fmllr.transforms[:, :, :40],
                           np.eye(40)[None])
    alignment_bar(results, corpus, truths)


def _numpy_map_means(model, pipeline, tau=20.0):
    """Means of a MAP update (I-smoothing with ``tau`` pseudo-counts, then a
    means-only update), in float64 from the pipeline's features and
    alignment: each frame's Gaussian posteriors under its aligned pdf."""
    gmm = model.gmm
    means = gmm.get_means().astype(np.float64)
    iv = gmm.inv_vars.astype(np.float64)
    miv = gmm.means_invvars.astype(np.float64)
    gc = gmm.gconsts.astype(np.float64)
    occ = np.zeros(gc.shape)
    acc = np.zeros(means.shape)
    for fb in pipeline.batches:
        feats = fb.feats.numpy().astype(np.float64)
        pdfs = fb.frame_pdf.numpy()
        for row, L in enumerate(fb.frame_lengths):
            x, p = feats[row, :L], pdfs[row, :L]
            ll = gc[p] + np.einsum("tgd,td->tg", miv[p], x) - 0.5 * np.einsum(
                "tgd,td->tg", iv[p], x * x)
            post = np.exp(ll - ll.max(axis=1, keepdims=True))
            post /= post.sum(axis=1, keepdims=True)
            np.add.at(occ, p, post)
            np.add.at(acc, p, post[:, :, None] * x[:, None, :])
    pad = np.arange(gc.shape[1])[None, :] >= gmm.num_gauss[:, None]
    tau_occ = np.where(pad, 0.0, tau)
    occ = occ + tau_occ
    acc = acc + tau_occ[:, :, None] * means
    return np.where((occ > 10.0)[:, :, None], acc / np.maximum(occ, 1e-10)[:, :, None],
                    means)


def test_pitch_adapt_meets_the_adapt_bars(mono_pitch, tmp_path):
    _tmp, corpus_dir, dict_path, model_path, _truths = mono_pitch
    adapter = PAD.MapAdapter(model_path, dict_path, 20.0, PConfig(batch_size=4),
                             device="cpu")
    got = adapter.adapt(corpus_dir)
    pipeline = adapter.pipeline
    assert pipeline.use_pitch and pipeline.feature_dim == 48
    jax = jax_pitch_rows(corpus_dir, dict_path)
    assert sorted(jax) == sorted(i for pb in pipeline.batches for i in pb.utt_indices)
    for pb in pipeline.batches:
        for row, L in enumerate(pb.frame_lengths):
            np.testing.assert_allclose(pb.raw[row, :L, 13:].numpy(),
                                       jax[pb.utt_indices[row]][:L],
                                       atol=1e-4, rtol=0)
    original = PModel.load(model_path)
    want = _numpy_map_means(original, pipeline)
    close_to_scale(got.gmm.get_means(), want)
    same_but_means(got.gmm, original.gmm)
    same_transitions(got, original)
    path = tmp_path / "adapted.zip"
    got.save(path)
    aligner = PAligner(path, dict_path, PConfig(batch_size=4), device="cpu")
    assert aligner.use_pitch
    assert len(aligner.align_corpus(PCorpus.load(corpus_dir))) == 6


def test_pitch_fine_tune_moves_within_the_window(mono_pitch, tmp_path):
    _tmp, corpus_dir, dict_path, model_path, _truths = mono_pitch
    aligner = PAligner(model_path, dict_path, PConfig(batch_size=4), device="cpu")
    corpus = PCorpus.load(corpus_dir)
    coarse = aligner.align_corpus(corpus)
    before = {k: [(p.label, p.begin) for p in v.phones] for k, v in coarse.items()}
    tuned = fine_tune_alignments(aligner, corpus, coarse)
    window = round(aligner.frame_shift * 1.5, 3)
    moved = 0
    for k, aln in tuned.items():
        assert [p.label for p in aln.phones] == [lab for lab, _b in before[k]]
        gb = np.array([p.begin for p in aln.phones])
        wb = np.array([b for _lab, b in before[k]])
        assert np.abs(gb - wb).max() <= window + 1e-9, k
        moved += int((np.round(gb * 1000) % 10 != 0).sum())
    assert moved > 5  # boundaries left the 10 ms grid
    tg = tmp_path / "tg"
    assert cli_main(["align", str(corpus_dir), str(dict_path), str(model_path),
                     str(tg), "--device", "cpu", "--fine_tune"]) == 0
    assert len(list(tg.rglob("*.TextGrid"))) == 6


def test_pitch_long_path_matches_the_corpus_path(mono_pitch, tmp_path, monkeypatch):
    _tmp, corpus_dir, dict_path, model_path, _truths = mono_pitch
    # one utterance a speaker: per-speaker CMVN is the utterance's own
    single = tmp_path / "single"
    for k, wav in enumerate(sorted(corpus_dir.rglob("*.wav"))):
        d = single / f"s{k}"
        d.mkdir(parents=True)
        shutil.copy(wav, d / wav.name)
        shutil.copy(wav.with_suffix(".lab"), d / wav.with_suffix(".lab").name)
    aligner = PAligner(model_path, dict_path, PConfig(batch_size=4), device="cpu")
    want = aligner.align_corpus(PCorpus.load(single))
    monkeypatch.setattr(PON, "LONG_UTTERANCE_FRAMES", 50)
    monkeypatch.setattr(PLV, "CHUNK_FRAMES", 64)
    calls = []
    real = PON.align_utterance_online

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(PON, "align_utterance_online", counting)
    got = aligner.align_corpus(PCorpus.load(single))
    assert len(calls) == len(want) == len(got) == 6
    report = chip_smoke.parity(got, want, aligner.frame_shift)  # raises below
    assert report["frames"] > 500


def _lda_stats(X, labels, C):
    counts = np.bincount(labels, minlength=C).astype(np.float64)
    sums = np.zeros((C, X.shape[1]))
    np.add.at(sums, labels, X)
    return counts, sums, X.T @ X


def test_lda_smooths_a_singular_within_class_covariance():
    """Spliced pitch of a stationary tone has constant columns, so the
    within-class covariance is singular: ``estimate_lda`` then adds 1e-3 of
    the mean variance to its diagonal (Kaldi ``LdaEstimate::Estimate``),
    where the 1e-6 floor scaled such a direction by up to 1e3. With no
    such column it keeps the floor (the JAX package's result, bit for bit,
    ``test_torch_train_ops.py``)."""
    import scipy.linalg

    from montreal_forced_aligner_tpu_torch.ops.transforms import estimate_lda

    rng = np.random.RandomState(0)
    labels = rng.randint(0, 6, 600)
    X = rng.randn(600, 10) * 3.0 + labels[:, None] * 0.5
    X[:, 8] = 0.25  # a constant column
    X[:, 9] = 1.0 + rng.randn(600) * 1e-5  # one at float32's resolution
    counts, sums, second = _lda_stats(X, labels, 6)
    got = estimate_lda(counts, sums, second, target_dim=4)
    mean = sums.sum(0) / counts.sum()
    means = sums / counts[:, None]
    between = np.einsum("c,cd,ce->de", counts, means, means) / counts.sum() - np.outer(
        mean, mean)
    within = second / counts.sum() - np.outer(mean, mean) - between
    within = (within + within.T) / 2
    within += 1e-3 * np.trace(within) / 10 * np.eye(10)
    w, v = scipy.linalg.eigh((between + between.T) / 2, within)
    want = v[:, np.argsort(w)[::-1][:4]].T
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=1e-4, atol=1e-5)
    assert np.linalg.norm(got, axis=1).max() < 10.0
    # without the singular columns: the 1e-6 floor, as before
    full = estimate_lda(*_lda_stats(X[:, :8], labels, 6), target_dim=4)
    counts8, sums8, second8 = _lda_stats(X[:, :8], labels, 6)
    mean8 = sums8.sum(0) / counts8.sum()
    means8 = sums8 / counts8[:, None]
    b8 = np.einsum("c,cd,ce->de", counts8, means8, means8) / counts8.sum() - np.outer(
        mean8, mean8)
    w8 = second8 / counts8.sum() - np.outer(mean8, mean8) - b8
    w8 = (w8 + w8.T) / 2 + 1e-6 * np.eye(8)
    ev, vec = scipy.linalg.eigh((b8 + b8.T) / 2, w8)
    np.testing.assert_allclose(np.abs(full),
                               np.abs(vec[:, np.argsort(ev)[::-1][:4]].T),
                               rtol=1e-4, atol=1e-5)


def test_voiced_corpus_moves_the_pitch(tmp_path):
    """``chip_smoke.build_voiced_corpus``, the pitch paths' audio: every
    utterance's pitch columns vary (the stationary tones of
    ``build_corpus`` leave normalized log-pitch and delta-pitch at 0)."""
    import montreal_forced_aligner_tpu_torch.ops.pitch as PP
    from montreal_forced_aligner_tpu_torch.io.wav import read_wave

    dict_path = tmp_path / "v.dict"
    dict_path.write_text("w0\tp00 p01 p02\nw1\tp03 p04\nw2\tp05 p06 p07 p08\n")
    corpus, seconds = chip_smoke.build_voiced_corpus(tmp_path, dict_path, 3, 1.5,
                                                     2.5, num_speakers=3)
    _m, _d, words = chip_smoke.build_sat_scale_model(tmp_path, num_phones=5,
                                                     gauss_per_pdf=2, num_words=3)
    flat, _s = chip_smoke.build_corpus(tmp_path, words, 3, 1.5, 2.5, name="flat")
    stds = {}
    for name, d in (("voiced", corpus), ("flat", flat)):
        for wav in sorted(d.rglob("*.wav")):
            x = read_wave(wav).samples.astype(np.float32)
            feats, n = PP.compute_pitch_batch(x[None], np.array([len(x)]),
                                              device="cpu")
            stds.setdefault(name, []).append(feats[0, : n[0]].std(axis=0))
        assert len(stds[name]) == 3
    assert 4.5 <= seconds <= 9.0
    assert all((s > 0.05).all() for s in stds["voiced"]), stds["voiced"]
    assert all(s[1] < 1e-5 and s[2] < 1e-5 for s in stds["flat"]), stds["flat"]
