"""The port's pitch features (``ops/pitch.py``) and 1 ms boundary
fine-tuning (``align/fine_tune.py``) against the JAX package's, on the CPU.

Tolerances: NCCF and pitch features within atol 1e-4 (float32 sums in
another order), frame counts equal; lag paths equal on the JAX package's
seeded tones (``tests/test_pitch_parity.py``) and the lag Viterbi equal on
the same input; ``compute_mfcc_batch`` within atol 1e-4; the pitch pipeline's pitch
columns within atol 1e-4 of the JAX package's and its MFCC columns those of
the pipeline without pitch, bit for bit; a model trained with pitch
aligns every utterance in both packages at the JAX package's parity bar;
fine-tuned boundaries within 1 ms of the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import montreal_forced_aligner_tpu.ops.pitch as JP
import montreal_forced_aligner_tpu.training.base as JB
import montreal_forced_aligner_tpu_torch.ops.pitch as PP
import montreal_forced_aligner_tpu_torch.training.base as PB
from montreal_forced_aligner_tpu.align.aligner import (
    AlignerConfig as JConfig,
    PretrainedAligner as JAligner,
)
from montreal_forced_aligner_tpu.align.fine_tune import (
    fine_tune_alignments as j_fine_tune,
)
from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
from montreal_forced_aligner_tpu.dictionary.lexicon import Lexicon as JLexicon
from montreal_forced_aligner_tpu.ops.mfcc import compute_mfcc_batch as j_mfcc
from montreal_forced_aligner_tpu_torch.align.aligner import (
    AlignerConfig as PConfig,
    PretrainedAligner as PAligner,
)
from montreal_forced_aligner_tpu_torch.align.fine_tune import (
    fine_tune_alignments as p_fine_tune,
)
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon as PLexicon
from montreal_forced_aligner_tpu_torch.ops.mfcc import MfccConfig
from montreal_forced_aligner_tpu_torch.ops.mfcc import compute_mfcc_batch as p_mfcc
from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig
from montreal_forced_aligner_tpu_torch.training.monophone import MonophoneTrainer

from test_training import make_training_corpus
from test_torch_train import write_dict

SR = 16000
CFG = PP.PitchConfig()


def sine(f0, seconds=0.5, amp=8000.0):
    t = np.arange(int(seconds * SR)) / SR
    return (amp * np.sin(2 * np.pi * f0 * t)).astype(np.float32)


def padded(waves):
    lens = np.array([len(w) for w in waves], np.int32)
    buf = np.zeros((len(waves), lens.max()), np.float32)
    for i, w in enumerate(waves):
        buf[i, : len(w)] = w
    return buf, lens


def test_nccf_matches_jax():
    rng = np.random.RandomState(0)
    ds = np.stack([
        JP._resample_batch(sine(200.0, 0.3)[None], np.array([4800]), CFG)[0][0],
        (rng.randn(1200) * 900).astype(np.float32),
    ])
    window, shift, T = 100, 40, 28
    want = np.asarray(JP._nccf(jnp.asarray(ds), window, shift, T, 80,
                               CFG.nccf_ballast))
    got = PP._nccf(torch.from_numpy(ds), window, shift, T, 80, CFG.nccf_ballast)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_pitch_features_match_jax():
    rng = np.random.RandomState(1)
    waves = [sine(120.0, 1.0), sine(230.0, 0.8) + (rng.randn(12800) * 300),
             (rng.randn(16000) * 1000)]
    buf, lens = padded([w.astype(np.float32) for w in waves])
    want, want_n = JP.compute_pitch_batch(buf, lens, CFG)
    got, got_n = PP.compute_pitch_batch(buf, lens, CFG, device="cpu")
    np.testing.assert_array_equal(got_n, want_n)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    out = PP.pitch_for_mfcc_frames(buf, lens, want_n + 3, int(want_n.max()) + 5,
                                   device="cpu")
    ref = JP.pitch_for_mfcc_frames(buf, lens, want_n + 3, int(want_n.max()) + 5)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("f0", [100.0, 125.0, 200.0, 250.0, 320.0])
def test_lag_paths_match_jax(f0):
    """The JAX package's exact-lag tones: the port's lag Viterbi on the
    JAX package's NCCF gives its path, and the port's whole chain lands on
    the same lags."""
    ds = JP._resample_batch(sine(f0, 0.4)[None], np.array([6400]), CFG)[0]
    shift, window = 40, 100
    T = (ds.shape[1] - window) // shift + 1
    lags = CFG.lags
    nccf = np.asarray(JP._nccf(jnp.asarray(ds), window, shift, T, int(lags.max()),
                               CFG.nccf_ballast))[:, :, lags]
    adj = (nccf * (1.0 - CFG.soft_min_f0 * lags / CFG.resample_rate)).astype(np.float32)
    log_lags = np.log(lags).astype(np.float32)
    want = np.asarray(JP._viterbi_lags(jnp.asarray(adj), jnp.asarray(log_lags),
                                       CFG.penalty_factor, len(lags)))
    got = PP._viterbi_lags(torch.from_numpy(adj), torch.from_numpy(log_lags),
                           CFG.penalty_factor, len(lags))
    np.testing.assert_array_equal(got, want)
    p_nccf = PP._nccf(torch.from_numpy(ds), window, shift, T, int(lags.max()),
                      CFG.nccf_ballast)[:, :, torch.from_numpy(lags).long()]
    p_adj = (p_nccf.numpy() * (1.0 - CFG.soft_min_f0 * lags / CFG.resample_rate))
    path = PP._viterbi_lags(torch.from_numpy(p_adj.astype(np.float32)),
                            torch.from_numpy(log_lags), CFG.penalty_factor, len(lags))
    np.testing.assert_array_equal(path, want)
    assert np.all(lags[path[0, 2:-2]] == int(round(CFG.resample_rate / f0)))


def test_first_maximum_wins_ties():
    x = torch.tensor([[[1.0, 3.0], [3.0, 3.0], [2.0, 3.0]]])
    best, idx = PP._first_argmax(x, 1)
    assert best.tolist() == [[3.0, 3.0]] and idx.tolist() == [[1, 0]]


def test_compute_mfcc_batch_matches_jax():
    rng = np.random.RandomState(2)
    waves = [(rng.randn(n) * 500).astype(np.float32) for n in (1600, 2300)]
    cfg = MfccConfig(frame_shift_ms=1.0)
    from montreal_forced_aligner_tpu.ops.mfcc import MfccConfig as JMfccConfig

    want, want_n = j_mfcc(waves, cfg=JMfccConfig(frame_shift_ms=1.0), padded_len=2400)
    got, got_n = p_mfcc(waves, cfg=cfg, padded_len=2400, device="cpu")
    np.testing.assert_array_equal(got_n, want_n)
    for b, n in enumerate(want_n):
        np.testing.assert_allclose(got[b, :n].numpy(), np.asarray(want)[b, :n],
                                   atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Monophone models trained by the port on the JAX training test's tone
    corpus, with and without pitch (8 iterations, chain topology)."""
    tmp = tmp_path_factory.mktemp("pitch_train")
    corpus_dir, truths = make_training_corpus(tmp)
    dict_path = write_dict(tmp / "train.dict")
    out = {}
    for use_pitch in (True, False):
        lexicon = PLexicon.load(dict_path, position_dependent=False)
        pipeline = PB.TrainingPipeline(PCorpus.load(corpus_dir), lexicon,
                                       batch_size=4, use_pitch=use_pitch,
                                       device="cpu")
        pipeline.prepare_features()
        trainer = MonophoneTrainer(
            lexicon, TrainerConfig(num_iterations=8, max_gaussians=40,
                                   boost_silence=1.0),
            variable_length_topology=False,
        )
        model = trainer.train(pipeline)
        path = tmp / f"mono_pitch{use_pitch}.zip"
        model.save(path)
        out[use_pitch] = (path, pipeline)
    return tmp, corpus_dir, dict_path, out


def test_pitch_pipeline_matches_jax(trained):
    """The pitch columns pasted after the CMVN'd MFCCs: within atol 1e-4 of
    the JAX package's, and the MFCC columns those of the port's pipeline
    without pitch, bit for bit."""
    _tmp, corpus_dir, dict_path, out = trained
    _path, port = out[True]
    _path, plain = out[False]
    jax = JB.TrainingPipeline(JCorpus.load(corpus_dir),
                              JLexicon.load(dict_path, position_dependent=False),
                              batch_size=4, use_pitch=True)
    jax.prepare_features()
    assert port.feature_dim == jax.feature_dim == 48
    for pb, qb, jb in zip(port.batches, plain.batches, jax.batches):
        assert pb.utt_indices == [int(i) for i in jb.utt_indices]
        np.testing.assert_array_equal(pb.raw[..., :13].numpy(), qb.raw.numpy())
        for row, L in enumerate(pb.frame_lengths):
            np.testing.assert_allclose(pb.raw[row, :L, 13:].numpy(),
                                       np.asarray(jb.raw)[row, :L, 13:], atol=1e-4,
                                       rtol=0)


def test_pitch_model_aligns_in_both(trained):
    import chip_smoke

    _tmp, corpus_dir, dict_path, out = trained
    path, _pipeline = out[True]
    aligner = PAligner(path, dict_path, PConfig(batch_size=4), device="cpu")
    assert aligner.use_pitch
    got = aligner.align_corpus(PCorpus.load(corpus_dir))
    want = JAligner(path, dict_path, JConfig(batch_size=4)).align_corpus(
        JCorpus.load(corpus_dir))
    assert len(got) == len(want) == 6
    chip_smoke.parity(got, want, aligner.frame_shift)  # raises below the bar


def test_fine_tune_matches_jax(trained):
    _tmp, corpus_dir, dict_path, out = trained
    path, _pipeline = out[False]
    p_al = PAligner(path, dict_path, PConfig(batch_size=4), device="cpu")
    p_corpus = PCorpus.load(corpus_dir)
    got = p_fine_tune(p_al, p_corpus, p_al.align_corpus(p_corpus))
    j_al = JAligner(path, dict_path, JConfig(batch_size=4))
    j_corpus = JCorpus.load(corpus_dir)
    want = j_fine_tune(j_al, j_corpus, j_al.align_corpus(j_corpus))
    moved = 0
    for k, w in want.items():
        g = got[k]
        assert [p.label for p in g.phones] == [p.label for p in w.phones]
        gb = np.array([p.begin for p in g.phones])
        wb = np.array([p.begin for p in w.phones])
        assert np.abs(gb - wb).max() <= 0.001 + 1e-9, k
        moved += int((np.round(wb * 1000) % 10 != 0).sum())
        assert [(x.label, x.begin, x.end) for x in g.words] == pytest.approx(
            [(x.label, x.begin, x.end) for x in w.words], abs=0.001 + 1e-9)
    assert moved > 10  # boundaries left the 10 ms grid


def test_cli_align_fine_tune(trained, tmp_path):
    _tmp, corpus_dir, dict_path, out = trained
    path, _pipeline = out[False]
    tg = tmp_path / "tg"
    assert cli_main(["align", str(corpus_dir), str(dict_path), str(path), str(tg),
                     "--device", "cpu", "--fine_tune", "-j", "2"]) == 0
    assert len(list(tg.rglob("*.TextGrid"))) == 6
