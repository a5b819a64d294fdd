"""The port's pitch features (``ops/pitch.py``) and 1 ms boundary
fine-tuning (``align/fine_tune.py``) against the JAX package's, on the CPU.

Each row's pitch is its own in the port: a row of a padded batch gets what
it gets alone. The JAX package's batched pitch still depends on the rows
beside it (it clamps the NCCF at the padded buffer's end and backtraces
every row from the batch's last frame), so the port is held against the
JAX package one utterance a batch.

Tolerances: NCCF and pitch features within atol 1e-4 of the JAX package's
of each row alone (float32 sums in another order), frame counts equal; lag
paths equal on the JAX package's seeded tones
(``tests/test_pitch_parity.py``) and on voiced audio and noise, and the lag
Viterbi equal on the same input; in any batch, with any ``max_frames``,
every row's lag path equal to its path alone and its features within atol
1e-6 of its features alone; ``compute_mfcc_batch`` within atol 1e-4; the
pitch pipeline's pitch columns within atol 1e-4 of the JAX package's at
one utterance a batch and its MFCC columns those of the pipeline without
pitch, bit for bit; a model trained with pitch aligns every utterance in
both packages at the JAX package's parity bar, and in the port each
utterance alike at batch sizes 1, 2 and 4 (frames equal, scores within
1e-3); fine-tuned boundaries within 1 ms of the JAX package's.
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


def alone_jax(waves, cfg=CFG):
    """The JAX package's pitch features of each wave alone, in a batch of
    one, with its lag path: [(features, frame count, path)]."""
    out = []
    real = JP._viterbi_lags
    paths = []

    def keep(*a, **k):
        paths.append(np.asarray(real(*a, **k)))
        return paths[-1]

    JP._viterbi_lags = keep
    try:
        for w in waves:
            feats, n = JP.compute_pitch_batch(w[None], np.array([len(w)]), cfg)
            out.append((feats[0], int(n[0]), paths[-1][0]))
    finally:
        JP._viterbi_lags = real
    return out


def port_pitch(buf, lens, max_frames=None):
    """The port's pitch features of a batch on the CPU, with its lag paths."""
    real = PP._viterbi_lags
    paths = []

    def keep(*a, **k):
        paths.append(real(*a, **k))
        return paths[-1]

    PP._viterbi_lags = keep
    try:
        feats, n = PP.compute_pitch_batch(buf, lens, CFG, max_frames=max_frames,
                                          device="cpu")
    finally:
        PP._viterbi_lags = real
    return feats, n, paths[-1]


def test_nccf_matches_jax():
    """Rows of two lengths in one padded buffer: each row's NCCF, frames
    past its end included, is the JAX package's of that row alone."""
    rng = np.random.RandomState(0)
    rows = [
        JP._resample_batch(sine(200.0, 0.3)[None], np.array([4800]), CFG)[0][0],
        (rng.randn(900) * 900).astype(np.float32),
    ]
    ds, lens = padded(rows)
    window, shift, T = 100, 40, 28
    got = PP._nccf(torch.from_numpy(ds), torch.from_numpy(lens), window, shift, T,
                   80, CFG.nccf_ballast)
    assert got.dtype == torch.float32
    for b, row in enumerate(rows):
        want = np.asarray(JP._nccf(jnp.asarray(row[None]), window, shift, T, 80,
                                   CFG.nccf_ballast))
        np.testing.assert_allclose(got[b].numpy(), want[0], atol=1e-4, rtol=0)


def test_pitch_features_match_jax():
    rng = np.random.RandomState(1)
    waves = [sine(120.0, 1.0), sine(230.0, 0.8) + (rng.randn(12800) * 300),
             (rng.randn(16000) * 1000)]
    waves = [w.astype(np.float32) for w in waves]
    buf, lens = padded(waves)
    got, got_n = PP.compute_pitch_batch(buf, lens, CFG, device="cpu")
    want = alone_jax(waves)
    np.testing.assert_array_equal(got_n, [n for _f, n, _p in want])
    for b, (feats, n, _path) in enumerate(want):
        np.testing.assert_allclose(got[b, :n], feats, atol=1e-4, rtol=0)
        assert not got[b, n:].any()
    out = PP.pitch_for_mfcc_frames(buf, lens, got_n + 3, int(got_n.max()) + 5,
                                   device="cpu")
    for b, w in enumerate(waves):
        n = int(got_n[b])
        ref = JP.pitch_for_mfcc_frames(w[None], lens[b : b + 1], got_n[b : b + 1] + 3,
                                       n + 3)
        np.testing.assert_allclose(out[b, : n + 3], ref[0], atol=1e-4, rtol=0)
        assert not out[b, n + 3 :].any()


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
                           CFG.penalty_factor, len(lags), np.array([T]))
    np.testing.assert_array_equal(got, want)
    p_nccf = PP._nccf(torch.from_numpy(ds), torch.tensor([ds.shape[1]]), window,
                      shift, T, int(lags.max()),
                      CFG.nccf_ballast)[:, :, torch.from_numpy(lags).long()]
    p_adj = (p_nccf.numpy() * (1.0 - CFG.soft_min_f0 * lags / CFG.resample_rate))
    path = PP._viterbi_lags(torch.from_numpy(p_adj.astype(np.float32)),
                            torch.from_numpy(log_lags), CFG.penalty_factor, len(lags),
                            np.array([T]))
    np.testing.assert_array_equal(path, want)
    assert np.all(lags[path[0, 2:-2]] == int(round(CFG.resample_rate / f0)))


def test_first_maximum_wins_ties():
    x = torch.tensor([[[1.0, 3.0], [3.0, 3.0], [2.0, 3.0]]])
    best, idx = PP._first_argmax(x, 1)
    assert best.tolist() == [[3.0, 3.0]] and idx.tolist() == [[1, 0]]


def voiced(seconds, f0, seed):
    """A harmonic voice gliding from 0.9 to 1.1 times ``f0``, over quiet
    noise."""
    rng = np.random.RandomState(seed)
    n = int(seconds * SR)
    phase = 2 * np.pi * np.cumsum(f0 * np.linspace(0.9, 1.1, n)) / SR
    x = sum(np.sin(h * phase) / h for h in range(1, 6)) * 3000 + rng.randn(n) * 50
    return x.astype(np.float32)


def noise(seconds, seed):
    return (np.random.RandomState(seed).randn(int(seconds * SR)) * 800).astype(
        np.float32)


# voiced audio and noise of 0.02 s (shorter than one 25 ms window: one
# frame), 0.3 s, 1 s and 2.5 s
ROWS = [voiced(0.02, 150.0, 0), noise(0.3, 1), voiced(1.0, 120.0, 2),
        np.concatenate([voiced(1.5, 210.0, 3), noise(1.0, 4)])]


@pytest.fixture(scope="module")
def rows_alone():
    """The port's pitch of each of ``ROWS`` alone: [(features, frame count,
    lag path)]."""
    out = []
    for w in ROWS:
        feats, n, path = port_pitch(w[None], np.array([len(w)]))
        out.append((feats[0], int(n[0]), path[0]))
    return out


# (rows in batch order, max_frames past the longest row's frame count: None
# leaves it at that count, a negative value cuts the longest rows)
BATCHES = [((0, 1, 2, 3), None), ((3, 2, 1, 0), None), ((2, 0), None),
           ((1, 3, 0), 7), ((3,), 12), ((0, 1), 40), ((2, 3, 1), -60)]


@pytest.mark.parametrize("order,extra", BATCHES)
def test_each_row_pitch_is_its_own(rows_alone, order, extra):
    """In permutations and subsets of ``ROWS``, padded to the longest row or
    to ``max_frames`` above or below it, every row's lag path is its path
    alone and its features are within atol 1e-6 of its features alone
    (past its frame count: 0)."""
    buf, lens = padded([ROWS[i] for i in order])
    longest = max(rows_alone[i][1] for i in order)
    max_frames = None if extra is None else longest + extra
    feats, counts, path = port_pitch(buf, lens, max_frames)
    assert feats.shape[1] == (longest if extra is None else max_frames)
    for r, i in enumerate(order):
        want, n, want_path = rows_alone[i]
        assert counts[r] == n
        np.testing.assert_array_equal(path[r, :n], want_path)
        k = min(n, feats.shape[1])
        np.testing.assert_allclose(feats[r, :k], want[:k], atol=1e-6, rtol=0)
        assert not feats[r, k:].any()


@pytest.fixture(scope="module")
def rows_batched():
    buf, lens = padded(ROWS)
    return port_pitch(buf, lens)


@pytest.fixture(scope="module")
def rows_jax():
    return alone_jax(ROWS)


@pytest.mark.parametrize("row", range(len(ROWS)))
def test_batched_rows_match_jax_alone(rows_batched, rows_jax, row):
    """``ROWS`` in one batch, each row against the JAX package's pitch of
    that row alone: lag paths equal, features within atol 1e-4."""
    feats, counts, path = rows_batched
    want, n, want_path = rows_jax[row]
    assert counts[row] == n
    np.testing.assert_array_equal(path[row, :n], want_path)
    np.testing.assert_allclose(feats[row, :n], want, atol=1e-4, rtol=0)


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


def jax_pitch_rows(corpus_dir, dict_path):
    """The JAX training pipeline's pitch columns at one utterance a batch:
    {utterance index: (T, 3)}."""
    jax = JB.TrainingPipeline(JCorpus.load(corpus_dir),
                              JLexicon.load(dict_path, position_dependent=False),
                              batch_size=1, use_pitch=True)
    jax.prepare_features()
    assert jax.feature_dim == 48
    out = {}
    for jb in jax.batches:
        (i,) = [int(i) for i in jb.utt_indices]
        out[i] = np.asarray(jb.raw)[0, : int(jb.frame_lengths[0]), 13:]
    return out


def test_pitch_pipeline_matches_jax(trained):
    """The pitch columns pasted after the CMVN'd MFCCs, at four utterances
    a batch: within atol 1e-4 of the JAX package's at one utterance a
    batch, and the MFCC columns those of the port's pipeline without pitch,
    bit for bit."""
    _tmp, corpus_dir, dict_path, out = trained
    _path, port = out[True]
    _path, plain = out[False]
    jax = jax_pitch_rows(corpus_dir, dict_path)
    assert port.feature_dim == 48
    for pb, qb in zip(port.batches, plain.batches):
        assert pb.utt_indices == qb.utt_indices
        np.testing.assert_array_equal(pb.raw[..., :13].numpy(), qb.raw.numpy())
        for row, L in enumerate(pb.frame_lengths):
            np.testing.assert_allclose(pb.raw[row, :L, 13:].numpy(),
                                       jax[pb.utt_indices[row]][:L], atol=1e-4,
                                       rtol=0)
    assert sorted(jax) == sorted(i for pb in port.batches for i in pb.utt_indices)


def test_pitch_model_aligns_in_both(trained):
    import chip_smoke

    _tmp, corpus_dir, dict_path, out = trained
    path, _pipeline = out[True]
    aligner = PAligner(path, dict_path, PConfig(batch_size=4), device="cpu")
    assert aligner.use_pitch
    got = aligner.align_corpus(PCorpus.load(corpus_dir))
    want = JAligner(path, dict_path, JConfig(batch_size=1)).align_corpus(
        JCorpus.load(corpus_dir))
    assert len(got) == len(want) == 6
    chip_smoke.parity(got, want, aligner.frame_shift)  # raises below the bar


def _intervals(aln):
    return ([(p.label, p.begin, p.end) for p in aln.phones],
            [(w.label, w.begin, w.end) for w in aln.words])


@pytest.fixture(scope="module")
def aligned_alone(trained):
    """The pitch model's alignment of each utterance at one a batch."""
    _tmp, corpus_dir, dict_path, out = trained
    path, _pipeline = out[True]
    aligner = PAligner(path, dict_path, PConfig(batch_size=1), device="cpu")
    return aligner.align_corpus(PCorpus.load(corpus_dir))


@pytest.mark.parametrize("batch_size", [2, 4])
def test_pitch_alignment_does_not_depend_on_the_batch(trained, aligned_alone,
                                                      batch_size):
    """Each utterance of the pitch model's corpus aligns in a batch of
    utterances of other lengths as it aligns alone: the same intervals,
    the score within 1e-3. (With pitch backtraced from the batch's last
    frame, one utterance's score moved by hundreds of nats.)"""
    _tmp, corpus_dir, dict_path, out = trained
    path, _pipeline = out[True]
    aligner = PAligner(path, dict_path, PConfig(batch_size=batch_size),
                       device="cpu")
    got = aligner.align_corpus(PCorpus.load(corpus_dir))
    assert sorted(got) == sorted(aligned_alone) and len(got) == 6
    for k, want in aligned_alone.items():
        assert _intervals(got[k]) == _intervals(want), k
        assert abs(got[k].log_likelihood - want.log_likelihood) <= 1e-3, k


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
