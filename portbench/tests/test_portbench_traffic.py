"""The traffic generator: deterministic for a seed, the sizes the mix's
alone, and the stated distributions."""

import numpy as np
import torch

from portbench import harness
from portbench.inputs import corpus


def _mix(name):
    return harness.load_json(harness.BENCH_DIR / "traffic" / f"{name}.json")


def test_lengths_fixed_by_the_mix_and_clipped():
    t = _mix("librispeech-dev-clean")
    a, b = corpus.lengths(t), corpus.lengths(t)
    assert np.array_equal(a, b)
    assert len(a) == t["speakers"] * t["utterances_per_speaker"] == 2720
    assert a.min() >= 1.5 and a.max() <= 33.0
    # LibriSpeech dev-clean: 7.2 s a mean utterance (5.4 h over 2,703)
    assert abs(a.mean() - 7.2) < 0.25
    assert np.allclose(a * 16000, np.round(a * 16000))


def test_zipf_ranks():
    cdf = corpus.zipf_cdf(20000, 1.0)
    words = [f"w{i}" for i in range(20000)]
    drawn = corpus.zipf_words(words, 200000, cdf, np.random.default_rng(0))
    top = sum(w == "w0" for w in drawn) / len(drawn)
    harmonic = (1.0 / np.arange(1, 20001)).sum()
    assert abs(top - 1 / harmonic) < 0.005
    second = sum(w == "w1" for w in drawn) / len(drawn)
    assert abs(second / top - 0.5) < 0.05


def _jobs(tmp_path, seed, name="a", prepare=True):
    t = _mix("librispeech-dev-clean")
    t.update(speakers=4, utterances_per_speaker=3, jobs=2)
    words = [f"w{i}" for i in range(50)]
    jobs = corpus.make_jobs(t, words, seed, tmp_path / name, torch.device("cpu"))
    if prepare:
        for j in jobs:
            j.prepare()
    return jobs, t


def test_a_job_is_written_when_first_prepared(tmp_path):
    """Planning the pool writes nothing; a job's files come with its
    first ``prepare``, the same as a pool prepared whole."""
    lazy, _ = _jobs(tmp_path, 7, "lazy", prepare=False)
    assert not (tmp_path / "lazy").exists()
    lazy[1].prepare()
    assert not lazy[0].directory.exists()
    assert all(u.path.exists() and u.path.with_suffix(".lab").exists()
               for u in lazy[1].utterances)
    whole, _ = _jobs(tmp_path, 7, "whole")
    for ua, ub in zip(lazy[1].utterances, whole[1].utterances):
        assert ua.words == ub.words
        assert np.array_equal(corpus.read_wave(ua.path), corpus.read_wave(ub.path))


def test_same_seed_same_inputs(tmp_path):
    a, _ = _jobs(tmp_path, 7, "a")
    b, _ = _jobs(tmp_path, 7, "b")
    for ja, jb in zip(a, b):
        for ua, ub in zip(ja.utterances, jb.utterances):
            assert ua.words == ub.words and ua.seconds == ub.seconds
            assert np.array_equal(corpus.read_wave(ua.path), corpus.read_wave(ub.path))


def test_other_seed_same_work_other_audio(tmp_path):
    """A run's seed draws the audio alone: the lengths, speakers and
    transcripts are the mix's."""
    a, t = _jobs(tmp_path, 7, "a")
    b, _ = _jobs(tmp_path, 8, "b")
    ua = [u for j in a for u in j.utterances]
    ub = [u for j in b for u in j.utterances]
    assert [u.seconds for u in ua] == [u.seconds for u in ub]
    assert [u.speaker for u in ua] == [u.speaker for u in ub]
    assert [u.words for u in ua] == [u.words for u in ub]
    assert len({tuple(u.words) for u in ua}) > 1
    assert not np.array_equal(corpus.read_wave(ua[0].path), corpus.read_wave(ub[0].path))
    for u in ua:
        assert len(u.words) == max(1, round(t["words_per_s"] * u.seconds))
        assert len(corpus.read_wave(u.path)) == round(u.seconds * 16000)
    assert [len(j.utterances) for j in a] == [6, 6]


def test_audio_is_noise_and_tones():
    w = corpus.synthesize(np.array([2.0]), 3, 16000, torch.device("cpu"))[0]
    spec = np.abs(np.fft.rfft(w.astype(np.float64)))
    freqs = np.fft.rfftfreq(len(w), 1 / 16000)
    peaks = sorted(freqs[np.argsort(spec)[-3:]])
    assert all(min(abs(p - f) for f in corpus.TONES_HZ) < 1.0 for p in peaks)
