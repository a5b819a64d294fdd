"""The port's transcription (``transcription/transcriber.py``, the N-best
half of ``ops/viterbi.py``, ``mfa transcribe``) against the JAX package's,
on the CPU.

* Decoding graphs: every host array identical (monophone and triphone).
* ``dedup_topk``, ``nbest_word_events`` and ``nbest_backtrace_host`` exact
  on random inputs, forced ties and hash wrap-around included; the K-best
  Viterbi on the same emissions: backpointers identical, scores within
  atol 1e-3.
* Dense 1-best, N-best with rescoring, the SAT two-pass decode and the
  per-speaker decode, the same final features (seeded with numpy) through
  both packages: texts, word intervals and ranked lists identical, scores
  within atol 1e-3; state paths of the dense decode identical; WER/CER
  equal.
* The ``transcribe`` command (N-best, ``--evaluate``, an LM archive,
  ``--output_type alignment``, ``--profile_dir``) on the CPU; the default
  device raises without a card.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import montreal_forced_aligner_tpu.align.aligner as JA
import montreal_forced_aligner_tpu.ops.viterbi as JV
import montreal_forced_aligner_tpu.transcription.transcriber as JT
import montreal_forced_aligner_tpu_torch.align.aligner as PA
import montreal_forced_aligner_tpu_torch.ops.viterbi as PV
import montreal_forced_aligner_tpu_torch.transcription.transcriber as PT
from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
from montreal_forced_aligner_tpu.graph.compiler import (
    batch_graphs as j_batch_graphs,
    ship_graph_to_device as j_ship,
)
from montreal_forced_aligner_tpu.language_modeling.ngram import ArpaModel as JArpa
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
from montreal_forced_aligner_tpu_torch.graph.compiler import (
    batch_graphs as p_batch_graphs,
    ship_graph_to_device as p_ship,
)
from montreal_forced_aligner_tpu_torch.io.wav import write_wave
from montreal_forced_aligner_tpu_torch.language_modeling.ngram import (
    ArpaModel as PArpa,
    train_lm_from_texts,
)

from helpers import SR, build_synthetic_model, synth_wave

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The decoders' per-frame loops launch many small ops; under pytest's
    parallel workers, each with a full intra-op thread pool, the pools
    oversubscribe the cores and every op's barrier waits on descheduled
    threads. One thread a worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_GRAPH_FIELDS = ("state_pdf", "state_phone", "state_word", "state_hmm_pos",
                 "state_tstate", "state_instance", "in_src", "in_weight",
                 "in_tid", "start", "final", "final_tid", "in_event")


def make_corpus(tmp: Path, n: int = 3, text: str = "ab a", seed: int = 0):
    """``n`` noisy copies of the synthetic "ab a" recording over two
    speakers."""
    rng = np.random.RandomState(seed)
    wave = synth_wave()
    for u in range(n):
        d = tmp / "corpus" / f"spk{u % 2}"
        d.mkdir(parents=True, exist_ok=True)
        noisy = wave + rng.randn(len(wave)).astype(np.float32) * 50.0
        write_wave(d / f"utt{u}.wav", noisy.astype(np.float32), SR)
        (d / f"utt{u}.lab").write_text(text)
    return tmp / "corpus", wave


def shared_lm(tmp: Path, texts, order: int, name: str):
    """One ARPA file read by both packages."""
    lm, _ = train_lm_from_texts(texts, order=order)
    path = tmp / f"{name}.arpa"
    lm.write(path)
    return JArpa.read(path), PArpa.read(path)


def seed_final_feats(monkeypatch, dim: int):
    """Both packages' final features replaced by the same numpy-seeded
    values (per batch shape), so everything downstream compares on
    identical inputs."""

    def feats_np(shape):
        B, T = shape[0], shape[1]
        return np.random.RandomState(B * 7919 + T).randn(B, T, dim).astype(
            np.float32)

    monkeypatch.setattr(
        JA, "_final_feats",
        lambda feats, fl, mr, lda=None, *a, **k: jnp.asarray(feats_np(feats.shape)))
    monkeypatch.setattr(
        PA, "_final_feats",
        lambda feats, fl, mr, lda=None, pitch=None: torch.from_numpy(
            feats_np(feats.shape)))


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tr_mono")
    corpus_dir, wave = make_corpus(tmp)
    model_path, dict_path = build_synthetic_model(tmp, wave=wave)
    rng = np.random.RandomState(3)
    words = ["ab", "a", "ba", "b"]
    texts = ["ab a"] * 4 + [" ".join(rng.choice(words, 4)) for _ in range(12)]
    jlm, plm = shared_lm(tmp, texts, 2, "bigram")
    return tmp, corpus_dir, model_path, dict_path, jlm, plm, texts


@pytest.fixture(scope="module")
def sat(tmp_path_factory):
    """A tiny SAT triphone model (chip_smoke's, 5 phones) and 4 utterances
    of 1.5-3 s over 2 speakers, with a bigram over 12 of its words."""
    tmp = tmp_path_factory.mktemp("tr_sat")
    model_path, dict_path, words = chip_smoke.build_sat_scale_model(
        tmp, num_phones=5, gauss_per_pdf=3, num_words=12)
    corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 4, 1.5, 3.0,
                                            num_speakers=2)
    rng = np.random.RandomState(5)
    texts = [" ".join(rng.choice(words, 5)) for _ in range(40)]
    jlm, plm = shared_lm(tmp, texts, 2, "sat_bigram")
    return tmp, corpus_dir, model_path, dict_path, jlm, plm, texts


@pytest.mark.parametrize("which", ["mono", "sat"])
def test_decoding_graph_host_arrays_identical(which, mono, sat):
    _tmp, _cd, model_path, dict_path, jlm, plm, _t = mono if which == "mono" else sat
    jt = JT.Transcriber(model_path, dict_path, lm=jlm)
    pt = PT.Transcriber(model_path, dict_path, lm=plm, device="cpu")
    jg, jv = JT.DecodingGraphCompiler(jt.aligner.compiler, jt.aligner.lexicon,
                                      jlm, word_insertion_penalty=0.5).build()
    pg, pv = PT.DecodingGraphCompiler(pt.aligner.compiler, pt.aligner.lexicon,
                                      plm, word_insertion_penalty=0.5).build()
    assert jv == pv and jg.words == pg.words
    for k in _GRAPH_FIELDS:
        a, b = getattr(jg, k), getattr(pg, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    if which == "sat":
        assert jt.aligner.model.tree.N == 3 and pg.num_states > 100


@pytest.mark.parametrize("C,K,ties", [(5, 8, False), (24, 4, True),
                                      (37, 8, True), (9, 3, False)])
def test_dedup_topk_matches_jax(C, K, ties):
    rng = np.random.RandomState(C * 10 + K)
    scores = rng.randn(3, 7, C).astype(np.float32)
    if ties:  # equal scores and repeated hashes in every row
        scores = np.round(scores, 0)
    hashes = rng.randint(0, 4 if ties else 1000, (3, 7, C)).astype(np.uint32)
    hashes[0, 0, :2] = 0xFFFFFFFF  # the top of the uint32 range
    jv, jh, ji = (np.asarray(x) for x in JV.dedup_topk(
        jnp.asarray(scores), jnp.asarray(hashes), K))
    pv, ph, pi = (x.numpy() for x in PV.dedup_topk(
        torch.from_numpy(scores), torch.from_numpy(hashes.astype(np.int64)), K))
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(ph, jh.astype(np.int64))
    np.testing.assert_array_equal(pi, ji)


def test_hash_wraps_as_uint32():
    h = np.array([0xFFFFFFFF, 0x12345678, 4000000000], np.uint32)
    ev = np.array([7, 1, 0xFFFF], np.uint32)
    want = (h * JV.HASH_MULT + ev).astype(np.uint32)
    got = PV.hash_push(torch.from_numpy(h.astype(np.int64)),
                       torch.from_numpy(ev.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _batched(mono_or_sat, B=2):
    _tmp, _cd, model_path, dict_path, jlm, plm, _t = mono_or_sat
    pt = PT.Transcriber(model_path, dict_path, lm=plm, device="cpu")
    graph, _v = PT.DecodingGraphCompiler(pt.aligner.compiler,
                                         pt.aligner.lexicon, plm).build()
    garrs = p_batch_graphs([graph] * B)
    jt = JT.Transcriber(model_path, dict_path, lm=jlm)
    jgraph, _ = JT.DecodingGraphCompiler(jt.aligner.compiler,
                                         jt.aligner.lexicon, jlm).build()
    jgarrs = j_batch_graphs([jgraph] * B)
    return garrs, p_ship(garrs, CPU), jgarrs, j_ship(jgarrs)


def test_nbest_word_events_match_jax(mono, sat):
    for fx in (mono, sat):
        garrs, _pg, jgarrs, _jg = _batched(fx)
        jev, jh = JV.nbest_word_events(jgarrs)
        pev, ph = PV.nbest_word_events(garrs)
        np.testing.assert_array_equal(pev, jev)
        np.testing.assert_array_equal(ph, jh)
        # without arc events: the instance-crossing inference
        for g in (garrs, jgarrs):
            g.pop("in_event")
        jev, jh = JV.nbest_word_events(jgarrs)
        pev, ph = PV.nbest_word_events(garrs)
        np.testing.assert_array_equal(pev, jev)
        np.testing.assert_array_equal(ph, jh)


@pytest.mark.parametrize("dedup", [True, False])
def test_viterbi_nbest_matches_jax(mono, dedup):
    garrs, pg, jgarrs, jg = _batched(mono)
    B, S = garrs["state_pdf"].shape
    T, K = 40, 4
    emit = np.random.RandomState(1).randn(B, T, S).astype(np.float32) * 3.0
    flens = np.array([T, T - 9], np.int32)
    kw = {}
    jkw = {}
    if dedup:
        ev, h0 = PV.nbest_word_events(garrs)
        kw = dict(word_event=torch.from_numpy(ev),
                  state0_hash=torch.from_numpy(h0.astype(np.int64)))
        jkw = dict(word_event=jnp.asarray(ev), state0_hash=jnp.asarray(h0))
    jf, jb = JV.viterbi_nbest_device(jnp.asarray(emit), jnp.asarray(flens), jg,
                                     acoustic_scale=0.5, K=K, **jkw)
    pf, pb = PV.viterbi_nbest_device(torch.from_numpy(emit),
                                     torch.from_numpy(flens), pg,
                                     acoustic_scale=0.5, K=K, **kw)
    jf, jb = np.asarray(jf), np.asarray(jb)
    fin = jf > -1e29
    np.testing.assert_array_equal(fin, pf.numpy() > -1e29)
    np.testing.assert_allclose(pf.numpy()[fin], jf[fin], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(pb.numpy(), jb)
    jout = JV.nbest_backtrace_host(jgarrs, jf, jb, flens, K)
    pout = PV.nbest_backtrace_host(garrs, pf.numpy(), pb.numpy(), flens, K)
    np.testing.assert_array_equal(pout[0], jout[0])
    np.testing.assert_allclose(pout[1], jout[1], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(pout[2], jout[2])


def test_dense_state_paths_match_jax(sat):
    """The dense decode (all pdfs and a gather on this small model, then the
    dense max-plus Viterbi) on the same features: identical state paths."""
    garrs, pg, jgarrs, jg = _batched(sat)
    _tmp, _cd, model_path, dict_path, jlm, plm, _t = sat
    pa = PA.PretrainedAligner(model_path, dict_path, device="cpu")
    ja = JA.PretrainedAligner(model_path, dict_path)
    B = garrs["state_pdf"].shape[0]
    ff = np.random.RandomState(2).randn(B, 120, 40).astype(np.float32)
    flens = np.array([120, 87], np.int32)
    W, gc, _w_rows = ja._device_gmm
    jsp, jsc = JA._emit_and_align(jnp.asarray(ff), jnp.asarray(flens), jg, W, gc,
                                  1.0 / 12)
    psp, psc = PA._emit_and_align(torch.from_numpy(ff), torch.from_numpy(flens),
                                  pg, pa.gmm, 1.0 / 12)
    np.testing.assert_array_equal(psp.numpy(), np.asarray(jsp))
    np.testing.assert_allclose(psc.numpy(), np.asarray(jsc), atol=1e-3, rtol=0)


def _same_results(jr, pr, nbest=False):
    assert sorted(jr) == sorted(pr)
    for i in jr:
        a, b = jr[i], pr[i]
        assert b.text == a.text, (i, a.text, b.text)
        assert abs(b.log_likelihood - a.log_likelihood) <= 1e-3
        assert [(w.label, round(w.begin, 6), round(w.end, 6)) for w in b.words] == [
            (w.label, round(w.begin, 6), round(w.end, 6)) for w in a.words]
        if nbest:
            assert [t for t, _s in b.alternatives] == [t for t, _s in a.alternatives]
            np.testing.assert_allclose([s for _t, s in b.alternatives],
                                       [s for _t, s in a.alternatives],
                                       atol=1e-3, rtol=0)
        else:
            assert a.alternatives is None and b.alternatives is None


def test_dense_1best_matches_jax(mono, monkeypatch):
    _tmp, corpus_dir, model_path, dict_path, jlm, plm, _t = mono
    # real features first: the transcript itself
    pt = PT.Transcriber(model_path, dict_path, lm=plm, batch_size=2, device="cpu")
    real = pt.transcribe_corpus(PCorpus.load(corpus_dir))
    assert [real[i].text for i in sorted(real)] == ["ab a"] * 3
    assert pt._graph is not None and pt._lvcsr is None
    seed_final_feats(monkeypatch, 39)
    jr = JT.Transcriber(model_path, dict_path, lm=jlm, batch_size=2
                        ).transcribe_corpus(JCorpus.load(corpus_dir))
    pr = PT.Transcriber(model_path, dict_path, lm=plm, batch_size=2, device="cpu"
                        ).transcribe_corpus(PCorpus.load(corpus_dir))
    _same_results(jr, pr)


def test_dense_nbest_and_rescoring_match_jax(mono, monkeypatch):
    tmp, corpus_dir, model_path, dict_path, jlm, plm, texts = mono
    seed_final_feats(monkeypatch, 39)
    j3, p3 = shared_lm(tmp, texts, 3, "trigram")
    jt = JT.Transcriber(model_path, dict_path, lm=jlm, batch_size=2)
    pt = PT.Transcriber(model_path, dict_path, lm=plm, batch_size=2, device="cpu")
    for kw in ({}, {"rescore_weight": 1.0}):
        jr = jt.transcribe_corpus(JCorpus.load(corpus_dir), nbest=6,
                                  rescore_lm=j3 if kw else None, **kw)
        pr = pt.transcribe_corpus(PCorpus.load(corpus_dir), nbest=6,
                                  rescore_lm=p3 if kw else None, **kw)
        _same_results(jr, pr, nbest=True)
        assert len(pr[0].alternatives) >= 2


def test_sat_two_pass_decode_matches_jax(sat, monkeypatch):
    _tmp, corpus_dir, model_path, dict_path, jlm, plm, _t = sat
    seed_final_feats(monkeypatch, 40)
    jt = JT.Transcriber(model_path, dict_path, lm=jlm, batch_size=2)
    pt = PT.Transcriber(model_path, dict_path, lm=plm, batch_size=2, device="cpu")
    assert pt.aligner.two_pass
    jr = jt.transcribe_corpus(JCorpus.load(corpus_dir))
    pr = pt.transcribe_corpus(PCorpus.load(corpus_dir))
    _same_results(jr, pr)
    assert pt.last_fmllr is not None
    # the phases in the order they ran, each once
    assert list(pt.last_phase_seconds) == [
        "audio_load", "decoding_graph", "phase_a_dispatch",
        "graph_ship_and_final_feats", "fmllr_pass1", "fmllr_stats_fetch",
        "fmllr_solve", "fmllr_apply", "decode_dispatch", "path_fetch", "words"]


def test_per_speaker_decode_and_evaluate_match_jax(sat, monkeypatch):
    _tmp, corpus_dir, model_path, dict_path, _jlm, _plm, _t = sat
    seed_final_feats(monkeypatch, 40)
    jt = JT.Transcriber(model_path, dict_path, batch_size=2)
    pt = PT.Transcriber(model_path, dict_path, batch_size=2, device="cpu")
    jc, pc = JCorpus.load(corpus_dir), PCorpus.load(corpus_dir)
    jr = jt.transcribe_corpus_per_speaker(jc)
    pr = pt.transcribe_corpus_per_speaker(pc)
    _same_results(jr, pr)
    assert jt.evaluate(jc, jr) == pt.evaluate(pc, pr)


def test_train_lm_from_corpus_and_phone_lm_match_jax(mono):
    _tmp, corpus_dir, model_path, dict_path, *_ = mono
    jt = JT.Transcriber(model_path, dict_path)
    pt = PT.Transcriber(model_path, dict_path, device="cpu")
    jlm = jt.train_lm_from_corpus(JCorpus.load(corpus_dir))
    plm = pt.train_lm_from_corpus(PCorpus.load(corpus_dir))
    assert jlm.ngrams == plm.ngrams
    from montreal_forced_aligner_tpu.data import (
        CtmInterval as JC, UtteranceAlignment as JU)
    from montreal_forced_aligner_tpu_torch.data import (
        CtmInterval as PCt, UtteranceAlignment as PU)

    seqs = [["aa", "bb", "aa"], ["bb", "aa"], ["aa", "aa", "bb", "bb"]]
    jres = {i: JU(i, [], [JC(0, 0, p) for p in s], 0.0, 0.0)
            for i, s in enumerate(seqs)}
    pres = {i: PU(i, [], [PCt(0, 0, p) for p in s], 0.0, 0.0)
            for i, s in enumerate(seqs)}
    assert JT.train_phone_lm(jres, order=3).ngrams == PT.train_phone_lm(
        pres, order=3).ngrams


def test_cuda_default_raises_without_card(mono):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _tmp, _cd, model_path, dict_path, _jlm, plm, _t = mono
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.Transcriber(model_path, dict_path, lm=plm)


def test_transcribe_cli(mono, tmp_path):
    tmp, corpus_dir, model_path, dict_path, _jlm, plm, texts = mono
    out = tmp_path / "out"
    assert cli_main(["transcribe", str(corpus_dir), str(dict_path),
                     str(model_path), str(out), "--device", "cpu", "--nbest",
                     "4", "--evaluate", "-j", "2", "--batch_size", "2",
                     "--profile_dir", str(tmp_path / "prof")]) == 0
    labs = sorted(out.rglob("*.lab"))
    assert len(labs) == 3 and all(p.read_text() == "ab a\n" for p in labs)
    assert len(list(out.glob("*.TextGrid"))) == 3
    assert (tmp_path / "prof" / "transcribe_trace.json").is_file()
    # an LM archive decodes with its small model and rescores with its large
    from montreal_forced_aligner_tpu_torch.language_modeling.archive import (
        LanguageModelArchive,
    )

    arch = LanguageModelArchive.train(texts, order=3)
    zpath = arch.save(tmp_path / "lm.zip")
    out2 = tmp_path / "out2"
    assert cli_main(["transcribe", str(corpus_dir), str(dict_path),
                     str(model_path), str(out2), "--device", "cpu",
                     "--language_model_path", str(zpath),
                     "--output_type", "alignment"]) == 0
    tgs = sorted(out2.glob("*.TextGrid"))
    assert len(tgs) == 3 and "phones" in tgs[0].read_text()
    assert all(p.read_text() == "ab a\n" for p in out2.rglob("*.lab"))
