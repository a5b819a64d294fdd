"""The port's LVCSR decoders (``transcription/lvcsr.py``, ``lvcsr_pm.py``)
against the JAX package's, on the CPU.

* Graphs: the position-major, chain-major and cross-word host arrays
  identical (a monophone model with 200 junk words; a tiny triphone SAT
  model with 200 words).
* The checkpointed 1-best pairs (position-major, cross-word) and the K-best
  junctions (chain-major with the device backtrace, cross-word with the
  host backtrace) on the same pdf emissions: paths, entered words and
  records identical, scores within atol 1e-3.
* ``transcribe`` through LVCSR (word-internal, and cross-word two-pass),
  the same final features through both packages: texts and words
  identical, scores within atol 1e-3; ``_lvcsr_nbest_decode`` (both
  K-best routes) on the same features: hypotheses identical.
* Three faults of the JAX package the port repairs (ROADMAP.md Queue 3),
  each tested on the port only.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import montreal_forced_aligner_tpu.transcription.lvcsr as JL
import montreal_forced_aligner_tpu.transcription.lvcsr_pm as JPM
import montreal_forced_aligner_tpu.transcription.transcriber as JT
import montreal_forced_aligner_tpu_torch.transcription.lvcsr as PL
import montreal_forced_aligner_tpu_torch.transcription.lvcsr_pm as PPM
import montreal_forced_aligner_tpu_torch.transcription.transcriber as PT
from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus

from helpers import build_synthetic_model
from test_torch_transcription import (
    _same_results,
    make_corpus,
    seed_final_feats,
    shared_lm,
)

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



def _junk_dict(dict_path: Path, n: int, phones, seed: int, lo=4, hi=8):
    rng = np.random.RandomState(seed)
    words = []
    with open(dict_path, "a") as f:
        for j in range(n):
            w = f"junk{j}"
            f.write(f"{w}\t{' '.join(rng.choice(phones, rng.randint(lo, hi)))}\n")
            words.append(w)
    return words


@pytest.fixture(scope="module")
def pm(tmp_path_factory):
    """The monophone synthetic model with 200 junk words: V > 150, so
    ``transcribe`` takes the position-major word-internal decoder."""
    tmp = tmp_path_factory.mktemp("lv_pm")
    corpus_dir, wave = make_corpus(tmp, n=2)
    model_path, dict_path = build_synthetic_model(tmp, wave=wave)
    extra = _junk_dict(dict_path, 200, ["aa", "bb"], 7)
    texts = ["ab a"] * 20 + [" ".join(extra[i : i + 5]) for i in range(0, 200, 5)]
    jlm, plm = shared_lm(tmp, texts, 2, "pm_bigram")
    return tmp, corpus_dir, model_path, dict_path, jlm, plm, texts


@pytest.fixture(scope="module")
def xw(tmp_path_factory):
    """A tiny SAT triphone model over 200 words: the cross-word decoder."""
    tmp = tmp_path_factory.mktemp("lv_xw")
    model_path, dict_path, words = chip_smoke.build_sat_scale_model(
        tmp, num_phones=5, gauss_per_pdf=3, num_words=200)
    corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 3, 1.5, 2.5,
                                            num_speakers=2)
    rng = np.random.RandomState(5)
    texts = [" ".join(rng.choice(words, 6)) for _ in range(80)]
    jlm, plm = shared_lm(tmp, texts, 2, "xw_bigram")
    return tmp, corpus_dir, model_path, dict_path, jlm, plm, texts


def _compilers(fx, cross_word=None, nominal_frames=None):
    _tmp, _cd, model_path, dict_path, jlm, plm, _t = fx
    jt = JT.Transcriber(model_path, dict_path, lm=jlm)
    pt = PT.Transcriber(model_path, dict_path, lm=plm, device="cpu")
    jc = JL.LvcsrGraphCompiler(jt.aligner.compiler, jt.aligner.lexicon, jlm,
                               cross_word=cross_word,
                               nominal_frames=nominal_frames)
    pc = PL.LvcsrGraphCompiler(pt.aligner.compiler, pt.aligner.lexicon, plm,
                               cross_word=cross_word,
                               nominal_frames=nominal_frames)
    return jt, pt, jc, pc


def _same_graph(jg, pg):
    assert type(jg).__name__ == type(pg).__name__
    for f in dataclasses.fields(pg):
        # the JAX cross-word graph has no fallback field (always False)
        a, b = getattr(jg, f.name, False), getattr(pg, f.name)
        if isinstance(b, np.ndarray):
            a = np.asarray(a)
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("kind", ["pm", "legacy", "xw"])
def test_lvcsr_graph_host_arrays_identical(kind, pm, xw):
    if kind == "xw":
        _jt, _pt, jc, pc = _compilers(xw)
        jg, pg = jc.build(), pc.build()
        assert isinstance(pg, PL.LvcsrXwGraph) and not pg.cross_word_fallback
        for k, v in pg.kbest_arrays().items():
            np.testing.assert_array_equal(v, jg.kbest_arrays()[k])
    else:
        _jt, _pt, jc, pc = _compilers(pm)
        if kind == "pm":
            jg, pg = jc.build(), pc.build()
            assert isinstance(pg, PPM.LvcsrPmGraph)
        else:
            jg, pg = jc.build_word_internal_legacy(), pc.build_word_internal_legacy()
    _same_graph(jg, pg)
    if kind != "pm":
        np.testing.assert_array_equal(pg.state0_hash, jg.state0_hash)
        np.testing.assert_array_equal(pg.entry_slot_of_state,
                                      jg.entry_slot_of_state)


def _emissions(P, B=2, T=75, seed=0, cut=23):
    """Seeded (B, T, P) pdf emissions and frame lengths (T = 75: two chunks
    of 64)."""
    e = np.random.RandomState(seed).randn(B, T, P).astype(np.float32) * 4.0
    return e, np.array([T, T - cut], np.int32)


def test_pm_ckpt_pair_matches_jax(pm):
    jt, pt, jc, pc = _compilers(pm)
    jg, pg = jc.build(), pc.build()
    P = int(pg.state_pdf.max()) + 1
    emit, flens = _emissions(P)
    T = emit.shape[1]
    d = PL.graph_tensors(pg, PPM.PM_DEVICE_NAMES, CPU)
    e0, ep = PL.split_emissions(torch.from_numpy(emit), PPM._PM_TC)
    fl = torch.from_numpy(flens)
    a_T, ck = PPM.lvcsr_pm_decode_ckpt_device(e0, ep, d, fl, pg.lbp, pg.ubp)
    p_path, p_word, p_score = PPM.lvcsr_pm_backtrace_ckpt_device(
        a_T, ck, ep, d, fl, pg.lbp, pg.ubp, T)
    jd = {k: jnp.asarray(getattr(jg, k)) for k in PPM.PM_DEVICE_NAMES}
    je0, jep = JL.split_emissions(jnp.asarray(emit), JPM._PM_TC)
    jfl = jnp.asarray(flens)
    ja, jck = JPM.lvcsr_pm_decode_ckpt_device(
        je0, jep, jd["state_pdf"], jfl, jd["band"], jd["start"],
        jd["exit_w_grid"], jd["bo_c"], jd["pred_c"], jd["pred_w"], jd["p1_c"],
        jd["entry_w_c"], jg.lbp, jg.ubp)
    j_path, j_word, j_score = JPM.lvcsr_pm_backtrace_ckpt_device(
        ja, jck, jep, jd["state_pdf"], jfl, jd["band"], jd["exit_w_grid"],
        jd["eos_c"], jd["bo_c"], jd["pred_c"], jd["pred_w"], jd["p1_c"],
        jd["entry_w_c"], jd["chain_word"], jd["state_word"], jg.lbp, jg.ubp, T)
    np.testing.assert_array_equal(p_path.numpy(), np.asarray(j_path))
    np.testing.assert_array_equal(p_word.numpy(), np.asarray(j_word))
    np.testing.assert_allclose(p_score.numpy(), np.asarray(j_score), atol=1e-3,
                               rtol=0)
    assert (p_word.numpy() >= 0).sum() > 4  # the path crosses junctions


def test_xw_ckpt_pair_matches_jax(xw):
    jt, pt, jc, pc = _compilers(xw)
    jg, pg = jc.build(), pc.build()
    P = int(pg.state_pdf.max()) + 1
    emit, flens = _emissions(P, seed=1)
    T = emit.shape[1]
    d = PL.graph_tensors(pg, PL.XW_DEVICE_NAMES, CPU)
    e0, ep = PL.split_emissions(torch.from_numpy(emit), PL._XW_TC)
    fl = torch.from_numpy(flens)
    a_T, ck = PL.lvcsr_xw_decode_ckpt_device(e0, ep, d, fl, pg.lb, pg.ub, pg.num_p)
    p_path, p_word, p_score = PL.lvcsr_xw_backtrace_ckpt_device(
        a_T, ck, ep, d, fl, pg.lb, pg.ub, pg.num_p, T)
    jd = {k: jnp.asarray(getattr(jg, k)) for k in PL.XW_DEVICE_NAMES}
    je0, jep = JL.split_emissions(jnp.asarray(emit), JL._XW_TC)
    jfl = jnp.asarray(flens)
    RG, F = jg.rg_mask.shape
    ja, jck = JL.lvcsr_xw_decode_ckpt_device(
        je0, jep, jd["state_pdf"], jfl, jd["band"], jd["start"],
        jd["cell_exit_idx"], jd["cell_exit_w"], jd["bo_cell"], jd["cell_seg"],
        jd["rg_mask"], jd["entry_state"], jd["entry_w"], jd["ebo_idx"],
        jd["ebo_pad"], jd["p1e"], jd["se_cell"], jd["se_w"], jg.lb, jg.ub,
        jg.num_p)
    np.testing.assert_allclose(a_T.numpy(), np.asarray(ja), atol=1e-3, rtol=0)
    j_path, j_word, j_score = JL.lvcsr_xw_backtrace_ckpt_device(
        ja, jck, jep, jd["state_pdf"], jfl, jd["band"], jd["cell_exit_idx"],
        jd["cell_exit_w"], jd["bo_cell"], jd["cell_seg"], jd["rg_mask"],
        jd["entry_state"], jd["entry_w"], jd["ebo_idx"], jd["ebo_pad"],
        jd["p1e"], jd["se_cell"], jd["se_w"], jd["fin_state"], jd["fin_w"],
        jd["entry_word"], jd["entry_slot_of_state"], jd["state_word"],
        jg.lb, jg.ub, jg.num_p, F, RG, T)
    np.testing.assert_array_equal(p_path.numpy(), np.asarray(j_path))
    np.testing.assert_array_equal(p_word.numpy(), np.asarray(j_word))
    np.testing.assert_allclose(p_score.numpy(), np.asarray(j_score), atol=1e-3,
                               rtol=0)
    assert (p_word.numpy() >= 0).sum() > 4


def _small_lm_fixture(fx, name, n_words=40):
    """``fx`` with a bigram over ``n_words`` of its LM words in place of its
    LM: a graph small enough for the K-best functions."""
    tmp, cd, model_path, dict_path, _jlm, _plm, texts = fx
    words = sorted({w for t in texts for w in t.split()})[:n_words]
    rng = np.random.RandomState(8)
    jlm, plm = shared_lm(tmp, [" ".join(rng.choice(words, 5)) for _ in range(60)],
                         2, name)
    return tmp, cd, model_path, dict_path, jlm, plm, texts


def test_flat_kbest_matches_jax(pm):
    jt, pt, jc, pc = _compilers(_small_lm_fixture(pm, "pm_small40"),
                                cross_word=False)
    jg, pg = jc.build_word_internal_legacy(), pc.build_word_internal_legacy()
    names = ("state_pdf", "band", "start", "state0_hash", "exit_idx", "exit_w",
             "entry_idx", "entry_word", "entry_w", "p1", "bo", "big_pred",
             "big_w", "eos", "entry_slot_of_state", "state_word")
    d = PL.graph_tensors(pg, names, CPU)
    jd = {k: jnp.asarray(getattr(jg, k)) for k in names}
    P = int(pg.state_pdf.max()) + 1
    emit, flens = _emissions(P, T=30, seed=2, cut=8)
    K, T = 3, 30
    args = ("state_pdf", "band", "start", "state0_hash", "exit_idx", "exit_w",
            "entry_idx", "entry_word", "entry_w", "p1", "bo", "big_pred", "big_w")
    pa, ph, precs = PL.lvcsr_nbest_device(
        torch.from_numpy(emit), d["state_pdf"], torch.from_numpy(flens),
        *[d[k] for k in args[1:]], pg.lb, pg.ub, K)
    ja, jh, jrecs = JL.lvcsr_nbest_device(
        jnp.asarray(emit), jd["state_pdf"], jnp.asarray(flens),
        *[jd[k] for k in args[1:]], jg.lb, jg.ub, K)
    fin = np.asarray(ja) > -1e29
    np.testing.assert_allclose(pa.numpy()[fin], np.asarray(ja)[fin], atol=1e-3,
                               rtol=0)
    np.testing.assert_array_equal(ph.numpy()[fin], np.asarray(jh)[fin])
    for p, j in zip(precs, jrecs):
        np.testing.assert_array_equal(p.numpy()[: T - 1], np.asarray(j)[: T - 1])
    ps, ps0, prk = PL.lvcsr_nbest_final_select_device(
        pa, ph, d["exit_idx"], d["exit_w"], d["eos"], K)
    js, js0, jrk = JL.lvcsr_nbest_final_select_device(
        ja, jh, jd["exit_idx"], jd["exit_w"], jd["eos"], K)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-3, rtol=0)
    np.testing.assert_array_equal(ps0.numpy(), np.asarray(js0))
    pp, pw = PL.lvcsr_nbest_backtrace_device(
        ps0, prk, precs, torch.from_numpy(flens), d["entry_word"],
        d["entry_slot_of_state"], d["big_pred"], d["exit_idx"], d["state_word"],
        pg.lb, pg.ub, K, T=T)
    jp, jw = JL.lvcsr_nbest_backtrace_device(
        js0, jrk, jrecs, jnp.asarray(flens), jd["entry_word"],
        jd["entry_slot_of_state"], jd["big_pred"], jd["exit_idx"],
        jd["state_word"], jg.lb, jg.ub, K, T=T)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    host_p = PL.lvcsr_nbest_backtrace_host(
        pg, pa.numpy(), ph.numpy(), [r.numpy() for r in precs], flens, K, T=T)
    host_j = JL.lvcsr_nbest_backtrace_host(
        jg, np.asarray(ja), np.asarray(jh), jrecs, flens, K, T=T)
    for rp, rj in zip(host_p, host_j):
        assert len(rp) == len(rj) >= 2
        for (a, sa, ea), (b, sb, eb) in zip(rp, rj):
            np.testing.assert_array_equal(a, b)
            assert abs(sa - sb) <= 1e-3 and ea == eb


@pytest.mark.parametrize("kind", ["pm", "xw"])
def test_kbest_decode_matches_jax(kind, pm, xw):
    """The K-best junctions and their backtraces (the chain-major one with
    the device backtrace behind a position-major graph, the cross-word one
    with the host backtrace), through each package's
    ``Transcriber._lvcsr_nbest_decode`` on the same features."""
    # a 20-word LM keeps the K-best graph small; the graphs are set directly
    _tmp, _cd, model_path, dict_path, jlm, plm, _t = _small_lm_fixture(
        pm if kind == "pm" else xw, f"{kind}_small20", 20)
    jt = JT.Transcriber(model_path, dict_path, lm=jlm)
    pt = PT.Transcriber(model_path, dict_path, lm=plm, device="cpu")
    for tr, mod in ((jt, JL), (pt, PL)):
        tr._lvcsr = mod.LvcsrGraphCompiler(
            tr.aligner.compiler, tr.aligner.lexicon, tr.lm).build()
        tr._vocab = tr._lvcsr.words
    want = PPM.LvcsrPmGraph if kind == "pm" else PL.LvcsrXwGraph
    assert isinstance(pt._lvcsr, want)
    dim = 39 if kind == "pm" else 40
    ff = np.random.RandomState(3).randn(2, 14, dim).astype(np.float32)
    flens = np.array([14, 12], np.int32)
    W, gc, _wr = jt.aligner._device_gmm
    j_rows, _g = jt._lvcsr_nbest_decode(jnp.asarray(ff), flens, W, gc, 2)
    b = PT._TBatch([0, 1], flens, None, None, torch.from_numpy(ff),
                   torch.from_numpy(flens), torch.zeros(2, dtype=torch.int64))
    p_rows, g = pt._lvcsr_nbest_decode(b, pt.aligner.gmm, 2)
    assert g is pt._lvcsr_graph_for(2) and len(p_rows[0]) >= 1
    for rp, rj in zip(p_rows, j_rows):
        assert len(rp) == len(rj)
        for (a, sa, ea), (c, sc, ec) in zip(rp, rj):
            np.testing.assert_array_equal(a, c)
            assert abs(sa - sc) <= 1e-3 and ea == ec


@pytest.mark.parametrize("kind", ["pm", "xw"])
def test_transcribe_lvcsr_matches_jax(kind, pm, xw, monkeypatch):
    fx = pm if kind == "pm" else xw
    _tmp, corpus_dir, model_path, dict_path, jlm, plm, _t = fx
    seed_final_feats(monkeypatch, 39 if kind == "pm" else 40)
    jt = JT.Transcriber(model_path, dict_path, lm=jlm, batch_size=2)
    pt = PT.Transcriber(model_path, dict_path, lm=plm, batch_size=2, device="cpu")
    jr = jt.transcribe_corpus(JCorpus.load(corpus_dir))
    pr = pt.transcribe_corpus(PCorpus.load(corpus_dir))
    want = PPM.LvcsrPmGraph if kind == "pm" else PL.LvcsrXwGraph
    assert isinstance(pt._lvcsr, want) and not pt.cross_word_fallback
    assert pt.aligner.two_pass == (kind == "xw")
    _same_results(jr, pr)
    assert all(r.cross_word_fallback is False for r in pr.values())


def test_high_fanout_lm_keeps_the_junction_source(pm):
    """Kb > 127: the position-major junction's winning seen-bigram index is
    int32 in the port. The JAX package stores it as int8 (``lvcsr_pm.py``),
    which wraps past 127, so its backtrace there takes the backoff branch
    into the wrong word at the right score; it differs here by design
    (ROADMAP.md Queue 3). The junction and one backtrace step on a chain
    whose winning predecessor sits at index 200 of its list, then a decode
    against the chain-major K-best decode at K = 1."""
    tmp, corpus_dir, model_path, dict_path, _jlm, _plm, _t = pm
    pt = PT.Transcriber(model_path, dict_path, device="cpu")
    words = [f"junk{j}" for j in range(200)]
    # "ab" follows every junk word: 200 seen-bigram predecessors
    texts = [f"{w} ab" for w in words] + ["ab a"] * 5
    _jlm_fanout, lm = shared_lm(tmp, texts, 2, "fanout")
    comp = PL.LvcsrGraphCompiler(pt.aligner.compiler, pt.aligner.lexicon, lm)
    g = comp.build()
    assert isinstance(g, PPM.LvcsrPmGraph) and g.pred_c.shape[1] > 127
    d = PL.graph_tensors(g, PPM.PM_DEVICE_NAMES, CPU)
    target = int(np.flatnonzero(g.chain_word == g.words.index("ab"))[0])
    k_star = 200 - 1
    src_chain = int(g.pred_c[target, k_star])
    exit_pos = int(np.flatnonzero(g.exit_w_grid[:, src_chain] > -1e29)[0])
    alpha = torch.full((1, g.Pmax, g.C), -1.0e30)
    alpha[0, exit_pos, src_chain] = 0.0
    ent, (ent_src, exit_arg, bo_arg) = PPM._pm_junction(alpha, d, True)
    assert ent_src.dtype == torch.int32
    assert int(ent_src[0, target]) == k_star > 127
    # one reverse step from the target's entry cell lands on the source exit
    m = torch.full_like(alpha, -1.0e30)
    jwin = (ent > m[:, 0, :])
    bp = torch.zeros(alpha.shape, dtype=torch.uint8)
    s, w = PPM._pm_bstep(d, torch.tensor([10]), g.lbp, g.C,
                         torch.tensor([target]), (bp, jwin, ent_src, exit_arg,
                                                  bo_arg), 3)
    assert int(s[0]) == exit_pos * g.C + src_chain
    assert int(w[0]) == g.words.index("ab")
    # a decode on seeded emissions: the same words as K = 1
    emit, flens = _emissions(int(g.state_pdf.max()) + 1, T=70, seed=4)
    T = emit.shape[1]
    e0, ep = PL.split_emissions(torch.from_numpy(emit), PPM._PM_TC)
    fl = torch.from_numpy(flens)
    a_T, ck = PPM.lvcsr_pm_decode_ckpt_device(e0, ep, d, fl, g.lbp, g.ubp)
    path, word, score = PPM.lvcsr_pm_backtrace_ckpt_device(
        a_T, ck, ep, d, fl, g.lbp, g.ubp, T)
    lg = comp.build_word_internal_legacy()
    names = ("state_pdf", "band", "start", "state0_hash", "exit_idx", "exit_w",
             "entry_idx", "entry_word", "entry_w", "p1", "bo", "big_pred",
             "big_w", "eos", "entry_slot_of_state", "state_word")
    ld = PL.graph_tensors(lg, names, CPU)
    la, lh, lrecs = PL.lvcsr_nbest_device(
        torch.from_numpy(emit), ld["state_pdf"], fl,
        *[ld[k] for k in names[1:13]], lg.lb, lg.ub, 1)
    ls, ls0, lrk = PL.lvcsr_nbest_final_select_device(
        la, lh, ld["exit_idx"], ld["exit_w"], ld["eos"], 1)
    _lp, lw = PL.lvcsr_nbest_backtrace_device(
        ls0, lrk, lrecs, fl, ld["entry_word"], ld["entry_slot_of_state"],
        ld["big_pred"], ld["exit_idx"], ld["state_word"], lg.lb, lg.ub, 1, T=T)
    # junk words share pronunciations, and a tie between homophones may
    # break another way in the two layouts: compare pronunciations
    lex = pt.aligner.lexicon
    pron = {i: tuple(lex.words[w][0].phones) for i, w in enumerate(g.words)}
    for b in range(2):
        L = int(flens[b])
        got = [pron[int(x)] for x in word[b, :L] if x >= 0]
        want = [pron[int(x)] for x in lw[b, 0, :L] if x >= 0]
        assert got == want and len(got) >= 2
    np.testing.assert_allclose(score.numpy(), ls[:, 0].numpy(), atol=1e-3, rtol=0)


def test_xw_split_estimate_covers_the_checkpointed_decode(xw):
    """The cross-word batch split counts ``xw_ckpt_bytes_per_row`` whole,
    its per-chunk transient records included. The JAX package's estimate
    (``transcriber.py:777``) leaves those out and differs here by design
    (ROADMAP.md Queue 3)."""
    _tmp, _cd, model_path, dict_path, jlm, plm, _t = xw
    pt = PT.Transcriber(model_path, dict_path, lm=plm, device="cpu")
    pt._ensure_graph(nominal_frames=300)
    g = pt._lvcsr
    assert isinstance(g, PL.LvcsrXwGraph)
    RG, F = g.rg_mask.shape
    P_pdf = int(g.state_pdf.max()) + 1
    for T in (120, 300, 3000):
        need = PL.xw_ckpt_bytes_per_row(g.num_states, len(g.entry_state),
                                        g.cell_exit_idx.shape[0], P_pdf,
                                        g.num_p, F, RG, T)
        assert pt._lvcsr_rec_bytes_per_row(T) >= need
        # what the JAX package's split counts: checkpoints and emissions only
        jax_est = T * ((4 * g.num_states) // JL._XW_TC + 4 * P_pdf)
        assert jax_est < need
    # the split honours it: room for two rows a chunk
    B, T = 5, 300
    pt.LVCSR_REC_BYTES = 2.5 * pt._lvcsr_rec_bytes_per_row(T)
    b = PT._TBatch(list(range(B)), np.full(B, T, np.int32), None, None,
                   torch.zeros((B, T, 40)), torch.full((B,), T), torch.zeros(B))
    assert [len(x.utts) for x in pt._lvcsr_split_rows([b])] == [2, 2, 1]


def test_longer_corpus_regates_the_cross_word_build(xw, monkeypatch):
    """A graph gated for a short corpus is gated again when a later corpus
    has longer utterances: with a budget between the two corpora's needs,
    the second falls back to word-internal context. The JAX package keeps
    the first graph (``transcriber.py:336``) and differs here by design
    (ROADMAP.md Queue 3)."""
    tmp, corpus_dir, model_path, dict_path, _jlm, plm, _t = xw
    pt = PT.Transcriber(model_path, dict_path, lm=plm, batch_size=3,
                        device="cpu")
    short = PCorpus.load(corpus_dir)
    pt.transcribe_corpus(short)
    g = pt._lvcsr
    assert isinstance(g, PL.LvcsrXwGraph) and not pt.cross_word_fallback
    gated = pt._gate_frames
    RG, F = g.rg_mask.shape
    P_pdf = int(g.state_pdf.max()) + 1

    def need(T):
        return PL.xw_ckpt_bytes_per_row(g.num_states, len(g.entry_state),
                                        g.cell_exit_idx.shape[0], P_pdf,
                                        g.num_p, F, RG, T)

    long_frames = 4 * gated
    monkeypatch.setattr(PL, "_REC_BUDGET", (need(gated) + need(long_frames)) / 2)
    pt._ensure_graph(nominal_frames=gated)  # same length: the graph stays
    assert pt._lvcsr is g
    pt._ensure_graph(nominal_frames=long_frames)
    assert isinstance(pt._lvcsr, PPM.LvcsrPmGraph)
    assert pt.cross_word_fallback and pt._gate_frames == long_frames


FLAT_NAMES = ("state_pdf", "band", "start", "exit_idx", "exit_w", "entry_idx",
              "entry_word", "entry_w", "p1", "bo", "big_pred", "big_w", "eos",
              "entry_slot_of_state", "state_word", "state0_hash")
# the decoders' graph arguments after (emit_pdf, state_pdf, frame_lengths)
FLAT_DECODE = ("band", "start", "exit_idx", "exit_w", "entry_idx", "entry_word",
               "entry_w", "p1", "bo", "big_pred", "big_w")


def _flat_pairs(mod, d, emit, flens, g, T, array):
    """Both chain-major pairs of one package (``mod``) on the same
    emissions: the record-based decode with its device and host
    backtraces, the checkpointed decode with its backtrace. Returns
    (alpha_T, recs, device rows, host rows, checkpointed rows), rows as
    (path, word_at, score)."""
    e, fl = array(emit), array(flens)
    alpha_T, recs = mod.lvcsr_decode_device(
        e, d["state_pdf"], fl, *[d[k] for k in FLAT_DECODE], g.lb, g.ub)
    dev = mod.lvcsr_backtrace_device(
        alpha_T, recs, fl, d["exit_idx"], d["exit_w"], d["eos"], d["entry_word"],
        d["entry_slot_of_state"], d["big_pred"], d["state_word"], g.lb, T)
    host = mod.lvcsr_backtrace_host(g, np.asarray(alpha_T), recs, flens, T=T)
    a2, ck, crecs = mod.lvcsr_decode_ckpt_device(
        e, d["state_pdf"], fl, *[d[k] for k in FLAT_DECODE], g.lb, g.ub)
    ckpt = mod.lvcsr_backtrace_ckpt_device(
        a2, ck, crecs, e, d["state_pdf"], fl, d["band"], d["exit_idx"],
        d["exit_w"], d["eos"], d["entry_idx"], d["entry_word"], d["entry_w"],
        d["p1"], d["bo"], d["big_pred"], d["big_w"], d["entry_slot_of_state"],
        d["state_word"], g.lb, g.ub, T)
    return alpha_T, recs, dev, host, ckpt


def _rows_equal(dev, host, flens):
    """Device (path, word_at, score) rows against host (path, score,
    events) rows: paths and entered words exact, scores within 1e-4."""
    path, word, score = (np.asarray(x) for x in dev)
    for b, (hp, hs, he) in enumerate(host):
        L = int(flens[b])
        np.testing.assert_array_equal(path[b], hp)
        assert [(t, int(w)) for t, w in enumerate(word[b, :L]) if w >= 0] == he
        assert abs(float(score[b]) - hs) <= 1e-4


def test_chain_major_pairs_match_jax(pm):
    """The chain-major 1-best pairs (record-based with its device and host
    backtraces, checkpointed) of both packages on the same pdf emissions:
    records equal, paths and entered words exact, scores within 1e-4; and
    within each package the three backtraces agree decision for decision."""
    _jt, _pt, jc, pc = _compilers(_small_lm_fixture(pm, "pm_small40"),
                                  cross_word=False)
    jg, pg = jc.build_word_internal_legacy(), pc.build_word_internal_legacy()
    assert pg.big_pred.shape[1] <= 127  # the JAX int8 ent_src holds here
    P = int(pg.state_pdf.max()) + 1
    emit, flens = _emissions(P, seed=6)
    T = emit.shape[1]
    pd = PL.graph_tensors(pg, FLAT_NAMES, CPU)
    jd = {k: jnp.asarray(getattr(jg, k)) for k in FLAT_NAMES}
    pa, precs, pdev, phost, pck = _flat_pairs(
        PL, pd, emit, flens, pg, T, torch.from_numpy)
    ja, jrecs, jdev, jhost, jck = _flat_pairs(
        JL, jd, emit, flens, jg, T, jnp.asarray)
    fin = np.asarray(ja) > -1e29
    np.testing.assert_allclose(pa.numpy()[fin], np.asarray(ja)[fin], atol=1e-4,
                               rtol=0)
    for p, j in zip(precs, jrecs):
        np.testing.assert_array_equal(p.numpy()[: T - 1],
                                      np.asarray(j)[: T - 1].astype(p.numpy().dtype))
    for rows in (pdev, pck, jdev, jck):
        _rows_equal(rows, phost, flens)
        _rows_equal(rows, jhost, flens)
    assert sum(len(e) for _p, _s, e in phost) > 4  # the paths cross junctions


def test_record_cross_word_pair_matches_jax(xw):
    """The record-based cross-word pair of both packages on the same pdf
    emissions: records equal, device and host backtraces exact against
    each other and across packages (scores within 1e-4), and equal to the
    port's checkpointed pair."""
    _jt, _pt, jc, pc = _compilers(xw)
    jg, pg = jc.build(), pc.build()
    assert isinstance(pg, PL.LvcsrXwGraph)
    P = int(pg.state_pdf.max()) + 1
    emit, flens = _emissions(P, seed=7)
    T = emit.shape[1]
    d = PL.graph_tensors(pg, PL.XW_DEVICE_NAMES, CPU)
    fl = torch.from_numpy(flens)
    pa, precs = PL.lvcsr_xw_decode_device(torch.from_numpy(emit), d, fl, pg.lb,
                                          pg.ub, pg.num_p)
    pdev = PL.lvcsr_xw_backtrace_device(pa, precs, d, fl, pg.lb, T)
    phost = PL.lvcsr_xw_backtrace_host(pg, pa.numpy(), [r.numpy() for r in precs],
                                       flens, T=T)
    jd = {k: jnp.asarray(getattr(jg, k)) for k in PL.XW_DEVICE_NAMES}
    jfl = jnp.asarray(flens)
    RG, F = jg.rg_mask.shape
    ja, jrecs = JL.lvcsr_xw_decode_device(
        jnp.asarray(emit), jd["state_pdf"], jfl, jd["band"], jd["start"],
        jd["cell_exit_idx"], jd["cell_exit_w"], jd["bo_cell"], jd["cell_seg"],
        jd["rg_mask"], jd["entry_state"], jd["entry_w"], jd["ebo_idx"],
        jd["ebo_pad"], jd["p1e"], jd["se_cell"], jd["se_w"], jg.lb, jg.ub,
        jg.num_p)
    jdev = JL.lvcsr_xw_backtrace_device(
        ja, jrecs, jfl, jd["fin_state"], jd["fin_w"], jd["entry_word"],
        jd["entry_slot_of_state"], jd["se_cell"], jd["ebo_idx"],
        jd["cell_exit_idx"], jd["state_word"], jg.lb, F, RG, T)
    jhost = JL.lvcsr_xw_backtrace_host(jg, np.asarray(ja), jrecs, flens, T=T)
    fin = np.asarray(ja) > -1e29
    np.testing.assert_allclose(pa.numpy()[fin], np.asarray(ja)[fin], atol=1e-4,
                               rtol=0)
    for p, j in zip(precs, jrecs):
        np.testing.assert_array_equal(p.numpy()[: T - 1], np.asarray(j)[: T - 1])
    e0, ep = PL.split_emissions(torch.from_numpy(emit), PL._XW_TC)
    a_T, ck = PL.lvcsr_xw_decode_ckpt_device(e0, ep, d, fl, pg.lb, pg.ub, pg.num_p)
    pck = PL.lvcsr_xw_backtrace_ckpt_device(a_T, ck, ep, d, fl, pg.lb, pg.ub,
                                            pg.num_p, T)
    for rows in (pdev, pck, jdev):
        _rows_equal(rows, phost, flens)
        _rows_equal(rows, jhost, flens)
    assert sum(len(e) for _p, _s, e in phost) > 4


def _capture_decodes(monkeypatch):
    """Record each ``Transcriber._lvcsr_decode_device`` call of the port:
    (handle, final features, frame lengths, model)."""
    captured = []
    real = PT.Transcriber._lvcsr_decode_device

    def spy(self, ff, flens_dev, gmm):
        handle = real(self, ff, flens_dev, gmm)
        captured.append((handle, ff, flens_dev, gmm))
        return handle

    monkeypatch.setattr(PT.Transcriber, "_lvcsr_decode_device", spy)
    return captured


@pytest.mark.parametrize("kind", ["pm", "xw"])
def test_production_routes_match_the_reference_decoders(kind, pm, xw, monkeypatch):
    """The port's production 1-best routes against its reference decoders
    on the emissions of every decode of a ``transcribe`` (both passes of
    the SAT two-pass), as the JAX package's ``test_transcription.py`` and
    ``test_triphone.py`` hold its own: the position-major pair against the
    chain-major pairs (scores within 1e-4, the same words at the same
    frames; paths number states differently, so the per-frame words are
    compared), the checkpointed cross-word pair against the record-based
    one (paths exact). Junk words share pronunciations, and a tie between
    homophones may break another way in the two layouts, so words compare
    by pronunciation."""
    fx = pm if kind == "pm" else xw
    _tmp, corpus_dir, model_path, dict_path, _jlm, plm, _t = fx
    captured = _capture_decodes(monkeypatch)
    pt = PT.Transcriber(model_path, dict_path, lm=plm, batch_size=2, device="cpu")
    pt.transcribe_corpus(PCorpus.load(corpus_dir))
    g = pt._lvcsr
    want = PPM.LvcsrPmGraph if kind == "pm" else PL.LvcsrXwGraph
    assert isinstance(g, want) and len(captured) >= (1 if kind == "pm" else 2)
    lex = pt.aligner.lexicon
    for handle, ff, flens_dev, gmm in captured:
        T = int(ff.shape[1])
        flens = flens_dev.numpy()
        prod = pt._lvcsr_backtrace_device_dispatch(handle, flens_dev, T)
        emit = PT._lvcsr_emissions(ff, gmm, pt.acoustic_scale).numpy()
        if kind == "pm":
            lg = pt._legacy_flat_graph()
            d = PL.graph_tensors(lg, FLAT_NAMES, CPU)
            _a, _r, dev, host, ck = _flat_pairs(PL, d, emit, flens, lg, T,
                                                torch.from_numpy)
            _rows_equal(dev, host, flens)
            _rows_equal(ck, host, flens)
            pron = {v: tuple(lex.words[w][0].phones) for v, w in enumerate(g.words)}
            path, word, score = (x.numpy() for x in prod)
            for b, (hp, hs, he) in enumerate(host):
                L = int(flens[b])
                assert abs(float(score[b]) - hs) <= 1e-4
                assert [(t, pron[int(v)]) for t, v in enumerate(word[b, :L])
                        if v >= 0] == [(t, pron[v]) for t, v in he]
                pw = [pron.get(int(v)) for v in g.state_word[path[b, :L]]]
                hw = [pron.get(int(v)) for v in lg.state_word[hp[:L]]]
                assert pw == hw
        else:
            d = pt._lvcsr_dev()
            fl = torch.from_numpy(flens)
            a_T, recs = PL.lvcsr_xw_decode_device(torch.from_numpy(emit), d, fl,
                                                  g.lb, g.ub, g.num_p)
            dev = PL.lvcsr_xw_backtrace_device(a_T, recs, d, fl, g.lb, T)
            host = PL.lvcsr_xw_backtrace_host(g, a_T.numpy(),
                                              [r.numpy() for r in recs], flens, T=T)
            for rows in (dev, prod):
                _rows_equal(rows, host, flens)


def test_transcriber_chain_major_route_matches_jax(pm, monkeypatch):
    """A plain chain-major graph decodes through the checkpointed
    chain-major pair in both packages' ``Transcriber``: on the same final
    features, the same transcripts, words and scores (atol 1e-3)."""
    _tmp, corpus_dir, model_path, dict_path, jlm, plm, _t = pm
    seed_final_feats(monkeypatch, 39)
    jt = JT.Transcriber(model_path, dict_path, lm=jlm, batch_size=2)
    pt = PT.Transcriber(model_path, dict_path, lm=plm, batch_size=2, device="cpu")
    for tr, mod in ((jt, JL), (pt, PL)):
        tr._lvcsr = mod.LvcsrGraphCompiler(
            tr.aligner.compiler, tr.aligner.lexicon, tr.lm,
            cross_word=False).build_word_internal_legacy()
        tr._vocab = tr._lvcsr.words
    captured = _capture_decodes(monkeypatch)
    jr = jt.transcribe_corpus(JCorpus.load(corpus_dir))
    pr = pt.transcribe_corpus(PCorpus.load(corpus_dir))
    assert captured and all(h[0][0] == "flat_ckpt" for h in captured)
    assert type(pt._lvcsr) is PL.LvcsrGraph
    _same_results(jr, pr)


def test_wide_chain_major_junction_keeps_the_source(pm):
    """Kb > 127 on the chain-major junction: the winning seen-bigram index
    (``ent_src``) at 199 stays 199 in the port's int32 record, and one
    reverse step lands on that source's exit. The JAX package's int8
    record wraps it to -57, which reads as the backoff, and its step lands
    on the backoff's source, another word, instead (ROADMAP.md Queue 3)."""
    tmp, _cd, model_path, dict_path, _jlm, _plm, _t = pm
    words = [f"junk{j}" for j in range(200)]
    texts = [f"{w} ab" for w in words] + ["ab a"] * 5
    jlm, plm = shared_lm(tmp, texts, 2, "fanout_flat")
    jt = JT.Transcriber(model_path, dict_path, lm=jlm)
    pt = PT.Transcriber(model_path, dict_path, lm=plm, device="cpu")
    jg = JL.LvcsrGraphCompiler(jt.aligner.compiler, jt.aligner.lexicon, jlm,
                               cross_word=False).build_word_internal_legacy()
    pg = PL.LvcsrGraphCompiler(pt.aligner.compiler, pt.aligner.lexicon, plm,
                               cross_word=False).build_word_internal_legacy()
    _same_graph(jg, pg)
    v = pg.words.index("ab")
    k_star = int(np.flatnonzero(pg.big_w[v] > -1e29).max())
    assert pg.big_pred.shape[1] > 127 and k_star > 127
    src_u = int(pg.big_pred[v, k_star])
    u2 = pg.words.index("a")  # never precedes "ab": no seen bigram to it
    assert u2 not in set(pg.big_pred[v][pg.big_w[v] > -1e29].tolist())
    # two live exits: the source at k_star's (its word scores 0) and "a",
    # which scores just enough to win the backoff maximum; the seen bigram
    # from the source still beats the backoff path into "ab"
    S = pg.num_states
    alpha = np.full((1, S), -1.0e30, np.float32)
    for u, score in ((src_u, 0.0), (u2, float(pg.bo[src_u] - pg.bo[u2]) + 0.01)):
        e = int(np.flatnonzero(pg.exit_w[u] > -1e29)[0])
        alpha[0, int(pg.exit_idx[u, e])] = score - pg.exit_w[u, e]
    assert pg.big_w[v, k_star] > pg.bo[src_u] + 0.01 + pg.p1[v]
    pd = PL.graph_tensors(pg, FLAT_NAMES, CPU)
    jd = {k: jnp.asarray(getattr(jg, k)) for k in FLAT_NAMES}
    args = ("exit_w", "bo", "big_pred", "big_w", "p1")
    _pv, (p_src, p_exit, p_bo) = PL._flat_junction(
        torch.from_numpy(alpha), pd["exit_idx"].reshape(-1),
        *[pd[k] for k in args], True)
    _jv, j_src, j_exit, j_bo = JL._flat_junction(
        jnp.asarray(alpha), jd["exit_idx"].reshape(-1), *[jd[k] for k in args],
        True)
    assert p_src.dtype == torch.int32 and int(p_src[0, v]) == k_star
    assert int(np.asarray(j_src)[0, v]) == k_star - 256 < 0
    # one reverse step from the word's entry state, the junction won there
    s = torch.tensor([int(pg.entry_idx[int(np.flatnonzero(pg.entry_word == v)[0])])])
    bp = torch.full((1, S), 0x80, dtype=torch.uint8)
    p_s, p_w = PL._flat_bstep(torch.tensor([10]), pd["entry_slot_of_state"],
                              pd["entry_word"], pd["big_pred"], pd["exit_idx"],
                              pg.lb, s, (bp, p_src, p_exit, p_bo), 3)
    assert int(p_s[0]) == int(pg.exit_idx[src_u, int(p_exit[0, src_u])])
    assert int(p_w[0]) == v
    jstep = JL._make_flat_bstep(jnp.asarray([10]), jd["entry_slot_of_state"],
                                jd["entry_word"], jd["big_pred"], jd["exit_idx"],
                                jg.lb, 1)
    j_s, (_s, j_w) = jstep(jnp.asarray([int(s[0])]), (
        jnp.asarray(bp.numpy()), j_src, j_exit, j_bo, 3))
    j_u = int(np.asarray(j_bo)[0])
    assert j_u == u2 == int(p_bo[0])  # the backoff's source is the other word
    assert int(j_s[0]) == int(pg.exit_idx[u2, int(np.asarray(j_exit)[0, u2])])
    assert int(j_s[0]) != int(p_s[0])
