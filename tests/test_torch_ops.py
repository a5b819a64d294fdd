"""Device modules of the PyTorch port against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port (``device="cpu"``). Tolerances:

* MFCC and phase A: rtol 1e-5 / atol 1e-4, the JAX package's own bar for
  its device MFCC (``tests/test_mfcc.py``). The FFTs and sums run in
  another order. The per-speaker sums add up to a few hundred frames, so
  their atol is 1e-4 per frame summed.
* Final features (deltas, splice, LDA): atol 1e-5.
* All-pdf emissions: rtol 1e-5 (the product sums in another order).
* Band densify, band limits, graph arrays, host label helpers: exact.
* Viterbi paths: exact; scores atol 1e-3 (float32 sums over a few hundred
  frames).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import montreal_forced_aligner_tpu.align.aligner as JA
import montreal_forced_aligner_tpu.graph.compiler as JG
import montreal_forced_aligner_tpu.ops.feats as JF
import montreal_forced_aligner_tpu.ops.mfcc as JM
import montreal_forced_aligner_tpu.ops.viterbi as JV
import montreal_forced_aligner_tpu_torch.align.aligner as PA
import montreal_forced_aligner_tpu_torch.graph.compiler as PG
import montreal_forced_aligner_tpu_torch.ops.feats as PF
import montreal_forced_aligner_tpu_torch.ops.mfcc as PM
import montreal_forced_aligner_tpu_torch.ops.viterbi as PV
from montreal_forced_aligner_tpu.ops.gmm_loglikes import (
    gmm_loglikes as j_gmm_loglikes,
    select_state_emissions as j_select,
)
from montreal_forced_aligner_tpu_torch.ops.gmm_loglikes import (
    gmm_loglikes as p_gmm_loglikes,
    select_state_emissions as p_select,
)
from montreal_forced_aligner_tpu_torch.params import gmm_params_from_numpy

from helpers import build_synthetic_corpus, build_synthetic_model

CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _waves(seed=0, lengths=(16000, 9100, 23457)):
    """Broadband integer audio (noise plus a tone). Every mel band holds
    energy, as in speech: a near-empty band's log would amplify the FFTs'
    round-off differences past the MFCC bar."""
    rng = np.random.RandomState(seed)
    out = []
    for n in lengths:
        t = np.arange(n) / 16000.0
        w = rng.randn(n) * 1000 + 2000 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t)
        out.append(np.round(w).astype(np.float32))
    return out


# -- MFCC and phase A --------------------------------------------------------


@pytest.mark.parametrize(
    "cfg",
    [
        JM.MfccConfig(),
        JM.MfccConfig(use_energy=True, num_mel_bins=40, num_coefficients=20),
        JM.MfccConfig(snip_edges=True, use_energy=True, raw_energy=False,
                      energy_floor=1.0),
    ],
    ids=["default", "energy", "snip-edges"],
)
def test_mfcc_matches_jax(cfg):
    pcfg = PM.MfccConfig(**cfg.__dict__)
    for name, value in cfg.constants().items():
        np.testing.assert_array_equal(pcfg.constants()[name], value, err_msg=name)
    waves = _waves()
    padded, lens = JM.pad_waves_for_mfcc(waves, cfg, 32000)
    p_padded, p_lens = PM.pad_waves_for_mfcc(waves, pcfg, 32000)
    np.testing.assert_array_equal(p_padded, padded)
    np.testing.assert_array_equal(p_lens, lens)
    assert padded.dtype == np.int16  # integral audio ships as int16
    max_frames = cfg.num_frames(32000)
    assert pcfg.num_frames(32000) == max_frames
    want = np.asarray(JM._mfcc_device(jnp.asarray(padded), cfg, max_frames))
    got = PM._mfcc_device(_t(padded), pcfg, max_frames).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_phase_a_speaker_sums_match_jax():
    cfg = JM.MfccConfig()
    waves = _waves(1, lengths=(16000, 12000, 8000, 15000))
    padded, lens = JM.pad_waves_for_mfcc(waves, cfg, 16000)
    flens = np.array([cfg.num_frames(int(n)) for n in lens], np.int32)
    spk = np.array([2, 0, 2, 1], np.int32)
    max_frames = cfg.num_frames(16000)
    f_j, s_j = JA._mfcc_and_spk_stats(
        jnp.asarray(padded), jnp.asarray(flens), jnp.asarray(spk), cfg,
        max_frames, 3,
    )
    f_p, s_p = PA._mfcc_and_spk_stats(
        _t(padded), _t(flens), _t(spk.astype(np.int64)),
        PM.MfccConfig(**cfg.__dict__), max_frames, 3,
    )
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        s_p.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-4 * flens.sum()
    )


# -- final features ----------------------------------------------------------


def _feats(seed=0, B=3, T=17, D=13):
    rng = np.random.RandomState(seed)
    x = (rng.randn(B, T, D) * 3).astype(np.float32)
    flens = np.array([T, 9, 1][:B], np.int32)
    return x, flens


def test_frame_mask_and_edge_fill_match_jax():
    x, flens = _feats()
    np.testing.assert_array_equal(
        PF.frame_mask(_t(flens), 17).numpy(),
        np.asarray(JF.frame_mask(jnp.asarray(flens), 17)),
    )
    np.testing.assert_array_equal(
        PF.edge_fill(_t(x), _t(flens)).numpy(),
        np.asarray(JF.edge_fill(jnp.asarray(x), jnp.asarray(flens))),
    )


@pytest.mark.parametrize("order,window", [(2, 2), (1, 3)])
def test_deltas_match_jax(order, window):
    x, flens = _feats(1)
    want = JF.compute_deltas(jnp.asarray(x), jnp.asarray(flens), order, window)
    got = PF.compute_deltas(_t(x), _t(flens), order, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("left,right", [(3, 3), (1, 2)])
def test_splice_matches_jax(left, right):
    x, flens = _feats(2)
    want = JF.splice_frames(jnp.asarray(x), jnp.asarray(flens), left, right)
    got = PF.splice_frames(_t(x), _t(flens), left, right)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("affine", [False, True])
def test_apply_transform_matches_jax(affine):
    x, _ = _feats(3, D=91)
    rng = np.random.RandomState(4)
    m = rng.randn(40, 92 if affine else 91).astype(np.float32) / 9.0
    want = JF.apply_transform(jnp.asarray(x), jnp.asarray(m))
    got = PF.apply_transform(_t(x), _t(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("lda", [False, True], ids=["deltas", "splice-lda"])
def test_final_feats_match_jax(lda):
    x, flens = _feats(5, B=3, T=23, D=13)
    rng = np.random.RandomState(6)
    means = rng.randn(3, 13).astype(np.float32)
    mat = rng.randn(40, 91).astype(np.float32) / 9.0 if lda else None
    want = JA._final_feats(
        jnp.asarray(x), jnp.asarray(flens), jnp.asarray(means),
        None if mat is None else jnp.asarray(mat),
    )
    got = PA._final_feats(_t(x), _t(flens), _t(means), None if mat is None else _t(mat))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -- emissions ---------------------------------------------------------------


def test_all_pdf_emissions_match_jax():
    rng = np.random.RandomState(7)
    P, G, D = 11, 3, 39
    miv = rng.randn(P, G, D).astype(np.float32)
    iv = rng.uniform(0.2, 2.0, (P, G, D)).astype(np.float32)
    gc = rng.uniform(-80, -40, (P, G)).astype(np.float32)
    gc[2, 1:] = -np.inf  # padded Gaussians
    feats = rng.randn(2, 15, D).astype(np.float32)
    state_pdf = rng.randint(0, P, (2, 21)).astype(np.int32)
    W = np.concatenate([miv.reshape(-1, D), -0.5 * iv.reshape(-1, D)], 1).T
    ll_j = j_gmm_loglikes(jnp.asarray(feats), jnp.asarray(W), jnp.asarray(gc))
    em_j = j_select(ll_j, jnp.asarray(state_pdf))
    params = gmm_params_from_numpy(miv, iv, gc)
    np.testing.assert_array_equal(params.W.numpy(), W.astype(np.float32))
    ll_p = p_gmm_loglikes(_t(feats), params.W, params.gconsts)
    em_p = p_select(ll_p, _t(state_pdf))
    np.testing.assert_allclose(ll_p.numpy(), np.asarray(ll_j), rtol=1e-5)
    np.testing.assert_allclose(em_p.numpy(), np.asarray(em_j), rtol=1e-5)


def test_boost_silence_matches_jax_rule():
    rng = np.random.RandomState(8)
    gc = rng.uniform(-80, -40, (6, 2)).astype(np.float32)
    gc[4, 1] = -np.inf
    params = gmm_params_from_numpy(
        np.zeros((6, 2, 3), np.float32), np.ones((6, 2, 3), np.float32), gc,
        boost_silence=1.5, silence_pdfs=np.array([0, 4]),
    )
    want = gc.copy()
    want[[0, 4]] += np.log(1.5)  # aligner.py _ali_params_on
    np.testing.assert_array_equal(params.gconsts.numpy(), want)
    assert params.rows[4, 1, 6].item() == np.float32(-1.0e30)  # padded: NEG_INF
    with pytest.raises(ValueError):
        gmm_params_from_numpy(np.zeros((1, 1, 3)), np.ones((1, 1, 3)),
                              np.zeros((1, 1)), boost_silence=2.0)


# -- graphs and Viterbi ------------------------------------------------------


@pytest.fixture(scope="module")
def graph_pair(tmp_path_factory):
    """Both packages' aligners on the synthetic mono model, and each one's
    batched graph arrays for the same transcripts."""
    tmp = tmp_path_factory.mktemp("graphs")
    _corpus, wave = build_synthetic_corpus(tmp)
    model_path, dict_path = build_synthetic_model(tmp, wave=wave)
    ja = JA.PretrainedAligner(model_path, dict_path)
    pa = PA.PretrainedAligner(model_path, dict_path, device="cpu")
    texts = ["ab a", "a b ab ba", "ba", "b a b a a"]
    jg = JG.batch_graphs([ja.compiler.compile(ja.tokenizer.tokenize(t)) for t in texts])
    pg = PG.batch_graphs([pa.compiler.compile(pa.tokenizer.tokenize(t)) for t in texts])
    return ja, pa, jg, pg


def test_batch_graphs_match_jax(graph_pair):
    _ja, _pa, jg, pg = graph_pair
    assert sorted(jg) == sorted(pg)
    for key in jg:
        if isinstance(jg[key], np.ndarray):
            assert jg[key].dtype == pg[key].dtype, key
            np.testing.assert_array_equal(pg[key], jg[key], err_msg=key)
        else:
            assert jg[key] == pg[key], key


def test_ship_graph_to_device_round_trips(graph_pair):
    _ja, _pa, _jg, pg = graph_pair
    graph = PG.ship_graph_to_device(pg, CPU)
    for key in PG.DEVICE_INT_GRAPH_KEYS + PG.DEVICE_FLOAT_GRAPH_KEYS:
        x = getattr(graph, key)
        assert isinstance(x, torch.Tensor), key
        np.testing.assert_array_equal(x.numpy(), pg[key], err_msg=key)
        assert x.dtype in (torch.int32, torch.float32), key
    for key in PG.HOST_GRAPH_KEYS:
        assert isinstance(getattr(graph, key), np.ndarray), key


def test_band_limits_and_densify_match_jax(graph_pair):
    _ja, _pa, jg, pg = graph_pair
    limits = JV.band_limits_from_arcs(jg)
    assert limits is not None
    assert PV.band_limits_from_arcs(pg) == limits
    for lb, ub in [limits, (16, 128)]:
        want = JV.densify_band(JG.ship_graph_to_device(jg), lb, ub)
        got = PV.densify_band(PG.ship_graph_to_device(pg, CPU), lb, ub)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for lo, hi in [(0, 3), (-2, 9), (-16, 128), (-17, 3), (0, 129)]:
        assert PV.band_limits_for(lo, hi) == JV.band_limits_for(lo, hi)
    assert PV.BAND_BUCKETS == JV.BAND_BUCKETS


def _graph_emissions(pg, seed, T=40):
    rng = np.random.RandomState(seed)
    B, S = pg["state_pdf"].shape
    emit = (rng.randn(B, T, S) * 4).astype(np.float32)
    flens = np.array([T, 31, 25, 12][:B], np.int32)
    return emit, flens


def test_viterbi_paths_match_jax(graph_pair):
    _ja, _pa, jg, pg = graph_pair
    emit, flens = _graph_emissions(pg, 9)
    jgraph = JG.ship_graph_to_device(jg)
    pgraph = PG.ship_graph_to_device(pg, CPU)
    lb, ub = PV.band_limits_from_arcs(pg)
    st_j, sc_j = JV.viterbi_align_batch_band(
        jnp.asarray(emit), jnp.asarray(flens), JV.densify_band(jgraph, lb, ub),
        jgraph.start, jgraph.final, lb, ub, acoustic_scale=0.1,
    )
    st_p, sc_p = PV.viterbi_align_batch_band(
        _t(emit), _t(flens), PV.densify_band(pgraph, lb, ub),
        pgraph.start, pgraph.final, lb, ub, acoustic_scale=0.1,
    )
    np.testing.assert_array_equal(st_p.numpy(), np.asarray(st_j))
    np.testing.assert_allclose(sc_p.numpy(), np.asarray(sc_j), atol=1e-3)
    # the dense recursion (graphs beyond the largest band) finds the same
    std_j, scd_j = JV.viterbi_align_batch(
        jnp.asarray(emit), jnp.asarray(flens), jgraph, acoustic_scale=0.1
    )
    std_p, scd_p = PV.viterbi_align_batch(_t(emit), _t(flens), pgraph, 0.1)
    np.testing.assert_array_equal(std_p.numpy(), np.asarray(std_j))
    np.testing.assert_allclose(scd_p.numpy(), np.asarray(scd_j), atol=1e-3)
    np.testing.assert_array_equal(std_p.numpy(), st_p.numpy())


def test_host_label_helpers_match_jax(graph_pair):
    _ja, _pa, jg, pg = graph_pair
    emit, flens = _graph_emissions(pg, 10)
    pgraph = PG.ship_graph_to_device(pg, CPU)
    path, _ = PV.viterbi_align_batch(_t(emit), _t(flens), pgraph, 0.1)
    path = path.numpy()
    for got, want in zip(
        PV.extract_frame_labels_host(pg, path),
        JV.extract_frame_labels_host(jg, path),
    ):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        PV.frame_tids_host(pg, path, flens), JV.frame_tids_host(jg, path, flens)
    )


# -- the JAX package's ops without a counterpart before: each against the JAX
# function on the same seeded inputs, rtol 1e-5 --------------------------------


def _close(got, want, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_ops_exports_match_jax():
    import montreal_forced_aligner_tpu.ops as JO
    import montreal_forced_aligner_tpu_torch.ops as PO

    assert set(JO.__all__) <= set(PO.__all__)
    assert {"accumulate_cmvn_stats", "apply_cmvn"} <= set(PO.__all__)
    for name in PO.__all__:
        assert getattr(PO, name).__module__.startswith(
            "montreal_forced_aligner_tpu_torch.ops.")


@pytest.mark.parametrize("norm_vars", [False, True])
def test_cmvn_stats_and_apply_match_jax(norm_vars):
    feats, _fl = _feats(seed=4, B=5, T=23)
    # every speaker with frames has several: a one-frame speaker's variance
    # is a cancellation to zero, whose float32 rounding is noise
    flens = np.array([23, 7, 19, 4, 12], np.int32)
    spk = np.array([2, 0, 2, 1, 0], np.int32)
    # the JAX function's body, run eagerly: under its ``jax.jit`` the
    # speaker count is traced, and ``segment_sum`` needs it static
    want = JF.accumulate_cmvn_stats.__wrapped__(
        jnp.asarray(feats), jnp.asarray(flens), jnp.asarray(spk), 4)
    got = PF.accumulate_cmvn_stats(_t(feats), _t(flens), _t(spk), 4)
    for g, w in zip(got, want):
        _close(g, w, atol=1e-4)  # sums of up to 42 frames
    assert float(got[2][3]) == 0.0  # an idle speaker sums nothing
    out_j = JF.apply_cmvn(jnp.asarray(feats), jnp.asarray(spk), *want,
                          norm_vars=norm_vars)
    out_p = PF.apply_cmvn(_t(feats), _t(spk), *(_t(np.asarray(w)) for w in want),
                          norm_vars=norm_vars)
    _close(out_p, out_j, atol=1e-5)


def test_gmm_state_loglikes_and_gather_match_jax():
    from montreal_forced_aligner_tpu.ops.gmm_loglikes import (
        gather_state_params as j_gather,
        gmm_state_loglikes as j_state,
    )
    from montreal_forced_aligner_tpu_torch.ops.gmm_loglikes import (
        gather_state_params as p_gather,
        gmm_state_loglikes as p_state,
    )

    rng = np.random.RandomState(9)
    P, G, D, B, S, T = 7, 3, 13, 2, 11, 9
    miv = rng.randn(P, G, D).astype(np.float32)
    iv = (0.5 + rng.rand(P, G, D)).astype(np.float32)
    gc = (-10.0 + rng.randn(P, G)).astype(np.float32)
    gc[1, 2] = -np.inf  # a padded Gaussian
    state_pdf = rng.randint(0, P, (B, S)).astype(np.int32)
    feats = rng.randn(B, T, D).astype(np.float32)
    jp = j_gather((jnp.asarray(miv), jnp.asarray(iv), jnp.asarray(gc)),
                  jnp.asarray(state_pdf))
    pp = p_gather((_t(miv), _t(iv), _t(gc)), _t(state_pdf))
    for g, w in zip(pp, jp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = j_state(jnp.asarray(feats), *jp)
    got = p_state(_t(feats), *pp)
    assert got.shape == (B, T, S)
    _close(got, want)


def test_apply_split_schedule_matches_jax():
    import montreal_forced_aligner_tpu.ops.device_update as JD
    import montreal_forced_aligner_tpu_torch.ops.device_update as PD

    rng = np.random.RandomState(11)
    P, G, D, G_new = 4, 2, 5, 4
    iv = (0.5 + rng.rand(P, G, D)).astype(np.float32)
    miv = (rng.randn(P, G, D) * iv).astype(np.float32)
    num_gauss = np.array([2, 3, 4, 1], np.int32)
    weights = np.zeros((P, G_new), np.float32)
    for p, n in enumerate(num_gauss):
        weights[p, :n] = 1.0 / n
    pdf_idx = np.array([1, 2, 2, 2, 0], np.int32)
    dst_idx = np.array([2, 2, 3, 0, 1], np.int32)
    origin_idx = np.array([0, 1, 1, 1, 1], np.int32)
    delta = (rng.randn(5, D) * 0.1).astype(np.float32)
    delta[4] = 0.0  # a pure copy
    args = (miv, iv, weights, num_gauss, pdf_idx, dst_idx, origin_idx, delta)
    want = JD.apply_split_schedule_device(*(jnp.asarray(a) for a in args),
                                          new_max_gauss=G_new)
    got = PD.apply_split_schedule_device(*(_t(a) for a in args),
                                         new_max_gauss=G_new)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        fin = np.isfinite(np.asarray(w))
        np.testing.assert_array_equal(np.isfinite(g.numpy()), fin)
        _close(g.numpy()[fin], np.asarray(w)[fin])


def test_solve_fmllr_matches_jax_and_the_batched_sweeps():
    """The one-speaker solve against the JAX package's (the same float64
    row sweeps, 1e-5), and the port's batched solve (native and its numpy
    plain version) against it, at the JAX package's own bar for that pair
    (``tests/test_components.py``: rtol/atol 2e-4, the batched form updates
    its cofactors by Sherman-Morrison)."""
    from montreal_forced_aligner_tpu.ops.transforms import solve_fmllr as j_solve
    from montreal_forced_aligner_tpu_torch.ops.transforms import (
        _solve_fmllr_batched_numpy,
        solve_fmllr,
        solve_fmllr_batched,
    )

    rng = np.random.RandomState(7)
    S, D, NG = 3, 13, 4
    E = D + 1
    K = np.zeros((S, D, E))
    G = np.zeros((S, D, E, E))
    beta = np.zeros(S)
    for s in range(S):
        n = 600 + 50 * s
        x = rng.randn(n, D) * (1.0 + 0.2 * s) + 0.4 * (s + 1)
        mus = rng.randn(NG, D) * 2.0
        ivs = 1.0 / (0.5 + rng.rand(NG, D))
        xp = np.hstack([x, np.ones((n, 1))])
        post = rng.rand(n, NG)
        post /= post.sum(axis=1, keepdims=True)
        K[s] = np.einsum("ng,gd,ne->de", post, ivs * mus, xp)
        G[s] = np.einsum("gd,gef->def", ivs, np.einsum("ng,ne,nf->gef", post, xp, xp))
        beta[s] = post.sum()
    native = solve_fmllr_batched(K, G, beta)
    plain = _solve_fmllr_batched_numpy(K, G, beta)
    for s in range(S):
        got = solve_fmllr(K[s], G[s], float(beta[s]), min_count=0.0)
        want = j_solve(K[s], G[s], float(beta[s]), min_count=0.0)
        assert got.dtype == np.float32
        _close(got, want, atol=1e-6)
        for batched in (native, plain):
            np.testing.assert_allclose(batched[s], got, rtol=2e-4, atol=2e-4)
    assert solve_fmllr(K[0], G[0], 10.0, min_count=100.0) is None
