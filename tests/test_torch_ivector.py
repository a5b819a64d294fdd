"""The port's i-vector modules (``ops/feats.sliding_cmn``, ``ivector/*``)
against the JAX package's, on the CPU, on the same seeded inputs.

* ``sliding_cmn``: against the JAX function and a literal transcription of
  Kaldi's ``SlidingWindowCmnInternal`` loop (the JAX test's), centred and
  not, with and without variance, utterances shorter than the window
  (atol 1e-4).
* The device functions ``_ubm_estep``, ``_utterance_stats``, ``_estep`` and
  ``_mstep_accumulate``: within 1e-4 of each output's largest magnitude, at
  C = 8 and C = 64, R = 32.
* ``train_ubm`` and ``train_ivector_extractor`` end to end on the JAX
  test's two tone speakers: the same Gaussian count, parameters within
  1e-3 of each array's largest magnitude, every i-vector's cosine with its
  JAX twin >= 0.999, identical ``agglomerative_cluster`` labels; the JAX
  tests' speaker-separation (>= 10/12) and latent-recovery (r^2 > 0.95)
  bars on the port.
* npz and reference-archive round trips across the packages, the
  full-covariance archive included.
* ``corpus_feature_batches``: the same order and features within atol 1e-3.
"""

import numpy as np
import pytest
import torch

import montreal_forced_aligner_tpu.ivector.extractor as JE
import montreal_forced_aligner_tpu.ivector.ubm as JU
import montreal_forced_aligner_tpu_torch.ivector.extractor as PE
import montreal_forced_aligner_tpu_torch.ivector.ubm as PU
from montreal_forced_aligner_tpu.diarization.clustering import (
    agglomerative_cluster,
    cosine_distance_matrix,
)
from montreal_forced_aligner_tpu.ops.feats import sliding_cmn as j_sliding_cmn
from montreal_forced_aligner_tpu_torch.ops.feats import sliding_cmn as p_sliding_cmn

from test_ivector import SR, make_speaker_wave

CPU = torch.device("cpu")


def kaldi_sliding_cmn(x, cmn_window, min_window, center, norm_var):
    """Kaldi ``SlidingWindowCmnInternal`` (feat/feature-functions.cc), one
    frame at a time in float64 (``tests/test_ivector.py``'s loop)."""
    T, _D = x.shape
    out = np.empty_like(x)
    for t in range(T):
        if center:
            ws = t - cmn_window // 2
            we = ws + cmn_window
        else:
            ws = t - cmn_window
            we = t + 1
        if ws < 0:
            we -= ws
            ws = 0
        if not center:
            if we > t:
                we = max(t + 1, min_window)
        if we > T:
            ws -= we - T
            we = T
            if ws < 0:
                ws = 0
        win = x[ws:we]
        mean = win.mean(axis=0)
        out[t] = x[t] - mean
        if norm_var:
            var = np.maximum(win.var(axis=0), 1e-10)
            out[t] /= np.sqrt(var)
    return out


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("norm_var", [False, True])
def test_sliding_cmn_matches_jax_and_kaldi_loop(center, norm_var):
    rng = np.random.RandomState(3)
    lens = [7, 50, 299, 300, 412]
    feats = rng.randn(len(lens), max(lens), 5).astype(np.float32)
    kw = dict(cmn_window=300, min_window=100, center=center,
              normalize_variance=norm_var)
    got = p_sliding_cmn(torch.from_numpy(feats),
                        torch.tensor(lens, dtype=torch.int32), **kw).numpy()
    want = np.asarray(j_sliding_cmn(feats, np.array(lens, np.int32), **kw))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    for b, L in enumerate(lens):
        ref = kaldi_sliding_cmn(feats[b, :L].astype(np.float64), 300, 100,
                                center, norm_var)
        np.testing.assert_allclose(got[b, :L], ref, rtol=0, atol=1e-4,
                                   err_msg=f"len={L}")
        # padded frames pass through untouched
        np.testing.assert_array_equal(got[b, L:], feats[b, L:])


def _same_ubm(rng, C, D):
    w = rng.rand(C) + 0.5
    args = (w / w.sum(), rng.randn(C, D) * 2, rng.rand(C, D) + 0.5)
    return JU.DiagUbm(*args), PU.DiagUbm(*args)


def assert_close_to_scale(got, want, rel, name=""):
    """|got - want| <= rel * max |want|, elementwise."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{name}: {err} > {rel} * {scale}"


@pytest.mark.parametrize("C", [8, 64])
def test_device_functions_match_jax(C):
    rng = np.random.RandomState(C)
    D, R, B, T = 13, 32, 4, 120
    jubm, pubm = _same_ubm(rng, C, D)
    feats = (rng.randn(B, T, D) * 2).astype(np.float32)
    lens = np.array([T, 100, 57, 9], np.int32)
    mask = np.arange(T)[None, :] < lens[:, None]
    W_j, g_j = jubm.device_params()
    W_p, g_p = pubm.device_params(CPU)
    # the port keeps the float64 values the JAX package rounds to float32
    assert W_p.dtype == g_p.dtype == torch.float64
    np.testing.assert_array_equal(np.asarray(W_j), W_p.float().numpy())
    np.testing.assert_array_equal(np.asarray(g_j), g_p.float().numpy())

    # the UBM E-step on the flattened frames
    flat = feats.reshape(-1, D)
    fmask = mask.reshape(-1)
    got = PU._ubm_estep(torch.from_numpy(flat), torch.from_numpy(fmask), W_p, g_p)
    want = JU._ubm_estep(flat, fmask, W_j, g_j)
    for name, g, w in zip(("occ", "mean", "var", "ll"), got, want):
        assert_close_to_scale(g.numpy(), w, 1e-4, name)

    # per-utterance statistics, E-step and M-step accumulators
    means = pubm.means.astype(np.float32)
    gamma_p, Xc_p = PE._utterance_stats(torch.from_numpy(feats),
                                        torch.from_numpy(mask), W_p, g_p,
                                        torch.from_numpy(means))
    gamma_j, Xc_j = JE._utterance_stats(feats, mask, W_j, g_j, means)
    assert_close_to_scale(gamma_p.numpy(), gamma_j, 1e-4, "gamma")
    assert_close_to_scale(Xc_p.numpy(), Xc_j, 1e-4, "Xc")
    Tm = (rng.randn(C, D, R) * 0.3).astype(np.float32)
    Ts_p, TTs_p = PE._prep_T(pubm, Tm, CPU)
    Ts_j, TTs_j = JE._prep_T(jubm, Tm)
    np.testing.assert_array_equal(Ts_p.float().numpy(), np.asarray(Ts_j))
    np.testing.assert_array_equal(TTs_p.float().numpy(), np.asarray(TTs_j))
    # both E-steps from the same statistics
    gamma = np.array(gamma_j)
    Xc = np.array(Xc_j)
    f64 = lambda a: torch.from_numpy(a).double()  # noqa: E731
    w_p, Li_p = PE._estep(f64(gamma), f64(Xc), Ts_p, TTs_p)
    w_j, Li_j = JE._estep(gamma, Xc, Ts_j, TTs_j)
    assert_close_to_scale(w_p.numpy(), w_j, 1e-4, "w_hat")
    assert_close_to_scale(Li_p.numpy(), Li_j, 1e-4, "Linv")
    w = np.array(w_j)
    Li = np.array(Li_j)
    A_p, B_p = PE._mstep_accumulate(f64(gamma), f64(Xc), f64(w), f64(Li))
    A_j, B_j = JE._mstep_accumulate(gamma, Xc, w, Li)
    assert_close_to_scale(A_p.numpy(), A_j, 1e-4, "A")
    assert_close_to_scale(B_p.numpy(), B_j, 1e-4, "Bm")


@pytest.fixture(scope="module")
def speaker_batches():
    """The JAX test's 12 utterances of two tone speakers (MFCC, utterance
    CMN), as numpy: the same features for both packages."""
    from montreal_forced_aligner_tpu.ops.mfcc import MfccConfig, compute_mfcc_batch

    rng = np.random.RandomState(0)
    waves, speakers = [], []
    for u in range(12):
        spk = u % 2
        waves.append(make_speaker_wave(rng, spk, 6.0 + 2.0 * rng.rand()))
        speakers.append(spk)
    batches = []
    for lo in range(0, len(waves), 4):
        feats, flens = compute_mfcc_batch(waves[lo : lo + 4], cfg=MfccConfig())
        batches.append((feats, flens))
    batches = [(np.asarray(f), np.asarray(l)) for f, l in
               JE.apply_utterance_cmn(batches)]
    return batches, np.array(speakers)


def _torch_batches(batches):
    return [(torch.from_numpy(f), l) for f, l in batches]


def _ubm_arrays_close(p, j, rel=1e-3):
    assert p.num_gauss == j.num_gauss
    for name in ("weights", "means", "variances"):
        assert_close_to_scale(getattr(p, name), getattr(j, name), rel, name)


@pytest.fixture(scope="module")
def trained_pair(speaker_batches):
    batches, _spk = speaker_batches
    kw = dict(num_gauss=8, num_init_iterations=6, num_iterations=2)
    jubm = JU.train_ubm(batches, **kw)
    pubm = PU.train_ubm(_torch_batches(batches), device="cpu", **kw)
    tkw = dict(ivector_dim=8, num_iterations=4, gaussian_min_count=1.0)
    jex = JE.train_ivector_extractor(batches, jubm, **tkw)
    pex = PE.train_ivector_extractor(_torch_batches(batches), pubm, device="cpu",
                                     **tkw)
    return jex, pex


def test_training_end_to_end_matches_jax(speaker_batches, trained_pair):
    batches, spk = speaker_batches
    jex, pex = trained_pair
    _ubm_arrays_close(pex.ubm, jex.ubm)
    assert_close_to_scale(pex.T, jex.T, 1e-3, "T")
    iv_j = JE.length_normalize(JE.extract_ivectors(jex, batches))
    iv_p = PE.length_normalize(PE.extract_ivectors(pex, _torch_batches(batches),
                                                   device="cpu"))
    cos = (iv_p * iv_j).sum(1) / (np.linalg.norm(iv_p, axis=1)
                                  * np.linalg.norm(iv_j, axis=1))
    assert cos.min() >= 0.999, cos
    labels_p = agglomerative_cluster(cosine_distance_matrix(iv_p), num_clusters=2)
    labels_j = agglomerative_cluster(cosine_distance_matrix(iv_j), num_clusters=2)
    np.testing.assert_array_equal(labels_p, labels_j)
    # the JAX test's speaker-separation bar, on the port's i-vectors
    from montreal_forced_aligner_tpu_torch.diarization.clustering import (
        agglomerative_cluster as p_agglomerative,
        cosine_distance_matrix as p_cosine,
        kmeans_cluster as p_kmeans,
    )

    labels = p_agglomerative(p_cosine(iv_p), num_clusters=2)
    acc = max((labels == spk).mean(), (labels == 1 - spk).mean())
    labels_km = p_kmeans(iv_p, 2)
    acc_km = max((labels_km == spk).mean(), (labels_km == 1 - spk).mean())
    assert max(acc, acc_km) >= 10 / 12


def test_tmatrix_em_recovers_latents_on_port():
    """The JAX test's model-based bar: features drawn from the
    total-variability model; the port's EM recovers w up to a linear map."""
    rng = np.random.RandomState(1)
    C, D, R = 6, 10, 3
    means = rng.randn(C, D) * 5
    ubm = PU.DiagUbm(np.ones(C) / C, means, np.ones((C, D)) * 0.5)
    T_true = rng.randn(C, D, R)
    batches, true_w = [], []
    n_utts, T_frames = 40, 200
    for lo in range(0, n_utts, 8):
        B = min(8, n_utts - lo)
        feats = np.zeros((B, T_frames, D), np.float32)
        for b in range(B):
            w = rng.randn(R)
            true_w.append(w)
            comps = rng.randint(0, C, T_frames)
            for t, c in enumerate(comps):
                feats[b, t] = means[c] + T_true[c] @ w + rng.randn(D) * np.sqrt(0.5)
        batches.append((torch.from_numpy(feats), np.full(B, T_frames, np.int32)))
    true_w = np.stack(true_w)
    ex = PE.train_ivector_extractor(batches, ubm, ivector_dim=R, num_iterations=8,
                                    gaussian_min_count=1.0, device="cpu")
    w_est = PE.extract_ivectors(ex, batches, device="cpu")
    x = w_est - w_est.mean(0)
    y = true_w - true_w.mean(0)
    proj, *_ = np.linalg.lstsq(x, y, rcond=None)
    r2 = 1 - ((x @ proj - y) ** 2).sum() / (y**2).sum()
    assert r2 > 0.95


def _jax_extractor(pex):
    from montreal_forced_aligner_tpu.ivector.plda import Plda as JPlda

    plda = None
    if pex.plda is not None:
        plda = JPlda(pex.plda.mean, pex.plda.transform, pex.plda.psi)
    u = pex.ubm
    return JE.IvectorExtractor(ubm=JU.DiagUbm(u.weights, u.means, u.variances),
                               T=pex.T, plda=plda)


def _archive_members(path):
    import zipfile

    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            return {n: zf.read(n) for n in zf.namelist()}
    z = np.load(path)
    return {k: z[k] for k in z.files}


def _assert_extractors_equal(a, b):
    for name in ("weights", "means", "variances"):
        np.testing.assert_array_equal(getattr(a.ubm, name), getattr(b.ubm, name))
    np.testing.assert_array_equal(a.T, b.T)
    for name in ("mean", "transform", "psi"):
        np.testing.assert_array_equal(getattr(a.plda, name), getattr(b.plda, name))
    for name in ("center_means", "sigma_inv"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("suffix", [".npz", ".ivector"])
def test_archives_round_trip_across_packages(speaker_batches, trained_pair,
                                             tmp_path, suffix):
    """One extractor (with PLDA) saved by each package: the same members;
    each package reads the other's file into the same arrays; the same
    i-vectors from what was read."""
    from montreal_forced_aligner_tpu_torch.ivector.plda import Plda

    batches, spk = speaker_batches
    _jex, pex = trained_pair
    iv = PE.length_normalize(PE.extract_ivectors(pex, _torch_batches(batches),
                                                 device="cpu"))
    pex.plda = Plda.train(iv, spk)
    p_port, p_jax = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    pex.save(p_port)
    _jax_extractor(pex).save(p_jax)
    got, want = _archive_members(p_port), _archive_members(p_jax)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]))
    j_of_port = JE.IvectorExtractor.load(p_port)
    p_of_jax = PE.IvectorExtractor.load(p_jax)
    j_of_jax = JE.IvectorExtractor.load(p_jax)
    _assert_extractors_equal(j_of_port, j_of_jax)
    _assert_extractors_equal(p_of_jax, j_of_jax)
    assert (p_of_jax.center_means is None) == (suffix == ".npz")
    iv_p = PE.extract_ivectors(p_of_jax, _torch_batches(batches), device="cpu")
    iv_j = JE.extract_ivectors(j_of_jax, batches)
    assert_close_to_scale(iv_p, iv_j, 1e-4, "i-vectors")


def test_full_covariance_archive_across_packages(tmp_path):
    """A Kaldi final.ie with full-covariance SigmaInv (the JAX test's):
    written by the port, read by the JAX package and back; both E-steps
    use the off-diagonals and agree."""
    from montreal_forced_aligner_tpu.ivector.kaldi_model import (
        load_reference_archive as j_load,
        save_reference_archive as j_save,
    )
    from montreal_forced_aligner_tpu_torch.ivector.kaldi_model import (
        load_reference_archive as p_load,
        save_reference_archive as p_save,
    )

    rng = np.random.RandomState(3)
    C, D, R = 4, 5, 3
    ubm = PU.DiagUbm(weights=np.ones(C) / C, means=rng.randn(C, D),
                     variances=np.abs(rng.rand(C, D)) + 0.5)
    ex = PE.IvectorExtractor(ubm=ubm, T=rng.randn(C, D, R).astype(np.float32))
    A = rng.randn(C, D, D) * 0.3
    ex.sigma_inv = np.stack([a @ a.T + np.eye(D) for a in A])
    p_save(ex, tmp_path / "port.ivector")
    jex = j_load(tmp_path / "port.ivector")
    np.testing.assert_allclose(jex.sigma_inv, ex.sigma_inv, atol=1e-12)
    j_save(jex, tmp_path / "jax.ivector")
    pex = p_load(tmp_path / "jax.ivector")
    np.testing.assert_array_equal(pex.sigma_inv, jex.sigma_inv)
    np.testing.assert_array_equal(pex.T, jex.T)
    assert pex.ivector_dim == R + 1
    feats = rng.randn(2, 50, D).astype(np.float32)
    lens = np.array([50, 50], np.int32)
    iv_p = PE.extract_ivectors(pex, [(torch.from_numpy(feats), lens)], device="cpu")
    iv_j = JE.extract_ivectors(jex, [(feats, lens)])
    assert_close_to_scale(iv_p, iv_j, 1e-4, "full-covariance i-vectors")
    diag = PE.extract_ivectors(PE.IvectorExtractor(ubm=ubm, T=ex.T),
                               [(torch.from_numpy(feats), lens)], device="cpu")
    assert np.abs(iv_p[:, 1:] - diag).max() > 1e-3


def write_speaker_corpus(root, n_speakers=2, n_utts=3, seed=5, dur=(3.0, 6.0),
                         text="x"):
    """Speaker directories of tone-speaker utterances with transcripts."""
    from montreal_forced_aligner_tpu_torch.io.wav import write_wave

    rng = np.random.RandomState(seed)
    for spk in range(n_speakers):
        d = root / f"spk{spk}"
        d.mkdir(parents=True, exist_ok=True)
        for u in range(n_utts):
            wave = make_speaker_wave(rng, spk % 2, dur[0] + (dur[1] - dur[0]) * rng.rand())
            write_wave(d / f"u{u}.wav", wave, SR)
            (d / f"u{u}.lab").write_text(text)
    return root


def test_corpus_feature_batches_match_jax(tmp_path):
    from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
    from montreal_forced_aligner_tpu.ivector.pipeline import (
        corpus_feature_batches as j_batches,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
    from montreal_forced_aligner_tpu_torch.ivector.pipeline import (
        corpus_feature_batches as p_batches,
    )

    root = write_speaker_corpus(tmp_path / "c", n_utts=4)
    jb, jorder = j_batches(JCorpus.load(root, require_transcripts=False),
                           batch_size=3)
    pb, porder = p_batches(PCorpus.load(root, require_transcripts=False),
                           batch_size=3, device="cpu")
    assert [int(i) for i in porder] == [int(i) for i in jorder]
    assert len(pb) == len(jb) == 3
    for (pf, pl), (jf, jl) in zip(pb, jb):
        np.testing.assert_array_equal(pl, np.asarray(jl))
        assert pf.shape == tuple(jf.shape) and pf.shape[2] == 39
        jf = np.asarray(jf)
        for b, L in enumerate(pl):
            np.testing.assert_allclose(pf[b, :L].numpy(), jf[b, :L], rtol=0,
                                       atol=1e-3)


def test_entry_points_default_to_the_card():
    """Without a card the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ubm = PU.DiagUbm(np.ones(1), np.zeros((1, 2)), np.ones((1, 2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PU.train_ubm([(torch.zeros(1, 4, 2), np.array([4]))], num_gauss=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PE.extract_ivectors(PE.IvectorExtractor(ubm=ubm, T=np.zeros((1, 2, 1))), [])


def test_apply_utterance_cmn_matches_jax(speaker_batches):
    """The simple per-utterance CMN (not on the production path) against
    the JAX package's, on the same MFCCs."""
    from montreal_forced_aligner_tpu.ops.mfcc import MfccConfig, compute_mfcc_batch

    rng = np.random.RandomState(2)
    waves = [make_speaker_wave(rng, s, 1.0 + s) for s in range(3)]
    feats, flens = compute_mfcc_batch(waves, cfg=MfccConfig())
    feats = np.array(feats)
    ((want, _),) = JE.apply_utterance_cmn([(feats, flens)])
    ((got, got_lens),) = PE.apply_utterance_cmn([(torch.from_numpy(feats), flens)])
    assert got_lens is flens
    for b, L in enumerate(flens):
        np.testing.assert_allclose(got[b, :L].numpy(), np.asarray(want)[b, :L],
                                   rtol=0, atol=1e-4)
