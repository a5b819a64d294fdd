"""The port's fMLLR pieces against the JAX package's, on the CPU, on the
same inputs made with numpy from a seed.

Tolerances: the statistics within rtol 1e-4 of each tensor's largest
magnitude (float32 sums in another order: per chunk of frames and per
utterance here, one einsum over all frames there); the native solve within
atol 2e-4 of the JAX package's solve and of the port's numpy sweep (the JAX
package's own bar for its native solver); the transform and the silence
weight within atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import montreal_forced_aligner_tpu.ops.feats as JF
import montreal_forced_aligner_tpu.ops.transforms as JT
import montreal_forced_aligner_tpu_torch.ops.feats as PF
import montreal_forced_aligner_tpu_torch.ops.transforms as PT
from montreal_forced_aligner_tpu_torch.ops import cuda_build

from torch_port_inputs import fmllr_inputs, fmllr_system


def _close_to_scale(got, want, rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize("chunks", ["whole", "tiny"])
def test_accumulate_fmllr_stats_matches_jax(monkeypatch, chunks):
    if chunks == "tiny":  # many chunks of frames, and of the G product
        monkeypatch.setattr(PT, "_GATHER_CHUNK_BYTES", 7 * 4 * 13 * 4)
        monkeypatch.setattr(PT, "_G_CHUNK_BYTES", 4 * 13 * 14 * 4 * 3)
    a = fmllr_inputs(3)
    want = JT.accumulate_fmllr_stats(
        *(jnp.asarray(a[k]) for k in ("feats", "flens", "frame_pdf", "spk",
                                      "weight", "means", "inv_vars", "gconsts",
                                      "miv")),
        a["num_speakers"],
    )
    got = PT.accumulate_fmllr_stats(
        *(torch.from_numpy(a[k]) for k in ("feats", "flens", "frame_pdf", "spk",
                                           "weight", "means", "inv_vars",
                                           "gconsts", "miv")),
        a["num_speakers"],
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close_to_scale(g.numpy(), np.asarray(w))
    # padded frames take no part: junk in them changes nothing
    junk = a["feats"].copy()
    for b, L in enumerate(a["flens"]):
        junk[b, L:] = 1e3
    again = PT.accumulate_fmllr_stats(
        torch.from_numpy(junk),
        *(torch.from_numpy(a[k]) for k in ("flens", "frame_pdf", "spk", "weight",
                                           "means", "inv_vars", "gconsts", "miv")),
        a["num_speakers"],
    )
    for g, h in zip(got, again):
        torch.testing.assert_close(g, h, rtol=1e-5, atol=1e-3)
    # a speaker with no utterance has zero statistics
    assert float(got[2][3]) == 0.0 and not got[0][3].any()


def test_native_solve_matches_jax_and_numpy():
    K, G, beta = fmllr_system(7, S=5, D=13)
    native = PT.solve_fmllr_batched(K, G, beta)
    plain = PT._solve_fmllr_batched_numpy(K, G, beta)
    jax_w = JT.solve_fmllr_batched(K, G, beta)
    assert native.dtype == np.float32 and native.shape == (5, 13, 14)
    np.testing.assert_allclose(native, plain, atol=2e-4, rtol=0)
    np.testing.assert_allclose(native, jax_w, atol=2e-4, rtol=0)


def test_native_solve_on_accumulated_statistics():
    """The solve on statistics of the kind the aligner accumulates (the
    port's own K, G, beta), native against the numpy sweep and the JAX
    package's solve, at D = 40."""
    a = fmllr_inputs(5, B=4, T=400, D=40, P=12, G=3, num_speakers=2)
    K, G, beta = (x.double().numpy() for x in PT.accumulate_fmllr_stats(
        *(torch.from_numpy(a[k]) for k in ("feats", "flens", "frame_pdf", "spk",
                                           "weight", "means", "inv_vars",
                                           "gconsts", "miv")),
        a["num_speakers"],
    ))
    assert (beta > 100).all()
    native = PT.solve_fmllr_batched(K, G, beta)
    np.testing.assert_allclose(native, PT._solve_fmllr_batched_numpy(K, G, beta),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(native, JT.solve_fmllr_batched(K, G, beta),
                               atol=2e-4, rtol=0)
    ident = np.hstack([np.eye(40), np.zeros((40, 1))])
    assert np.abs(native - ident).max() > 1e-2


def test_estimate_speaker_fmllr_under_count_is_identity():
    K, G, beta = fmllr_system(3, S=4, D=13)
    beta[1] = 99.0
    got = PT.estimate_speaker_fmllr(K, G, beta, min_count=100.0)
    want = JT.estimate_speaker_fmllr(K, G, beta, min_count=100.0)
    ident = np.hstack([np.eye(13), np.zeros((13, 1))])
    np.testing.assert_array_equal(got[1], ident)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    for s in (0, 2, 3):
        assert np.abs(got[s] - ident).max() > 1e-3
    none = PT.estimate_speaker_fmllr(K, G, np.zeros(4), min_count=100.0)
    np.testing.assert_array_equal(none, np.tile(ident, (4, 1, 1)))


def test_native_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setitem(cuda_build.SOURCES, "broken",
                        cuda_build.Source(bad, "g++", ["-shared", "-fPIC"]))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        cuda_build.load_library("broken", lambda lib: None)


def test_apply_per_speaker_transform_matches_jax():
    rng = np.random.RandomState(4)
    B, T, D, S = 3, 17, 13, 4
    feats = (rng.randn(B, T, D) * 3).astype(np.float32)
    spk = np.array([2, 0, 2], np.int64)
    trans = (np.tile(np.hstack([np.eye(D), np.zeros((D, 1))]), (S, 1, 1))
             + rng.randn(S, D, D + 1) * 0.2).astype(np.float32)
    got = PF.apply_per_speaker_transform(
        torch.from_numpy(feats), torch.from_numpy(spk), torch.from_numpy(trans)
    )
    want = JF.apply_per_speaker_transform(
        jnp.asarray(feats), jnp.asarray(spk.astype(np.int32)), jnp.asarray(trans)
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_silence_weight_matches_jax():
    rng = np.random.RandomState(6)
    P = 30
    sil = np.array([0, 3, 4, 17])
    mask = PF.silence_pdf_mask(sil, P)
    np.testing.assert_array_equal(mask, JF.silence_pdf_mask(sil, P))
    frame_pdf = rng.randint(0, P, (3, 40)).astype(np.int32)
    got = PF.nonsilence_weight(torch.from_numpy(frame_pdf), torch.from_numpy(mask))
    want = JF.nonsilence_weight(jnp.asarray(frame_pdf), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert set(np.unique(got.numpy())) == {0.0, 1.0}
