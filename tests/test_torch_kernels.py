"""Kernels K1, K2 and K3 of the PyTorch port against the JAX package's
Pallas kernels.

The Pallas kernels run in interpret mode on the CPU (``pl.pallas_call``
patched with ``interpret=True``, as ``tests/test_align_e2e.py`` does for the
emission kernel). The port's wrappers get CPU tensors here, so they run
their plain PyTorch versions; the CUDA kernels themselves are compared with
those plain versions on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``).

Tolerances:

* K1 backpointers (within each row's frame count) and K2 states:
  bit-identical. Both sides add in the same order with two rounded
  operations per step and break ties by the first maximum.
* K1 alpha_T: atol 1e-4, the bar of ``tests/test_viterbi.py`` for the
  Pallas kernel against its scan.
* K3: rtol 1e-5 / atol 1e-3. The dot products and the logsumexp sum in
  another order (MXU tiles against a per-Gaussian matmul).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import montreal_forced_aligner_tpu.ops.pallas_emission as PE
import montreal_forced_aligner_tpu.ops.pallas_viterbi as PV
from montreal_forced_aligner_tpu_torch.ops import cuda_build
from montreal_forced_aligner_tpu_torch.ops import cuda_emission as CE
from montreal_forced_aligner_tpu_torch.ops import cuda_viterbi as CV
from montreal_forced_aligner_tpu_torch.ops.gmm_loglikes import (
    gmm_loglikes,
    select_state_emissions,
)
from montreal_forced_aligner_tpu_torch.params import gmm_params_from_numpy

from torch_port_inputs import band_inputs, gmm_arrays


@pytest.fixture
def interpret(monkeypatch):
    """Run every Pallas kernel in interpret mode for one test."""
    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(PV.pl, "pallas_call", interp_call)
    monkeypatch.setattr(PE.pl, "pallas_call", interp_call)
    jitted = (
        PV.band_forward_pallas,
        PV.band_backtrace_pallas,
        PE.pallas_state_loglikes,
    )
    for fn in jitted:
        fn.clear_cache()
    yield
    for fn in jitted:
        fn.clear_cache()


# XLA on the CPU may contract scale * emit + m into one fused multiply-add,
# which the port (and its CUDA kernel) never does. With integer inputs and
# ties everywhere the scale is 0.5, so that the product is exact and both
# roundings agree; with random float inputs it is the real 0.1.
@pytest.mark.parametrize(
    "lb,ub,S,ties",
    [
        (1, 4, 40, True),
        (2, 12, 70, True),
        (4, 16, 33, True),
        (16, 128, 150, True),
        (2, 12, 70, False),
        (8, 32, 90, False),
    ],
)
def test_band_forward_and_backtrace_match_pallas(interpret, lb, ub, S, ties):
    B, T = 4, 11  # T not a multiple of the Pallas chunk of 8
    scale = 0.5 if ties else 0.1
    emit, band, start, final, flens = band_inputs(
        lb * 100 + S, B, T, S, lb, ub, ties
    )
    aT_j, bp_j = PV.band_forward_pallas(
        jnp.asarray(emit), jnp.asarray(flens), jnp.asarray(band),
        jnp.asarray(start), lb, ub, scale, full_bp=True,
    )
    aT_j, bp_j = np.asarray(aT_j), np.asarray(bp_j)
    best_j = np.argmax(aT_j + final, axis=1).astype(np.int32)
    st_j = np.asarray(
        PV.band_backtrace_pallas(
            jnp.asarray(bp_j), jnp.asarray(flens), jnp.asarray(best_j), lb, T
        )
    )

    cuda_build.reset_launch_counts()
    aT_p, bp_p = CV.band_forward(
        torch.from_numpy(emit), torch.from_numpy(flens),
        torch.from_numpy(band), torch.from_numpy(start), lb, ub, scale,
    )
    best_p = torch.argmax(aT_p + torch.from_numpy(final), dim=1).to(torch.int32)
    st_p = CV.band_backtrace(bp_p, torch.from_numpy(flens), best_p, lb)
    assert all(v == 0 for v in cuda_build.LAUNCHES.values())

    np.testing.assert_allclose(aT_p.numpy(), aT_j, atol=1e-4)
    within = np.arange(T)[:, None] < flens[None, :]  # (T, B)
    within[0] = False  # bp[0] is never written
    assert np.array_equal(bp_p.numpy()[within], bp_j[:T][within])
    np.testing.assert_array_equal(best_p.numpy(), best_j)
    np.testing.assert_array_equal(st_p.numpy(), st_j)
    # K2 alone, on the Pallas kernel's own backpointers
    st_p2 = CV.band_backtrace(
        torch.from_numpy(bp_j[:T].copy()), torch.from_numpy(flens),
        torch.from_numpy(best_j), lb,
    )
    np.testing.assert_array_equal(st_p2.numpy(), st_j)


@pytest.mark.parametrize("seed", [0, 1])
def test_band_backtrace_matches_pallas_on_random_backpointers(interpret, seed):
    """Random slots walk states out of [0, S); both sides then read slot 0."""
    rng = np.random.RandomState(seed)
    B, T, S, lb, ub = 5, 13, 24, 2, 12
    Tp = 16
    bp = rng.randint(0, lb + ub + 1, size=(Tp, B, S)).astype(np.uint8)
    flens = np.array([T, 9, 2, 1, T - 1], np.int32)
    best = rng.randint(0, S, size=B).astype(np.int32)
    st_j = np.asarray(
        PV.band_backtrace_pallas(
            jnp.asarray(bp), jnp.asarray(flens), jnp.asarray(best), lb, T
        )
    )
    st_p = CV.band_backtrace(
        torch.from_numpy(bp[:T].copy()), torch.from_numpy(flens),
        torch.from_numpy(best), lb,
    )
    assert ((st_j < 0) | (st_j >= S)).any()  # the case is exercised
    np.testing.assert_array_equal(st_p.numpy(), st_j)


@pytest.mark.parametrize(
    "B,T,S,P,G,D",
    [(2, 37, 150, 30, 6, 40), (3, 9, 5, 7, 3, 13), (1, 70, 129, 12, 1, 39)],
)
def test_state_emission_matches_pallas(interpret, B, T, S, P, G, D):
    miv, iv, gc = gmm_arrays(T + S, P, G, D, padded_pdfs=(0, P - 1))
    rng = np.random.RandomState(S)
    feats = (rng.randn(B, T, D) * 2).astype(np.float32)
    state_pdf = rng.randint(0, P, size=(B, S)).astype(np.int32)
    want = np.asarray(
        PE.pallas_state_loglikes(
            jnp.asarray(feats), jnp.asarray(state_pdf),
            jnp.asarray(PE.pack_rows(miv, iv, gc)),
        )
    )
    params = gmm_params_from_numpy(miv, iv, gc)
    assert params.rows.shape[2] % 4 == 0
    cuda_build.reset_launch_counts()
    got = CE.state_loglikes(
        torch.from_numpy(feats), torch.from_numpy(state_pdf), params.rows
    )
    assert cuda_build.LAUNCHES["state_emission"] == 0
    assert got.shape == (B, T, S)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    # and the port's all-pdf path gives the same emissions
    allpdf = select_state_emissions(
        gmm_loglikes(torch.from_numpy(feats), params.W, params.gconsts),
        torch.from_numpy(state_pdf),
    )
    np.testing.assert_allclose(got.numpy(), allpdf.numpy(), rtol=1e-5, atol=1e-3)


def test_cpu_tensors_never_reach_a_kernel(monkeypatch):
    def no_build(name, declare):
        raise AssertionError(f"kernel library {name} loaded for CPU tensors")

    monkeypatch.setattr(cuda_build, "load_library", no_build)
    cuda_build.reset_launch_counts()
    emit, band, start, final, flens = band_inputs(3, 4, 6, 20, 2, 8)
    aT, bp = CV.band_forward(
        torch.from_numpy(emit), torch.from_numpy(flens),
        torch.from_numpy(band), torch.from_numpy(start), 2, 8, 0.1,
    )
    CV.band_backtrace(bp, torch.from_numpy(flens),
                      torch.zeros(4, dtype=torch.int32), 2)
    miv, iv, gc = gmm_arrays(0, 4, 2, 5)
    params = gmm_params_from_numpy(miv, iv, gc)
    CE.state_loglikes(torch.zeros(1, 3, 5), torch.zeros(1, 4, dtype=torch.int32),
                      params.rows)
    assert cuda_build.LAUNCHES == {
        "band_forward": 0, "band_backtrace": 0, "state_emission": 0
    }


def test_wrappers_refuse_other_devices():
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        CV.band_forward(
            torch.empty(1, 2, 3, device=meta),
            torch.empty(1, dtype=torch.int32, device=meta),
            torch.empty(1, 3, 6, device=meta), torch.empty(1, 3, device=meta),
            1, 4, 0.1,
        )
    with pytest.raises(ValueError):
        CV.band_backtrace(
            torch.empty(2, 1, 3, dtype=torch.uint8, device=meta),
            torch.empty(1, dtype=torch.int32, device=meta),
            torch.empty(1, dtype=torch.int32, device=meta), 1,
        )
    with pytest.raises(ValueError):
        CE.state_loglikes(
            torch.empty(1, 2, 3, device=meta),
            torch.empty(1, 4, dtype=torch.int32, device=meta),
            torch.empty(2, 1, 8, device=meta),
        )
