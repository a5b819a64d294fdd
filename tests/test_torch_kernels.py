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

from torch_port_inputs import (
    backtrace_inputs,
    band_inputs,
    gmm_arrays,
    leaves_range_across_chunks,
)


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


def _pallas_backtrace(bp, flens, best, lb):
    """States (B, T) from the Pallas kernel, bp padded with junk frames to
    its chunk of 8."""
    T = bp.shape[0]
    Tp = -(-T // PV._TC) * PV._TC
    padded = np.concatenate([bp, np.full((Tp - T,) + bp.shape[1:], 255, np.uint8)])
    return np.asarray(PV.band_backtrace_pallas(
        jnp.asarray(padded), jnp.asarray(flens), jnp.asarray(best), lb, T))


def _staged_walk(bp, offset, flens, best, lb, plan, rng=None):
    """The card's walk (csrc/band_viterbi.cu band_backtrace_kernel), step
    for step, in numpy. bp sits at byte ``offset`` + 16 of a junk-filled
    memory. Chunk c stages, from frame row t, the aligned 16-byte blocks
    that cover states [lo, lo + WL) into a junk-filled row of its stage; lo
    follows the copier's rule from the state the walker published at the
    start of chunk c - stages + 1 (the earliest the ring allows), or is
    drawn from ``rng``. The fast pass keeps r, the state's byte in its stage
    row, and reads byte r & (row - 1); if r ever left the staged states, or
    the chunk is short, the chunk is walked again exactly. Returns (states,
    full chunks walked again)."""
    T, B, S = bp.shape
    RB, NS, TC = plan.row_bytes, plan.stages, plan.frames
    WL = min(S, RB - 16)
    step = B * S
    base = 16 + offset
    mem = np.full(base + bp.size + 32, 254, np.uint8)
    mem[base : base + bp.size] = bp.reshape(-1)
    out = np.empty((B, T), np.int32)
    misses = 0
    for b in range(B):
        L = max(min(int(flens[b]), T), 1)
        out[b, L:] = best[b]
        state = int(best[b])
        entries = []
        for c in range((L - 1 + TC - 1) // TC):
            entries.append(state)
            hi = L - 1 - c * TC
            nf = min(TC, hi)
            if rng is None:
                lo = max(0, min(entries[max(0, c - NS + 1)] - (WL - 16), S - WL))
            else:
                lo = int(rng.randint(0, S - WL + 1))
            stage = np.full((TC, RB), 253, np.uint8)
            for k in range(nf):
                frm = base + ((hi - k) * B + b) * S + lo
                o = frm & 15
                n = ((o + WL + 15) >> 4) * 16
                assert n <= RB
                # the first and last blocks hold bytes of the tensor
                assert base <= frm and frm - o + n - 16 < base + bp.size
                stage[k, :n] = mem[frm - o : frm - o + n]
            a0 = base + lo + (hi * B + b) * S
            mine = np.empty(nf, np.int64)
            missed = nf < TC
            if not missed:
                o = a0 & 15
                r = state - lo + o
                for k in range(TC):
                    next_o = (a0 - (k + 1) * step) & 15
                    mine[k] = r - o + lo
                    missed |= not 0 <= r - o < WL
                    r += lb + next_o - o - int(stage[k, r & (RB - 1)])
                    o = next_o
                state = r - o + lo
            if missed:
                misses += nf == TC
                state = entries[-1]
                for k in range(nf):
                    mine[k] = state
                    u = state - lo
                    if 0 <= u < WL:
                        j = int(stage[k, ((a0 - k * step) & 15) + u])
                    elif 0 <= state < S:
                        j = int(bp[hi - k, b, state])
                    else:
                        j = 0
                    state += lb - j
            out[b, hi - np.arange(nf)] = mine
        out[b, 0] = state
    return out, misses


def test_band_backtrace_plan_fits_every_graph():
    """A layout for every S up to 100k: whole rows while they fit a
    512-byte staged row, else a window; the ring fits the 227 KB a block
    may use, and a staged row covers its states wherever the frame row
    starts."""
    modes = set()
    for S in range(1, 100_001):
        plan = CV.band_backtrace_plan(S)
        modes.add(plan.mode)
        rb = plan.row_bytes
        assert plan.frames >= 1
        assert plan.smem_bytes == (plan.stages * plan.frames + 1) * rb <= CV.MAX_SMEM
        assert 32 <= rb <= 512 and rb & (rb - 1) == 0
        if plan.mode == CV.BT_ROWS:
            assert S + 15 < rb  # any start offset, then S states
        else:
            assert plan.mode == CV.BT_WINDOW and S > rb - 16 and rb == 512
    assert modes == {CV.BT_ROWS, CV.BT_WINDOW}
    assert CV.band_backtrace_plan(300).mode == CV.BT_ROWS
    assert CV.band_backtrace_plan(832).mode == CV.BT_WINDOW  # the first batch


@pytest.mark.parametrize("S", [29, 300, 1100])
@pytest.mark.parametrize("edge", [-1, 0, 1, 2, 66])
def test_band_backtrace_matches_pallas_at_chunk_boundaries(interpret, S, edge):
    """K2's plain version against the Pallas kernel on random backpointers
    that leave [0, S), at T = TC + edge for the plan's chunk of TC frames
    (T - 1 frames are walked), with frame lengths 1, 2 and T; and the
    card's walk, emulated, on the same inputs, with bp at two byte offsets
    and the window placed by the copier's rule and at random."""
    lb, ub = 2, 12
    plan = CV.band_backtrace_plan(S)
    T = plan.frames + edge
    bp, flens, best = backtrace_inputs(S + edge, T, 5, S, lb, ub)
    want = _pallas_backtrace(bp, flens, best, lb)
    assert ((want < 0) | (want >= S)).any()
    got = CV.band_backtrace(torch.from_numpy(bp), torch.from_numpy(flens),
                            torch.from_numpy(best), lb)
    np.testing.assert_array_equal(got.numpy(), want)
    for offset in (0, 5):
        np.testing.assert_array_equal(
            _staged_walk(bp, offset, flens, best, lb, plan)[0], want)
    np.testing.assert_array_equal(
        _staged_walk(bp, 7, flens, best, lb, plan, np.random.RandomState(S))[0], want)


def test_band_backtrace_leaves_range_across_chunks(interpret):
    """Walks that leave [0, S) in one chunk and come back in the next: the
    plain version and the emulated card walk against the Pallas kernel."""
    S, lb, ub = 29, 2, 12
    plan = CV.band_backtrace_plan(S)
    T = 3 * plan.frames + 5
    bp, flens, best = backtrace_inputs(11, T, 5, S, lb, ub)
    want = _pallas_backtrace(bp, flens, best, lb)
    assert leaves_range_across_chunks(want, flens, S, plan.frames)
    got = CV.band_backtrace(torch.from_numpy(bp), torch.from_numpy(flens),
                            torch.from_numpy(best), lb)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_staged_walk(bp, 3, flens, best, lb, plan)[0], want)


def test_band_backtrace_window_follows_the_path():
    """A path that drifts down about a state a frame through a graph wider
    than the window (the main path's shape, shortened): the emulated card
    walk stays inside the copier's windows on every full chunk, and matches
    the plain version."""
    T, B, S, lb = 200, 3, 1100, 2
    plan = CV.band_backtrace_plan(S)
    assert plan.mode == CV.BT_WINDOW
    rng = np.random.RandomState(4)
    bp = rng.randint(lb, lb + 3, size=(T, B, S)).astype(np.uint8)
    flens = np.array([T, T - 7, 150], np.int32)
    best = np.array([S - 1, 700, 400], np.int32)
    want = CV.band_backtrace_plain(torch.from_numpy(bp), torch.from_numpy(flens),
                                   torch.from_numpy(best), lb).numpy()
    assert ((want >= 0) & (want < S)).all()
    got, misses = _staged_walk(bp, 9, flens, best, lb, plan)
    np.testing.assert_array_equal(got, want)
    assert misses == 0


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
    assert params.rows.shape[2] % 8 == 0
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
