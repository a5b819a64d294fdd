"""The port's CUDA kernels on the card: each against its plain PyTorch
version, its input checks and launch counts, and the slice end to end
against the CPU path. Every test needs an NVIDIA card and skips without one.

This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: K1 backpointers (within each row's frames), K1 alpha_T and K2
states bit-identical (same operations in the same order, no FMA
contraction); K3 rtol 1e-5 / atol 1e-3 (another summation order); the
aligned corpus on the card against the CPU, the JAX package's parity bar.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from montreal_forced_aligner_tpu_torch.ops import cuda_build
from montreal_forced_aligner_tpu_torch.ops import cuda_emission as CE
from montreal_forced_aligner_tpu_torch.ops import cuda_viterbi as CV
from montreal_forced_aligner_tpu_torch.params import gmm_params_from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from torch_port_inputs import band_inputs, gmm_arrays  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _no_plain(*a, **k):
    raise AssertionError("plain version reached for CUDA tensors")


@pytest.mark.parametrize(
    "lb,ub,S,T",
    [
        (2, 12, 70, 40),
        (16, 128, 1100, 40),  # band too large for shared memory
        (1, 4, 29100, 4),  # alpha too large for shared memory
        (4, 16, 33, 1),
    ],
)
def test_band_kernels_match_plain(cuda_device, monkeypatch, lb, ub, S, T):
    B = 4 if T > 3 else 2
    emit, band, start, final, flens = band_inputs(S, B, T, S, lb, ub, ties=True)
    flens = np.clip(flens, 1, T).astype(np.int32)
    args = [torch.from_numpy(x).to(cuda_device) for x in (emit, flens, band, start)]
    aT_r, bp_r = CV.band_forward_plain(*args, lb, ub, 0.1)
    best = torch.argmax(aT_r + torch.from_numpy(final).to(cuda_device), 1)
    best = best.to(torch.int32)
    st_r = CV.band_backtrace_plain(bp_r, args[1], best, lb)

    monkeypatch.setattr(CV, "band_forward_plain", _no_plain)
    monkeypatch.setattr(CV, "band_backtrace_plain", _no_plain)
    cuda_build.reset_launch_counts()
    aT_k, bp_k = CV.band_forward(*args, lb, ub, 0.1)
    st_k = CV.band_backtrace(bp_k, args[1], best, lb)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES == {
        "band_forward": 1, "band_backtrace": 1, "state_emission": 0
    }
    assert torch.equal(aT_k, aT_r)
    within = torch.arange(T, device=cuda_device)[:, None] < args[1][None, :]
    within[0] = False
    assert torch.equal(bp_k[within], bp_r[within])
    assert torch.equal(st_k, st_r)


def test_backtrace_walks_out_of_range_like_plain(cuda_device):
    rng = np.random.RandomState(3)
    T, B, S, lb = 30, 6, 24, 2
    bp = torch.from_numpy(rng.randint(0, 15, (T, B, S)).astype(np.uint8))
    flens = torch.tensor([30, 29, 12, 2, 1, 30], dtype=torch.int32)
    best = torch.from_numpy(rng.randint(0, S, B).astype(np.int32))
    want = CV.band_backtrace_plain(bp, flens, best, lb)
    assert ((want < 0) | (want >= S)).any()
    got = CV.band_backtrace(*(x.to(cuda_device) for x in (bp, flens, best)), lb)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("B,T,S,P,G", [(3, 100, 130, 40, 8), (1, 7, 3, 5, 33)])
def test_state_emission_matches_plain(cuda_device, monkeypatch, B, T, S, P, G):
    miv, iv, gc = gmm_arrays(5, P, G, 40, padded_pdfs=(3,))
    rng = np.random.RandomState(5)
    feats = torch.from_numpy((rng.randn(B, T, 40) * 2).astype(np.float32))
    state_pdf = torch.from_numpy(rng.randint(0, P, (B, S)).astype(np.int32))
    rows = gmm_params_from_numpy(miv, iv, gc).rows
    feats, state_pdf, rows = (x.to(cuda_device) for x in (feats, state_pdf, rows))
    want = CE.state_loglikes_plain(feats, state_pdf, rows)
    monkeypatch.setattr(CE, "state_loglikes_plain", _no_plain)
    cuda_build.reset_launch_counts()
    got = CE.state_loglikes(feats, state_pdf, rows)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["state_emission"] == 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)


def test_wrappers_check_their_inputs(cuda_device):
    emit, band, start, _final, flens = band_inputs(0, 4, 6, 20, 2, 8)
    e, f, b, s = (torch.from_numpy(x).to(cuda_device) for x in (emit, flens, band, start))
    with pytest.raises(ValueError):  # dtype
        CV.band_forward(e.double(), f, b, s, 2, 8, 0.1)
    with pytest.raises(ValueError):  # another device
        CV.band_forward(e, f.cpu(), b, s, 2, 8, 0.1)
    with pytest.raises(ValueError):  # band width does not match lb, ub
        CV.band_forward(e, f, b, s, 2, 9, 0.1)
    with pytest.raises(ValueError):  # not contiguous
        CV.band_forward(e.transpose(1, 2).contiguous().transpose(1, 2), f, b, s,
                        2, 8, 0.1)
    bp = torch.zeros((6, 4, 20), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        CV.band_backtrace(bp, f, torch.zeros(4, device=cuda_device), 2)
    rows = torch.zeros((5, 2, 30), device=cuda_device)  # not a multiple of 4
    with pytest.raises(ValueError):
        CE.state_loglikes(torch.zeros((1, 3, 13), device=cuda_device),
                          torch.zeros((1, 4), dtype=torch.int32, device=cuda_device),
                          rows)


def test_aligner_on_card_matches_cpu(cuda_device, tmp_path):
    """A small SAT-scale corpus through every kernel on the card, against
    the CPU path, with the state-emission kernel forced on."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    model_path, dict_path, words = chip_smoke.build_sat_scale_model(
        tmp_path, num_phones=6, gauss_per_pdf=4, num_words=20
    )
    corpus_dir, _ = chip_smoke.build_corpus(tmp_path, words, 6, 1.5, 5.0)
    cfg = AlignerConfig(batch_size=4, uses_speaker_adaptation=False)
    results = {}
    for dev in (cuda_device, torch.device("cpu")):
        al = PretrainedAligner(model_path, dict_path, cfg, device=dev)
        al.use_emission_kernel = True
        cuda_build.reset_launch_counts()
        results[dev.type] = al.align_corpus(Corpus.load(corpus_dir))
        launched = dict(cuda_build.LAUNCHES)
        if dev.type == "cuda":
            assert all(n == 2 for n in launched.values()), launched
        else:
            assert not any(launched.values()), launched
    chip_smoke.parity(results["cuda"], results["cpu"], 0.01)
