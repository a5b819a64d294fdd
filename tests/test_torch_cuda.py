"""The port's CUDA kernels on the card: each against its plain PyTorch
version, its input checks and launch counts, and the slice end to end
against the CPU path. Every test needs an NVIDIA card and skips without one.

This file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: K1 backpointers (within each row's frames), K1 alpha_T and K2
states bit-identical (same operations in the same order, no FMA
contraction), in every band bucket; K3 rtol 1e-5 / atol 1e-3 (3xTF32
products on the tensor cores against float32 ones, another summation
order); the aligned corpus on the card against the CPU, the JAX package's
parity bar, speaker-independent and two-pass; the fMLLR statistics within
rtol 1e-4 of each tensor's largest magnitude (float32 sums in another
order); the native solve within atol 2e-4 of its numpy sweep; the chunked
long-utterance Viterbi's state path identical to one whole-utterance run,
its score within 1e-3.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from montreal_forced_aligner_tpu_torch.ops import cuda_build
from montreal_forced_aligner_tpu_torch.ops import cuda_emission as CE
from montreal_forced_aligner_tpu_torch.ops import cuda_viterbi as CV
from montreal_forced_aligner_tpu_torch.ops import long_viterbi as LV
from montreal_forced_aligner_tpu_torch.ops import transforms as TR
from montreal_forced_aligner_tpu_torch.params import gmm_params_from_numpy

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402
from torch_port_inputs import (  # noqa: E402
    backtrace_inputs,
    band_inputs,
    fmllr_inputs,
    fmllr_system,
    gmm_arrays,
    leaves_range_across_chunks,
)

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
    ]
    # every bucket at 300 states (band in registers through (4, 16), else in
    # shared memory or L2) and at 1100, past one block of threads (two
    # states a thread in registers through (2, 12), else shared memory or
    # L2), each longer than the emission ring
    + [(lb, ub, S, 24) for lb, ub in CV.BAND_BUCKETS for S in (300, 1100)],
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


def _backtrace_cases():
    """(S, T, B, offset) for K2 alone: both layouts of its plan (whole rows
    through S = 300, a window from 832), S a multiple of 16 and not, T at 1,
    2, the plan's chunk -1 / 0 / +1 and 1600, B of 1, 5 and 33 in turn (1
    where bp would pass 64 MB), and bp starting 0 or 5 bytes past an
    allocation."""
    cases = []
    for S in (1, 29, 300, 832, 1100, 29100):
        tc = CV.band_backtrace_plan(S).frames
        for i, T in enumerate(sorted({1, 2, tc - 1, tc, tc + 1, 1600} - {0})):
            B = (1, 5, 33)[i % 3]
            cases.append((S, T, B if T * B * S <= 1 << 26 else 1, 5 * (i % 2)))
    return cases


@pytest.mark.parametrize("S,T,B,offset", _backtrace_cases())
def test_band_backtrace_matches_plain(cuda_device, monkeypatch, S, T, B, offset):
    lb, ub = 2, 12
    bp, flens, best = backtrace_inputs(S + T + B, T, B, S, lb, ub)
    flat = torch.zeros(offset + bp.size, dtype=torch.uint8, device=cuda_device)
    flat[offset:] = torch.from_numpy(bp.reshape(-1)).to(cuda_device)
    bp = flat[offset:].view(T, B, S)
    flens, best = (torch.from_numpy(x).to(cuda_device) for x in (flens, best))
    want = CV.band_backtrace_plain(bp, flens, best, lb)
    monkeypatch.setattr(CV, "band_backtrace_plain", _no_plain)
    cuda_build.reset_launch_counts()
    got = CV.band_backtrace(bp, flens, best, lb)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["band_backtrace"] == 1
    assert torch.equal(got, want)


def test_band_backtrace_leaves_range_across_chunks(cuda_device, monkeypatch):
    S, lb, ub = 29, 2, 12
    tc = CV.band_backtrace_plan(S).frames
    T = 3 * tc + 5
    bp, flens, best = backtrace_inputs(11, T, 5, S, lb, ub)
    args = [torch.from_numpy(x).to(cuda_device) for x in (bp, flens, best)]
    want = CV.band_backtrace_plain(*args, lb)
    assert leaves_range_across_chunks(want.cpu().numpy(), flens, S, tc)
    monkeypatch.setattr(CV, "band_backtrace_plain", _no_plain)
    cuda_build.reset_launch_counts()
    got = CV.band_backtrace(*args, lb)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["band_backtrace"] == 1
    assert torch.equal(got, want)


def test_band_backtrace_window_follows_a_long_path(cuda_device, monkeypatch):
    """A path that drifts down a state a frame on average through 1600
    frames of a 2000-state graph: the staged window moves with it."""
    T, B, S, lb = 1600, 4, 2000, 2
    rng = np.random.RandomState(8)
    bp = torch.from_numpy(rng.randint(lb, lb + 3, (T, B, S)).astype(np.uint8))
    flens = torch.tensor([T, T - 1, 1000, 33], dtype=torch.int32)
    best = torch.tensor([S - 1, S - 2, 1500, 600], dtype=torch.int32)
    args = [x.to(cuda_device) for x in (bp, flens, best)]
    want = CV.band_backtrace_plain(*args, lb)
    assert ((want >= 0) & (want < S)).all()
    monkeypatch.setattr(CV, "band_backtrace_plain", _no_plain)
    got = CV.band_backtrace(*args, lb)
    assert torch.equal(got, want)


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


# T and S not multiples of the block's 128 frames and 64 states; G of 1
# and 33 (odd, past 32); D of 39 (deltas, D2p 80) and 40 (LDA, D2p 88);
# features of scale 1 to 8 against the SAT-scale GMM draw
@pytest.mark.parametrize(
    "B,T,S,P,G,D,scale",
    [
        (3, 100, 130, 40, 8, 40, 2.0),
        (1, 7, 3, 5, 33, 40, 2.0),
        (2, 131, 70, 50, 33, 39, 8.0),
        (2, 129, 65, 30, 1, 39, 8.0),
        (1, 300, 200, 60, 32, 40, 1.0),
        (2, 257, 131, 45, 32, 40, 3.0),
    ],
)
def test_state_emission_matches_plain(cuda_device, monkeypatch, B, T, S, P, G,
                                      D, scale):
    miv, iv, gc = gmm_arrays(5, P, G, D, padded_pdfs=(3,))
    rng = np.random.RandomState(5)
    feats = torch.from_numpy((rng.randn(B, T, D) * scale).astype(np.float32))
    state_pdf = torch.from_numpy(rng.randint(0, P, (B, S)).astype(np.int32))
    params = gmm_params_from_numpy(miv, iv, gc).to(cuda_device)
    feats, state_pdf = feats.to(cuda_device), state_pdf.to(cuda_device)
    want = CE.state_loglikes_plain(feats, state_pdf, params.rows)
    monkeypatch.setattr(CE, "state_loglikes_plain", _no_plain)
    cuda_build.reset_launch_counts()
    got = CE.state_loglikes(feats, state_pdf, params.rows, params.rows_split)
    # without the split rows the wrapper makes them, to the same result
    got2 = CE.state_loglikes(feats, state_pdf, params.rows)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["state_emission"] == 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
    assert torch.equal(got, got2)


def test_wrappers_check_their_inputs(cuda_device):
    emit, band, start, _final, flens = band_inputs(0, 4, 6, 20, 2, 8)
    e, f, b, s = (torch.from_numpy(x).to(cuda_device) for x in (emit, flens, band, start))
    with pytest.raises(ValueError):  # dtype
        CV.band_forward(e.double(), f, b, s, 2, 8, 0.1)
    with pytest.raises(ValueError):  # another device
        CV.band_forward(e, f.cpu(), b, s, 2, 8, 0.1)
    with pytest.raises(ValueError):  # band width does not match lb, ub
        CV.band_forward(e, f, b, s, 2, 9, 0.1)
    e3, b3, s3, _f, f3 = band_inputs(0, 4, 6, 20, 3, 12)
    with pytest.raises(ValueError):  # (3, 12) is not one of the buckets
        CV.band_forward(*(torch.from_numpy(x).to(cuda_device)
                          for x in (e3, f3, b3, s3)), 3, 12, 0.1)
    with pytest.raises(ValueError):  # not contiguous
        CV.band_forward(e.transpose(1, 2).contiguous().transpose(1, 2), f, b, s,
                        2, 8, 0.1)
    bp = torch.zeros((6, 4, 20), dtype=torch.uint8, device=cuda_device)
    with pytest.raises(ValueError):
        CV.band_backtrace(bp, f, torch.zeros(4, device=cuda_device), 2)
    for d2p in (30, 36):  # not a multiple of 8
        rows = torch.zeros((5, 2, d2p), device=cuda_device)
        with pytest.raises(ValueError):
            CE.state_loglikes(torch.zeros((1, 3, 13), device=cuda_device),
                              torch.zeros((1, 4), dtype=torch.int32,
                                          device=cuda_device),
                              rows)
    rows = torch.zeros((5, 2, 32), device=cuda_device)
    with pytest.raises(ValueError):  # split rows of the wrong width
        CE.state_loglikes(torch.zeros((1, 3, 13), device=cuda_device),
                          torch.zeros((1, 4), dtype=torch.int32, device=cuda_device),
                          rows, torch.zeros((5, 2, 32), device=cuda_device))


@pytest.mark.parametrize("adaptation", [False, True])
def test_aligner_on_card_matches_cpu(cuda_device, tmp_path, adaptation):
    """A small SAT-scale corpus through every kernel on the card, against
    the CPU path, with the state-emission kernel forced on: single-pass
    with the speaker-independent model, or the fMLLR two-pass."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    model_path, dict_path, words = chip_smoke.build_sat_scale_model(
        tmp_path, num_phones=6, gauss_per_pdf=4, num_words=20
    )
    corpus_dir, _ = chip_smoke.build_corpus(tmp_path, words, 6, 1.5, 5.0,
                                            num_speakers=2)
    cfg = AlignerConfig(batch_size=4, uses_speaker_adaptation=adaptation)
    results, transforms = {}, {}
    for dev in (cuda_device, torch.device("cpu")):
        al = PretrainedAligner(model_path, dict_path, cfg, device=dev)
        al.use_emission_kernel = al.si_use_emission_kernel = True
        cuda_build.reset_launch_counts()
        results[dev.type] = al.align_corpus(Corpus.load(corpus_dir))
        launched = dict(cuda_build.LAUNCHES)
        if dev.type == "cuda":
            want = 4 if adaptation else 2
            assert all(n == want for n in launched.values()), launched
        else:
            assert not any(launched.values()), launched
        if adaptation:
            transforms[dev.type] = al.last_fmllr.transforms
    chip_smoke.parity(results["cuda"], results["cpu"], 0.01)
    if adaptation:
        assert np.abs(transforms["cuda"] - transforms["cpu"]).max() < 1e-3


def test_native_fmllr_solve_matches_numpy(cuda_device):
    """The g++ build of native/fmllr_solve.cc on this machine."""
    K, G, beta = fmllr_system(7, S=6, D=40)
    native = TR.solve_fmllr_batched(K, G, beta)
    plain = TR._solve_fmllr_batched_numpy(K, G, beta)
    np.testing.assert_allclose(native, plain, atol=2e-4, rtol=0)


def test_fmllr_stats_on_card_match_cpu(cuda_device):
    a = fmllr_inputs(9, B=6, T=300, D=40, P=50, G=8, num_speakers=4)
    names = ("feats", "flens", "frame_pdf", "spk", "weight", "means", "inv_vars",
             "gconsts", "miv")
    want = TR.accumulate_fmllr_stats(*(torch.from_numpy(a[k]) for k in names),
                                     a["num_speakers"])
    got = TR.accumulate_fmllr_stats(
        *(torch.from_numpy(a[k]).to(cuda_device) for k in names), a["num_speakers"])
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        err = (g.cpu().double() - w.double()).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), err


def _long_case(tmp_path, num_words, T, seed=0):
    """A reduced SAT model, a graph of ``num_words`` words, and T random
    40-dim frames: (features on the card, graph arrays, the model's GMM on
    the card)."""
    from montreal_forced_aligner_tpu_torch.align.aligner import PretrainedAligner
    from montreal_forced_aligner_tpu_torch.graph.compiler import batch_graphs

    model_path, dict_path, words = chip_smoke.build_sat_scale_model(
        tmp_path, num_phones=6, gauss_per_pdf=4, num_words=40
    )
    al = PretrainedAligner(model_path, dict_path, device="cuda")
    rng = np.random.RandomState(seed)
    text = " ".join(rng.choice(sorted(words), num_words))
    garrs = batch_graphs([al.compiler.compile(al.tokenizer.tokenize(text))])
    feats = torch.from_numpy((rng.randn(T, 40) * 2).astype(np.float32))
    return feats.to("cuda"), garrs, al.gmm


@pytest.mark.parametrize("num_words,chunk", [(15, 512), (15, 37), (55, 512),
                                             (55, 37)])
def test_long_viterbi_matches_whole_run(cuda_device, tmp_path, num_words, chunk):
    """At S about 300 and 1100, T 5000: the chunked sweeps (K3, K1 from
    each checkpoint, K2 from each handed-down state) against one
    whole-utterance emit and align."""
    from montreal_forced_aligner_tpu_torch.align.aligner import _emit_and_align

    T = 5000
    feats, garrs, gmm = _long_case(tmp_path, num_words, T)
    S = garrs["state_pdf"].shape[1]
    assert (200 < S < 400) if num_words == 15 else (900 < S < 1400), S
    cuda_build.reset_launch_counts()
    path, score = LV.viterbi_align_long(feats, garrs, gmm, chunk=chunk,
                                        use_emission_kernel=True)
    n = -(-T // chunk)
    assert cuda_build.LAUNCHES == {
        "band_forward": 2 * n, "band_backtrace": n, "state_emission": 2 * n
    }
    lg = LV.prepare_long_graph(garrs, cuda_device)
    whole, whole_score = _emit_and_align(
        feats[None], torch.tensor([T], dtype=torch.int32, device=cuda_device),
        lg.graph, gmm, 0.1, band_limits=lg.band_limits, use_emission_kernel=True,
    )
    np.testing.assert_array_equal(path, whole[0].cpu().numpy())
    assert abs(score - float(whole_score[0])) <= 1e-3


@pytest.mark.parametrize("lb,ub,S", [(2, 12, 300), (2, 12, 1100), (16, 128, 300),
                                     (1, 4, 29100)])
def test_k1_from_a_checkpoint_with_zeroed_row(cuda_device, lb, ub, S):
    """K1 on the card: a one-frame run of a zeroed emission row gives the
    start back bit for bit, and a run from a checkpoint continues the whole
    run bit for bit."""
    T, lo = 60, 23
    emit, band, start, _final, _fl = band_inputs(S, 1, T, S, lb, ub, ties=False)
    emit, band, start = (torch.from_numpy(x).to(cuda_device)
                         for x in (emit, band, start))

    def n(k):
        return torch.tensor([k], dtype=torch.int32, device=cuda_device)

    aT, bp = CV.band_forward(emit, n(T), band, start, lb, ub, 0.1)
    ck, _ = CV.band_forward(emit[:, :lo].contiguous(), n(lo), band, start, lb, ub,
                            0.1)
    sub = emit[:, lo - 1 :].clone()
    sub[:, 0] = 0.0
    one, _ = CV.band_forward(sub[:, :1].contiguous(), n(1), band, ck, lb, ub, 0.1)
    assert torch.equal(one, ck)
    aT2, bp2 = CV.band_forward(sub, n(T - lo + 1), band, ck, lb, ub, 0.1)
    assert torch.equal(aT2, aT)
    assert torch.equal(bp2[1:], bp[lo:])


# -- training ----------------------------------------------------------------


def test_training_stats_on_card_match_cpu(cuda_device):
    """The fixed-order statistics on the card: the same layout as the CPU's,
    sums within rtol 1e-5 of each tensor's largest magnitude, and the same
    bits from run to run."""
    from montreal_forced_aligner_tpu_torch.ops import stats as ST
    from montreal_forced_aligner_tpu_torch.training import base as TB

    from torch_port_inputs import train_batch_inputs

    a = train_batch_inputs(4, B=6, T=300, D=13, P=40, G=8)
    keys = ("feats", "flens", "frame_pdf", "W", "gconsts")
    cpu = [torch.from_numpy(a[k]) for k in keys]
    card = [t.to(cuda_device) for t in cpu]
    lay_cpu = ST.frame_layout(cpu[2], cpu[1], a["P"])
    lay_card = ST.frame_layout(card[2], card[1], a["P"])
    for x, y in zip(lay_cpu[:4], lay_card[:4]):
        assert torch.equal(x, y.cpu())
    want = TB._accumulate_batch(*cpu, a["P"])
    got = TB._accumulate_batch(*card, a["P"])
    again = TB._accumulate_batch(*card, a["P"])
    for w, g, g2 in zip(want, got, again):
        assert torch.equal(g, g2)
        scale = w.abs().max().item()
        assert (g.cpu() - w).abs().max().item() <= 1e-5 * scale
    rows = CE.pack_rows_device(*(torch.from_numpy(a[k]).to(cuda_device)
                                 for k in ("miv", "inv_vars", "gconsts")))
    assert np.array_equal(rows.cpu().numpy(),
                          CE.pack_rows(a["miv"], a["inv_vars"], a["gconsts"]))


def test_lda_mllt_stats_on_card_match_cpu(cuda_device):
    from torch_port_inputs import train_batch_inputs

    a = train_batch_inputs(5, B=4, T=200, D=10, P=30, G=4)
    means = (a["miv"] / a["inv_vars"]).astype(np.float32)
    args = [torch.from_numpy(x) for x in (a["feats"], a["flens"], a["frame_pdf"],
                                          means, a["inv_vars"], a["gconsts"],
                                          a["miv"])]
    for fn, call in ((TR.accumulate_lda_stats, args[:3] + [a["P"]]),
                     (TR.accumulate_mllt_stats, args)):
        want = fn(*call)
        got = fn(*[x.to(cuda_device) if isinstance(x, torch.Tensor) else x
                   for x in call])
        for w, g in zip(want, got):
            assert (g.cpu() - w).abs().max().item() <= 1e-5 * w.abs().max().item()


def test_monophone_training_on_card_is_reproducible(cuda_device, tmp_path):
    """The JAX training test's tone corpus and monophone stage on the card,
    twice: the same bits; against the CPU, log-likelihoods within 1e-3."""
    from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    corpus_dir, _truths = chip_smoke.make_tone_corpus(tmp_path, n_utts=6)
    dict_path = tmp_path / "tone.dict"
    dict_path.write_text("".join(f"{w}\t{' '.join(p)}\n"
                                 for w, p in chip_smoke.WORD_PHONES.items()))

    def run(device):
        ta = TrainableAligner(
            corpus_dir, dict_path, recipe=[StageConfig("monophone", "mono", 6, 40)],
            base_config=TrainerConfig(boost_silence=1.0), batch_size=4,
            variable_length_topology=False, device=device,
        )
        model = ta.train()
        lls = [e["loglike_per_frame"] for e in ta.trainers["monophone"].iteration_log]
        return model, np.asarray(lls)

    m1, l1 = run(cuda_device)
    m2, l2 = run(cuda_device)
    _m3, l3 = run(torch.device("cpu"))
    assert np.array_equal(l1, l2)
    for name in ("weights", "means_invvars", "inv_vars", "gconsts"):
        assert np.array_equal(getattr(m1.gmm, name), getattr(m2.gmm, name))
    assert np.all(np.abs(l1 - l3) <= 1e-3 * np.abs(l3))
