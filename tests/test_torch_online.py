"""The port's long-utterance Viterbi and single-utterance alignment against
the JAX package's, on the CPU (the kernels' plain PyTorch versions).

* ``viterbi_align_long`` at chunk 37 on the mono fixture: through the band
  kernels' plain versions, the state path equal to both packages' band
  batch paths; through the dense fallback and the plain version (the
  reference's algorithm), equal to the JAX package's
  ``viterbi_align_long`` and both dense batch paths (band and dense break
  exact ties differently); scores within 1e-2, as the JAX package's own
  test holds its two paths.
* The two tricks the band route rests on, through K1's and K2's plain
  versions: K1 started from a checkpoint with a zeroed first emission row
  continues the whole run bit for bit; K2 walks from a handed-down state.
* ``align_utterance_online``: the mono model's intervals equal to the JAX
  package's; the reduced SAT model's two-pass at the JAX package's parity
  bar (``tests/test_parity_sweep.py``); both also on the chunked path.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import montreal_forced_aligner_tpu.align.aligner as JA
import montreal_forced_aligner_tpu.online.alignment as JO
import montreal_forced_aligner_tpu_torch.align.aligner as PA
import montreal_forced_aligner_tpu_torch.online.alignment as PO
import montreal_forced_aligner_tpu_torch.ops.long_viterbi as LV
from montreal_forced_aligner_tpu.graph.compiler import batch_graphs as j_batch_graphs
from montreal_forced_aligner_tpu.graph.compiler import (
    ship_graph_to_device as j_ship_graph,
)
from montreal_forced_aligner_tpu.ops.long_viterbi import (
    viterbi_align_long as j_viterbi_align_long,
)
from montreal_forced_aligner_tpu.ops.mfcc import pad_waves_for_mfcc as j_pad
from montreal_forced_aligner_tpu_torch.graph.compiler import batch_graphs
from montreal_forced_aligner_tpu_torch.ops import cuda_viterbi as CV
from montreal_forced_aligner_tpu_torch.ops.viterbi import band_limits_from_arcs

from helpers import build_sat_scale_model, build_synthetic_model, synth_wave
from torch_port_inputs import band_inputs

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def mono_case(tmp_path_factory):
    """The mono fixture's utterance: final features (T, 39), its graph, and
    both packages' aligners (as ``tests/test_viterbi.py`` builds it)."""
    tmp = tmp_path_factory.mktemp("mono_long")
    wave = synth_wave()
    model_path, dict_path = build_synthetic_model(tmp, wave=wave)
    jal = JA.PretrainedAligner(model_path, dict_path, JA.AlignerConfig(batch_size=1))
    pal = PA.PretrainedAligner(model_path, dict_path, device="cpu")
    padded, lens = j_pad([wave], jal.mfcc_config, len(wave))
    T = jal.mfcc_config.num_frames(int(lens[0]))
    feats, _ = JA._mfcc_and_sums(jnp.asarray(padded), jnp.asarray([T]),
                                 jal.mfcc_config, T)
    mean = feats[0, :T].mean(axis=0)
    ff = np.asarray(JA._final_feats(feats, jnp.asarray([T]), mean[None], None))[0]
    tokens = jal.tokenizer.tokenize("ab a")
    return dict(wave=wave, ff=ff, T=T, jal=jal, pal=pal,
                jgarrs=j_batch_graphs([jal.compiler.compile(tokens)]),
                garrs=batch_graphs([pal.compiler.compile(tokens)]),
                model_path=model_path, dict_path=dict_path)


def _batch_paths(c, band):
    """Both packages' batch paths on the whole utterance: band-sparse (K1
    and K2, their plain versions here, Pallas in interpret mode there) or
    dense max-plus. The two break exact ties differently (the first
    maximum by band slot, or by source state), so a chunked route is held
    to the batch path of its own kind."""
    jal, pal, T = c["jal"], c["pal"], c["T"]
    W, gc = jal._device_gmm[0], jal._device_gmm[1]
    limits = band_limits_from_arcs(c["garrs"]) if band else None
    assert not band or limits is not None
    j_sp, j_sc = JA._emit_and_align(
        jnp.asarray(c["ff"][None]), jnp.asarray([T]), j_ship_graph(c["jgarrs"]),
        W, gc, 0.1, band_limits=limits,
    )
    p_sp, p_sc = PA._emit_and_align(
        torch.from_numpy(c["ff"][None].copy()), torch.tensor([T], dtype=torch.int32),
        PA.ship_graph_to_device(c["garrs"], torch.device("cpu")), pal.gmm, 0.1,
        band_limits=limits,
    )
    return ((np.asarray(j_sp)[0, :T], float(j_sc[0])),
            (p_sp[0].numpy(), float(p_sc[0])))


@pytest.mark.parametrize("route", ["band", "dense", "plain"])
def test_long_viterbi_matches_jax_and_batch_path(mono_case, monkeypatch, route):
    """The band route (K3 or all pdfs, K1, K2 per chunk) against both
    packages' band batch paths; the dense fallback and the plain version
    against the JAX package's ``viterbi_align_long`` and both dense batch
    paths."""
    c = mono_case
    T = c["T"]
    ff = torch.from_numpy(c["ff"].copy())
    if route == "dense":  # a graph outside the band buckets
        monkeypatch.setattr(LV, "band_limits_from_arcs", lambda garrs: None)
    fn = LV.viterbi_align_long_plain if route == "plain" else LV.viterbi_align_long
    path, score = fn(ff, c["garrs"], c["pal"].gmm, acoustic_scale=0.1, chunk=37)
    assert path.dtype == np.int32 and path.shape == (T,)
    wants = list(_batch_paths(c, band=route == "band"))
    if route != "band":
        W, gc = c["jal"]._device_gmm[0], c["jal"]._device_gmm[1]
        wants.append(j_viterbi_align_long(c["ff"], c["jgarrs"], W, gc,
                                          acoustic_scale=0.1, chunk=37))
    for want_path, want_score in wants:
        np.testing.assert_array_equal(path, want_path)
        assert abs(score - want_score) < 1e-2


@pytest.mark.parametrize("chunk", [1, 2, 37, 10_000])
def test_long_viterbi_chunk_sizes(mono_case, chunk):
    """Any chunk size gives the whole-utterance path, from a chunk a frame
    to one chunk for the whole utterance, on both routes."""
    c = mono_case
    ff = torch.from_numpy(c["ff"].copy())
    (_j, (band_path, band_score)) = _batch_paths(c, band=True)
    path, score = LV.viterbi_align_long(ff, c["garrs"], c["pal"].gmm, chunk=chunk)
    np.testing.assert_array_equal(path, band_path)
    assert abs(score - band_score) < 1e-2
    (_j, (dense_path, dense_score)) = _batch_paths(c, band=False)
    path, score = LV.viterbi_align_long_plain(ff, c["garrs"], c["pal"].gmm,
                                              chunk=chunk)
    np.testing.assert_array_equal(path, dense_path)
    assert abs(score - dense_score) < 1e-2


def test_long_viterbi_through_state_emissions(mono_case):
    """The band route with the state-emission path (K3's plain version
    here): each chunk's emissions, with the zeroed lead row, give the batch
    path's state path on the same emission path."""
    c = mono_case
    T = c["T"]
    ff = torch.from_numpy(c["ff"].copy())
    limits = band_limits_from_arcs(c["garrs"])
    sp, sc = PA._emit_and_align(
        ff[None], torch.tensor([T], dtype=torch.int32),
        PA.ship_graph_to_device(c["garrs"], torch.device("cpu")), c["pal"].gmm,
        0.1, band_limits=limits, use_emission_kernel=True,
    )
    path, score = LV.viterbi_align_long(ff, c["garrs"], c["pal"].gmm, chunk=37,
                                        use_emission_kernel=True)
    np.testing.assert_array_equal(path, sp[0].numpy())
    assert abs(score - float(sc[0])) < 1e-3


@pytest.mark.parametrize("lb,ub", [(2, 12), (16, 128)])
def test_k1_continues_from_a_checkpoint(lb, ub):
    """K1's plain version from the alpha of frame lo - 1, with a zeroed
    first emission row: its frame 0 is the checkpoint exactly, and every
    later frame and backpointer is the whole run's, bit for bit."""
    B, T, S, lo = 1, 90, 60, 37
    emit, band, start, _final, _fl = band_inputs(3, B, T, S, lb, ub, ties=False)
    emit, band, start = (torch.from_numpy(x) for x in (emit, band, start))
    full = torch.tensor([T], dtype=torch.int32)
    aT, bp = CV.band_forward_plain(emit, full, band, start, lb, ub, 0.1)
    ck, _ = CV.band_forward_plain(emit, torch.tensor([lo], dtype=torch.int32),
                                  band, start, lb, ub, 0.1)  # frame lo - 1
    sub = emit[:, lo - 1 :].clone()
    sub[:, 0] = 0.0
    one, _ = CV.band_forward_plain(sub[:, :1], torch.tensor([1], dtype=torch.int32),
                                   band, ck, lb, ub, 0.1)
    assert torch.equal(one, ck)
    aT2, bp2 = CV.band_forward_plain(sub, torch.tensor([T - lo + 1], dtype=torch.int32),
                                     band, ck, lb, ub, 0.1)
    assert torch.equal(aT2, aT)
    assert torch.equal(bp2[1:], bp[lo:])


def test_k2_walks_from_a_given_state():
    """K2's plain version over the later frames from the best state, then
    over the earlier ones from the state it handed down: the whole walk."""
    lb, ub, B, T, S, lo = 2, 12, 1, 80, 50, 30
    emit, band, start, final, _fl = band_inputs(4, B, T, S, lb, ub, ties=True)
    emit, band, start, final = (torch.from_numpy(x)
                                for x in (emit, band, start, final))
    full = torch.tensor([T], dtype=torch.int32)
    aT, bp = CV.band_forward_plain(emit, full, band, start, lb, ub, 0.5)
    best = torch.argmax(aT + final, 1).to(torch.int32)
    whole = CV.band_backtrace_plain(bp, full, best, lb)
    late = CV.band_backtrace_plain(bp[lo - 1 :].contiguous(),
                                   torch.tensor([T - lo + 1], dtype=torch.int32),
                                   best, lb)
    assert torch.equal(late, whole[:, lo - 1 :])
    early = CV.band_backtrace_plain(bp[:lo].contiguous(),
                                    torch.tensor([lo], dtype=torch.int32),
                                    late[:, 0].contiguous(), lb)
    assert torch.equal(early, whole[:, :lo])


def _ivals(aln):
    return ([(p.label, round(p.begin, 6), round(p.end, 6)) for p in aln.phones],
            [(w.label, round(w.begin, 6), round(w.end, 6)) for w in aln.words])


@pytest.mark.parametrize("long", [False, True])
def test_online_mono_matches_jax(mono_case, monkeypatch, long):
    c = mono_case
    if long:
        monkeypatch.setattr(PO, "LONG_UTTERANCE_FRAMES", 50)
        monkeypatch.setattr(JO, "LONG_UTTERANCE_FRAMES", 50)
    want = JO.align_utterance_online(c["jal"], c["wave"], "ab a")
    got = PO.align_utterance_online(c["pal"], c["wave"], "ab a")
    assert _ivals(got) == _ivals(want)
    assert [w.label for w in got.words] == ["ab", "a"]
    assert abs(got.log_likelihood - want.log_likelihood) < 1e-2


@pytest.fixture(scope="module")
def sat_online(tmp_path_factory):
    """The reduced SAT model and one utterance of 6 s."""
    tmp = tmp_path_factory.mktemp("sat_online")
    model_path, dict_path = build_sat_scale_model(
        tmp, num_phones=6, gauss_per_pdf=4, num_words=20
    )
    words = [line.split("\t")[0] for line in dict_path.read_text().splitlines()]
    corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 1, min_s=6.0, max_s=6.0)
    from montreal_forced_aligner_tpu_torch.io.wav import read_wave

    wave = read_wave(corpus_dir / "spk0" / "utt0.wav").samples
    text = (corpus_dir / "spk0" / "utt0.lab").read_text()
    return model_path, dict_path, wave, text


@pytest.mark.parametrize("long", [False, True])
def test_online_sat_two_pass_meets_parity_bar(sat_online, monkeypatch, long):
    model_path, dict_path, wave, text = sat_online
    if long:
        monkeypatch.setattr(PO, "LONG_UTTERANCE_FRAMES", 100)
        monkeypatch.setattr(JO, "LONG_UTTERANCE_FRAMES", 100)
    jal = JA.PretrainedAligner(model_path, dict_path)
    pal = PA.PretrainedAligner(model_path, dict_path, device="cpu")
    want = JO.align_utterance_online(jal, wave, text)
    got = PO.align_utterance_online(pal, wave, text)
    report = chip_smoke.parity({0: got}, {0: want}, pal.frame_shift)
    assert report["frames"] > 500
    _K, _G, beta, transforms = pal.last_fmllr
    assert beta[0] >= pal.config.fmllr_min_count
    assert np.abs(transforms[0] - np.hstack([np.eye(40), np.zeros((40, 1))])).max() > 1e-2
