"""The PyTorch port's ``align`` slice end to end, against the JAX package,
on the CPU (the port's plain PyTorch versions of its kernels).

* Mono model: phone and word intervals identical to the JAX package's, and
  the same TextGrid text.
* SAT-scale model (reduced) in speaker-independent mode, with the port's
  state-emission path forced on: the JAX package's parity bar
  (``tests/test_parity_sweep.py``: >= 99.9% of frames agree, >= 99.5% of
  boundaries within one frame, scores within 5 nats); with the emission
  path off the port gives the same intervals.
* The same model with speaker adaptation (the fMLLR two-pass) against the
  JAX package's two-pass, at the parity bar, with the three models wired as
  the reference wires them; long utterances routed to the single-utterance
  path; the confidence margin within 1e-4 of the JAX package's.
* The CLI's ``align`` (with its analysis CSV) and ``align_one``.
* What the slice does not serve raises; the port never imports JAX.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import numpy as np

import jax.numpy as jnp
import montreal_forced_aligner_tpu.align.aligner as JA
import montreal_forced_aligner_tpu.online.alignment as JO
import montreal_forced_aligner_tpu.ops.viterbi as JV
import montreal_forced_aligner_tpu_torch.align.aligner as PA
import montreal_forced_aligner_tpu_torch.online.alignment as PO
from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
from montreal_forced_aligner_tpu_torch.device import resolve_device
from montreal_forced_aligner_tpu_torch.io.wav import read_wave

from helpers import (
    build_sat_scale_model,
    build_synthetic_corpus,
    build_synthetic_model,
    synth_wave,
)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

PORT = REPO / "montreal_forced_aligner_tpu_torch"


def _intervals(results):
    return {
        k: (
            [(p.label, round(p.begin, 6), round(p.end, 6)) for p in a.phones],
            [(w.label, round(w.begin, 6), round(w.end, 6)) for w in a.words],
        )
        for k, a in results.items()
    }


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mono")
    corpus_dir, wave = build_synthetic_corpus(tmp)
    model_path, dict_path = build_synthetic_model(tmp, wave=wave)
    return tmp, corpus_dir, model_path, dict_path


@pytest.mark.parametrize("boost", [1.0, 3.0])
def test_mono_slice_matches_jax(mono, boost):
    tmp, corpus_dir, model_path, dict_path = mono
    jal = JA.PretrainedAligner(
        model_path, dict_path, JA.AlignerConfig(batch_size=4, boost_silence=boost)
    )
    jcorp = JCorpus.load(corpus_dir)
    want = jal.align_corpus(jcorp)
    pal = PA.PretrainedAligner(
        model_path, dict_path,
        PA.AlignerConfig(batch_size=4, boost_silence=boost), device="cpu",
    )
    pcorp = PCorpus.load(corpus_dir)
    got = pal.align_corpus(pcorp)
    assert _intervals(got) == _intervals(want)
    assert [w.label for w in got[0].words] == ["ab", "a"]
    assert abs(got[0].log_likelihood - want[0].log_likelihood) < 1e-2
    j_out = jal.export_textgrids(jcorp, want, tmp / f"tg_jax{boost}")
    p_out = pal.export_textgrids(pcorp, got, tmp / f"tg_port{boost}")
    assert [p.name for p in p_out] == [p.name for p in j_out]
    for a, b in zip(p_out, j_out):
        assert a.read_text() == b.read_text()


def test_cli_aligns_on_cpu(mono, tmp_path):
    _tmp, corpus_dir, model_path, dict_path = mono
    out = tmp_path / "out"
    rc = cli_main(["align", str(corpus_dir), str(dict_path), str(model_path),
                   str(out), "--device", "cpu", "--batch_size", "2"])
    assert rc == 0
    tg = out / "utt1.TextGrid"
    assert tg.exists() and '"ab"' in tg.read_text()
    rows = (out / "alignment_analysis.csv").read_text().splitlines()
    assert rows[0] == ("utterance,file,speaker,log_likelihood_per_frame,"
                       "duration_deviation")
    assert len(rows) == 2 and rows[1].startswith("0,utt1,spk1,")


def test_cli_align_one_on_cpu(mono, tmp_path):
    _tmp, corpus_dir, model_path, dict_path = mono
    out = tmp_path / "one" / "aligned.TextGrid"
    rc = cli_main(["align_one", str(corpus_dir / "spk1" / "utt1.wav"),
                   str(corpus_dir / "spk1" / "utt1.lab"), str(dict_path),
                   str(model_path), str(out), "--device", "cpu"])
    assert rc == 0
    assert '"ab"' in out.read_text()
    # the same TextGrid as the corpus path writes for that file
    al = PA.PretrainedAligner(model_path, dict_path, device="cpu")
    corpus = PCorpus.load(corpus_dir)
    (want,) = al.export_textgrids(corpus, al.align_corpus(corpus), tmp_path / "c")
    assert out.read_text() == want.read_text()


@pytest.fixture(scope="module")
def sat(tmp_path_factory):
    """Reduced SAT-scale model and a corpus of short utterances."""
    tmp = tmp_path_factory.mktemp("sat")
    model_path, dict_path = build_sat_scale_model(
        tmp, num_phones=6, gauss_per_pdf=4, num_words=20
    )
    words = [line.split("\t")[0] for line in dict_path.read_text().splitlines()]
    corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 5, min_s=1.5, max_s=4.0)
    return model_path, dict_path, corpus_dir


def test_sat_scale_si_slice_meets_parity_bar(sat):
    model_path, dict_path, corpus_dir = sat
    jal = JA.PretrainedAligner(
        model_path, dict_path,
        JA.AlignerConfig(batch_size=3, uses_speaker_adaptation=False),
    )
    want = jal.align_corpus(JCorpus.load(corpus_dir))
    cfg = PA.AlignerConfig(batch_size=3, uses_speaker_adaptation=False)
    pal = PA.PretrainedAligner(model_path, dict_path, cfg, device="cpu")
    assert not pal.use_emission_kernel  # P*G is below the threshold here
    pal.use_emission_kernel = True
    got = pal.align_corpus(PCorpus.load(corpus_dir))
    report = chip_smoke.parity(got, want, pal.frame_shift)
    assert report["frames"] > 500
    # the all-pdf emission path gives the same alignment
    pal.use_emission_kernel = False
    assert _intervals(pal.align_corpus(PCorpus.load(corpus_dir))) == _intervals(got)


@pytest.fixture(scope="module")
def sat2(tmp_path_factory):
    """The reduced SAT model and 6 utterances of 2.5-5 s over 2 speakers, so
    every speaker passes fmllr_min_count."""
    tmp = tmp_path_factory.mktemp("sat2")
    model_path, dict_path = build_sat_scale_model(
        tmp, num_phones=6, gauss_per_pdf=4, num_words=20
    )
    words = [line.split("\t")[0] for line in dict_path.read_text().splitlines()]
    corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 6, min_s=2.5, max_s=5.0,
                                            num_speakers=2)
    return model_path, dict_path, corpus_dir


_IDENTITY = np.hstack([np.eye(40), np.zeros((40, 1))])


@pytest.mark.parametrize("boost", [1.0, 3.0])
def test_sat_two_pass_meets_parity_bar(sat2, boost):
    model_path, dict_path, corpus_dir = sat2
    jal = JA.PretrainedAligner(
        model_path, dict_path, JA.AlignerConfig(batch_size=4, boost_silence=boost)
    )
    want = jal.align_corpus(JCorpus.load(corpus_dir))
    pal = PA.PretrainedAligner(
        model_path, dict_path, PA.AlignerConfig(batch_size=4, boost_silence=boost),
        device="cpu",
    )
    assert pal.two_pass and pal.si_gmm is not None and pal.fmllr is not None
    got = pal.align_corpus(PCorpus.load(corpus_dir))
    report = chip_smoke.parity(got, want, pal.frame_shift)
    assert report["frames"] > 1000
    _K, _G, beta, transforms = pal.last_fmllr
    assert (beta >= pal.config.fmllr_min_count).all()
    assert np.abs(transforms - _IDENTITY).max() > 1e-2
    for name in ("fmllr_pass1", "fmllr_stats_fetch", "fmllr_solve", "fmllr_apply",
                 "emit_and_align_dispatch"):
        assert name in pal.last_phase_seconds


def test_two_pass_model_wiring(sat2):
    """Pass 1 aligns with the SI model (boosted), the statistics read the
    final model's unboosted gconsts, pass 2 aligns with the final model
    (boosted): a swap of any of the three models changes the result. The
    boost itself cannot show in the statistics: it adds one constant to
    every Gaussian of a silence pdf, which leaves the posteriors within the
    pdf as they were, and silence frames weigh 0."""
    model_path, dict_path, corpus_dir = sat2
    cfg = PA.AlignerConfig(batch_size=4, boost_silence=3.0)

    def run(patch=None):
        pal = PA.PretrainedAligner(model_path, dict_path, cfg, device="cpu")
        if patch:
            patch(pal)
        res = pal.align_corpus(PCorpus.load(corpus_dir))
        return pal.last_fmllr.transforms, _intervals(res), [r.log_likelihood
                                                   for r in res.values()]

    base_t, base_iv, base_sc = run()
    boosted = run(lambda p: p.fmllr.gconsts.copy_(p.gmm.gconsts))[0]
    np.testing.assert_array_equal(boosted, base_t)
    # the SI model's gconsts in the statistics
    si_gc = run(lambda p: p.fmllr.gconsts.copy_(
        torch.from_numpy(p.model.alignment_model[1].gconsts)))[0]
    assert np.abs(si_gc - base_t).max() > 1e-4
    # the final model in pass 1
    t1, _iv, _sc = run(lambda p: setattr(p, "si_gmm", p.gmm))
    assert np.abs(t1 - base_t).max() > 1e-4
    # the SI model in pass 2
    t2, iv2, sc2 = run(lambda p: setattr(p, "gmm", p.si_gmm))
    np.testing.assert_array_equal(t2, base_t)
    assert iv2 != base_iv or max(abs(a - b) for a, b in zip(sc2, base_sc)) > 1.0


def test_single_speaker_skips_the_two_pass(sat2):
    model_path, dict_path, corpus_dir = sat2
    pal = PA.PretrainedAligner(
        model_path, dict_path, PA.AlignerConfig(uses_speaker_adaptation=False),
        device="cpu",
    )
    assert not pal.two_pass and pal.si_gmm is None and pal.fmllr is None
    pal.align_corpus(PCorpus.load(corpus_dir))
    assert pal.last_fmllr is None
    assert "fmllr_pass1" not in pal.last_phase_seconds


def test_cli_aligns_sat_model_with_adaptation(sat2, tmp_path):
    model_path, dict_path, corpus_dir = sat2
    out = tmp_path / "out"
    assert cli_main(["align", str(corpus_dir), str(dict_path), str(model_path),
                     str(out), "--device", "cpu"]) == 0
    assert len(list(out.rglob("*.TextGrid"))) == 6
    assert len((out / "alignment_analysis.csv").read_text().splitlines()) == 7


def test_emission_rule():
    assert PA._emission_kernel_eligible(5045, 32)
    assert PA._emission_kernel_eligible(512, 32)
    assert not PA._emission_kernel_eligible(150, 4)
    assert PA._emission_kernel_eligible(4, 4096)  # no cap on G


@pytest.mark.parametrize(
    "kwargs",
    [
        {"transfer_mode": "features"},
        {"distributed": True},
        {"language": "english"},
    ],
    ids=lambda k: next(iter(k)),
)
def test_unserved_settings_raise(mono, kwargs):
    """``transfer_mode="features"`` (ported with the transfer mode) aligns
    at the JAX transfer test's bar against waves
    (``tests/test_torch_transfer_mode.py`` holds the mode in full);
    ``language`` (ported since the host extras) builds the JAX package's
    composed tokenizer
    (``tests/test_torch_tokenization.py`` holds every language);
    ``distributed`` (ported with multi-GPU) runs, in one process on the
    CPU a mesh of one device, to the plain run's intervals
    (``tests/test_torch_distributed.py`` holds the ranks)."""
    _tmp, corpus_dir, model_path, dict_path = mono
    if "distributed" in kwargs:
        pal = PA.PretrainedAligner(model_path, dict_path, PA.AlignerConfig(**kwargs),
                                   device="cpu")
        assert pal.mesh is not None and pal.mesh.world_size == 1
        plain = PA.PretrainedAligner(model_path, dict_path, device="cpu")
        assert _intervals(pal.align_corpus(PCorpus.load(corpus_dir))) == \
            _intervals(plain.align_corpus(PCorpus.load(corpus_dir)))
        return
    if "language" in kwargs:
        pal = PA.PretrainedAligner(model_path, dict_path, PA.AlignerConfig(**kwargs),
                                   device="cpu")
        jal = JA.PretrainedAligner(model_path, dict_path, JA.AlignerConfig(**kwargs))
        for text in ("Ab a!", "ab's [laughter] ba", "aing b"):
            assert pal.tokenizer.tokenize(text) == jal.tokenizer.tokenize(text)
        return
    from test_torch_transfer_mode import jax_transfer_bar

    pal = PA.PretrainedAligner(model_path, dict_path, PA.AlignerConfig(**kwargs),
                               device="cpu")
    got = pal.align_corpus(PCorpus.load(corpus_dir))
    assert pal.last_transfer_mode == "features"
    plain = PA.PretrainedAligner(model_path, dict_path, device="cpu")
    jax_transfer_bar(plain.align_corpus(PCorpus.load(corpus_dir)), got)


def test_g2p_and_rules_raise(mono, tmp_path):
    """``--transfer_mode features`` aligns, at the JAX transfer test's bar
    against waves; ``--g2p_model_path``, ``--rules_path`` and
    ``--language`` (the host extras), ``--distributed`` (multi-GPU; one
    process here) and ``--transfer_mode features`` align as the JAX
    package's CLI does (``tests/test_torch_align_g2p.py`` holds the host
    extras in full, ``tests/test_torch_distributed.py`` the ranks,
    ``tests/test_torch_transfer_mode.py`` the transfer mode)."""
    from click.testing import CliRunner

    import montreal_forced_aligner_tpu.cli as JCLI
    from montreal_forced_aligner_tpu_torch.g2p.trainer import G2PTrainer

    from montreal_forced_aligner_tpu_torch.io.textgrid import TextGrid

    _tmp, corpus_dir, model_path, dict_path = mono
    for extra in (["--transfer_mode", "features"],):
        tiers = {}
        for mode in ("waves", "features"):
            out = tmp_path / f"transfer_{mode}"
            assert cli_main(["align", str(corpus_dir), str(dict_path),
                             str(model_path), str(out), "--device", "cpu",
                             "--transfer_mode", mode]) == 0
            (tg,) = list(out.rglob("*.TextGrid"))
            tiers[mode] = TextGrid.read(tg)
        phones = {m: [iv for name, iv in g.tiers.items() if "phone" in name][0]
                  for m, g in tiers.items()}
        assert [i.label for i in phones["features"]] == [
            i.label for i in phones["waves"]]
        for a, b in zip(phones["waves"], phones["features"]):
            assert abs(a.begin - b.begin) <= 0.011 and abs(a.end - b.end) <= 0.011
    g2p = tmp_path / "g2p.zip"
    G2PTrainer(order=3, num_alignment_iterations=2).train_from_dictionary(
        dict_path).save(g2p)
    rules = tmp_path / "rules.yaml"
    rules.write_text("rules:\n  - segment: bb\n    following_context: $\n"
                     "    replacement: aa\n")
    for i, extra in enumerate((["--language", "english"],
                               ["--g2p_model_path", str(g2p)],
                               ["--rules_path", str(rules)],
                               ["--distributed"],
                               ["--transfer_mode", "features"])):
        got, want = tmp_path / f"port{i}", tmp_path / f"jax{i}"
        assert cli_main(["align", str(corpus_dir), str(dict_path), str(model_path),
                         str(got), "--device", "cpu", *extra]) == 0
        out = CliRunner().invoke(JCLI.align_cli, [str(corpus_dir), str(dict_path),
                                                  str(model_path), str(want),
                                                  *extra], catch_exceptions=False)
        assert out.exit_code == 0, out.output
        (a,), (b,) = list(got.rglob("*.TextGrid")), list(want.rglob("*.TextGrid"))
        assert a.read_text() == b.read_text()


@pytest.fixture(scope="module")
def mono_mixed(tmp_path_factory, mono):
    """The mono model and a corpus of two files, the second twice as long
    as the first and starting 0.5 s into its file."""
    _tmp, _corpus_dir, model_path, dict_path = mono
    from montreal_forced_aligner_tpu_torch.io.wav import write_wave

    d = tmp_path_factory.mktemp("mixed") / "corpus"
    (d / "spk1").mkdir(parents=True)
    wave = synth_wave()
    write_wave(d / "spk1" / "short.wav", wave, 16000)
    (d / "spk1" / "short.lab").write_text("ab a")
    write_wave(d / "spk1" / "long.wav", np.concatenate([wave, wave]), 16000)
    (d / "spk1" / "long.lab").write_text("ab a ab a")
    return d, model_path, dict_path, len(wave) // 160


@pytest.mark.parametrize("threshold", ["between", "below_both"])
def test_long_utterances_take_the_online_path(mono_mixed, monkeypatch, threshold):
    """With LONG_UTTERANCE_FRAMES patched low, the long utterance (or both)
    aligns through the single-utterance path and the chunked Viterbi, as
    the JAX package routes it, to the same intervals."""
    corpus_dir, model_path, dict_path, short_frames = mono_mixed
    limit = short_frames + 10 if threshold == "between" else 50
    monkeypatch.setattr(PO, "LONG_UTTERANCE_FRAMES", limit)
    monkeypatch.setattr(JO, "LONG_UTTERANCE_FRAMES", limit)
    calls = []
    orig = PO.align_utterance_online
    monkeypatch.setattr(PO, "align_utterance_online",
                        lambda *a, **k: calls.append(a[3] if len(a) > 3 else
                                                     k["utterance_id"])
                        or orig(*a, **k))
    want = JA.PretrainedAligner(model_path, dict_path).align_corpus(
        JCorpus.load(corpus_dir))
    pal = PA.PretrainedAligner(model_path, dict_path, device="cpu")
    corpus = PCorpus.load(corpus_dir)
    got = pal.align_corpus(corpus)
    long_ids = [u.id for u in corpus.utterances if u.file_name == "long"]
    assert sorted(calls) == (long_ids if threshold == "between"
                             else sorted(u.id for u in corpus.utterances))
    assert "long_utterances" in pal.last_phase_seconds
    assert _intervals(got) == _intervals(want)
    (lid,) = long_ids
    assert [w.label for w in got[lid].words] == ["ab", "a", "ab", "a"]


def test_long_segment_times_are_file_times(mono_mixed, monkeypatch):
    """A long segment that starts 0.5 s into its file: its intervals are
    file times, as the JAX package's are."""
    corpus_dir, model_path, dict_path, short_frames = mono_mixed
    monkeypatch.setattr(PO, "LONG_UTTERANCE_FRAMES", short_frames + 10)
    monkeypatch.setattr(JO, "LONG_UTTERANCE_FRAMES", short_frames + 10)
    jcorp, pcorp = JCorpus.load(corpus_dir), PCorpus.load(corpus_dir)
    for corpus in (jcorp, pcorp):
        for u in corpus.utterances:
            if u.file_name == "long":
                u.begin = 0.5
    want = JA.PretrainedAligner(model_path, dict_path).align_corpus(jcorp)
    got = PA.PretrainedAligner(model_path, dict_path, device="cpu").align_corpus(
        pcorp)
    assert _intervals(got) == _intervals(want)
    (lid,) = [u.id for u in pcorp.utterances if u.file_name == "long"]
    assert got[lid].phones[0].begin == 0.5
    assert got[lid].words[0].begin >= 0.5


@pytest.mark.parametrize("chunked", [False, True])
def test_confidence_matches_jax(sat2, monkeypatch, chunked):
    """The confidence margin of the port against the JAX package's
    ``_phone_confidence``, on the same features and state path (atol 1e-4),
    and the aligners' per-phone confidences (rtol 2e-5: there the features
    themselves differ at float32 rounding, and the margins are hundreds)."""
    if chunked:  # a few frames a chunk
        monkeypatch.setattr(PA, "_CONFIDENCE_CHUNK_BYTES", 3 * 4 * 4 * 40 * 4)
    model_path, dict_path, corpus_dir = sat2
    rng = np.random.RandomState(2)
    pal = PA.PretrainedAligner(
        model_path, dict_path,
        PA.AlignerConfig(batch_size=4, compute_confidence=True,
                         uses_speaker_adaptation=False),
        device="cpu",
    )
    P = pal.gmm.num_pdfs
    B, T, S = 3, 41, 12
    ff = (rng.randn(B, T, 40) * 3).astype(np.float32)
    state_pdf = rng.randint(0, P, (B, S)).astype(np.int32)
    path = rng.randint(0, S, (B, T)).astype(np.int32)
    pgraph = PA.BatchedGraph._make([None] * len(PA.BatchedGraph._fields))._replace(
        state_pdf=torch.from_numpy(state_pdf))
    got = PA._phone_confidence(torch.from_numpy(ff), torch.from_numpy(path),
                               pgraph, pal.gmm.W, pal.gmm.gconsts)
    jgraph = JV.BatchedGraph._make(
        [jnp.zeros(1)] * len(JV.BatchedGraph._fields))._replace(
        state_pdf=jnp.asarray(state_pdf))
    want = JA._phone_confidence(jnp.asarray(ff), jnp.asarray(path), jgraph,
                                jnp.asarray(pal.gmm.W.numpy()),
                                jnp.asarray(pal.gmm.gconsts.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert (got <= 0).all()

    results = pal.align_corpus(PCorpus.load(corpus_dir))
    jal = JA.PretrainedAligner(
        model_path, dict_path,
        JA.AlignerConfig(batch_size=4, compute_confidence=True,
                         uses_speaker_adaptation=False),
    )
    jres = jal.align_corpus(JCorpus.load(corpus_dir))
    for uid, aln in results.items():
        confs = [p.confidence for p in aln.phones]
        assert all(c is not None and c <= 0 for c in confs)
        if _intervals({0: aln}) == _intervals({0: jres[uid]}):
            np.testing.assert_allclose(
                confs, [p.confidence for p in jres[uid].phones], rtol=2e-5,
                atol=1e-4)


def test_compressed_audio_raises(tmp_path, monkeypatch):
    """FLAC, MP3 and Opus decode (``tests/test_torch_codecs.py`` holds them
    against the JAX package in full); a file that is not what its name says
    raises the JAX package's error."""
    import montreal_forced_aligner_tpu.io.flac as JF
    from montreal_forced_aligner_tpu.io.wav import read_wave as j_read_wave

    monkeypatch.setattr(JF, "_decode_frames_native", lambda *a: None)
    for ext in ("flac", "mp3", "opus"):
        path = tmp_path / f"a.{ext}"
        path.write_bytes(b"\0" * 4096)
        with pytest.raises(Exception) as got:
            read_wave(path)
        with pytest.raises(Exception) as want:
            j_read_wave(path)
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value)
    x = np.round(synth_wave()).astype(np.int64)
    chip_smoke.write_flac_files([(tmp_path / "b.flac", x, 16000, {})])
    got, want = read_wave(tmp_path / "b.flac"), j_read_wave(tmp_path / "b.flac")
    assert np.array_equal(got.samples, want.samples)
    assert np.array_equal(got.samples, x.astype(np.float32))


def test_cuda_default_raises_without_card(mono):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _tmp, _corpus_dir, model_path, dict_path = mono
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PA.PretrainedAligner(model_path, dict_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PA.PretrainedAligner(model_path, dict_path, device="cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
            + sorted((REPO / "mfa_tpu_torch").rglob("*.py")))


def test_port_names_no_jax_in_any_import():
    """Every import statement of the port and of chip_smoke.py, lazy ones
    included."""
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for module in ("ops/transforms.py", "ops/long_viterbi.py",
                   "online/alignment.py", "align/analysis.py",
                   "ops/stats.py", "ops/device_update.py",
                   "io/openfst.py", "language_modeling/ngram.py",
                   "language_modeling/fst_convert.py", "training/base.py",
                   "training/em.py", "training/monophone.py",
                   "training/tree_builder.py", "training/triphone.py",
                   "training/lda.py", "training/sat.py",
                   "training/pronunciation.py", "training/trainer.py",
                   "training/adapt.py", "graph/native_compile.py",
                   "graph/parallel.py", "evaluation.py",
                   "language_modeling/archive.py", "model_manager.py",
                   "config.py", "ops/pitch.py", "align/fine_tune.py",
                   "transcription/transcriber.py", "transcription/lvcsr.py",
                   "transcription/lvcsr_pm.py",
                   "transcription/phone_transcriber.py",
                   "online/transcription.py", "io/flac.py", "io/codecs.py",
                   "dictionary/rules.py", "g2p/trainer.py", "g2p/generator.py",
                   "g2p/pair_ngram.py", "g2p/openfst_model.py",
                   "g2p/export_openfst.py", "tokenization/languages.py",
                   "tokenization/trainer.py", "tokenization_surface.py",
                   "parallel/multihost.py", "parallel/mesh.py",
                   "parallel/data_parallel.py", "parallel/scaling.py",
                   "parallel/dryrun.py", "wrapper.py",
                   "parity/reference_decoder.py", "parity/harness.py",
                   "parity/accuracy.py", "speechbrain_surface.py",
                   "transcription/torch_models.py",
                   "transcription/whisper/__init__.py",
                   "transcription/whisper/checkpoint.py",
                   "transcription/whisper/features.py",
                   "transcription/whisper/model.py",
                   "transcription/whisper/generate.py",
                   "transcription/whisper/tokenizer.py",
                   "diarization/embeddings.py", "vad/segmenter.py"):
        assert f"montreal_forced_aligner_tpu_torch/{module}" in names
    assert "mfa_tpu_torch/__init__.py" in names
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "montreal_forced_aligner_tpu",
                                    "mfa_tpu", "transformers", "safetensors"), (
                    path, name)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import montreal_forced_aligner_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import mfa_tpu_torch\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'montreal_forced_aligner_tpu', 'transformers', "
        "'safetensors')]\n"
        "assert not bad, bad\n"
        "assert len(mods) > 25, mods\n"
        "for m in ('training.trainer', 'training.sat', 'ops.stats', "
        "'language_modeling.fst_convert', 'io.openfst', 'training.adapt', "
        "'graph.native_compile', 'graph.parallel', 'evaluation', "
        "'language_modeling.archive', 'model_manager', 'config', 'ops.pitch', "
        "'align.fine_tune', 'transcription.transcriber', 'transcription.lvcsr', "
        "'transcription.lvcsr_pm', 'transcription.phone_transcriber', "
        "'online.transcription', 'io.flac', 'io.codecs', 'dictionary.rules', "
        "'g2p.trainer', 'g2p.generator', 'g2p.pair_ngram', 'g2p.openfst_model', "
        "'g2p.export_openfst', 'tokenization.languages', 'tokenization.trainer', "
        "'tokenization_surface', 'parallel.multihost', 'parallel.mesh', "
        "'parallel.data_parallel', 'parallel.scaling', 'parallel.dryrun', "
        "'wrapper', 'parity.reference_decoder', 'parity.harness', "
        "'parity.accuracy', 'speechbrain_surface', 'transcription.torch_models', "
        "'transcription.whisper.checkpoint', 'transcription.whisper.features', "
        "'transcription.whisper.model', 'transcription.whisper.generate', "
        "'transcription.whisper.tokenizer', 'diarization.embeddings'):\n"
        "    assert p.__name__ + '.' + m in mods, m\n"
        "print('ok', len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_chip_smoke_fails_without_its_package(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_chip_smoke_phases_run_on_cpu(tmp_path, monkeypatch):
    """The script's phases at a tiny size on the CPU, where every wrapper
    takes its plain version: the fixture, both main paths with their checks
    and captures, the reference checks, the kernel lines, the native solve
    check and the long-utterance phase (threshold and chunk patched low)."""
    import montreal_forced_aligner_tpu_torch.ops.long_viterbi as LV

    monkeypatch.setattr(PA, "_emission_kernel_eligible", lambda P, G: True)
    cpu = torch.device("cpu")
    model_path, dict_path, words = chip_smoke.build_sat_scale_model(
        tmp_path, num_phones=5, gauss_per_pdf=3, num_words=15
    )
    corpus_dir, audio_s = chip_smoke.build_corpus(tmp_path, words, 5, 1.5, 3.0,
                                                  num_speakers=2)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    aligners = {}
    for adaptation in (True, False):
        report, aligner, counted = chip_smoke.run_main_path(
            model_path, dict_path, corpus_dir, tmp_path / f"tg{adaptation}", cpu,
            batch_size=3, warm_runs=1, adaptation=adaptation,
        )
        aligners[adaptation] = aligner
        assert report["utterances"] == 5 and report["textgrids"] == 5
        assert report["batches"] == 2
        assert abs(report["audio_s"] - audio_s) < 1e-3
        assert report["launches"] == {
            "band_forward": 0, "band_backtrace": 0, "state_emission": 0
        }
        # every wrapper call of the counted run is recorded (timed on the
        # card): once a batch, twice with the two-pass
        passes = 2 if adaptation else 1
        assert report["kernel_calls"] == {k: 2 * passes for k in report["launches"]}
        assert set(report["kernel_ms"]) == set(report["warm_kernel_ms"]) == set(
            report["launches"])
        if adaptation:
            assert report["fmllr"]["speakers_over_min_count"] >= 1
            assert report["fmllr"]["max_dev_from_identity"] > 1e-2
            assert "fmllr_solve" in report["phases_synced_s"]
        else:
            assert report["fmllr"] is None
        inputs = chip_smoke.batch_inputs(counted, report["batches"] if adaptation
                                         else 0)
        if adaptation:  # the second pass reads the adapted features
            pass1 = counted["state_emission"].args[0][0]
            assert inputs["state_emission"][0][0].shape == pass1.shape
            assert not torch.equal(inputs["state_emission"][0][0], pass1)
        # K2 is held on the last batch too (5 utterances in batches of 3)
        assert inputs["band_backtrace_last"] is not inputs["band_backtrace"]
        checks = chip_smoke.kernel_checks(inputs, aligner.gmm, cpu, reps=1)
        last = checks["band_backtrace"]["last_batch"]
        assert last["max_abs_err"] == 0.0 and last["bound_ms"] > 0
        assert last["chain_floor_ms"] is None  # no SM clock given
        line = chip_smoke.kernels_line(checks, {k: 4 for k in checks})
        assert [k["name"] for k in line["kernels"]] == [
            "band_forward", "band_backtrace", "state_emission"]
        for k in line["kernels"]:
            assert set(k) == keys
            assert k["max_abs_err"] == 0.0 and k["bound_ms"] > 0
            assert (REPO / k["source"]).is_file()
            src, lineno = k["replaces"].split(":")
            assert "pallas_call" in (REPO / src).read_text().splitlines()[int(lineno) - 1]
    for adaptation in (False, True):
        ref = chip_smoke.reference_check(model_path, dict_path, corpus_dir, cpu,
                                         adaptation)
        assert ref["frame_agreement"] == 1.0
        if adaptation:
            assert ref["transforms_max_abs_diff"] == 0.0
    solve = chip_smoke.native_solve_check(aligners[True])
    assert solve["speakers"] >= 1 and solve["max_abs_err"] <= 2e-4

    long_dir, _ = chip_smoke.build_corpus(tmp_path, words, 1, 4.0, 4.0, seed=3,
                                          name="long", num_speakers=1)
    monkeypatch.setattr(PO, "LONG_UTTERANCE_FRAMES", 100)
    monkeypatch.setattr(LV, "CHUNK_FRAMES", 90)
    out = chip_smoke.long_utterance_phase(aligners[True], long_dir, cpu, reps=1)
    assert out["T"] == 400 and out["chunks"] == 5 and out["chunk"] == 90
    assert out["paths_identical"] and out["score_diff"] <= 1e-3
    assert out["last_chunk"]["frames"] == 400 - 4 * 90 + 1
    assert out["launches"] == {k: 0 for k in out["launches"]}
    for k in ("state_emission", "band_forward", "band_backtrace"):
        assert out["last_chunk"][f"{k}_bound_ms"] > 0
        assert out["last_chunk"][f"{k}_max_abs_err"] == 0.0
    assert out["fmllr"]["speakers_over_min_count"] == 1
