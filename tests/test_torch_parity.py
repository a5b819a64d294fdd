"""The port's parity harness (``parity/*``) against the JAX package's on the
CPU: the numpy reference decoder (copied as it is) and ``compare_corpus``
on the synthetic model of ``tests/helpers.py``, ``compare_corpus_sat`` on a
reduced SAT-scale model of two speakers, and ``accuracy`` scoring the
port's alignments against the TextGrids the JAX package exports.

Tolerances: each utterance's report equal field for field (frames,
mismatching frames, boundaries exact and within one frame), the production
and the reference scores within 1e-5 of their magnitude (float32 features
and sums of the two packages differ in their last bits); the accuracy
metrics equal within 1e-6.
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke
from helpers import build_synthetic_corpus, build_synthetic_model


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity_mono")
    model_path, dict_path = build_synthetic_model(tmp)
    corpus_dir, _wave = build_synthetic_corpus(tmp)
    return model_path, dict_path, corpus_dir


@pytest.fixture(scope="module")
def sat(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity_sat")
    model_path, dict_path, words = chip_smoke.build_sat_scale_model(
        tmp, num_phones=5, gauss_per_pdf=3, num_words=15)
    corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 4, min_s=2.0, max_s=3.0,
                                            num_speakers=2)
    return model_path, dict_path, corpus_dir


def _aligners(model_path, dict_path, **cfg):
    from montreal_forced_aligner_tpu.align.aligner import AlignerConfig as JCfg
    from montreal_forced_aligner_tpu.align.aligner import PretrainedAligner as JAl
    from montreal_forced_aligner_tpu_torch.align.aligner import AlignerConfig
    from montreal_forced_aligner_tpu_torch.align.aligner import PretrainedAligner

    return (PretrainedAligner(model_path, dict_path, AlignerConfig(**cfg),
                              device="cpu"),
            JAl(model_path, dict_path, JCfg(**cfg)))


def _corpora(corpus_dir):
    from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    return Corpus.load(corpus_dir), JCorpus.load(corpus_dir)


def _same_reports(got, want, rtol=1e-5):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        for key in ("utterance_id", "num_frames", "frame_mismatches",
                    "boundary_total", "boundary_exact", "boundary_within_1"):
            assert g[key] == w[key], key
        for key in ("score_production", "score_reference"):
            assert abs(g[key] - w[key]) <= rtol * abs(w[key]), key


@pytest.mark.parametrize("boost", [1.0, 2.0])
def test_compare_corpus_matches_jax(mono, boost):
    from montreal_forced_aligner_tpu.parity.harness import compare_corpus as jcc
    from montreal_forced_aligner_tpu_torch.parity.harness import compare_corpus

    model_path, dict_path, corpus_dir = mono
    pal, jal = _aligners(model_path, dict_path, boost_silence=boost)
    pc, jc = _corpora(corpus_dir)
    got, want = compare_corpus(pal, pc), jcc(jal, jc)
    _same_reports(got, want)
    # the synthetic model's tones: the two paths agree on every frame
    assert all(r.frame_mismatches == 0 for r in got)


def test_compare_corpus_sat_matches_jax(sat):
    from montreal_forced_aligner_tpu.parity.harness import compare_corpus_sat as jcs
    from montreal_forced_aligner_tpu_torch.parity.harness import compare_corpus_sat

    model_path, dict_path, corpus_dir = sat
    pal, jal = _aligners(model_path, dict_path, batch_size=2,
                         fmllr_min_count=10.0)
    pc, jc = _corpora(corpus_dir)
    _same_reports(compare_corpus_sat(pal, pc, max_utterances=3),
                  jcs(jal, jc, max_utterances=3))


def test_reference_decoder_copied_as_is():
    from pathlib import Path

    import montreal_forced_aligner_tpu.parity.reference_decoder as J
    import montreal_forced_aligner_tpu_torch.parity.reference_decoder as P

    assert Path(P.__file__).read_text() == Path(J.__file__).read_text()


def test_accuracy_scores_port_against_jax_textgrids(mono, tmp_path):
    from montreal_forced_aligner_tpu.parity.accuracy import (
        evaluate_corpus_against_textgrids as jeval,
    )
    from montreal_forced_aligner_tpu_torch.parity.accuracy import (
        evaluate_corpus_against_textgrids,
        main,
    )

    model_path, dict_path, corpus_dir = mono
    pal, jal = _aligners(model_path, dict_path)
    pc, jc = _corpora(corpus_dir)
    ref_dir = tmp_path / "jax_tg"
    jal.export_textgrids(jc, jal.align_corpus(jc), ref_dir)
    got = evaluate_corpus_against_textgrids(pal, pc, ref_dir)
    want = jeval(jal, _corpora(corpus_dir)[1], ref_dir)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k
    assert got["files"] == 1 and got["boundary_agreement_10ms"] == 1.0
    out = tmp_path / "acc.json"
    assert main([str(corpus_dir), str(dict_path), str(model_path), str(ref_dir),
                 "--device", "cpu", "--json_path", str(out)]) == 0
    assert out.read_text().startswith("{")


def test_harness_main_runs(mono, sat, capsys):
    from montreal_forced_aligner_tpu_torch.parity.harness import main

    model_path, dict_path, corpus_dir = mono
    main([str(corpus_dir), str(dict_path), str(model_path), "--device", "cpu"])
    assert "frame_agreement=100.0000%" in capsys.readouterr().out
    model_path, dict_path, corpus_dir = sat
    main([str(corpus_dir), str(dict_path), str(model_path), "--device", "cpu",
          "--sat", "--max_utterances", "1"])
    assert "utterances=1" in capsys.readouterr().out
