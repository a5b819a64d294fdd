"""The port's whole staged recipe (mono -> tri -> LDA+MLLT -> pron_prob ->
SAT, the JAX package's ``TINY_RECIPE``) against the JAX package's, on the
CPU, and the archives carried across: each package's trained archive loads
and aligns in the other.

Bars: the same stages, the same tree leaf counts, a 40 x 91 LDA, speaker
transforms off the identity, every stage's log-likelihood per frame within
1e-3 relative of the JAX package's at every iteration, and the JAX
training test's alignment bar (labels equal to the truth, median boundary
error under 30 ms) for every (archive, aligner) pair.
"""

import zipfile

import numpy as np
import pytest

import montreal_forced_aligner_tpu.align.aligner as JA
import montreal_forced_aligner_tpu_torch.align.aligner as PA
from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus

from test_torch_train import alignment_bar, write_dict
from test_training import make_training_corpus

RECIPE = [  # tests/test_full_training.py's TINY_RECIPE
    ("monophone", "mono", 6, 40, 0),
    ("triphone", "tri", 4, 64, 48),
    ("lda", "lda", 5, 64, 48),
    ("pron_prob", "pron_prob", 0, 0, 0),
    ("sat", "sat", 5, 64, 48),
]


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    from montreal_forced_aligner_tpu.training.base import TrainerConfig as JCfg
    from montreal_forced_aligner_tpu.training.trainer import (
        StageConfig as JStage,
        TrainableAligner as JTrainable,
    )
    from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig as PCfg
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig as PStage,
        TrainableAligner as PTrainable,
    )

    tmp = tmp_path_factory.mktemp("torch_recipe")
    corpus_dir, truths = make_training_corpus(tmp, n_utts=14)
    dict_path = write_dict(tmp / "train.dict")
    out = {}
    for side, Trainable, Stage, Cfg, kw in (
        ("jax", JTrainable, JStage, JCfg, {}),
        ("port", PTrainable, PStage, PCfg, {"device": "cpu"}),
    ):
        ta = Trainable(
            corpus_dir, dict_path,
            recipe=[Stage(n, k, it, g, num_leaves=lv) for n, k, it, g, lv in RECIPE],
            base_config=Cfg(boost_silence=1.0), batch_size=4,
            variable_length_topology=False, **kw,
        )
        final = ta.train()
        final.save(tmp / f"{side}.zip")
        out[side] = (ta, final)
    return tmp, corpus_dir, dict_path, truths, out


def test_same_stages_trees_and_loglikes(recipe):
    _tmp, _cd, _dp, _truths, out = recipe
    jta, _ = out["jax"]
    pta, _ = out["port"]
    assert set(pta.models) == set(jta.models) == {"monophone", "triphone", "lda", "sat"}
    for name in pta.models:
        assert pta.models[name].gmm.num_pdfs == jta.models[name].gmm.num_pdfs, name
        jl = np.array([e["loglike_per_frame"] for e in jta.trainers[name].iteration_log])
        pl = np.array([e["loglike_per_frame"] for e in pta.trainers[name].iteration_log])
        assert pl.shape == jl.shape and np.isfinite(pl).all(), name
        assert np.all(np.abs(pl - jl) <= 1e-3 * np.abs(jl)), (name, pl, jl)
    assert set(pta.stage_seconds) == {n for n, *_ in RECIPE}
    for phase in ("features", "graph_compile", "equal_align", "realign", "stats",
                  "update", "tree", "build_tree", "mllt", "fmllr",
                  "sat_finalize"):
        assert pta.phase_seconds[phase] > 0, phase


def test_lda_and_speaker_transforms(recipe):
    _tmp, _cd, _dp, _truths, out = recipe
    pta, final = out["port"]
    assert final.meta["features"]["lda"] is True
    assert final.meta["features"]["fmllr"] is True
    assert final.lda_mat.shape == (40, 91)
    assert final.alignment_model is not None
    probs = [p.probability for prons in pta.lexicon.words.values() for p in prons]
    assert any(p is not None for p in probs)
    ident = np.hstack([np.eye(40), np.zeros((40, 1))])
    st = pta.trainers["sat"].speaker_transforms
    assert st.shape == (2, 40, 41)
    assert max(np.abs(t - ident).max() for t in st) > 1e-3


@pytest.mark.parametrize("archive", ["jax", "port"])
@pytest.mark.parametrize("aligner", ["jax", "port"])
def test_archives_align_in_both_packages(recipe, archive, aligner):
    """Each package's SAT archive (phone LM, phone_pdf.counts, alignment
    model) through each package's two-pass aligner."""
    tmp, corpus_dir, dict_path, truths, _out = recipe
    path = tmp / f"{archive}.zip"
    if aligner == "jax":
        al = JA.PretrainedAligner(path, dict_path,
                                  JA.AlignerConfig(frame_bucket_multiple=32, batch_size=4))
        corpus = JCorpus.load(corpus_dir)
    else:
        al = PA.PretrainedAligner(path, dict_path, PA.AlignerConfig(batch_size=4),
                                  device="cpu")
        corpus = PCorpus.load(corpus_dir)
    assert al.model.phone_lm is not None
    alignment_bar(al.align_corpus(corpus), corpus, truths)


def test_archive_members_are_the_jax_packages(recipe):
    tmp = recipe[0]
    names = {}
    for side in ("jax", "port"):
        with zipfile.ZipFile(tmp / f"{side}.zip") as zf:
            names[side] = set(zf.namelist())
    assert names["port"] == names["jax"]
    assert {"phone_pdf.counts", "phone_lm.arpa", "phone_lm.fst", "final.alimdl",
            "lda.mat"} <= names["port"]
