"""The port's training against the JAX package's, on the CPU: the training
alignment, one EM iteration, the monophone stage, resume from a checkpoint,
the phone-LM archive members, and the ``train`` command.

Tolerances: state paths equal and scores within 1e-3; one EM iteration's
accumulators and model within rtol 1e-5 of each tensor's largest magnitude
(Gaussian counts equal); the monophone stage's log-likelihood per frame
within 1e-3 relative at every iteration, Gaussian counts equal; a resumed
port run within atol 1e-4 of the uninterrupted one (the JAX package's
resume test bars), a JAX checkpoint finished by the port held to the
monophone stage's bars against the JAX package's uninterrupted run;
alignments of the trained models held to the JAX training test's bar
(labels equal to the truth, median boundary error under 30 ms).
"""

import json
import zipfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import montreal_forced_aligner_tpu.training.base as JB
import montreal_forced_aligner_tpu_torch.align.aligner as PA
import montreal_forced_aligner_tpu_torch.training.base as PB
from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
from montreal_forced_aligner_tpu.dictionary.lexicon import Lexicon as JLexicon
from montreal_forced_aligner_tpu.models.acoustic_model import AcousticModel as JModel
from montreal_forced_aligner_tpu.training.em import ViterbiEmTrainer as JEm
from montreal_forced_aligner_tpu.training.monophone import MonophoneTrainer as JMono
from montreal_forced_aligner_tpu_torch.cli import main as cli_main
from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon as PLexicon
from montreal_forced_aligner_tpu_torch.graph.compiler import ship_graph_to_device
from montreal_forced_aligner_tpu_torch.models.acoustic_model import (
    AcousticModel as PModel,
)
from montreal_forced_aligner_tpu_torch.training.em import ViterbiEmTrainer as PEm
from montreal_forced_aligner_tpu_torch.training.monophone import (
    MonophoneTrainer as PMono,
)

from test_training import WORD_PHONES, make_training_corpus

CPU = torch.device("cpu")


def write_dict(path):
    path.write_text("".join(f"{w}\t{' '.join(p)}\n" for w, p in WORD_PHONES.items()))
    return path


def alignment_bar(results, corpus, truths):
    """The JAX training test's bar: non-silence labels equal to the truth,
    median boundary error under 30 ms, mean under 50 ms."""
    errors = []
    for utt in corpus.utterances:
        full = truths[utt.file_name]
        truth = [(ph, b, e) for ph, b, e in full if ph != "sil"]
        got = [p for p in results[utt.id].phones if p.label not in ("sil", "spn")]
        assert [p.label for p in got] == [ph for ph, _b, _e in truth], utt.file_name
        nonsil_idx = [i for i, (ph, _b, _e) in enumerate(full) if ph != "sil"]
        for j, ((ph, b, e), p) in enumerate(zip(truth, got)):
            i = nonsil_idx[j]
            if i == 0 or full[i - 1][0] != ph:
                errors.append(abs(p.begin - b))
            if i == len(full) - 1 or full[i + 1][0] != ph:
                errors.append(abs(p.end - e))
    assert np.median(errors) < 0.03
    assert np.mean(errors) < 0.05
    return float(np.median(errors))


def _close_to_scale(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    scale = np.abs(want[fin]).max()
    assert np.abs(got[fin] - want[fin]).max() <= rtol * scale


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    """The JAX training test's monophone run (6 utterances, 10 iterations,
    74 Gaussians, chain topology) on each side."""
    from montreal_forced_aligner_tpu.training.base import TrainerConfig as JCfg
    from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig as PCfg

    tmp = tmp_path_factory.mktemp("torch_mono_train")
    corpus_dir, truths = make_training_corpus(tmp)
    dict_path = write_dict(tmp / "train.dict")
    out = {}
    for side, Lex, Corp, Pipe, Mono, Cfg, kw in (
        ("jax", JLexicon, JCorpus, JB.TrainingPipeline, JMono, JCfg, {}),
        ("port", PLexicon, PCorpus, PB.TrainingPipeline, PMono, PCfg,
         {"device": "cpu"}),
    ):
        lexicon = Lex.load(dict_path, position_dependent=False)
        pipeline = Pipe(Corp.load(corpus_dir), lexicon, batch_size=4, **kw)
        pipeline.prepare_features()
        trainer = Mono(
            lexicon,
            Cfg(num_iterations=10, max_gaussians=74, boost_silence=1.0),
            variable_length_topology=False,
        )
        model = trainer.train(pipeline)
        model.save(tmp / f"{side}.zip")
        out[side] = (lexicon, pipeline, trainer, model)
    return tmp, corpus_dir, dict_path, truths, out


def test_monophone_stage_matches_jax(mono):
    _tmp, _cd, _dp, _truths, out = mono
    jlog = out["jax"][2].iteration_log
    plog = out["port"][2].iteration_log
    assert [e["iteration"] for e in plog] == list(range(1, 11))
    assert [e["num_gaussians"] for e in plog] == [e["num_gaussians"] for e in jlog]
    jl = np.array([e["loglike_per_frame"] for e in jlog])
    pl = np.array([e["loglike_per_frame"] for e in plog])
    assert np.all(np.abs(pl - jl) <= 1e-3 * np.abs(jl))
    assert pl[-1] > pl[0] + 1.0
    pm, jm = out["port"][3], out["jax"][3]
    assert pm.gmm.num_pdfs == jm.gmm.num_pdfs
    np.testing.assert_array_equal(pm.gmm.num_gauss, jm.gmm.num_gauss)


def test_monophone_model_aligns(mono):
    tmp, corpus_dir, dict_path, truths, _out = mono
    aligner = PA.PretrainedAligner(tmp / "port.zip", dict_path,
                                   PA.AlignerConfig(batch_size=4), device="cpu")
    corpus = PCorpus.load(corpus_dir)
    alignment_bar(aligner.align_corpus(corpus), corpus, truths)


@pytest.mark.parametrize("use_kernel_rule", [False, True])
def test_align_batch_matches_jax(mono, monkeypatch, use_kernel_rule):
    """The training alignment with the trained JAX model, on the JAX
    pipeline's batches: all pdfs and a gather, or the state-emission path
    (forced on), against the JAX package's one-hot selection."""
    monkeypatch.setattr(PB, "_emission_kernel_eligible",
                        lambda P, G: use_kernel_rule)
    _tmp, _cd, _dp, _truths, out = mono
    _lex, jpipe, jtrainer, _model = out["jax"]
    W, gconsts = jtrainer._device_gmm(boosted=False)
    gmm = PB.train_gmm(*(torch.from_numpy(np.array(x)) for x in (
        W, gconsts, jtrainer.gmm.means_invvars, jtrainer.gmm.inv_vars)))
    assert gmm.use_emission_kernel == use_kernel_rule
    for fb in jpipe.batches:
        assert fb.band_limits is not None
        feats = np.asarray(fb.feats)
        graph = ship_graph_to_device(fb.garrs, CPU)
        want = JB._align_batch(jnp.asarray(feats), jnp.asarray(fb.frame_lengths),
                               fb.graph, W, gconsts, 0.1,
                               band_limits=fb.band_limits, use_pallas=False)
        got = PB._align_batch(torch.from_numpy(feats.copy()),
                              torch.from_numpy(fb.frame_lengths), graph, gmm, 0.1,
                              band_limits=fb.band_limits)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-3)
        want = JB._equal_align_batch(jnp.asarray(feats), jnp.asarray(fb.frame_lengths),
                                     fb.graph, band_limits=fb.band_limits,
                                     use_pallas=False)
        got = PB._equal_align_batch(torch.from_numpy(feats.copy()),
                                    torch.from_numpy(fb.frame_lengths), graph,
                                    band_limits=fb.band_limits)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-3)


def test_one_em_iteration_matches_jax(mono):
    """Accumulate, update and mix up once from the same model (the trained
    JAX archive's tree and transitions, a flat-start GMM from the corpus's
    global moments) and the same alignment: the accumulators within rtol
    1e-5 of their largest magnitude; the update and mixing-up, given the
    JAX package's accumulators, within rtol 1e-5 of the JAX package's model
    (from each side's own accumulators the updated variances differ by
    more: E[x^2] - mean^2 of the tones' narrow Gaussians loses digits to
    cancellation, on either side)."""
    from montreal_forced_aligner_tpu.training.base import TrainerConfig as JCfg
    from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig as PCfg
    from montreal_forced_aligner_tpu_torch.training.em import DeviceAccumulators

    tmp, corpus_dir, dict_path, _truths, out = mono
    jlex, jpipe, _jt, _jm = out["jax"]
    plex, ppipe, _pt, _pm = out["port"]
    mean, var = jpipe.global_mean_var()
    trainers = []
    for Em, Model, Cfg, lex, pipe in ((JEm, JModel, JCfg, jlex, jpipe),
                                      (PEm, PModel, PCfg, plex, ppipe)):
        m = Model.load(tmp / "jax.zip")
        tr = Em(lex, Cfg(num_iterations=10, max_gaussians=120, boost_silence=1.25))
        tr.tm, tr.tree = m.transition_model, m.tree
        tr.gmm = type(m.gmm).from_lists(
            weights_list=[np.ones(1, np.float32)] * m.gmm.num_pdfs,
            miv_list=[(mean / var)[None].astype(np.float32)] * m.gmm.num_pdfs,
            iv_list=[(1.0 / var)[None].astype(np.float32)] * m.gmm.num_pdfs,
        )
        tr._pipeline = pipe
        trainers.append(tr)
    jt, pt = trainers
    ppipe.compile_graphs(pt.make_compiler())
    for jfb, pfb in zip(jpipe.batches, ppipe.batches):
        assert jfb.utt_indices == pfb.utt_indices
        pfb.set_host_alignment(jfb.host_state_path(), jfb.host_frame_tid(),
                               jfb.host_align_scores())
    jacc = jt._accumulate(jpipe)
    pacc = pt._accumulate(ppipe)
    for g, w in zip(pacc, jacc):
        _close_to_scale(g.numpy(), np.asarray(w))
    target = jt.gmm.total_gauss * 3
    jstats = jt._update(jacc, mixup_target=target)
    pstats = pt._update(
        DeviceAccumulators(*(torch.from_numpy(np.array(x)) for x in jacc)),
        mixup_target=target,
    )
    jt.sync_host_model(jpipe)
    pt.sync_host_model(ppipe)
    assert pt.gmm.total_gauss == jt.gmm.total_gauss > target // 2
    np.testing.assert_array_equal(pt.gmm.num_gauss, jt.gmm.num_gauss)
    for name in ("weights", "means_invvars", "inv_vars", "gconsts"):
        _close_to_scale(getattr(pt.gmm, name), getattr(jt.gmm, name))
    _close_to_scale(pt.tm.log_probs, jt.tm.log_probs)
    assert pstats == jstats


class _KillAt(Exception):
    pass


def _port_trainable(tmp_path, recipe, wd=None):
    from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig
    from montreal_forced_aligner_tpu_torch.training.trainer import TrainableAligner

    return TrainableAligner(
        tmp_path / "train_corpus", tmp_path / "train.dict", recipe=recipe,
        base_config=TrainerConfig(boost_silence=1.0),
        batch_size=4, variable_length_topology=False, working_directory=wd,
        device="cpu",
    )


@pytest.mark.parametrize("kill_stage,kill_iter", [("mono", 4), ("sat", 4)])
def test_kill_and_resume_matches_uninterrupted(tmp_path, monkeypatch, kill_stage,
                                               kill_iter):
    """A port run killed after checkpoint ``kill_iter`` resumes from it and
    reproduces the uninterrupted run (SAT: after the iteration-2 fMLLR
    estimate, so the checkpoint carries transforms and adapted features)."""
    from montreal_forced_aligner_tpu_torch.training.trainer import StageConfig

    make_training_corpus(tmp_path, n_utts=6)
    write_dict(tmp_path / "train.dict")
    if kill_stage == "mono":
        recipe = [StageConfig("monophone", "mono", 6, 40)]
    else:
        recipe = [StageConfig("monophone", "mono", 4, 30),
                  StageConfig("triphone", "tri", 3, 48, num_leaves=32),
                  StageConfig("sat", "sat", 5, 64, num_leaves=32)]
    m_ref = (ref := _port_trainable(tmp_path, recipe)).train()
    wd = tmp_path / "work"
    orig_save = PEm._save_iter_checkpoint

    def killer(self, it, pipeline, current_target):
        orig_save(self, it, pipeline, current_target)
        if self.train_type == kill_stage and it == kill_iter:
            raise _KillAt()

    monkeypatch.setattr(PEm, "_save_iter_checkpoint", killer)
    with pytest.raises(_KillAt):
        _port_trainable(tmp_path, recipe, wd).train()
    assert list(wd.rglob("iters/*.npz"))
    assert json.loads((wd / "run_state.json").read_text())["state"] == "running"
    monkeypatch.setattr(PEm, "_save_iter_checkpoint", orig_save)
    res = _port_trainable(tmp_path, recipe, wd)
    m_res = res.train()
    last = recipe[-1].name
    assert [e["iteration"] for e in res.trainers[last].iteration_log] == list(
        range(1, recipe[-1].num_iterations + 1))
    assert m_res.gmm.num_pdfs == m_ref.gmm.num_pdfs
    np.testing.assert_allclose(m_res.transition_model.log_probs,
                               m_ref.transition_model.log_probs, atol=1e-4)
    np.testing.assert_allclose(m_res.gmm.gconsts, m_ref.gmm.gconsts, atol=1e-4)
    np.testing.assert_allclose(m_res.gmm.means_invvars, m_ref.gmm.means_invvars,
                               atol=1e-4)
    if kill_stage == "sat":
        np.testing.assert_allclose(res.trainers[last].speaker_transforms,
                                   ref.trainers[last].speaker_transforms, atol=1e-4)


def test_jax_checkpoint_resumes_in_port(tmp_path, monkeypatch):
    """A JAX run killed after iteration 4 of 6 leaves ``4.npz``; the port
    resumes it, runs iterations 5 and 6, and ends where the JAX package's
    uninterrupted run does: the same Gaussian counts, log-likelihoods within
    1e-3, transitions within 1e-4."""
    from montreal_forced_aligner_tpu.training.base import TrainerConfig as JCfg
    from montreal_forced_aligner_tpu.training.trainer import (
        StageConfig as JStage,
        TrainableAligner as JTrainable,
    )
    from montreal_forced_aligner_tpu_torch.training.trainer import StageConfig

    make_training_corpus(tmp_path, n_utts=6)
    write_dict(tmp_path / "train.dict")

    def jax_run(wd=None):
        return JTrainable(
            tmp_path / "train_corpus", tmp_path / "train.dict",
            recipe=[JStage("monophone", "mono", 6, 40)],
            base_config=JCfg(boost_silence=1.0), batch_size=4,
            variable_length_topology=False, distributed=False, working_directory=wd,
        )

    ref = jax_run()
    m_ref = ref.train()
    wd = tmp_path / "work"
    orig_save = JEm._save_iter_checkpoint

    def killer(self, it, pipeline, current_target):
        orig_save(self, it, pipeline, current_target)
        if it == 4:
            raise _KillAt()

    monkeypatch.setattr(JEm, "_save_iter_checkpoint", killer)
    with pytest.raises(_KillAt):
        jax_run(wd).train()
    assert (wd / "monophone" / "iters" / "4.npz").exists()
    port = _port_trainable(tmp_path, [StageConfig("monophone", "mono", 6, 40)], wd)
    m_res = port.train()
    plog = port.trainers["monophone"].iteration_log
    jlog = ref.trainers["monophone"].iteration_log
    assert [e["iteration"] for e in plog] == list(range(1, 7))
    assert [e["num_gaussians"] for e in plog] == [e["num_gaussians"] for e in jlog]
    jl = np.array([e["loglike_per_frame"] for e in jlog])
    pl = np.array([e["loglike_per_frame"] for e in plog])
    assert np.all(np.abs(pl - jl) <= 1e-3 * np.abs(jl))
    np.testing.assert_allclose(m_res.transition_model.log_probs,
                               m_ref.transition_model.log_probs, atol=1e-4)
    np.testing.assert_array_equal(m_res.gmm.num_gauss, m_ref.gmm.num_gauss)


def _synthetic_archives(tmp_path):
    """The JAX package's synthetic model, saved as it is and with a phone
    LM trained by the JAX package on a few phone strings."""
    from helpers import build_synthetic_corpus, build_synthetic_model
    from montreal_forced_aligner_tpu.language_modeling.ngram import (
        train_lm_from_texts,
    )

    corpus_dir, wave = build_synthetic_corpus(tmp_path, text="ab a")
    plain_path, dict_path = build_synthetic_model(tmp_path, wave=wave)
    model = JModel.load(plain_path)
    model.phone_lm, _ = train_lm_from_texts(
        ["a b a", "b a", "a b", "a a b b"], order=2
    )
    lm_path = tmp_path / "with_phone_lm.zip"
    model.save(lm_path)
    return corpus_dir, dict_path, plain_path, lm_path


def test_phone_lm_archive_members_load_and_align(tmp_path):
    """The port loaded no archive with a phone LM (every archive the JAX
    package trains has one): ``AcousticModel.load`` raised. It now reads
    ``phone_lm.arpa`` (or ``phone_lm.fst``), writes both back, and aligns
    as without the LM."""
    corpus_dir, dict_path, plain_path, lm_path = _synthetic_archives(tmp_path)
    with zipfile.ZipFile(lm_path) as zf:
        assert {"phone_lm.arpa", "phone_lm.fst"} <= set(zf.namelist())
    got = PModel.load(lm_path)
    want = JModel.load(lm_path).phone_lm
    assert got.phone_lm is not None
    assert got.phone_lm.ngrams == want.ngrams
    results = {}
    for key, path in (("lm", lm_path), ("plain", plain_path)):
        aligner = PA.PretrainedAligner(path, dict_path, device="cpu")
        results[key] = aligner.align_corpus(PCorpus.load(corpus_dir))
    for uid, aln in results["plain"].items():
        other = results["lm"][uid]
        assert [(p.label, p.begin, p.end) for p in other.phones] == [
            (p.label, p.begin, p.end) for p in aln.phones]
        assert other.log_likelihood == aln.log_likelihood
    # the port writes both members back; the JAX package reads them
    again = tmp_path / "port_saved.zip"
    got.save(again)
    with zipfile.ZipFile(again) as zf:
        assert {"phone_lm.arpa", "phone_lm.fst"} <= set(zf.namelist())
    assert JModel.load(again).phone_lm.ngrams == want.ngrams
    # the FST member alone is read too
    fst_only = tmp_path / "fst_only.zip"
    with zipfile.ZipFile(lm_path) as src, zipfile.ZipFile(fst_only, "w") as dst:
        for name in src.namelist():
            if name != "phone_lm.arpa":
                dst.writestr(name, src.read(name))
    from_fst = PModel.load(fst_only).phone_lm
    assert from_fst is not None
    assert set(from_fst.ngrams[1]) == set(JModel.load(fst_only).phone_lm.ngrams[1])


def test_corrupt_phone_lm_fst_warns(tmp_path, caplog):
    import logging

    _corpus_dir, _dict_path, _plain, lm_path = _synthetic_archives(tmp_path)
    bad = tmp_path / "bad_fst.zip"
    with zipfile.ZipFile(lm_path) as src, zipfile.ZipFile(bad, "w") as dst:
        for name in src.namelist():
            if name == "phone_lm.arpa":
                continue
            data = src.read(name)
            dst.writestr(name, data[:20] if name == "phone_lm.fst" else data)
    with caplog.at_level(logging.WARNING, logger="mfa_tpu"):
        model = PModel.load(bad)
    assert model.phone_lm is None
    assert "could not parse phone_lm.fst" in caplog.text


def test_cli_train_writes_a_loadable_archive(tmp_path, capsys):
    make_training_corpus(tmp_path, n_utts=4)
    dict_path = write_dict(tmp_path / "train.dict")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("training:\n  - monophone:\n      num_iterations: 3\n"
                   "      max_gaussians: 30\n")
    out = tmp_path / "out.zip"
    tg = tmp_path / "tg"
    rc = cli_main(["train", str(tmp_path / "train_corpus"), str(dict_path), str(out),
                   "--device", "cpu", "--config_path", str(cfg), "--batch_size", "4",
                   "--chain_topology", "--output_directory", str(tg),
                   "--output_format", "json"])
    assert rc == 0
    assert "Saved model" in capsys.readouterr().out
    for Model in (PModel, JModel):
        m = Model.load(out)
        assert m.gmm.num_pdfs > 0 and m.phone_lm is not None
        assert m.meta["train_type"] == "mono"
    assert len(list(tg.glob("**/*.json"))) == 4


@pytest.mark.parametrize("args,item", [
    (["--language", "thai"], "item 16"),
    (["--rules_path", "rules.yaml"], "item 16"),
    (["--graph_workers", "2"], "item 16"),
    (["--train_g2p"], "item 16"),
    (["--distributed"], "item 15"),
    (["--config_path", "pitch.yaml"], "item 11"),
])
def test_cli_train_unported_options_raise(tmp_path, monkeypatch, args, item):
    make_training_corpus(tmp_path, n_utts=2)
    dict_path = write_dict(tmp_path / "train.dict")
    (tmp_path / "rules.yaml").write_text("rules: []\n")
    (tmp_path / "pitch.yaml").write_text("features:\n  use_pitch: true\n")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=item):
        cli_main(["train", str(tmp_path / "train_corpus"), str(dict_path),
                  str(tmp_path / "m.zip"), "--device", "cpu"] + args)


def test_training_raises_without_a_card(tmp_path):
    from montreal_forced_aligner_tpu_torch.training.trainer import TrainableAligner

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    make_training_corpus(tmp_path, n_utts=2)
    dict_path = write_dict(tmp_path / "train.dict")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainableAligner(tmp_path / "train_corpus", dict_path)


def test_chip_smoke_training_phases_run_on_cpu(tmp_path, monkeypatch):
    """The script's training phases at a tiny size on the CPU (every
    wrapper takes its plain version, so no launches): its tone corpus is
    the JAX training test's, train-mono's and train-recipe's reports and
    checks, train-mono's K1/K2 captures of the equal alignment and the first
    realignment and the LDA stage's kernel capture through the checks and
    the kernels line."""
    import chip_smoke

    from test_training import make_training_corpus as jax_corpus

    cpu = torch.device("cpu")
    corpus_dir, truths = chip_smoke.make_tone_corpus(tmp_path / "port", n_utts=8)
    _jdir, jtruths = jax_corpus(tmp_path / "jax", n_utts=8)
    assert truths == jtruths
    for wav in sorted(corpus_dir.rglob("*.wav")):
        other = tmp_path / "jax" / "train_corpus" / wav.relative_to(corpus_dir)
        assert wav.read_bytes() == other.read_bytes()
    dict_path = tmp_path / "tone.dict"
    dict_path.write_text("".join(f"{w}\t{' '.join(p)}\n"
                                 for w, p in chip_smoke.WORD_PHONES.items()))
    mono, mono_checks = chip_smoke.train_mono_phase(corpus_dir, dict_path, 10.0, cpu,
                                                    warm_runs=1, batch_size=4)
    assert set(mono_checks) == {"train_mono_equal_align", "train_mono_realign"}
    for cks in mono_checks.values():
        assert set(cks) == {"band_forward", "band_backtrace"}
        assert cks["band_forward"]["max_abs_err"] == 0.0
        assert cks["band_backtrace"]["last_batch"]["max_abs_err"] == 0.0
    # the equal alignment's emissions are the position priors at scale 1.0
    assert mono_checks["train_mono_equal_align"]["band_forward"]["shape"]["B"] == 4
    assert mono["launches"] == {"band_forward": 0, "band_backtrace": 0,
                                "state_emission": 0}
    assert mono["alignments"] == 2 and mono["banded_batches"] == 2
    assert mono["profiled_warm_run"] is None
    assert {"features", "graph_compile", "equal_align", "realign", "stats",
            "update"} <= set(mono["phases_synced_s"])
    monkeypatch.setattr(PB, "_emission_kernel_eligible", lambda P, G: True)
    recipe = [("monophone", "mono", 3, 40, 0), ("triphone", "tri", 3, 64, 24),
              ("lda", "lda", 3, 64, 24), ("sat_1", "sat", 3, 64, 24),
              ("pron_prob_1", "pron_prob", 0, 0, 0)]
    report, captured = chip_smoke.train_recipe_phase(
        corpus_dir, dict_path, tmp_path, cpu, recipe=recipe, batch_size=4)
    assert report["aligned_utterances"] == 8
    assert set(report["stages"]) == {name for name, *_ in recipe}
    assert report["stages"]["lda"]["tree_leaves"] == 24
    calls = captured["calls"]
    assert {k: r.calls for k, r in calls.items()} == {
        "state_emission": 2, "band_forward": 2, "band_backtrace": 2}
    checks = chip_smoke.kernel_checks(chip_smoke.batch_inputs(calls, 0),
                                      captured["gmm"], cpu, reps=1,
                                      k3_term_bound=True)
    assert checks["state_emission"]["max_abs_err"] == 0.0
    assert checks["state_emission"]["bar_term_rtol"] > 0
    assert checks["state_emission"]["term_scale_max"] < 1e29
    f64 = checks["state_emission"]["against_float64"]
    assert f64["states"] == captured["calls"]["state_emission"].args[0][1].shape[1]
    assert 0.0 <= f64["kernel_worst_share_of_bar"] <= 1.0
    line = chip_smoke.kernels_line(checks, {k: 4 for k in checks},
                                   {"train-recipe": report["launches"]},
                                   {**mono_checks, "train_recipe": checks})
    for row in line["kernels"]:
        assert row["launches_by_path"] == {"train-recipe": 0}
        assert row["train_recipe_check"]["max_abs_err"] == 0.0
        has_mono = row["name"] != "state_emission"
        assert ("train_mono_realign_check" in row) == has_mono


def test_features_on_host_match_device_resident(tmp_path):
    """Feature batches in host memory (``features_on_host``) move to the
    device at each use and train the same model."""
    from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig

    corpus_dir, _ = make_training_corpus(tmp_path, n_utts=4)
    dict_path = write_dict(tmp_path / "train.dict")
    lexicon = PLexicon.load(dict_path, position_dependent=False)
    logs = []
    for on_host in (False, True):
        pipeline = PB.TrainingPipeline(PCorpus.load(corpus_dir), lexicon, batch_size=4,
                                       features_on_host=on_host, device="cpu")
        pipeline.prepare_features()
        trainer = PMono(lexicon, TrainerConfig(num_iterations=3, max_gaussians=20,
                                               boost_silence=1.0))
        trainer.train(pipeline)
        logs.append([e["loglike_per_frame"] for e in trainer.iteration_log])
    assert logs[0] == logs[1]


def test_stage_checkpoints_resume_without_retraining(tmp_path):
    from montreal_forced_aligner_tpu_torch.training.trainer import StageConfig

    make_training_corpus(tmp_path, n_utts=4)
    write_dict(tmp_path / "train.dict")
    recipe = [StageConfig("monophone", "mono", 3, 30),
              StageConfig("triphone", "tri", 2, 40, num_leaves=32)]
    wd = tmp_path / "work"
    m1 = _port_trainable(tmp_path, recipe, wd).train()
    assert (wd / "monophone" / "model.zip").exists()
    assert (wd / "triphone" / "model.zip").exists()
    again = _port_trainable(tmp_path, recipe, wd)
    m2 = again.train()
    assert again.trainers["triphone"].iteration_log == []
    assert m2.gmm.num_pdfs == m1.gmm.num_pdfs
    np.testing.assert_allclose(m2.transition_model.log_probs,
                               m1.transition_model.log_probs, atol=1e-6)
