"""Multi-GPU on the CPU: the port's ``train --distributed``, ``align
--distributed``, the CLI under several ranks and the dry run, against the
port's single run and the JAX package's; counterparts of
``tests/test_distributed.py``. Ranks are processes spawned by
``parallel.multihost.run_ranks`` over gloo (a ``file://`` store), or
launched as users launch them (``python -m torch.distributed.run``); each
multi-process test has a hard timeout that kills every rank.

Tolerances (the JAX package's ``test_distributed.py`` bars): training at
W = 2 against the port's single run and the JAX package's: the same pdf
count and Gaussian counts at every iteration, log-likelihood per frame
within 2e-3, transition log-probabilities within 1e-4; at W = 1 the model
and its iteration log bit-identical to the non-distributed run's; the two
ranks' models bit-identical. Alignment at W = 2: speaker-independent
intervals identical to the single run's and scores within 1e-5 relative
plus 1e-3 (a rank's batches group a speaker's utterances otherwise, so its
float32 CMVN sums round otherwise), a pitch model's too (a row's pitch
does not depend on its batch); the SAT
two-pass with identical phone sequences and boundaries within 11 ms (one
frame; fMLLR statistics sum in another order). ``devices=("cpu", "cpu")``:
intervals and scores identical. CLI: the union of the ranks' exports is
the single run's, file for file.
"""

import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from montreal_forced_aligner_tpu_torch.parallel.multihost import run_ranks

REPO = Path(__file__).resolve().parent.parent
# a multi-process test's hard limit (every rank is killed past it)
RANK_TIMEOUT = 300.0

# the JAX test's recipe: (name, kind, iterations, max Gaussians, leaves)
RECIPE = [("monophone", "mono", 4, 40, 0), ("triphone", "tri", 3, 64, 48)]


def _stage_configs(StageConfig):
    return [StageConfig(n, k, it, g, num_leaves=l) for n, k, it, g, l in RECIPE]


def _train_port(corpus_dir, dict_path, **kw):
    from montreal_forced_aligner_tpu_torch.training.base import TrainerConfig
    from montreal_forced_aligner_tpu_torch.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    ta = TrainableAligner(
        corpus_dir, dict_path, recipe=_stage_configs(StageConfig),
        base_config=TrainerConfig(boost_silence=1.0), batch_size=4,
        variable_length_topology=False, device="cpu", **kw,
    )
    return ta, ta.train()


def _summary(ta, model):
    gmm = model.gmm
    return {
        "logs": {k: [(e["loglike_per_frame"], e["num_gaussians"])
                     for e in t.iteration_log] for k, t in ta.trainers.items()},
        "log_probs": np.asarray(model.transition_model.log_probs),
        "num_pdfs": int(gmm.num_pdfs),
        "arrays": [np.asarray(a) for a in (gmm.weights, gmm.means_invvars,
                                           gmm.inv_vars, gmm.gconsts)],
        "utterances": ta.corpus.num_utterances,
    }


def _train_rank(rank, world, corpus_dir, dict_path):
    """A rank of ``train --distributed``; at W = 1 also the same training
    without the mesh, in this process, for the bit-for-bit check."""
    out = {"dist": _summary(*_train_port(corpus_dir, dict_path, distributed=True))}
    if world == 1:
        out["plain"] = _summary(*_train_port(corpus_dir, dict_path,
                                             distributed=False))
    return out


def _align_rank(rank, world, jobs):
    """A rank aligning each (model, dict, corpus, config) job distributed."""
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    out = []
    for model_path, dict_path, corpus_dir, cfg in jobs:
        al = PretrainedAligner(model_path, dict_path,
                               AlignerConfig(distributed=True, **cfg), device="cpu")
        assert al.mesh.world_size == world
        res = al.align_corpus(Corpus.load(corpus_dir))
        out.append((_intervals(res), al.last_shard))
    # without ``distributed`` the aligner aligns the whole corpus it is
    # given, and makes no collective, whatever the process group
    model_path, dict_path, corpus_dir, cfg = jobs[0]
    al = PretrainedAligner(model_path, dict_path, AlignerConfig(**cfg), device="cpu")
    assert al.mesh is None
    out.append(_intervals(al.align_corpus(Corpus.load(corpus_dir))))
    return out


def _cli_rank(rank, world, runs):
    """A rank running each CLI command line; returns each one's exit code
    and what it printed."""
    from montreal_forced_aligner_tpu_torch.cli import main

    out = []
    for argv in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        out.append((rc, buf.getvalue()))
    return out


def _intervals(results):
    return {
        k: ([(p.label, round(p.begin, 6), round(p.end, 6)) for p in a.phones],
            [(w.label, round(w.begin, 6), round(w.end, 6)) for w in a.words],
            a.log_likelihood)
        for k, a in results.items()
    }


def _write_dict(path):
    from test_training import WORD_PHONES

    path.write_text("".join(f"{w}\t{' '.join(p)}\n" for w, p in WORD_PHONES.items()))
    return path


@pytest.fixture(scope="module")
def train_corpus(tmp_path_factory):
    from test_training import make_training_corpus

    tmp = tmp_path_factory.mktemp("dist_train")
    corpus_dir, _truths = make_training_corpus(tmp, n_utts=10)
    return corpus_dir, _write_dict(tmp / "train.dict")


@pytest.fixture(scope="module")
def trained(train_corpus):
    """The port's single run and its W = 2 run of the JAX test's recipe."""
    corpus_dir, dict_path = train_corpus
    single = _summary(*_train_port(corpus_dir, dict_path))
    ranks = run_ranks(_train_rank, 2, args=(str(corpus_dir), str(dict_path)),
                      timeout=RANK_TIMEOUT, threads=2)
    return single, [r["dist"] for r in ranks]


def _at_bars(got, want):
    assert got["num_pdfs"] == want["num_pdfs"]
    assert list(got["logs"]) == list(want["logs"])
    for stage in want["logs"]:
        (ll_g, n_g), (ll_w, n_w) = zip(*got["logs"][stage]), zip(*want["logs"][stage])
        assert list(n_g) == list(n_w), stage
        np.testing.assert_allclose(ll_g, ll_w, atol=2e-3)
    np.testing.assert_allclose(got["log_probs"], want["log_probs"], atol=1e-4)


def test_training_two_ranks_matches_single_run(trained):
    single, (r0, r1) = trained
    # each rank trained on its own speaker, and both hold the same model
    assert r0["utterances"] + r1["utterances"] == single["utterances"]
    assert 0 < r0["utterances"] < single["utterances"]
    for a, b in zip(r0["arrays"], r1["arrays"]):
        assert np.array_equal(a, b)
    assert r0["logs"] == r1["logs"]
    _at_bars(r0, single)


def test_training_two_ranks_matches_jax(trained, train_corpus):
    from montreal_forced_aligner_tpu.training.base import TrainerConfig
    from montreal_forced_aligner_tpu.training.trainer import (
        StageConfig,
        TrainableAligner,
    )

    corpus_dir, dict_path = train_corpus
    ta = TrainableAligner(
        corpus_dir, dict_path, recipe=_stage_configs(StageConfig),
        base_config=TrainerConfig(boost_silence=1.0), batch_size=4,
        variable_length_topology=False, distributed=False,
    )
    want = _summary(ta, ta.train())
    _at_bars(trained[1][0], want)


def test_training_one_rank_bit_identical(train_corpus):
    corpus_dir, dict_path = train_corpus
    (out,) = run_ranks(_train_rank, 1, args=(str(corpus_dir), str(dict_path)),
                       timeout=RANK_TIMEOUT, threads=2)
    got, want = out["dist"], out["plain"]
    assert got["logs"] == want["logs"]
    assert np.array_equal(got["log_probs"], want["log_probs"])
    for a, b in zip(got["arrays"], want["arrays"]):
        assert np.array_equal(a, b)


def test_training_mesh_argument_runs(train_corpus):
    """``TrainableAligner(mesh=...)`` and ``TrainingPipeline(mesh=...)`` on
    one process: a mesh of one device, the plain run's model bit for bit;
    a mesh of two local devices raises (one device a rank)."""
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon
    from montreal_forced_aligner_tpu_torch.parallel.mesh import get_mesh
    from montreal_forced_aligner_tpu_torch.training.base import TrainingPipeline

    corpus_dir, dict_path = train_corpus
    ta, model = _train_port(corpus_dir, dict_path, mesh=get_mesh(device="cpu"))
    assert ta.pipeline.mesh is not None
    _ta, plain = _train_port(corpus_dir, dict_path)
    for a, b in zip(_summary(ta, model)["arrays"], _summary(_ta, plain)["arrays"]):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="one device per rank"):
        TrainingPipeline(Corpus.load(corpus_dir), Lexicon.load(dict_path),
                         mesh=get_mesh(("cpu", "cpu")), device="cpu")


@pytest.fixture(scope="module")
def sat2(tmp_path_factory):
    """A reduced SAT-scale model and 6 utterances over 2 speakers."""
    import chip_smoke

    tmp = tmp_path_factory.mktemp("dist_sat")
    model_path, dict_path, words = chip_smoke.build_sat_scale_model(
        tmp, num_phones=6, gauss_per_pdf=4, num_words=20)
    corpus_dir, _ = chip_smoke.build_corpus(tmp, words, 6, min_s=2.5, max_s=5.0,
                                            num_speakers=2)
    return str(model_path), str(dict_path), str(corpus_dir)


@pytest.fixture(scope="module")
def mono(tmp_path_factory):
    from helpers import build_synthetic_corpus, build_synthetic_model

    tmp = tmp_path_factory.mktemp("dist_mono")
    model_path, dict_path = build_synthetic_model(tmp)
    corpus_dir, _ = build_synthetic_corpus(tmp)
    return str(model_path), str(dict_path), str(corpus_dir)


def _align_single(model_path, dict_path, corpus_dir, **cfg):
    from montreal_forced_aligner_tpu_torch.align.aligner import (
        AlignerConfig,
        PretrainedAligner,
    )
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus

    al = PretrainedAligner(model_path, dict_path, AlignerConfig(**cfg), device="cpu")
    return _intervals(al.align_corpus(Corpus.load(corpus_dir)))


def test_aligner_two_ranks(sat2, mono):
    """SI on the SAT model and on the one-utterance corpus (one rank has no
    utterance: it still takes part), and the SAT two-pass."""
    jobs = [(*sat2, dict(batch_size=2, uses_speaker_adaptation=False)),
            (*mono, dict(batch_size=4)),
            (*sat2, dict(batch_size=2))]
    ranks = run_ranks(_align_rank, 2, args=(jobs,), timeout=RANK_TIMEOUT, threads=2)
    whole = _align_single(*jobs[0][:3], **jobs[0][3])
    for r in ranks:
        assert {i: v[:2] for i, v in r[-1].items()} == \
            {i: v[:2] for i, v in whole.items()}
        for i in whole:
            assert abs(r[-1][i][2] - whole[i][2]) <= 1e-5 * abs(whole[i][2]) + 1e-3
    for j, (m, d, c, cfg) in enumerate(jobs):
        want = _align_single(m, d, c, **cfg)
        (got0, shard0), (got1, shard1) = ranks[0][j], ranks[1][j]
        assert got0 == got1  # every rank returns every utterance
        assert sorted(shard0 + shard1) == sorted(want)
        if cfg.get("uses_speaker_adaptation", True) and j == 2:
            for i in want:
                (pa, _wa, _sa), (pb, _wb, _sb) = got0[i], want[i]
                assert [p[0] for p in pa] == [p[0] for p in pb]
                drift = [max(abs(x[1] - y[1]), abs(x[2] - y[2]))
                         for x, y in zip(pa, pb)]
                assert max(drift) <= 0.011, drift
            continue
        assert {i: v[:2] for i, v in got0.items()} == \
            {i: v[:2] for i, v in want.items()}
        for i in want:
            # per-speaker CMVN sums group the utterances into other batches
            assert abs(got0[i][2] - want[i][2]) <= 1e-5 * abs(want[i][2]) + 1e-3


@pytest.fixture(scope="module")
def pitch_mono(train_corpus, tmp_path_factory):
    """A monophone pitch model trained by the port (8 iterations) on the
    tone corpus of 10 utterances over 2 speakers."""
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus
    from montreal_forced_aligner_tpu_torch.dictionary.lexicon import Lexicon
    from montreal_forced_aligner_tpu_torch.training.base import (
        TrainerConfig,
        TrainingPipeline,
    )
    from montreal_forced_aligner_tpu_torch.training.monophone import MonophoneTrainer

    corpus_dir, dict_path = train_corpus
    lexicon = Lexicon.load(dict_path, position_dependent=False)
    pipeline = TrainingPipeline(Corpus.load(corpus_dir), lexicon, batch_size=4,
                                use_pitch=True, device="cpu")
    pipeline.prepare_features()
    model = MonophoneTrainer(
        lexicon, TrainerConfig(num_iterations=8, max_gaussians=40, boost_silence=1.0),
        variable_length_topology=False,
    ).train(pipeline)
    path = tmp_path_factory.mktemp("dist_pitch") / "mono_pitch.zip"
    model.save(path)
    return str(path), str(dict_path), str(corpus_dir)


def test_aligner_two_ranks_pitch(pitch_mono):
    """A pitch model at W = 2: each rank batches its own speaker's
    utterances, and the union of the ranks' intervals is the single
    run's."""
    job = (*pitch_mono, dict(batch_size=4))
    ranks = run_ranks(_align_rank, 2, args=([job],), timeout=RANK_TIMEOUT, threads=2)
    want = _align_single(*job[:3], **job[3])
    (got0, shard0), (got1, shard1) = ranks[0][0], ranks[1][0]
    assert got0 == got1  # every rank returns every utterance
    assert shard0 and shard1 and sorted(shard0 + shard1) == sorted(want)
    assert {i: v[:2] for i, v in got0.items()} == {i: v[:2] for i, v in want.items()}
    for i in want:
        assert abs(got0[i][2] - want[i][2]) <= 1e-5 * abs(want[i][2]) + 1e-3


def test_aligner_devices_round_robin(sat2):
    """``devices=("cpu", "cpu")``: batches alternate between the devices and
    the results are the single device's."""
    for cfg in (dict(batch_size=2), dict(batch_size=2, uses_speaker_adaptation=False)):
        want = _align_single(*sat2, **cfg)
        got = _align_single(*sat2, devices=("cpu", "cpu"), **cfg)
        assert got == want


def test_aligner_per_device_copies_leave_its_own(sat2):
    """A batch on another device gets a copy of the model tensors: the
    aligner's own stay on its first device (``Module.to`` moves in place).
    The meta device stands in for a second card."""
    from montreal_forced_aligner_tpu_torch.align.aligner import PretrainedAligner

    model_path, dict_path, _corpus = sat2
    al = PretrainedAligner(model_path, dict_path, device="cpu")
    other = torch.device("meta")
    for name in ("gmm", "si_gmm", "fmllr"):
        own = getattr(al, name)
        copy = al._on(name, other)
        assert copy is not own and al._on(name, other) is copy
        assert all(t.device.type == "meta" for t in copy.buffers())
        assert all(t.device.type == "cpu" for t in own.buffers())
        assert al._on(name, al.device) is own


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_align_under_torchrun(sat2, tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    montreal_forced_aligner_tpu_torch.cli align ... --distributed``: each
    rank exports its speakers' files; the union is the single run's."""
    from montreal_forced_aligner_tpu_torch.cli import main

    model_path, dict_path, corpus_dir = sat2
    want_dir, got_dir = tmp_path / "single", tmp_path / "ranks"
    assert main(["align", corpus_dir, dict_path, model_path, str(want_dir),
                 "--device", "cpu", "--single_speaker", "--batch_size", "2"]) == 0
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    logs = tmp_path / "logs"  # a file a rank: ranks on one pipe interleave
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_addr", "localhost", "--master_port", str(_free_port()),
           "--log-dir", str(logs), "--redirects", "3",
           "-m", "montreal_forced_aligner_tpu_torch.cli", "align", corpus_dir,
           dict_path, model_path, str(got_dir), "--device", "cpu",
           "--single_speaker", "--batch_size", "2", "--distributed"]
    # the launcher and its ranks in one session, killed whole at the timeout
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout_, stderr_ = proc.communicate(timeout=RANK_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    out = subprocess.CompletedProcess(cmd, proc.returncode, stdout_, stderr_)
    stdout = "".join(f.read_text() for f in sorted(logs.rglob("stdout.log")))
    assert out.returncode == 0, out.stderr + "".join(
        f.read_text() for f in logs.rglob("stderr.log"))
    summaries = [json.loads(line.split(" ", 1)[1]) for line in stdout.splitlines()
                 if line.startswith("rank_summary ")]
    assert sorted(s["rank"] for s in summaries) == [0, 1]
    assert sum(s["utterances"] for s in summaries) == 6
    want = {p.relative_to(want_dir): p.read_text() for p in want_dir.rglob("*.TextGrid")}
    got = {p.relative_to(got_dir): p.read_text() for p in got_dir.rglob("*.TextGrid")}
    assert got == want
    assert (got_dir / "alignment_analysis.csv").read_text() == \
        (want_dir / "alignment_analysis.csv").read_text()


def test_cli_train_validate_transcribe_two_ranks(train_corpus, sat2, tmp_path):
    """``train``, ``validate --test_transcriptions`` and ``transcribe`` with
    ``--distributed`` on 2 ranks: rank 0 writes the model (the same as a
    single run of the recipe at the bars), each rank decodes its own
    speakers, and the reduced WER covers the corpus."""
    corpus_dir, dict_path = train_corpus
    model_path, sat_dict, sat_corpus = sat2
    cfg = tmp_path / "recipe.yaml"
    cfg.write_text("training:\n  - monophone:\n      num_iterations: 3\n"
                   "      max_gaussians: 30\n")
    out_model, trans_dir = tmp_path / "model.zip", tmp_path / "trans"
    runs = [
        ["train", str(corpus_dir), str(dict_path), str(out_model), "--device", "cpu",
         "--config_path", str(cfg), "--batch_size", "4", "--chain_topology",
         "--distributed", "--working_directory", str(tmp_path / "wd"), "--clean"],
        ["validate", sat_corpus, sat_dict, "--acoustic_model_path", model_path,
         "--test_transcriptions", "--device", "cpu", "--distributed"],
        ["transcribe", sat_corpus, sat_dict, model_path, str(trans_dir),
         "--device", "cpu", "--distributed", "--batch_size", "2", "--evaluate",
         "--output_type", "alignment"],
    ]
    ranks = run_ranks(_cli_rank, 2, args=(runs,), timeout=RANK_TIMEOUT, threads=2)
    for r in ranks:
        assert [rc for rc, _ in r] == [0, 0, 0], r
    from montreal_forced_aligner_tpu_torch.models.acoustic_model import AcousticModel

    assert out_model.exists() and AcousticModel.load(out_model).gmm.num_pdfs > 0
    assert "Saved model" in ranks[0][0][1] and "Saved model" not in ranks[1][0][1]
    decoded = [int(r[1][1].split("decoding ")[1].split()[0]) for r in ranks]
    assert sum(decoded) == 6 and all(n > 0 for n in decoded)
    assert all("Transcription check (all ranks)" in r[1][1] for r in ranks)
    assert all("over 6 utterances" in r[1][1].split("(all ranks)")[1] for r in ranks)
    assert len(list(trans_dir.rglob("*.lab"))) == 6
    # --output_type alignment: each rank aligned and exported its own files
    assert len(list(trans_dir.rglob("*.TextGrid"))) == 6
    assert all("WER (all ranks)" in r[2][1] for r in ranks)


def test_dryrun_two_ranks(tmp_path):
    from montreal_forced_aligner_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(2, device="cpu", timeout=RANK_TIMEOUT, threads=2,
                           workdir=str(tmp_path))
    assert [r["rank"] for r in out] == [0, 1]
    assert all(r["aligned"] == 4 and r["num_pdfs"] > 0 for r in out)
    assert all(0 < r["utterances"] < 4 for r in out)
