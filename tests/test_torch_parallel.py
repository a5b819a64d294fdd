"""The port's multi-GPU layer (``parallel/*``) against the JAX package's, on
the CPU: ranks are processes spawned by ``parallel.multihost.run_ranks``
over gloo (a ``file://`` store, no port), each with a hard timeout that
kills every rank.

Tolerances: the corpus and speaker shards equal the JAX functions'; the
host collectives exact; ``make_sharded_accumulate_step`` at W = 2 against
the JAX package's on its 8-device CPU mesh (the same global batch): state
paths identical, scores within 1e-3, statistics within 1e-5 of each
tensor's largest magnitude; ``make_sharded_fmllr_stats_step`` likewise
(K, G, beta within 1e-5 of each tensor's largest magnitude); at W = 1 both
steps bit-identical to the port's non-distributed statistics; every rank
holds the same bits. The scaling report has the JAX report's keys, and its
occupancy per rank is the same at W = 1 and 2 (1e-6 relative).
"""

import numpy as np
import pytest
import torch

from montreal_forced_aligner_tpu_torch.parallel import multihost as PMH
from montreal_forced_aligner_tpu_torch.parallel.multihost import run_ranks

# a multi-process test's hard limit (every rank is killed past it)
RANK_TIMEOUT = 180.0

WORKLOAD = dict(num_frames=40, num_states=24, num_pdfs=16, num_gauss=2,
                feat_dim=8)
GLOBAL_BATCH = 8  # divides over the JAX package's 8 CPU devices


def _fmllr_inputs(seed=7, B=GLOBAL_BATCH, T=30, D=6, P=10, G=3, S=3):
    rng = np.random.RandomState(seed)
    means = rng.randn(P, G, D).astype(np.float32)
    inv_vars = (0.5 + rng.rand(P, G, D)).astype(np.float32)
    weights = rng.dirichlet(np.ones(G), size=P).astype(np.float32)
    gconsts = (np.log(weights) - 0.5 * (
        D * np.log(2 * np.pi) - np.log(inv_vars).sum(-1)
        + (means * means * inv_vars).sum(-1))).astype(np.float32)
    lens = rng.randint(T // 2, T + 1, B).astype(np.int32)
    return dict(
        feats=rng.randn(B, T, D).astype(np.float32),
        frame_lengths=lens,
        frame_pdf=rng.randint(0, P, (B, T)).astype(np.int32),
        speaker_idx=rng.randint(0, S, B).astype(np.int32),
        frame_weight=(rng.rand(B, T) > 0.2).astype(np.float32),
        means=means, inv_vars=inv_vars, gconsts=gconsts,
        miv=(means * inv_vars).astype(np.float32), num_speakers=S,
    )


_BATCH_KEYS = ("feats", "frame_lengths", "frame_pdf", "speaker_idx",
               "frame_weight")
_MODEL_KEYS = ("means", "inv_vars", "gconsts", "miv")


def _steps_rank(rank, world):
    """One rank: the collectives, then both sharded steps on its rows."""
    from montreal_forced_aligner_tpu_torch.ops.transforms import (
        accumulate_fmllr_stats,
    )
    from montreal_forced_aligner_tpu_torch.parallel.data_parallel import (
        _align_and_accumulate,
        make_sharded_accumulate_step,
        make_sharded_fmllr_stats_step,
        ordered_allreduce,
    )
    from montreal_forced_aligner_tpu_torch.parallel.mesh import (
        get_mesh,
        replicated,
        shard_leading_axis,
    )
    from montreal_forced_aligner_tpu_torch.parallel.scaling import build_workload

    out = {}
    if world > 1:
        out["allgather"] = PMH.host_allgather(np.arange(3) + 10 * rank)
        out["sum"] = PMH.host_allreduce_sum(np.array([0.1, 1e16]) * (rank + 1))
        out["max"] = PMH.host_allreduce_max(7 - rank)
        out["ragged"] = PMH.allgather_ragged_rows(
            np.arange(3 * (rank + 1)).reshape(-1, 3))
        out["objects"] = PMH.host_allgather_object({"rank": rank, "s": "x" * rank})
        PMH.host_barrier("test")
        parts = ([1.0e8, 3.0, 7], [1.0, 4.5, -2])[rank]
        out["ordered"] = [t.numpy() for t in ordered_allreduce([
            torch.tensor(parts[:2], dtype=torch.float32),
            torch.tensor(parts[2:], dtype=torch.int64)])]
    mesh = get_mesh(device="cpu")
    feats, lens, graph, miv, iv, gconst = build_workload(GLOBAL_BATCH, **WORKLOAD)
    x, fl, g = shard_leading_axis(mesh, (feats, lens, graph))
    model = replicated(mesh, (miv, iv, gconst))
    got = make_sharded_accumulate_step(mesh)(x, fl, g, *model)
    out["acc"] = [t.numpy() for t in got]
    fm = _fmllr_inputs()
    batch = shard_leading_axis(mesh, tuple(torch.from_numpy(fm[k])
                                           for k in _BATCH_KEYS))
    params = replicated(mesh, tuple(fm[k] for k in _MODEL_KEYS))
    step = make_sharded_fmllr_stats_step(mesh)(fm["num_speakers"])
    out["fmllr"] = [t.numpy() for t in step(*batch, *params)]
    if world == 1:
        plain = _align_and_accumulate(x, fl, g, *model, 0.1, reduce=False)
        out["acc_bitwise"] = all(torch.equal(a, b) for a, b in zip(got, plain))
        ref = accumulate_fmllr_stats(*batch, *params, fm["num_speakers"])
        out["fmllr_bitwise"] = all(
            np.array_equal(a, b.numpy()) for a, b in zip(out["fmllr"], ref))
    return out


@pytest.fixture(scope="module")
def two_ranks():
    return run_ranks(_steps_rank, 2, timeout=RANK_TIMEOUT, threads=1)


def _close_to_scale(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale


def _corpus_pair(seed, multi_speaker_files):
    """The same seeded corpus in both packages' ``Corpus`` classes (no
    audio: sharding reads speakers and files only)."""
    from montreal_forced_aligner_tpu.corpus.corpus import Corpus as JCorpus
    from montreal_forced_aligner_tpu.corpus.corpus import Utterance as JUtt
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Corpus as PCorpus
    from montreal_forced_aligner_tpu_torch.corpus.corpus import Utterance as PUtt

    rng = np.random.RandomState(seed)
    rows = []
    for i in range(40):
        spk = f"s{rng.randint(9)}"
        if multi_speaker_files and rng.rand() < 0.3:
            path = f"/c/shared{rng.randint(4)}.wav"  # several speakers a file
        else:
            path = f"/c/{spk}/u{i}.wav"
        rows.append((i, spk, path))
    out = []
    for C, U in ((JCorpus, JUtt), (PCorpus, PUtt)):
        utts = [U(id=i, speaker=s, file_path=p, file_name=p, begin=0.0,
                  end=None, channel=0, text="a") for i, s, p in rows]
        out.append(C(utterances=utts, speakers=sorted({r[1] for r in rows})))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("world", [1, 2, 3, 5])
def test_shard_speakers_matches_jax(seed, world):
    from montreal_forced_aligner_tpu.parallel import multihost as JMH

    rng = np.random.RandomState(seed)
    counts = {f"spk{i}": int(rng.randint(1, 30)) for i in range(11)}
    for r in range(world):
        assert PMH.shard_speakers_for_host(counts, r, world) == \
            JMH.shard_speakers_for_host(counts, r, world)


@pytest.mark.parametrize("multi_speaker_files", [False, True])
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_shard_corpus_matches_jax(multi_speaker_files, world):
    from montreal_forced_aligner_tpu.parallel import multihost as JMH

    jc, pc = _corpus_pair(world + 10 * multi_speaker_files, multi_speaker_files)
    owned = []
    for r in range(world):
        got = PMH.shard_corpus_for_host(pc, r, world)
        assert got == JMH.shard_corpus_for_host(jc, r, world)
        owned += got
    # a partition, and no file split over ranks
    assert sorted(owned) == list(range(pc.num_utterances))
    owner = {}
    for r in range(world):
        for i in PMH.shard_corpus_for_host(pc, r, world):
            owner.setdefault(pc.utterances[i].file_path, set()).add(r)
    assert all(len(v) == 1 for v in owner.values())


def test_host_collectives_two_ranks(two_ranks):
    for out in two_ranks:
        assert [a.tolist() for a in out["allgather"]] == [[0, 1, 2], [10, 11, 12]]
        assert out["sum"].dtype == np.float64
        assert out["sum"].tolist() == [0.1 + 0.2, 1e16 + 2e16]
        assert out["max"] == 7
        assert [r.tolist() for r in out["ragged"]] == [
            [[0, 1, 2]], [[0, 1, 2], [3, 4, 5]]]
        assert out["objects"] == [{"rank": 0, "s": ""}, {"rank": 1, "s": "x"}]
        f32, i64 = out["ordered"]
        assert f32.dtype == np.float32 and i64.dtype == np.int64
        assert f32.tolist() == [np.float32(1e8) + np.float32(1.0), 7.5]
        assert i64.tolist() == [5]
    a, b = two_ranks
    for x, y in zip(a["acc"][2:] + a["fmllr"], b["acc"][2:] + b["fmllr"]):
        assert np.array_equal(x, y)  # every rank holds the same bits


def test_accumulate_step_two_ranks_matches_jax_mesh(two_ranks):
    import jax
    from jax.sharding import Mesh

    from montreal_forced_aligner_tpu.parallel.data_parallel import (
        make_sharded_accumulate_step as jstep,
    )
    from montreal_forced_aligner_tpu.parallel.scaling import build_workload as jbuild

    assert len(jax.devices()) == 8
    mesh = Mesh(np.array(jax.devices()), ("data",))
    want = [np.asarray(x) for x in jstep(mesh)(*jbuild(GLOBAL_BATCH, **WORKLOAD))]
    paths = np.concatenate([r["acc"][0] for r in two_ranks])
    scores = np.concatenate([r["acc"][1] for r in two_ranks])
    assert np.array_equal(paths, want[0])
    np.testing.assert_allclose(scores, want[1], atol=1e-3)
    for got, ref in zip(two_ranks[0]["acc"][2:], want[2:]):
        _close_to_scale(got, ref)


def test_fmllr_stats_step_two_ranks_matches_jax_mesh(two_ranks):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from montreal_forced_aligner_tpu.parallel.data_parallel import (
        make_sharded_fmllr_stats_step as jstep,
    )

    mesh = Mesh(np.array(jax.devices()), ("data",))
    fm = _fmllr_inputs()
    want = jstep(mesh)(fm["num_speakers"])(
        *(jnp.asarray(fm[k]) for k in _BATCH_KEYS + _MODEL_KEYS))
    for got, ref in zip(two_ranks[0]["fmllr"], want):
        _close_to_scale(got, np.asarray(ref))


def test_steps_one_rank_bit_identical_to_plain():
    (out,) = run_ranks(_steps_rank, 1, timeout=RANK_TIMEOUT, threads=1)
    assert out["acc_bitwise"] and out["fmllr_bitwise"]


def test_fmllr_estimate_on_a_rank_equals_the_reduced_one():
    """A rank holds its speakers whole, so it estimates their transforms
    from its own statistics: bit for bit what an estimate over the
    statistics reduced into one speaker space over the ranks (this rank's
    sums plus the other ranks' zeros) gives its speakers."""
    from montreal_forced_aligner_tpu_torch.ops.transforms import (
        accumulate_fmllr_stats,
        estimate_speaker_fmllr,
    )

    fm = _fmllr_inputs(S=4)
    S = fm["num_speakers"]
    model = [torch.from_numpy(fm[k]) for k in _MODEL_KEYS]
    for speakers in ([0, 1], [2, 3]):  # one rank's speakers
        rows = np.isin(fm["speaker_idx"], speakers)
        local = np.searchsorted(speakers, fm["speaker_idx"][rows]).astype(np.int32)
        batch = [torch.from_numpy(fm[k][rows]) for k in _BATCH_KEYS]
        batch[3] = torch.from_numpy(local)
        K, G, beta = (t.numpy().astype(np.float64) for t in accumulate_fmllr_stats(
            *batch, *model, len(speakers)))
        mine = estimate_speaker_fmllr(K, G, beta, min_count=1.0)
        full = [np.zeros((S,) + a.shape[1:]) for a in (K, G, beta)]
        for f, a in zip(full, (K, G, beta)):
            f[speakers] = a
        reduced = estimate_speaker_fmllr(*full, min_count=1.0)
        assert (beta >= 1.0).all()
        assert np.array_equal(mine, reduced[speakers])


def test_scaling_report_structure_and_statistics():
    from montreal_forced_aligner_tpu_torch.parallel.scaling import measure_scaling

    rep = measure_scaling([1, 2], per_device_batch=2, repeats=2, warmup=1,
                          device="cpu", timeout=RANK_TIMEOUT, threads=1,
                          num_frames=30, workload_kwargs=dict(
                              num_states=12, num_pdfs=8, num_gauss=2,
                              feat_dim=6))
    for key in ("mesh_overhead_1dev_pct", "stat_check_ok", "metric", "platform",
                "host_cpus", "per_device_batch", "num_frames", "rows", "note"):
        assert key in rep
    assert rep["metric"] == "weak_scaling_efficiency"
    assert rep["platform"] == "cpu" and rep["shared_device"] is True
    assert rep["backend"] == "gloo" and rep["stat_check_ok"] is True
    assert [r["devices"] for r in rep["rows"]] == [1, 2]
    assert [r["global_batch"] for r in rep["rows"]] == [2, 4]
    assert rep["rows"][0]["weak_efficiency"] == 1.0
    occ = [r["occ_per_replica"] for r in rep["rows"]]
    assert abs(occ[1] - occ[0]) <= 1e-6 * occ[0]
    for r in rep["rows"]:
        assert r["min_step_s"] > 0 and len(r["all_times_s"]) == 2
    assert np.isfinite(rep["mesh_overhead_1dev_pct"])


def test_backend_and_layout_rules(monkeypatch):
    """The backend is chosen, never guessed: NCCL only for CUDA devices, and
    a rank without a card of its own under NCCL raises."""
    from montreal_forced_aligner_tpu_torch.parallel.mesh import Mesh, get_mesh

    monkeypatch.delenv(PMH.BACKEND_ENV, raising=False)
    assert PMH.resolve_backend(None, "cpu") == "gloo"
    assert PMH.resolve_backend(None, "cuda") == "nccl"
    monkeypatch.setenv(PMH.BACKEND_ENV, "gloo")
    assert PMH.resolve_backend(None, "cuda") == "gloo"
    with pytest.raises(ValueError):
        PMH.resolve_backend("nccl", "cpu")
    with pytest.raises(ValueError):
        PMH.resolve_backend("mpi", "cpu")
    assert PMH.initialize_multihost() == (0, 1)  # no launcher, no group
    mesh = get_mesh(device="cpu")
    assert mesh == Mesh((torch.device("cpu"),)) and mesh.world_size == 1
    assert get_mesh(("cpu", "cpu")).devices == (torch.device("cpu"),) * 2
