"""Per-speaker CMVN and fMLLR statistics do not depend on the batching, on
the CPU.

The same 11 utterances of 4 speakers (1, 2, 3 and 5 utterances, 7 to 90
frames) go through ``ops.feats.frame_sums`` and
``ops.transforms.utterance_fmllr_stats`` in batches of 1, 2, 3 and 8 that
are consecutive slices of the corpus order, each batch's rows shuffled and
padded to another length T (junk in the padded frames). Each utterance's
float64 statistics must equal its statistics at one utterance a batch bit
for bit, and so must each speaker's float64 totals (``add_to_speakers``,
one utterance at a time in corpus order; ``accumulate_fmllr_stats`` with
``totals``). No op needs a looser bar. The totals stay within rtol 1e-4
of each tensor's largest magnitude of the JAX package's
``accumulate_fmllr_stats`` and ``accumulate_cmvn_stats`` over all
utterances in one batch (float32 sums in another order there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import montreal_forced_aligner_tpu.ops.feats as JF
import montreal_forced_aligner_tpu.ops.transforms as JT
import montreal_forced_aligner_tpu_torch.ops.feats as PF
import montreal_forced_aligner_tpu_torch.ops.transforms as PT

from torch_port_inputs import gmm_arrays

D, P, NG = 13, 20, 4
SPEAKERS = np.array([3, 0, 3, 1, 2, 3, 1, 3, 2, 2, 3])  # 1, 2, 3 and 5 utterances
LENGTHS = np.array([7, 90, 33, 61, 12, 45, 90, 28, 71, 9, 52])
BATCH_SIZES = (1, 2, 3, 8)


def _close_to_scale(got, want, rtol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


@pytest.fixture(scope="module")
def corpus():
    """Each utterance's frames, aligned pdfs and weights, and the model."""
    rng = np.random.RandomState(13)
    utts = []
    for n in LENGTHS:
        utts.append(dict(
            feats=(rng.randn(n, D) * 2 + rng.randn(D) * 5).astype(np.float32),
            pdf=rng.randint(0, P, n).astype(np.int64),
            weight=(rng.rand(n) > 0.25).astype(np.float32),
        ))
    miv, inv_vars, gconsts = gmm_arrays(13, P, NG, D, padded_pdfs=(2,))
    means = (miv / inv_vars).astype(np.float32)
    model = [torch.from_numpy(a) for a in (means, inv_vars, gconsts, miv)]
    return utts, model


def _batches(utts, batch_size, seed):
    """Consecutive slices of the corpus order, each batch's rows shuffled
    and padded past its longest utterance by a batch-dependent margin, the
    padded frames holding junk: (utterance ids by row, feats, lengths,
    pdfs, weights) per batch."""
    rng = np.random.RandomState(seed)
    out = []
    for lo in range(0, len(utts), batch_size):
        ids = rng.permutation(np.arange(lo, min(len(utts), lo + batch_size)))
        T = int(LENGTHS[ids].max()) + int(rng.randint(0, 40))
        feats = np.full((len(ids), T, D), 1e3, np.float32)
        pdf = rng.randint(0, P, (len(ids), T)).astype(np.int64)
        weight = np.ones((len(ids), T), np.float32)
        for r, i in enumerate(ids):
            n = LENGTHS[i]
            feats[r, :n] = utts[i]["feats"]
            pdf[r, :n] = utts[i]["pdf"]
            weight[r, :n] = utts[i]["weight"]
        out.append((ids, torch.from_numpy(feats), LENGTHS[ids].astype(np.int32),
                    torch.from_numpy(pdf), torch.from_numpy(weight)))
    return out


def _per_utterance(utts, model, batch_size, stat):
    """Each utterance's statistics (float64 numpy arrays) by utterance id,
    and each speaker's totals, batched at ``batch_size``."""
    rows = {}
    S = int(SPEAKERS.max()) + 1
    totals = None
    for ids, feats, flens, pdf, weight in _batches(utts, batch_size, batch_size):
        if stat == "cmvn":
            got = (PF.frame_sums(feats, torch.from_numpy(flens)),)
        else:
            got = PT.utterance_fmllr_stats(feats, flens, pdf, weight, *model)
        assert all(g.dtype == torch.float64 for g in got)
        if totals is None:
            totals = [torch.zeros((S,) + g.shape[1:], dtype=torch.float64)
                      for g in got]
        for r, i in enumerate(ids):
            rows[int(i)] = [g[r].numpy() for g in got]
        # the speakers' totals take the batch's utterances in corpus order
        back = np.argsort(ids)
        for total, g in zip(totals, got):
            PF.add_to_speakers(total, g[torch.from_numpy(back)], SPEAKERS[ids[back]])
    return rows, [t.numpy() for t in totals]


@pytest.fixture(scope="module")
def alone(corpus):
    utts, model = corpus
    return {stat: _per_utterance(utts, model, 1, stat) for stat in ("cmvn", "fmllr")}


@pytest.mark.parametrize("stat", ["cmvn", "fmllr"])
@pytest.mark.parametrize("batch_size", BATCH_SIZES)
def test_statistics_do_not_depend_on_the_batch(corpus, alone, stat, batch_size):
    utts, model = corpus
    rows, totals = _per_utterance(utts, model, batch_size, stat)
    want_rows, want_totals = alone[stat]
    assert sorted(rows) == sorted(want_rows) == list(range(len(utts)))
    for i, want in want_rows.items():
        for g, w in zip(rows[i], want):
            assert np.array_equal(g, w), (i, np.abs(g - w).max())
    for g, w in zip(totals, want_totals):
        assert np.array_equal(g, w), np.abs(g - w).max()
    # every utterance has statistics
    assert all(np.abs(r[0]).max() > 0 for r in want_rows.values())


@pytest.mark.parametrize("batch_size", BATCH_SIZES[1:])
def test_fmllr_totals_in_corpus_order(corpus, batch_size, monkeypatch):
    """``accumulate_fmllr_stats`` over unshuffled consecutive batches, its
    ``totals`` carried from batch to batch, with small frame blocks (many
    gathered chunks and G products an utterance): the speakers' totals of
    one utterance a batch at the same blocks, bit for bit."""
    monkeypatch.setattr(PT, "_GATHER_CHUNK_BYTES", 5 * NG * D * 4)
    monkeypatch.setattr(PT, "_G_CHUNK_BYTES", 7 * D * (D + 1) * 8)
    utts, model = corpus
    S = int(SPEAKERS.max()) + 1
    runs = []
    for bs in (1, batch_size):
        totals = PT.zero_fmllr_totals(S, D, "cpu")
        for ids, feats, flens, pdf, weight in _batches(utts, bs, 0):
            order = np.argsort(ids)
            got = PT.accumulate_fmllr_stats(
                feats[order], flens[order], pdf[order], SPEAKERS[ids[order]],
                weight[order], *model, S, totals=totals)
            assert got[0] is totals[0]
        runs.append(totals)
    for g, w in zip(*runs):
        assert np.array_equal(g.numpy(), w.numpy()), (g - w).abs().max()


def _one_batch(utts):
    (ids, feats, flens, pdf, weight), = _batches(utts, len(utts), 1)
    order = np.argsort(ids)
    return (feats[order].numpy(), flens[order], pdf[order].numpy(),
            weight[order].numpy())


def test_fmllr_totals_match_jax(corpus, alone):
    utts, model = corpus
    feats, flens, pdf, weight = _one_batch(utts)
    feats = np.where(np.arange(feats.shape[1])[None, :, None] < flens[:, None, None],
                     feats, 0.0).astype(np.float32)
    want = JT.accumulate_fmllr_stats(
        jnp.asarray(feats), jnp.asarray(flens), jnp.asarray(pdf.astype(np.int32)),
        jnp.asarray(SPEAKERS.astype(np.int32)), jnp.asarray(weight),
        *(jnp.asarray(m.numpy()) for m in model), int(SPEAKERS.max()) + 1)
    for g, w in zip(alone["fmllr"][1], want):
        _close_to_scale(g, np.asarray(w))


def test_cmvn_totals_match_jax(corpus, alone):
    utts, _model = corpus
    feats, flens, _pdf, _w = _one_batch(utts)
    S = int(SPEAKERS.max()) + 1
    # the JAX function's body, run eagerly (its speaker count is static)
    want = JF.accumulate_cmvn_stats.__wrapped__(
        jnp.asarray(feats), jnp.asarray(flens), jnp.asarray(SPEAKERS.astype(np.int32)),
        S)
    got = PF.accumulate_cmvn_stats(torch.from_numpy(feats), torch.from_numpy(flens),
                                   torch.from_numpy(SPEAKERS), S)
    assert all(g.dtype == torch.float64 for g in got)
    assert np.array_equal(got[0].numpy(), alone["cmvn"][1][0])
    for g, w in zip(got, want):
        _close_to_scale(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(got[2].numpy(), np.bincount(SPEAKERS, LENGTHS))


@pytest.mark.parametrize("extra", [0, 1, 37, 300])
def test_frame_sums_ignore_padding(extra):
    """A row's sums at any padded length, with junk in the padded frames,
    bit for bit its sums unpadded."""
    rng = np.random.RandomState(extra)
    x = (rng.randn(3, 50, 4) * 10).astype(np.float32)
    flens = np.array([50, 1, 23], np.int32)
    want = PF.frame_sums(torch.from_numpy(x), torch.from_numpy(flens)).numpy()
    padded = np.concatenate([x, np.full((3, extra, 4), np.inf, np.float32)], 1)
    got = PF.frame_sums(torch.from_numpy(padded), torch.from_numpy(flens)).numpy()
    assert np.array_equal(got, want)
    for r, n in enumerate(flens):
        alone = PF.frame_sums(torch.from_numpy(x[r : r + 1, :n].copy()),
                              torch.tensor([n])).numpy()
        assert np.array_equal(alone[0], want[r])
        assert abs(want[r] - x[r, :n].astype(np.float64).sum(0)).max() < 1e-9
