"""The port's training operations against the JAX package's, on the CPU, on
the same inputs made with numpy from a seed.

Tolerances: integer outputs (transition counts, transition-ids, split
schedules, subsets, layouts) equal; float statistics and updates within
rtol 1e-5 of each tensor's largest magnitude (float32 sums in another
order: tiles of one pdf, then indicator products, where the reference sums
with ``segment_sum`` or a one-hot product); gconsts' -inf padding in the
same places.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import montreal_forced_aligner_tpu.ops.device_update as JD
import montreal_forced_aligner_tpu.ops.stats as JS
import montreal_forced_aligner_tpu.ops.transforms as JT
import montreal_forced_aligner_tpu.training.base as JB
import montreal_forced_aligner_tpu_torch.ops.cuda_emission as PE
import montreal_forced_aligner_tpu_torch.ops.device_update as PD
import montreal_forced_aligner_tpu_torch.ops.stats as PS
import montreal_forced_aligner_tpu_torch.ops.transforms as PT
import montreal_forced_aligner_tpu_torch.training.base as PB

from torch_port_inputs import (
    segment_inputs,
    split_schedule_inputs,
    train_batch_inputs,
)

T_ = torch.from_numpy


def _close_to_scale(got, want, rtol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.array_equal(got[~fin], want[~fin])
    scale = np.abs(want[fin]).max() if fin.any() else 1.0
    err = np.abs(got[fin] - want[fin]).max() if fin.any() else 0.0
    assert err <= rtol * max(scale, 1e-30), err / scale


@pytest.mark.parametrize("tile,per_product", [(2, 2), (16, 128)])
def test_segment_sums_are_exact_sums_in_a_fixed_order(monkeypatch, tile, per_product):
    """Every segment's rows, summed over tiles and then by indicator
    products (four products of two segments each at ``per_product`` 2, one
    at 128), equal float64 sums; the same inputs give the same bits twice."""
    monkeypatch.setattr(PS, "TILE", tile)
    monkeypatch.setattr(PS, "SEGMENTS_PER_PRODUCT", per_product)
    seg, vals = segment_inputs(0)
    P = 7
    layout = PS.segment_layout(T_(seg), P, tile=tile)
    counts = np.bincount(seg[seg < P], minlength=P)
    assert layout.tiles_per.tolist() == [-(-c // tile) for c in counts]
    assert len(layout.products) == -(-P // per_product)
    assert layout.products[-1][1::2] == (P, layout.num_tiles)
    got = PS.reduce_tiles(PS.gather_rows(T_(vals), layout.idx).sum(dim=1), layout)
    want = np.zeros((P, vals.shape[1]))
    np.add.at(want, seg[seg < P], vals[seg < P].astype(np.float64))
    _close_to_scale(got.numpy(), want)
    assert np.all(got[3].numpy() == 0.0)
    again = PS.reduce_tiles(PS.gather_rows(T_(vals), layout.idx).sum(dim=1), layout)
    assert torch.equal(got, again)


def test_transition_counts_match_jax():
    a = train_batch_inputs(1)
    rng = np.random.RandomState(1)
    tids = rng.randint(0, 30, a["frame_pdf"].shape).astype(np.int32)
    want = JS.accumulate_transition_stats(jnp.asarray(tids), jnp.asarray(a["flens"]), 29)
    got = PS.accumulate_transition_stats(T_(tids), T_(a["flens"]), 29)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_frame_tids_match_jax():
    rng = np.random.RandomState(2)
    B, T, S, K = 4, 40, 12, 3
    in_src = rng.randint(0, S, (B, S, K)).astype(np.int32)
    in_tid = rng.randint(1, 50, (B, S, K)).astype(np.int32)
    final_tid = rng.randint(1, 50, (B, S)).astype(np.int32)
    path = np.minimum(np.cumsum(rng.rand(B, T) < 0.3, axis=1), S - 1).astype(np.int32)
    flens = np.array([T, 0, 17, 1], np.int32)
    want = JD.frame_tids_device(*(jnp.asarray(x) for x in (
        path, flens, in_src, in_tid, final_tid)))
    got = PD.frame_tids_device(*(T_(x) for x in (path, flens, in_src, in_tid,
                                                  final_tid)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_accumulate_batch_matches_jax(seed):
    """Padded Gaussians (pdf 2), a zero-length row, a pdf never aligned."""
    a = train_batch_inputs(seed)
    want = JB._accumulate_batch(
        jnp.asarray(a["feats"]), jnp.asarray(a["flens"]), jnp.asarray(a["frame_pdf"]),
        jnp.asarray(a["W"]), jnp.asarray(a["gconsts"]), a["P"],
    )
    got = PB._accumulate_batch(
        T_(a["feats"]), T_(a["flens"]), T_(a["frame_pdf"]), T_(a["W"]),
        T_(a["gconsts"]), a["P"],
    )
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close_to_scale(g.numpy(), np.asarray(w))
    assert np.all(got[0][a["P"] - 1].numpy() == 0.0)
    # the layout-taking form and the gather-based accumulate_gmm_stats agree
    P, G, D = a["P"], a["G"], a["D"]
    want2 = JS.accumulate_gmm_stats(
        *(jnp.asarray(a[k]) for k in ("feats", "flens", "frame_pdf", "miv",
                                      "inv_vars", "gconsts")), P)
    got2 = PS.accumulate_gmm_stats(
        *(T_(a[k]) for k in ("feats", "flens", "frame_pdf", "miv", "inv_vars",
                             "gconsts")), P)
    for g, w in zip(got2, want2):
        _close_to_scale(g.numpy(), np.asarray(w))


def test_accumulate_events_and_moments_match_jax():
    a = train_batch_inputs(3)
    rng = np.random.RandomState(3)
    ev = rng.randint(0, 11, a["frame_pdf"].shape).astype(np.int32)
    want = JB._accumulate_events(jnp.asarray(a["feats"]), jnp.asarray(a["flens"]),
                                 jnp.asarray(ev), 12)
    got = PB._accumulate_events(T_(a["feats"]), T_(a["flens"]), T_(ev), 12)
    for g, w in zip(got, want):
        _close_to_scale(g.numpy(), np.asarray(w))
    want = JD.masked_feature_moments(jnp.asarray(a["feats"]), jnp.asarray(a["flens"]))
    got = PD.masked_feature_moments(T_(a["feats"]), T_(a["flens"]))
    for g, w in zip(got, want):
        _close_to_scale(g.numpy(), np.asarray(w))


def test_lda_and_mllt_stats_match_jax(monkeypatch):
    a = train_batch_inputs(4, D=8)
    want = JT.accumulate_lda_stats(jnp.asarray(a["feats"]), jnp.asarray(a["flens"]),
                                   jnp.asarray(a["frame_pdf"]), a["P"])
    got = PT.accumulate_lda_stats(T_(a["feats"]), T_(a["flens"]),
                                  T_(a["frame_pdf"]), a["P"])
    for g, w in zip(got, want):
        _close_to_scale(g.numpy(), np.asarray(w))
    means = (a["miv"] / a["inv_vars"]).astype(np.float32)
    args = (a["feats"], a["flens"], a["frame_pdf"], means, a["inv_vars"],
            a["gconsts"], a["miv"])
    want = JT.accumulate_mllt_stats(*(jnp.asarray(x) for x in args))
    # several chunks of frames
    monkeypatch.setattr(PT, "_GATHER_CHUNK_BYTES", 37 * a["G"] * 8 * 8 * 4)
    got = PT.accumulate_mllt_stats(*(T_(x) for x in args))
    for g, w in zip(got, want):
        _close_to_scale(g.numpy(), np.asarray(w))
    # the host solves are the reference's
    counts, sums, second = (g.numpy().astype(np.float64) for g in
                            PT.accumulate_lda_stats(T_(a["feats"]), T_(a["flens"]),
                                                    T_(a["frame_pdf"]), a["P"]))
    assert np.array_equal(PT.estimate_lda(counts, sums, second, 5),
                          JT.estimate_lda(counts, sums, second, 5))
    G_mats, beta = (x.numpy().astype(np.float64) for x in got)
    assert np.array_equal(PT.solve_mllt(G_mats, float(beta)),
                          JT.solve_mllt(G_mats, float(beta)))


def test_mle_update_and_gconsts_match_jax():
    a = train_batch_inputs(5)
    occ, mean_acc, var_acc, _ll = JB._accumulate_batch(
        jnp.asarray(a["feats"]), jnp.asarray(a["flens"]), jnp.asarray(a["frame_pdf"]),
        jnp.asarray(a["W"]), jnp.asarray(a["gconsts"]), a["P"],
    )
    occ, mean_acc, var_acc = (np.array(x) for x in (occ, mean_acc, var_acc))
    want = JD.mle_update_means_vars_device(
        jnp.asarray(a["miv"]), jnp.asarray(a["inv_vars"]), jnp.asarray(occ),
        jnp.asarray(mean_acc), jnp.asarray(var_acc), min_gaussian_occupancy=3.0,
    )
    got = PD.mle_update_means_vars_device(
        T_(a["miv"]), T_(a["inv_vars"]), T_(occ), T_(mean_acc), T_(var_acc),
        min_gaussian_occupancy=3.0,
    )
    for g, w in zip(got, want):
        _close_to_scale(g.numpy(), np.asarray(w))
    num_gauss = np.isfinite(a["gconsts"]).sum(axis=1).astype(np.int32)
    w = np.where(np.isfinite(a["gconsts"]), 1.0 / num_gauss[:, None], 0.0)
    w = w.astype(np.float32)
    want = JD.gconsts_device(jnp.asarray(w), jnp.asarray(a["miv"]),
                             jnp.asarray(a["inv_vars"]), jnp.asarray(num_gauss))
    got = PD.gconsts_device(T_(w), T_(a["miv"]), T_(a["inv_vars"]), T_(num_gauss))
    assert np.isneginf(got.numpy()[2, 2:]).all()
    _close_to_scale(got.numpy(), np.asarray(want))
    assert np.array_equal(PD.flatten_W_device(T_(a["miv"]), T_(a["inv_vars"])).numpy(),
                          np.asarray(JD.flatten_W_device(jnp.asarray(a["miv"]),
                                                         jnp.asarray(a["inv_vars"]))))


@pytest.mark.parametrize("seed", [0, 7])
def test_split_schedule_and_scaled_apply_match_jax(seed):
    w, num_gauss, occ = split_schedule_inputs(seed)
    P, G = w.shape
    D = 5
    wh = JD.update_weights_host(w, num_gauss, occ)
    assert np.array_equal(PD.update_weights_host(w, num_gauss, occ), wh)
    want = JD.split_schedule_host(wh, num_gauss, occ, 30, D, seed=seed)
    got = PD.split_schedule_host(wh, num_gauss, occ, 30, D, seed=seed)
    for k in ("weights", "num_gauss", "pdf_idx", "dst_idx", "origin_idx", "delta"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    assert got.new_max_gauss == want.new_max_gauss > G
    rng = np.random.RandomState(seed)
    miv = rng.randn(P, G, D).astype(np.float32)
    iv = (0.5 + rng.rand(P, G, D)).astype(np.float32)
    M = got.num_writes
    Mp = max(8, 1 << (M - 1).bit_length())

    def rep(x):  # padded by repeating the first write, as the EM loop does
        return np.concatenate([x, np.repeat(x[:1], Mp - M, axis=0)], axis=0)

    args = (miv, iv, got.weights, got.num_gauss, rep(got.pdf_idx), rep(got.dst_idx),
            rep(got.origin_idx), rep(got.delta))
    want = JD.apply_split_schedule_scaled_device(
        *(jnp.asarray(x) for x in args), got.new_max_gauss)
    out = PD.apply_split_schedule_scaled_device(*(T_(x) for x in args),
                                               got.new_max_gauss)
    for g, w_ in zip(out, want):
        _close_to_scale(g.numpy(), np.asarray(w_))


def test_pack_rows_device_is_the_numpy_packing():
    a = train_batch_inputs(6)
    want = PE.pack_rows(a["miv"], a["inv_vars"], a["gconsts"])
    got = PE.pack_rows_device(T_(a["miv"]), T_(a["inv_vars"]), T_(a["gconsts"]))
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(PE.split_rows(got), PE.split_rows(T_(want)))


def test_gmm_stats_do_not_depend_on_chunking(monkeypatch):
    """The same layout over many chunks of tiles gives the same bits."""
    a = train_batch_inputs(8)
    args = (T_(a["feats"]), T_(a["flens"]), T_(a["frame_pdf"]), T_(a["W"]),
            T_(a["gconsts"]), a["P"])
    whole = PB._accumulate_batch(*args)
    monkeypatch.setattr(PS, "_CHUNK_BYTES", 1)
    chunked = PB._accumulate_batch(*args)
    for x, y in zip(whole, chunked):
        assert torch.equal(x, y)


@pytest.mark.parametrize("leaves", [12, 40])
def test_build_tree_matches_jax(leaves):
    """The port scores every split of a leaf at once; the tree is the
    reference loop's, leaf for leaf."""
    import montreal_forced_aligner_tpu.training.tree_builder as JTB
    import montreal_forced_aligner_tpu_torch.training.tree_builder as PTB

    from torch_port_inputs import tree_event_inputs

    events, groups = tree_event_inputs(leaves)
    trees = []
    for M in (JTB, PTB):
        stats = M.TreeStats(4)
        for (l, c, r, cls), (n, s, ss) in events.items():
            stats.add_event([l, c, r], cls, M.GaussStats(n, s.copy(), ss.copy()))
        qs = M.auto_questions(stats, groups, 1)
        trees.append(M.build_tree(stats, qs, [M.Root(set(g)) for g in groups],
                                  max_leaves=leaves))
    jt, pt = trees
    assert pt.num_pdfs == jt.num_pdfs == leaves
    for (l, c, r, cls) in events:
        assert pt.compute_pdf([l, c, r], cls) == jt.compute_pdf([l, c, r], cls)
    for a, b in zip(pt.leaf_stats, jt.leaf_stats):
        assert a.count == b.count and np.array_equal(a.sum, b.sum)


def test_training_subset_matches_jax():
    """The subset rules (speaker preference, 10x shortest pool, thin
    speakers dropped) pick the same utterances as the reference's."""
    from types import SimpleNamespace

    rng = np.random.RandomState(9)
    utts = [
        SimpleNamespace(
            id=i, speaker=f"s{rng.randint(12)}", num_frames=int(rng.randint(50, 900)),
            normalized_tokens=["w"] * int(rng.randint(2, 9)), text="",
        )
        for i in range(400)
    ]
    corpus = SimpleNamespace(utterances=utts)
    for size in (10, 30, 300):
        want = JB.select_training_subset(corpus, size, seed=1234)
        got = PB.select_training_subset(corpus, size, seed=1234)
        assert got == want and len(got) > 0
