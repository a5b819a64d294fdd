"""Each row's features and all-pdf emissions are its own, on the CPU.

The port's feature layer (``ops.mfcc._mfcc_device``, ``ops.feats.
apply_transform`` and ``apply_per_speaker_transform``,
``ops.gmm_loglikes.gmm_loglikes``) runs every product on tiles of frames
of one fixed shape (``ops.tiles``). Checked here, on utterances of mixed
lengths batched 1, 3 and 8 at a time (consecutive slices, each batch
padded to its own longest):

* the shapes reaching ``torch.fft.rfft``, ``torch.matmul`` and
  ``torch.bmm`` are the same at every batch size and padded length;
* each row's valid frames are bit-identical at every batch size;
* the results agree with the JAX package's functions at the port's
  existing bars (``tests/test_torch_ops.py``, ``tests/test_torch_fmllr.py``):
  MFCC rtol 1e-5 / atol 1e-4, transforms and final features atol 1e-5,
  all-pdf emissions rtol 1e-5.

``small_tiles`` shrinks the tiles to a few dozen frames so these short
inputs cross many tile edges; ``card_tiles`` lifts the CPU's cap so the
card's own tile sizes run.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import montreal_forced_aligner_tpu.align.aligner as JA
import montreal_forced_aligner_tpu.ops.feats as JF
import montreal_forced_aligner_tpu.ops.mfcc as JM
import montreal_forced_aligner_tpu_torch.align.aligner as PA
import montreal_forced_aligner_tpu_torch.ops.feats as PF
import montreal_forced_aligner_tpu_torch.ops.mfcc as PM
import montreal_forced_aligner_tpu_torch.ops.tiles as tiles
from montreal_forced_aligner_tpu.ops.gmm_loglikes import gmm_loglikes as j_gmm_loglikes
from montreal_forced_aligner_tpu_torch.params import gmm_params_from_numpy

# the module, not the function ``ops`` exports under the same name
PG = importlib.import_module("montreal_forced_aligner_tpu_torch.ops.gmm_loglikes")

BATCH_SIZES = (1, 3, 8)


def _waves(seed=0, n=8):
    """Broadband integer audio of 0.2-0.9 s (20-90 frames), shortest and
    longest mixed (see ``tests/test_torch_ops.py::_waves``)."""
    rng = np.random.RandomState(seed)
    out = []
    for n_samples in rng.randint(3200, 14400, n):
        t = np.arange(n_samples) / 16000.0
        w = (rng.randn(n_samples) * 1000
             + 2000 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t))
        out.append(np.round(w).astype(np.float32))
    return out


def _rows(seed=1, n=8, D=13, lo=20, hi=90):
    rng = np.random.RandomState(seed)
    return [(rng.randn(int(T), D) * 3).astype(np.float32)
            for T in rng.randint(lo, hi, n)]


def _pad(rows, fill_seed=None):
    """(B, T_max, D) of ``rows``, padded with zeros or, with ``fill_seed``,
    with noise (frames past a row's count are the caller's garbage)."""
    T = max(len(r) for r in rows)
    if fill_seed is None:
        out = np.zeros((len(rows), T) + rows[0].shape[1:], np.float32)
    else:
        out = np.random.RandomState(fill_seed).randn(
            len(rows), T, *rows[0].shape[1:]).astype(np.float32)
    for b, r in enumerate(rows):
        out[b, : len(r)] = r
    return out, np.array([len(r) for r in rows], np.int32)


def _rebatched(items, fn, bs):
    """``fn`` over consecutive slices of ``bs`` items: each item's output."""
    out = []
    for lo in range(0, len(items), bs):
        out += fn(items[lo : lo + bs], lo)
    return out


def _assert_rows_equal(by_bs):
    base = by_bs[BATCH_SIZES[0]]
    for bs in BATCH_SIZES[1:]:
        for i, (a, b) in enumerate(zip(by_bs[bs], base)):
            assert torch.equal(a, b), (
                f"row {i} at batch {bs}: {(a - b).abs().max().item()} from batch 1")


@pytest.fixture
def small_tiles(monkeypatch):
    monkeypatch.setattr(tiles, "BLOCK", 8)
    monkeypatch.setattr(PM, "TILE_FRAMES", 24)
    monkeypatch.setattr(PF, "TRANSFORM_TILE_FRAMES", 32)
    monkeypatch.setattr(PG, "MAX_TILE_FRAMES", 40)


@pytest.fixture
def card_tiles(monkeypatch):
    monkeypatch.setattr(tiles, "CPU_TILE_FRAMES", 1 << 20)


@pytest.fixture(params=["small_tiles", "card_tiles"])
def tiling(request):
    request.getfixturevalue(request.param)
    return request.param


# -- inputs of each function, batched ---------------------------------------


def _mfcc_batches(waves, bs, dtype=torch.float32, padded_len=None):
    cfg = PM.MfccConfig()

    def run(part, _lo):
        L = padded_len or -(-max(len(w) for w in part) // 16000) * 16000
        feats, flens = PM.compute_mfcc_batch(part, cfg, padded_len=L, device="cpu",
                                             dtype=dtype)
        assert feats.dtype == dtype
        return [feats[b, :n] for b, n in enumerate(flens)]

    return _rebatched(waves, run, bs)


def _mfcc_device_batches(waves, bs):
    cfg = PM.MfccConfig()

    def run(part, _lo):
        L = -(-max(len(w) for w in part) // 8000) * 8000
        padded, lens = PM.pad_waves_for_mfcc(part, cfg, L)
        feats = PM._mfcc_device(torch.from_numpy(padded), cfg, cfg.num_frames(L))
        return [feats[b, : cfg.num_frames(int(n))] for b, n in enumerate(lens)]

    return _rebatched(waves, run, bs)


def _lda_matrix(seed=6, D=13):
    return torch.from_numpy(
        (np.random.RandomState(seed).randn(40, 7 * D) / 9.0).astype(np.float32))


def _final_feats_batches(rows, bs, lda):
    means = torch.from_numpy(
        np.random.RandomState(5).randn(len(rows), 13).astype(np.float32))

    def run(part, lo):
        x, flens = _pad(part, fill_seed=lo)
        out = PA._final_feats(torch.from_numpy(x), torch.from_numpy(flens),
                              means[lo : lo + len(part)], lda)
        return [out[b, :n] for b, n in enumerate(flens)]

    return _rebatched(rows, run, bs)


def _transforms(seed=4, S=3, D=13):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        (np.tile(np.hstack([np.eye(D), np.zeros((D, 1))]), (S, 1, 1))
         + rng.randn(S, D, D + 1) * 0.2).astype(np.float32))


def _speakers(n=8, S=3):
    return np.arange(n) % S


def _fmllr_batches(rows, bs, trans):
    spk = _speakers(len(rows), trans.shape[0])

    def run(part, lo):
        x, flens = _pad(part, fill_seed=lo)
        out = PF.apply_per_speaker_transform(
            torch.from_numpy(x), torch.from_numpy(spk[lo : lo + len(part)]), trans)
        return [out[b, :n] for b, n in enumerate(flens)]

    return _rebatched(rows, run, bs)


def _gmm(seed=7, P=11, G=3, D=13):
    rng = np.random.RandomState(seed)
    miv = rng.randn(P, G, D).astype(np.float32)
    iv = rng.uniform(0.2, 2.0, (P, G, D)).astype(np.float32)
    gc = rng.uniform(-80, -40, (P, G)).astype(np.float32)
    gc[2, 1:] = -np.inf  # padded Gaussians
    return miv, iv, gc


def _gmm_batches(rows, bs, params):
    def run(part, lo):
        x, flens = _pad(part, fill_seed=lo)
        out = PG.gmm_loglikes(torch.from_numpy(x), params.W, params.gconsts)
        return [out[b, :n] for b, n in enumerate(flens)]

    return _rebatched(rows, run, bs)


# -- shapes ------------------------------------------------------------------


class _ShapeRecorder:
    """Records (op, argument shapes) of every rfft, matmul and bmm call."""

    def __init__(self, monkeypatch):
        self.calls = []
        for mod, name in ((torch.fft, "rfft"), (torch, "matmul"), (torch, "bmm")):
            monkeypatch.setattr(mod, name, self._wrap(name, getattr(mod, name)))

    def _wrap(self, name, fn):
        def call(*args, **kwargs):
            self.calls.append((name,) + tuple(
                tuple(a.shape) for a in args if isinstance(a, torch.Tensor)))
            return fn(*args, **kwargs)

        return call

    def take(self):
        out, self.calls = set(self.calls), []
        return out


def test_every_call_has_one_shape(small_tiles, monkeypatch):
    """At batch sizes 1, 3 and 8 and at two padded lengths, every rfft,
    matmul and bmm of the four functions runs at the tile's shape."""
    waves, rows = _waves(), _rows()
    lda, trans = _lda_matrix(), _transforms()
    params = gmm_params_from_numpy(*_gmm())
    block = tiles.BLOCK
    rec = _ShapeRecorder(monkeypatch)
    seen = {}
    for bs in BATCH_SIZES:
        for extra in (0, 37):  # a second padded length
            longer = [np.pad(r, ((0, extra), (0, 0))) for r in rows]
            _mfcc_batches(waves, bs, padded_len=16000 + 160 * extra)
            seen.setdefault("mfcc", set()).update(rec.take())
            x, _ = _pad(longer[:bs])
            PF.apply_transform(PF.splice_frames(
                torch.from_numpy(x), torch.full((bs,), x.shape[1]), 3, 3), lda)
            seen.setdefault("lda", set()).update(rec.take())
            PF.apply_per_speaker_transform(
                torch.from_numpy(x), torch.from_numpy(_speakers(bs)), trans)
            seen.setdefault("fmllr", set()).update(rec.take())
            PG.gmm_loglikes(torch.from_numpy(x), params.W, params.gconsts)
            seen.setdefault("gmm", set()).update(rec.take())
    mfcc_c, lda_c = PM.TILE_FRAMES, PF.TRANSFORM_TILE_FRAMES
    P, G = params.gconsts.shape
    assert seen["mfcc"] == {("rfft", (mfcc_c, 400)),
                            ("matmul", (mfcc_c, 256), (256, 23)),
                            ("matmul", (mfcc_c, 23), (23, 13))}
    assert seen["lda"] == {("matmul", (lda_c, 91), (91, 40))}
    assert seen["fmllr"] == {("bmm", (lda_c // block, block, 13),
                              (lda_c // block, 13, 13))}
    assert seen["gmm"] == {("matmul", (PG.MAX_TILE_FRAMES, 26), (26, P * G))}


def test_gmm_tile_follows_the_model(monkeypatch):
    """The emissions' tile holds at most TILE_BYTES of Gaussians, whole
    blocks, at least one block."""
    params = gmm_params_from_numpy(*_gmm())
    P, G = params.gconsts.shape
    rec = _ShapeRecorder(monkeypatch)
    x = torch.from_numpy(_pad(_rows())[0])
    for tile_bytes, frames in ((P * G * 4 * 100, 96), (P * G * 4, 16)):
        monkeypatch.setattr(PG, "TILE_BYTES", tile_bytes)
        PG.gmm_loglikes(x, params.W, params.gconsts)
        assert rec.take() == {("matmul", (frames, 26), (26, P * G))}


# -- rows --------------------------------------------------------------------


def test_mfcc_device_rows_are_their_own(tiling):
    waves = _waves()
    _assert_rows_equal({bs: _mfcc_device_batches(waves, bs) for bs in BATCH_SIZES})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_compute_mfcc_batch_rows_are_their_own(tiling, dtype):
    waves = _waves(2)
    _assert_rows_equal({bs: _mfcc_batches(waves, bs, dtype) for bs in BATCH_SIZES})


@pytest.mark.parametrize("lda", [False, True], ids=["deltas", "splice-lda"])
def test_final_feats_rows_are_their_own(tiling, lda):
    rows, mat = _rows(3), _lda_matrix() if lda else None
    _assert_rows_equal({bs: _final_feats_batches(rows, bs, mat)
                        for bs in BATCH_SIZES})


def test_per_speaker_transform_rows_are_their_own(tiling):
    rows, trans = _rows(4), _transforms()
    _assert_rows_equal({bs: _fmllr_batches(rows, bs, trans) for bs in BATCH_SIZES})


def test_gmm_loglikes_rows_are_their_own(tiling):
    rows, params = _rows(5), gmm_params_from_numpy(*_gmm())
    _assert_rows_equal({bs: _gmm_batches(rows, bs, params) for bs in BATCH_SIZES})


# -- against the JAX package, across tile edges ------------------------------


def test_mfcc_across_tiles_matches_jax(small_tiles):
    cfg, pcfg = JM.MfccConfig(), PM.MfccConfig()
    waves = _waves(6)
    padded, _lens = JM.pad_waves_for_mfcc(waves, cfg, 16000)
    max_frames = cfg.num_frames(16000)
    want = np.asarray(JM._mfcc_device(jnp.asarray(padded), cfg, max_frames))
    got = PM._mfcc_device(torch.from_numpy(padded), pcfg, max_frames).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("affine", [False, True])
def test_apply_transform_across_tiles_matches_jax(small_tiles, affine):
    x, _ = _pad(_rows(7, D=91))
    rng = np.random.RandomState(4)
    m = rng.randn(40, 92 if affine else 91).astype(np.float32) / 9.0
    want = JF.apply_transform(jnp.asarray(x), jnp.asarray(m))
    got = PF.apply_transform(torch.from_numpy(x), torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("lda", [False, True], ids=["deltas", "splice-lda"])
def test_final_feats_across_tiles_match_jax(small_tiles, lda):
    x, flens = _pad(_rows(8))
    means = np.random.RandomState(6).randn(len(flens), 13).astype(np.float32)
    mat = _lda_matrix().numpy() if lda else None
    want = JA._final_feats(jnp.asarray(x), jnp.asarray(flens), jnp.asarray(means),
                           None if mat is None else jnp.asarray(mat))
    got = PA._final_feats(torch.from_numpy(x), torch.from_numpy(flens),
                          torch.from_numpy(means),
                          None if mat is None else torch.from_numpy(mat))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_per_speaker_transform_across_tiles_matches_jax(small_tiles):
    x, _ = _pad(_rows(9))
    trans = _transforms()
    spk = _speakers(len(x))
    got = PF.apply_per_speaker_transform(torch.from_numpy(x), torch.from_numpy(spk),
                                         trans)
    want = JF.apply_per_speaker_transform(
        jnp.asarray(x), jnp.asarray(spk.astype(np.int32)), jnp.asarray(trans.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_gmm_loglikes_across_tiles_matches_jax(small_tiles):
    x, _ = _pad(_rows(10))
    miv, iv, gc = _gmm()
    D = miv.shape[-1]
    W = np.concatenate([miv.reshape(-1, D), -0.5 * iv.reshape(-1, D)], 1).T
    params = gmm_params_from_numpy(miv, iv, gc)
    want = j_gmm_loglikes(jnp.asarray(x), jnp.asarray(W), jnp.asarray(gc))
    got = PG.gmm_loglikes(torch.from_numpy(x), params.W, params.gconsts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
