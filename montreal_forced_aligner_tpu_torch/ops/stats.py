"""Training statistic accumulation and GMM maximum-likelihood updates.

Counterpart of ``montreal_forced_aligner_tpu/ops/stats.py``. The reference
package reduces per-frame statistics per pdf with ``segment_sum``. On a
GPU the natural counterpart, ``index_add_``, adds floats with atomics, so
its order, and with it the last bits of every statistic, changes from run
to run; training would drift between runs and a resumed run would not
match the uninterrupted one. Every reduction here instead has a fixed
order:

* the valid frames of a batch are sorted by segment (pdf or tree event),
  stably, once per alignment, and cut into tiles of at most ``TILE``
  frames of one segment each (:func:`segment_layout`);
* a tile's statistics are products over its frames (``bmm``) or sums over
  its rows;
* the tiles of each run of ``SEGMENTS_PER_PRODUCT`` segments, which lie
  side by side, are summed by one product with their (segments, tiles)
  indicator (:func:`reduce_tiles`).

Only gathers, products and ``sum`` over a dimension do the arithmetic, each
of them deterministic on the card and on the CPU. No one-hot over frames is
built: each tile's pdf parameters are gathered once for its frames.

The MLE update, mixing-up and the host accumulator container are numpy
copies of the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.models.gmm import DiagGmmSet

# frames per tile
TILE = 16
# segments whose tiles one indicator product sums: its cost is this many
# multiply-adds per tile and statistic
SEGMENTS_PER_PRODUCT = 128
# bytes of the gathered per-tile tensors alive at once
_CHUNK_BYTES = 64 << 20


class SegmentLayout(NamedTuple):
    """Rows of a source tensor grouped by segment into tiles of ``TILE``.

    Row ``n`` (one past the source's last row) is a zero row: padded tile
    slots point at it."""

    idx: torch.Tensor  # (nt, TILE) int64 source row of each slot
    valid: torch.Tensor  # (nt, TILE) bool: the slot holds a real row
    tile_seg: torch.Tensor  # (nt,) int64 segment of each tile
    tiles_per: torch.Tensor  # (num_segments,) int64 tiles of each segment
    num_rows: int  # n
    # (first segment, end segment, first tile, end tile) of each product
    products: Tuple[Tuple[int, int, int, int], ...]

    @property
    def num_tiles(self) -> int:
        return int(self.idx.shape[0])

    @property
    def num_segments(self) -> int:
        return int(self.tiles_per.shape[0])


def _tile_counts(counts: torch.Tensor, order: torch.Tensor, num_rows: int,
                 tile: int) -> SegmentLayout:
    """Tiles over rows sorted by segment: ``order[k]`` is the source row at
    sorted position k."""
    dev = counts.device
    P = counts.shape[0]
    tiles_per = (counts + tile - 1) // tile
    tile_end = torch.cumsum(tiles_per, 0)
    # the one host sync: where each product's tiles end (the last, nt)
    per = SEGMENTS_PER_PRODUCT
    seg_ends = list(range(per, P, per)) + [P] if P else []
    ends = tile_end[per - 1 :: per]
    if P % per:
        ends = torch.cat([ends, tile_end[-1:]])
    tile_ends = ends.tolist()
    nt = tile_ends[-1] if P else 0
    products = tuple(zip([0] + seg_ends[:-1], seg_ends, [0] + tile_ends[:-1],
                         tile_ends))
    tile_seg = torch.repeat_interleave(
        torch.arange(P, device=dev), tiles_per, output_size=nt
    )
    first_tile = tile_end - tiles_per
    seg_start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(nt, device=dev) - first_tile[tile_seg]
    off = rank[:, None] * tile + torch.arange(tile, device=dev)[None, :]
    valid = off < counts[tile_seg][:, None]
    pos = torch.clamp(seg_start[tile_seg][:, None] + off, max=max(num_rows - 1, 0))
    idx = torch.where(valid, order[pos], num_rows)
    return SegmentLayout(idx, valid, tile_seg, tiles_per, num_rows, products)


def segment_layout(seg: torch.Tensor, num_segments: int,
                   tile: int = TILE) -> SegmentLayout:
    """Layout of rows by segment id ``seg`` (n,); ids outside
    [0, num_segments) drop their row. Rows of one segment keep their order
    (a stable sort)."""
    seg = seg.reshape(-1).long()
    n = seg.shape[0]
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    order = torch.sort(seg, stable=True).indices
    counts = torch.bincount(seg, minlength=num_segments + 1)[:num_segments]
    return _tile_counts(counts, order, n, tile)


def frame_layout(frame_seg: torch.Tensor, frame_lengths: torch.Tensor,
                 num_segments: int, tile: int = TILE) -> SegmentLayout:
    """:func:`segment_layout` of a batch's valid frames ((B, T) segment ids,
    frames past each row's length dropped), rows indexing the flattened
    (B*T) frames."""
    B, T = frame_seg.shape
    mask = torch.arange(T, device=frame_seg.device)[None, :] < frame_lengths[:, None]
    seg = torch.where(mask, frame_seg.long(), num_segments)
    return segment_layout(seg, num_segments, tile)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with index ``len(x)`` reading a zero row."""
    pad = torch.zeros((1,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])[idx]


def reduce_tiles(tile_vals: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """(num_segments, ...) sums of each segment's tiles (``tile_vals`` (nt,
    ...), in the layout's tile order): for each run of segments in
    ``layout.products``, one product of its (segments, tiles) indicator with
    its tiles' rows."""
    shape = tuple(tile_vals.shape[1:])
    vals = tile_vals.reshape(tile_vals.shape[0], -1)
    dev = vals.device
    out = torch.empty((layout.num_segments, vals.shape[1]), dtype=vals.dtype,
                      device=dev)
    for p0, p1, t0, t1 in layout.products:
        ind = (torch.arange(p0, p1, device=dev)[:, None]
               == layout.tile_seg[None, t0:t1]).to(vals.dtype)
        out[p0:p1] = ind @ vals[t0:t1]
    return out.reshape((layout.num_segments,) + shape)


def flatten_W_pdf_major(miv: torch.Tensor, iv: torch.Tensor) -> torch.Tensor:
    """(P, 2D, G) rows ``[miv; -0.5*iv]`` per pdf: the per-tile operand of
    the statistics (the (2D, P*G) likelihood layout, pdf-major)."""
    return torch.cat([miv, -0.5 * iv], dim=2).transpose(1, 2).contiguous()


def gmm_stats_tiles(
    x: torch.Tensor,  # (N, D) frames
    layout: SegmentLayout,  # by pdf over the N frames
    Wp: torch.Tensor,  # (P, 2D, G) from flatten_W_pdf_major
    gconsts: torch.Tensor,  # (P, G), -inf padding
):
    """Viterbi-alignment GMM statistics of the frames in ``layout``:
    (occ (P, G), mean_acc (P, G, D), var_acc (P, G, D), total_loglike ()).
    Posteriors are the Gaussian responsibilities within each frame's
    aligned pdf."""
    P, D2, G = Wp.shape
    D = D2 // 2
    dev = x.device
    nt = layout.num_tiles
    R = layout.idx.shape[1]
    # clamp the -inf padding to a finite floor: exp(-1e30 - ll) is 0
    gc = torch.clamp(gconsts, min=-1.0e30)
    # per tile and Gaussian: [occupancy, mean_acc (D), var_acc (D)], reduced
    # per pdf by one product
    acc_t = torch.empty((nt, G, 1 + 2 * D), dtype=torch.float32, device=dev)
    ll_t = torch.empty((nt,), dtype=torch.float32, device=dev)
    per_tile = 4 * (3 * R * D + 2 * D * G + 3 * R * G + 2 * G * D)
    step = max(1, _CHUNK_BYTES // per_tile)
    for t0 in range(0, nt, step):
        sl = slice(t0, t0 + step)
        X = gather_rows(x, layout.idx[sl])  # (c, R, D)
        X2 = X * X
        p = layout.tile_seg[sl]
        quad = torch.bmm(torch.cat([X, X2], dim=2), Wp[p]) + gc[p][:, None, :]
        ll = torch.logsumexp(quad, dim=-1)  # (c, R)
        v = layout.valid[sl]
        post = torch.where(v[..., None], torch.exp(quad - ll[..., None]), 0.0)
        acc_t[sl, :, 0] = post.sum(dim=1)
        postT = post.transpose(1, 2)
        acc_t[sl, :, 1 : D + 1] = torch.bmm(postT, X)
        acc_t[sl, :, D + 1 :] = torch.bmm(postT, X2)
        ll_t[sl] = torch.where(v, ll, 0.0).sum(dim=1)
    acc = reduce_tiles(acc_t, layout)
    return (acc[:, :, 0].contiguous(), acc[:, :, 1 : D + 1].contiguous(),
            acc[:, :, D + 1 :].contiguous(), ll_t.sum())


def accumulate_gmm_stats(
    feats: torch.Tensor,  # (B, T, D)
    frame_lengths: torch.Tensor,  # (B,)
    frame_pdf: torch.Tensor,  # (B, T) aligned pdf-id per frame
    miv: torch.Tensor,  # (P, G, D) means*invvars
    iv: torch.Tensor,  # (P, G, D) invvars
    gconst: torch.Tensor,  # (P, G)
    num_pdfs: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Viterbi-alignment GMM stats: (occupancy (P, G), mean_acc (P, G, D),
    var_acc (P, G, D), total_loglike ()), as the reference's function."""
    B, T, D = feats.shape
    layout = frame_layout(frame_pdf, frame_lengths, num_pdfs)
    return gmm_stats_tiles(feats.reshape(B * T, D), layout,
                           flatten_W_pdf_major(miv, iv), gconst)


def accumulate_transition_stats(
    frame_tid: torch.Tensor,  # (B, T) transition-id per frame (0 = none)
    frame_lengths: torch.Tensor,  # (B,)
    num_tids: int,
) -> torch.Tensor:
    """Counts per transition-id: (num_tids + 1,) float32, entry 0 unused
    (it counts the padded frames). Integer counts, so exact."""
    B, T = frame_tid.shape
    mask = torch.arange(T, device=frame_tid.device)[None, :] < frame_lengths[:, None]
    tid = torch.where(mask, frame_tid.long(), 0).reshape(-1)
    return torch.bincount(tid, minlength=num_tids + 1)[: num_tids + 1].float()


def segment_moments(
    x: torch.Tensor,  # (N, D)
    layout: SegmentLayout,
):
    """Per segment (count (P,), sum (P, D), sumsq (P, D)) of the rows in
    ``layout``, float32."""
    nt = layout.num_tiles
    D = x.shape[1]
    R = layout.idx.shape[1]
    vals = torch.empty((nt, 2 * D + 1), dtype=torch.float32, device=x.device)
    step = max(1, _CHUNK_BYTES // (4 * R * D * 2))
    for t0 in range(0, nt, step):
        sl = slice(t0, t0 + step)
        X = gather_rows(x, layout.idx[sl])
        vals[sl, 0] = layout.valid[sl].sum(dim=1).float()
        vals[sl, 1 : D + 1] = X.sum(dim=1)
        vals[sl, D + 1 :] = (X * X).sum(dim=1)
    out = reduce_tiles(vals, layout)
    return out[:, 0], out[:, 1 : D + 1], out[:, D + 1 :]


@dataclass
class GmmAccumulators:
    """Host-side accumulator container with summation (the parent-process
    reduction in the reference, ``triphone.py:371-380``)."""

    occ: np.ndarray  # (P, G)
    mean_acc: np.ndarray  # (P, G, D)
    var_acc: np.ndarray  # (P, G, D)
    transition_counts: np.ndarray  # (num_tids + 1,)
    total_loglike: float = 0.0
    total_frames: float = 0.0

    @classmethod
    def zeros(cls, num_pdfs: int, max_gauss: int, dim: int, num_tids: int):
        return cls(
            occ=np.zeros((num_pdfs, max_gauss)),
            mean_acc=np.zeros((num_pdfs, max_gauss, dim)),
            var_acc=np.zeros((num_pdfs, max_gauss, dim)),
            transition_counts=np.zeros(num_tids + 1),
        )

    def add(self, occ, mean_acc, var_acc, tcounts, loglike, frames) -> None:
        self.occ += np.asarray(occ)
        self.mean_acc += np.asarray(mean_acc)
        self.var_acc += np.asarray(var_acc)
        self.transition_counts += np.asarray(tcounts)
        self.total_loglike += float(loglike)
        self.total_frames += float(frames)


def mle_update(
    gmm: DiagGmmSet,
    acc: GmmAccumulators,
    min_gaussian_occupancy: float = 10.0,
    min_variance: float = 0.001,
    remove_low_count_gaussians: bool = False,
    update_flags: str = "mvw",
) -> Tuple[DiagGmmSet, dict]:
    """Maximum-likelihood re-estimation (Kaldi ``MleDiagGmmUpdate`` semantics:
    weights/means/variances from accumulated stats; components under the
    occupancy floor keep their previous parameters). ``update_flags`` selects
    which parameter groups update (m=means, v=variances, w=weights), matching
    the reference's MAP adaptation which updates means only
    (``alignment/adapting.py:86-135``, ``update_flags_str="m"``)."""
    occ = acc.occ  # (P, G)
    P, G = occ.shape
    D = acc.mean_acc.shape[2]
    old_means = gmm.get_means()
    old_vars = gmm.get_vars()
    tot_occ_per_pdf = occ.sum(axis=1, keepdims=True)
    valid = occ > min_gaussian_occupancy

    with np.errstate(divide="ignore", invalid="ignore"):
        new_means = np.where(valid[:, :, None], acc.mean_acc / occ[:, :, None], old_means)
        ex2 = acc.var_acc / np.maximum(occ, 1e-10)[:, :, None]
        new_vars = np.where(
            valid[:, :, None], ex2 - new_means**2, old_vars
        )
    new_vars = np.maximum(new_vars, min_variance)
    weights = np.where(
        tot_occ_per_pdf > 0, occ / np.maximum(tot_occ_per_pdf, 1e-10), gmm.weights
    )
    if "m" not in update_flags:
        new_means = old_means
    # keep padding weights at zero
    pad = np.arange(G)[None, :] >= gmm.num_gauss[:, None]
    if "w" in update_flags:
        weights = np.where(pad, 0.0, weights)
        wsum = weights.sum(axis=1, keepdims=True)
        weights = (weights / np.maximum(wsum, 1e-10)).astype(np.float32)
    else:
        # not updated: the model's own weights, bit for bit
        weights = gmm.weights.astype(np.float32)
    if "v" in update_flags:
        inv_vars = (1.0 / new_vars).astype(np.float32)
        means_invvars = new_means * (1.0 / new_vars)
    else:
        # not updated: the model's own inverse variances, bit for bit (the
        # round trip through 1 / (1 / x) in float32 moves some by an ulp)
        inv_vars = gmm.inv_vars.astype(np.float32)
        means_invvars = new_means * inv_vars
    out = DiagGmmSet(
        weights=weights,
        means_invvars=means_invvars.astype(np.float32),
        inv_vars=inv_vars,
        gconsts=gmm.gconsts.copy(),
        num_gauss=gmm.num_gauss.copy(),
    )
    out.compute_gconsts()
    info = {
        "tot_occ": float(occ.sum()),
        "updated_gauss": int(valid.sum()),
        "floored_gauss": int((~valid & ~pad).sum()),
    }
    return out, info


def ismooth_stats_from_model(
    gmm: DiagGmmSet, acc: GmmAccumulators, tau: float = 20.0
) -> GmmAccumulators:
    """I-smoothing for MAP adaptation (Kaldi
    ``IsmoothStatsAmDiagGmmFromModel``): add ``tau`` pseudo-counts of each
    Gaussian's own distribution to its statistics (reference
    ``alignment/adapting.py:86-135``, ``mapping_tau=20``)."""
    means = gmm.get_means()
    variances = gmm.get_vars()
    pad = np.arange(gmm.max_gauss)[None, :] >= gmm.num_gauss[:, None]
    tau_occ = np.where(pad, 0.0, tau)
    acc.occ = acc.occ + tau_occ
    acc.mean_acc = acc.mean_acc + tau_occ[:, :, None] * means
    acc.var_acc = acc.var_acc + tau_occ[:, :, None] * (variances + means**2)
    return acc


def split_gaussians(
    gmm: DiagGmmSet,
    occs: np.ndarray,  # (P,) or (P, G) occupancy used to pick split targets
    target_total: int,
    perturb_factor: float = 0.01,
    power: float = 0.25,
    min_count: float = 20.0,
    seed: int = 0,
) -> DiagGmmSet:
    """Mix up to ``target_total`` Gaussians (Kaldi ``gmm-mixup`` semantics:
    pdfs get Gaussian budgets proportional to occupancy**power with a
    min-count floor; each new component splits the heaviest-weight component
    with a +-perturb_factor * stddev perturbation).
    """
    rng = np.random.RandomState(seed)
    P = gmm.num_pdfs
    occ_pdf = occs.sum(axis=1) if occs.ndim == 2 else occs
    raw = np.maximum(occ_pdf, min_count) ** power
    targets = np.maximum(
        1, np.floor(raw / raw.sum() * target_total).astype(int)
    )
    targets = np.maximum(targets, gmm.num_gauss)  # never shrink here

    # pad the gaussian axis to the next power of two (padding rows carry
    # weight 0 / gconst -inf, so numerics are unchanged)
    new_max = int(targets.max())
    new_max = max(int(gmm.max_gauss), 8, 1 << (new_max - 1).bit_length())
    D = gmm.dim
    weights = np.zeros((P, new_max), dtype=np.float64)
    means = np.zeros((P, new_max, D), dtype=np.float64)
    variances = np.ones((P, new_max, D), dtype=np.float64)
    old_means = gmm.get_means().astype(np.float64)
    old_vars = gmm.get_vars().astype(np.float64)
    counts = np.zeros(P, dtype=np.int32)
    for p in range(P):
        n = int(gmm.num_gauss[p])
        weights[p, :n] = gmm.weights[p, :n]
        means[p, :n] = old_means[p, :n]
        variances[p, :n] = old_vars[p, :n]
        tgt = int(targets[p])
        while n < tgt:
            g = int(np.argmax(weights[p, :n]))
            w = weights[p, g] / 2.0
            weights[p, g] = w
            weights[p, n] = w
            std = np.sqrt(variances[p, g])
            delta = perturb_factor * std * rng.randn(D)
            means[p, n] = means[p, g] - delta
            means[p, g] = means[p, g] + delta
            variances[p, n] = variances[p, g]
            n += 1
        counts[p] = n
    inv_vars = 1.0 / variances
    out = DiagGmmSet(
        weights=weights.astype(np.float32),
        means_invvars=(means * inv_vars).astype(np.float32),
        inv_vars=inv_vars.astype(np.float32),
        gconsts=np.full((P, new_max), -np.inf, dtype=np.float32),
        num_gauss=counts,
    )
    out.compute_gconsts()
    return out
