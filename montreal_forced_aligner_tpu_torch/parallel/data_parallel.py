"""Data-parallel alignment and statistic accumulation over ranks.

Counterpart of ``montreal_forced_aligner_tpu/parallel/data_parallel.py``.
There one SPMD step shards (features, graphs) over a mesh's "data" axis,
runs emissions and the Viterbi per shard and ``psum``s the GMM statistics.
Here each rank runs the same step on its own rows on its own card (the
emission kernel K3 when the model's size takes it) and the statistics meet
in :func:`ordered_allreduce`. Reference
counterpart: per-job ``AccStatsFunction`` workers plus the parent process's
accumulator sums (``alignment/multiprocessing.py:576-666``,
``utils.py:1505-1641``).

The reduction is exact and reproducible: each rank writes its partial into
slot ``rank`` of a zeroed ``(W, ...)`` buffer, one ``all_reduce(SUM)`` fills
every slot on every rank (a slot sums one value and zeros, so no backend's
ring order can round it), and each rank sums the slots in rank order. Every
rank holds the same bits, repeated runs are bit-identical, and one rank
returns its own statistics unchanged. The cost is ``W`` times the bytes.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from montreal_forced_aligner_tpu_torch.ops.viterbi import BatchedGraph


def ordered_allreduce(tensors: Sequence[torch.Tensor], group=None
                      ) -> List[torch.Tensor]:
    """Sum each tensor over the ranks of ``group`` in rank order (see the
    module note); the tensors themselves when no process group exists.
    Every rank must pass tensors of the same shapes and dtypes, on the
    device its backend carries. One collective per dtype."""
    import torch.distributed as dist

    tensors = list(tensors)
    if not dist.is_initialized():
        return tensors
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        sizes = [tensors[i].numel() for i in idx]
        dev = tensors[idx[0]].device
        slots = torch.zeros((world, sum(sizes)), dtype=dtype, device=dev)
        slots[rank] = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(slots, op=dist.ReduceOp.SUM, group=group)
        total = slots[0].clone()
        for r in range(1, world):
            total += slots[r]
        off = 0
        for i, n in zip(idx, sizes):
            out[i] = total[off:off + n].reshape(tensors[i].shape)
            off += n
    return out


def _align_and_accumulate(
    feats,  # (b, T, D) this rank's rows
    frame_lengths,  # (b,)
    graph: BatchedGraph,  # this rank's rows
    miv,  # (P, G, D) replicated
    iv,
    gconst,  # (P, G)
    acoustic_scale: float,
    reduce: bool = True,
):
    """One rank's step, as the JAX package's: each graph state's emissions
    (the aligner's rule: the state-emission kernel K3 above its size
    threshold, else all pdfs and a gather) and the exact dense Viterbi,
    whose first-maximum tie rule the JAX step's has; then the GMM
    statistics of the aligned pdfs in the fixed order of ``ops/stats.py``,
    reduced over the ranks when ``reduce``. Returns (state_path, scores,
    occ, mean_acc, var_acc, total_ll, total_frames): the paths and scores of
    this rank's rows, the statistics of all rows."""
    from montreal_forced_aligner_tpu_torch.ops.device_update import (
        flatten_W_device,
    )
    from montreal_forced_aligner_tpu_torch.training.base import (
        _accumulate_batch,
        _align_batch,
        train_gmm,
    )

    P = miv.shape[0]
    W = flatten_W_device(miv, iv)
    state_path, scores = _align_batch(
        feats, frame_lengths, graph, train_gmm(W, gconst, miv, iv),
        acoustic_scale,
    )
    frame_pdf = torch.gather(graph.state_pdf, 1, state_path.long())
    occ, mean_acc, var_acc, total_ll = _accumulate_batch(
        feats, frame_lengths, frame_pdf, W, gconst, P
    )
    total_frames = frame_lengths.sum().to(torch.float32)
    stats = [occ, mean_acc, var_acc, total_ll, total_frames]
    if reduce:
        stats = ordered_allreduce(stats)
    return (state_path, scores, *stats)


def make_sharded_accumulate_step(mesh, acoustic_scale: float = 0.1) -> Callable:
    """The step each rank runs on its rows of a batch
    (``mesh.shard_leading_axis``) with the model whole on its device
    (``mesh.replicated``): ``step(feats, frame_lengths, graph, miv, iv,
    gconst) -> (state_path, scores, occ, mean_acc, var_acc, total_ll,
    total_frames)``, the statistics reduced over every rank."""
    del mesh  # the ranks are the process group's

    def step(feats, frame_lengths, graph, miv, iv, gconst):
        return _align_and_accumulate(
            feats, frame_lengths, graph, miv, iv, gconst, acoustic_scale
        )

    return step


def make_sharded_fmllr_stats_step(mesh) -> Callable:
    """Per-speaker fMLLR statistics over the ranks: ``build(num_speakers)``
    gives ``step(feats, frame_lengths, frame_pdf, speaker_idx, frame_weight,
    means, inv_vars, gconsts, miv) -> (K, G, beta)``, each rank's sums over
    its rows reduced over every rank (a rank contributes zeros for the
    speakers it does not hold). Reference semantics:
    ``kalpy.feat.fmllr.FmllrComputer`` per-speaker accumulation,
    ``corpus/features.py:422-548``."""
    from montreal_forced_aligner_tpu_torch.ops.transforms import (
        accumulate_fmllr_stats,
    )

    del mesh

    def build(num_speakers: int):
        def step(feats, frame_lengths, frame_pdf, speaker_idx, frame_weight,
                 means, inv_vars, gconsts, miv):
            return tuple(ordered_allreduce(accumulate_fmllr_stats(
                feats, frame_lengths, frame_pdf, speaker_idx, frame_weight,
                means, inv_vars, gconsts, miv, num_speakers,
            )))

        return step

    return build
