"""Weak-scaling report of the training statistic pass.

    python -m montreal_forced_aligner_tpu_torch.parallel.scaling [--device cpu]

Counterpart of ``montreal_forced_aligner_tpu/parallel/scaling.py``. It
times the statistic pass that ``train --distributed`` runs on each rank
(:func:`training_pass`: ``ViterbiEmTrainer``'s realignment through K3 and
the band Viterbi K1/K2, its GMM statistics, and ``reduce_card``'s
reduction over the ranks) at a FIXED per-rank batch for W = 1, 2, 4, ...
ranks (weak scaling: more cards, more utterances in flight), with the
SAT-scale model's statistics (5045 pdfs x 32 Gaussians, 40 dimensions:
51.7 MB of ``mean_acc`` plus ``var_acc`` a rank), and emits one JSON-able
dict. Each W runs in its own spawned process group
(``parallel.multihost.run_ranks``).

``shared_device`` says whether ranks shared a device (the CPU, or more ranks
than cards under gloo): then the ranks contend for it and the efficiency
measures the protocol, not scaling. ``stat_check_ok`` says the reduction
counted every row once at every W (total occupancy over W equals one rank's
frames). ``mesh_overhead_1dev_pct`` prices the reduction itself: the W = 1
pass against the same pass without it.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from montreal_forced_aligner_tpu_torch.ops.viterbi import NEG_INF, BatchedGraph

# the SAT-scale model's statistics (``bench.py``'s sat workload)
SAT_SCALE = dict(num_pdfs=5045, num_gauss=32, feat_dim=40)


def build_workload(
    batch: int,
    num_frames: int = 500,
    num_states: int = 192,
    num_pdfs: int = 512,
    num_gauss: int = 4,
    feat_dim: int = 39,
    seed: int = 0,
):
    """Synthetic (feats, lens, graph, miv, iv, gconst) alignment workload
    shaped like a real triphone pass: left-to-right graphs with self-loops,
    a GMM per pdf. Deterministic in ``seed``; the model comes from its own
    stream so every W sees the same model (the same draws as the JAX
    package's ``build_workload``)."""
    rng = np.random.RandomState(seed)
    mrng = np.random.RandomState(seed + 104729)
    B, T, S, P, G, D = batch, num_frames, num_states, num_pdfs, num_gauss, feat_dim
    feats = rng.randn(B, T, D).astype(np.float32)
    lens = np.full(B, T, np.int32)
    lens[1::2] = max(2, (3 * T) // 4)
    in_src = np.zeros((B, S, 2), np.int32)
    in_weight = np.full((B, S, 2), NEG_INF, np.float32)
    for s in range(S):
        in_src[:, s, 0] = s  # self-loop
        in_weight[:, s, 0] = np.log(0.5)
        if s > 0:
            in_src[:, s, 1] = s - 1  # forward arc
            in_weight[:, s, 1] = np.log(0.5)
    start = np.full((B, S), NEG_INF, np.float32)
    start[:, 0] = 0.0
    final = np.full((B, S), NEG_INF, np.float32)
    final[:, S - 1] = 0.0
    zeros = np.zeros((B, S), np.int32)
    t = torch.from_numpy
    graph = BatchedGraph(
        in_src=t(in_src),
        in_weight=t(in_weight),
        in_tid=np.zeros((B, S, 2), np.int32),
        start=t(start),
        final=t(final),
        final_tid=zeros,
        state_pdf=t(rng.randint(0, P, (B, S)).astype(np.int32)),
        state_phone=zeros,
        state_word=zeros,
        state_hmm_pos=zeros,
        state_tstate=zeros,
        state_instance=zeros,
        num_states=t(np.full(B, S, np.int32)),
    )
    miv = mrng.randn(P, G, D).astype(np.float32)
    iv = (0.5 + mrng.rand(P, G, D)).astype(np.float32)
    gconst = mrng.randn(P, G).astype(np.float32)
    return t(feats), t(lens), graph, t(miv), t(iv), t(gconst)


def _timed(fn, device, repeats: int, warmup: int):
    def run():
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    for _ in range(warmup):
        run()
    times, out = [], None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run()
        times.append(time.perf_counter() - t0)
    return times, out


def training_pass(feats, frame_lengths, graph, band_limits, gmm,
                  acoustic_scale: float = 0.1, reduce: bool = True):
    """One statistic pass of ``train --distributed`` on a rank's rows, made
    of the functions the trainer calls: ``ViterbiEmTrainer._realign``'s
    ``_align_batch`` (K3 at this model size, then K1 and K2 on the band),
    ``_accumulate_device``'s ``_accumulate_batch``, and the reduction of
    ``TrainingPipeline.reduce_card`` (``ordered_allreduce``) when
    ``reduce``. Returns [occ, mean_acc, var_acc, total_ll, total_frames]."""
    from montreal_forced_aligner_tpu_torch.parallel.data_parallel import (
        ordered_allreduce,
    )
    from montreal_forced_aligner_tpu_torch.training.base import (
        _accumulate_batch,
        _align_batch,
    )

    state_path, _scores = _align_batch(feats, frame_lengths, graph, gmm,
                                       acoustic_scale, band_limits=band_limits)
    frame_pdf = torch.gather(graph.state_pdf, 1, state_path.long())
    params = gmm.params
    stats = [*_accumulate_batch(feats, frame_lengths, frame_pdf, params.W,
                                params.gconsts, params.gconsts.shape[0]),
             frame_lengths.sum().to(torch.float32)]
    return ordered_allreduce(stats) if reduce else stats


def scaling_rank(rank: int, world_size: int, per_device_batch: int,
                 repeats: int, warmup: int, workload_kwargs: Dict,
                 device: str) -> Dict:
    """One rank of one W: its rows of the global batch through the pass."""
    from montreal_forced_aligner_tpu_torch.ops import cuda_build
    from montreal_forced_aligner_tpu_torch.ops.device_update import (
        flatten_W_device,
    )
    from montreal_forced_aligner_tpu_torch.ops.viterbi import band_limits_from_arcs
    from montreal_forced_aligner_tpu_torch.parallel.mesh import (
        get_mesh,
        replicated,
        shard_leading_axis,
    )
    from montreal_forced_aligner_tpu_torch.training.base import train_gmm

    mesh = get_mesh(device=device)
    feats, lens, graph, miv, iv, gconst = build_workload(
        world_size * per_device_batch, **workload_kwargs)
    band = band_limits_from_arcs({"in_src": graph.in_src.numpy(),
                                  "in_weight": graph.in_weight.numpy()})
    x, fl, g = shard_leading_axis(mesh, (feats, lens, graph))
    miv, iv, gconst = replicated(mesh, (miv, iv, gconst))
    gmm = train_gmm(flatten_W_device(miv, iv), gconst, miv, iv)
    cuda_build.reset_launch_counts()
    times, outs = _timed(lambda: training_pass(x, fl, g, band, gmm),
                         mesh.device, repeats, warmup)
    row = {
        "rank": rank,
        "times_s": times,
        "launches": dict(cuda_build.LAUNCHES),
        "frames": int(fl.sum()),
        "occ_sum": float(outs[0].double().sum()),
        "stats": [o.cpu().numpy() for o in outs],
    }
    if world_size == 1:
        plain, _ = _timed(
            lambda: training_pass(x, fl, g, band, gmm, reduce=False),
            mesh.device, repeats, warmup)
        row["plain_times_s"] = plain
    return row


def measure_scaling(
    device_counts: Optional[Sequence[int]] = None,
    per_device_batch: int = 8,
    num_frames: int = 500,
    repeats: int = 5,
    warmup: int = 2,
    workload_kwargs: Optional[Dict] = None,
    device: str = "cuda",
    backend: Optional[str] = None,
    timeout: float = 600.0,
    threads: int = 0,
) -> Dict:
    """Weak-scaling sweep: for each W (default: 1, 2, 4, ... up to the
    visible cards, at least 2), W ranks each run ``per_device_batch`` rows;
    min and median step seconds (the slowest rank's) over ``repeats``
    after ``warmup``. ``weak_efficiency`` = t(smallest W) / t(W). The
    model is SAT-scale unless ``workload_kwargs`` says otherwise."""
    from montreal_forced_aligner_tpu_torch.parallel.multihost import run_ranks

    dev = torch.device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if device_counts is None:
        top = max(2, cards)
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= top]
    device_counts = sorted(device_counts)
    kw = dict(SAT_SCALE, num_frames=num_frames)
    kw.update(workload_kwargs or {})
    rows, t1, check, stat_check_ok, overhead = [], None, None, True, None
    for n in device_counts:
        ranks = run_ranks(
            scaling_rank, n,
            args=(per_device_batch, repeats, warmup, kw, device),
            backend=backend, device=device, timeout=timeout, threads=threads,
        )
        per_rep = np.max([r["times_s"] for r in ranks], axis=0)
        best, med = float(per_rep.min()), float(np.median(per_rep))
        occ_sum = ranks[0]["occ_sum"]
        if check is None:
            check = occ_sum / n
        elif abs(occ_sum / n - check) > 1e-3 * max(abs(check), 1.0):
            stat_check_ok = False
        # every rank holds the same reduced statistics
        for r in ranks[1:]:
            if any(not np.array_equal(a, b)
                   for a, b in zip(r["stats"], ranks[0]["stats"])):
                stat_check_ok = False
        if t1 is None:
            t1 = best
        if n == 1:
            overhead = 100.0 * (best / float(np.min(ranks[0]["plain_times_s"]))
                                - 1.0)
        frames = sum(r["frames"] for r in ranks)
        rows.append({
            "devices": n,
            "global_batch": n * per_device_batch,
            "median_step_s": med,
            "min_step_s": best,
            "all_times_s": [float(t) for t in per_rep],
            "frames_per_s_per_device": frames / best / n,
            "weak_efficiency": t1 / best,
            "occ_per_replica": occ_sum / n,
            "launches_rank0": ranks[0]["launches"],
        })
    shared = dev.type == "cpu" or max(device_counts) > cards
    return {
        "mesh_overhead_1dev_pct": overhead,
        "stat_check_ok": stat_check_ok,
        "metric": "weak_scaling_efficiency",
        "platform": "cpu" if dev.type == "cpu" else "gpu",
        "device_name": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                        else "cpu"),
        "backend": backend or os.environ.get("MFA_TPU_TORCH_DIST_BACKEND")
        or ("nccl" if dev.type == "cuda" else "gloo"),
        "host_cpus": os.cpu_count(),
        "shared_device": shared,
        "per_device_batch": per_device_batch,
        "num_frames": num_frames,
        "workload": kw,
        "rows": rows,
        "note": (
            "weak_efficiency = t(1 rank)/t(W ranks) of train --distributed's "
            "statistic pass at a fixed per-rank batch; with shared_device the "
            "ranks contend for one device, so the sweep measures the "
            "protocol's cost, not scaling"
        ),
    }


def main(argv=None) -> int:  # pragma: no cover - exercised via the CLI
    p = argparse.ArgumentParser(description="weak-scaling report")
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"])
    p.add_argument("--counts", default=None,
                   help="comma-separated rank counts (default 1,2,4,...)")
    p.add_argument("--per_device_batch", type=int, default=8)
    p.add_argument("--num_frames", type=int, default=500)
    args = p.parse_args(argv)
    counts = ([int(c) for c in args.counts.split(",")] if args.counts
              else None)
    print(json.dumps(measure_scaling(
        counts, per_device_batch=args.per_device_batch,
        num_frames=args.num_frames, device=args.device, backend=args.backend)))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
