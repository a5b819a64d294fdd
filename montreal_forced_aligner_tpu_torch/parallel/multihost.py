"""Multi-process orchestration on ``torch.distributed``: process-group set-up,
per-rank corpus sharding and the host collectives.

Counterpart of ``montreal_forced_aligner_tpu/parallel/multihost.py``. The
reference shards speakers onto NUM_JOBS local worker processes by greedy
bin-packing on utterance count (``corpus/base.py:922-1035``) so per-speaker
CMVN/fMLLR statistics stay job-local. Here each rank (one process, one card)
owns the same kind of shard (:func:`shard_corpus_for_host`), and only the
reduced model statistics cross ranks (``parallel/data_parallel.py``).

Launch: ``python -m torch.distributed.run --nproc_per_node N -m
montreal_forced_aligner_tpu_torch.cli ... --distributed`` sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``, which
:func:`initialize_multihost` reads; tests pass a ``file://`` store instead.

The backend that carries card tensors is chosen, never guessed: NCCL for
ranks on cards (one card a rank), gloo on the CPU, and gloo on cards when the
caller names it (``backend="gloo"`` or ``MFA_TPU_TORCH_DIST_BACKEND=gloo``),
which lets ranks share one card. Host collectives (small numpy arrays and
pickled objects) always ride a CPU gloo group, whatever the backend.
"""

from __future__ import annotations

import logging
import os
import pickle
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

_logger = logging.getLogger("mfa_tpu")

BACKEND_ENV = "MFA_TPU_TORCH_DIST_BACKEND"

# the CPU gloo group of the host collectives (the default group when the
# process group itself is gloo)
_HOST_GROUP = None


def resolve_backend(backend: Optional[str] = None, device="cuda") -> str:
    """The backend that carries card tensors: the argument, else
    ``MFA_TPU_TORCH_DIST_BACKEND``, else NCCL for a CUDA device and gloo for
    the CPU. NCCL on the CPU raises."""
    import torch

    dev_type = torch.device(device).type
    name = backend or os.environ.get(BACKEND_ENV) or (
        "nccl" if dev_type == "cuda" else "gloo")
    name = name.lower()
    if name not in ("nccl", "gloo"):
        raise ValueError(f"unsupported torch.distributed backend {name!r} "
                         "(nccl or gloo)")
    if name == "nccl" and dev_type != "cuda":
        raise ValueError("the nccl backend carries CUDA tensors only; "
                         "ranks on the CPU use gloo")
    return name


def initialize_multihost(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> Tuple[int, int]:
    """Initialise ``torch.distributed`` (idempotent) and return
    ``(rank, world_size)``.

    With no arguments it reads the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` as ``torchrun`` sets
    them); without that environment and without ``init_method`` the process
    runs alone and nothing is initialised: ``(0, 1)``. ``init_method`` (for
    example a ``file://`` store) needs ``world_size`` and ``rank``.
    """
    import torch.distributed as dist

    global _HOST_GROUP
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if init_method is None and "WORLD_SIZE" not in os.environ:
        return 0, 1
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    name = resolve_backend(backend, device)
    import torch

    if torch.device(device).type == "cuda":
        # each rank works on its card from here on ("cuda" means it); NCCL
        # binds the rank to it before the group forms
        from montreal_forced_aligner_tpu_torch.parallel.mesh import rank_device

        torch.cuda.set_device(rank_device(device, backend=name))
    dist.init_process_group(
        name, init_method=init_method or "env://", world_size=world_size,
        rank=rank,
    )
    # every rank creates the host group at once, in the same order
    _HOST_GROUP = dist.new_group(backend="gloo") if name != "gloo" else None
    return rank, world_size


def shutdown_multihost() -> None:
    """Destroy the process group (a no-op when none is initialised)."""
    import torch.distributed as dist

    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_initialized()


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index among the ranks of its machine (``LOCAL_RANK``,
    else the global rank)."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def shard_speakers_for_host(
    speaker_utterance_counts: Dict[str, int],
    process_index: int,
    process_count: int,
) -> List[str]:
    """Greedy bin-packing of speakers onto hosts by utterance count
    (reference ``initialize_jobs``, ``corpus/base.py:994-1015``): speakers
    sorted by descending load, each assigned to the lightest bin. Returns
    the speakers owned by ``process_index`` (deterministic across hosts)."""
    loads = [0] * process_count
    owner: Dict[str, int] = {}
    for spk in sorted(
        speaker_utterance_counts,
        key=lambda s: (-speaker_utterance_counts[s], s),
    ):
        bin_i = min(range(process_count), key=lambda i: (loads[i], i))
        owner[spk] = bin_i
        loads[bin_i] += speaker_utterance_counts[spk]
    return sorted(s for s, b in owner.items() if b == process_index)


def host_allgather(arr) -> "list":
    """All-gather a small host-side numpy array across processes; returns a
    list of per-process arrays (identical order on every host). Returns
    ``[arr]`` in single-process runs. Every rank must pass the same shape
    and dtype."""
    import torch
    import torch.distributed as dist

    arr = np.asarray(arr)
    if process_count() == 1:
        return [arr]
    t = torch.from_numpy(np.ascontiguousarray(arr))
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t, group=_HOST_GROUP)
    return [p.numpy() for p in parts]


def host_allreduce_sum(arr):
    """Cross-process elementwise sum of a host numpy array (identity in
    single-process runs), in rank order: every rank gets the same bits."""
    parts = host_allgather(arr)
    out = parts[0].astype(np.float64, copy=True) if parts[0].dtype.kind == "f" else parts[0].copy()
    for p in parts[1:]:
        out = out + p
    return out


def host_barrier(name: str = "barrier") -> None:
    """Cross-process synchronization point (no-op in single-process runs).
    Used around shared-filesystem mutations (e.g. ``train --clean`` wiping a
    shared working directory) so no rank races past another's writes."""
    import torch.distributed as dist

    if process_count() == 1:
        return
    dist.barrier(group=_HOST_GROUP)


def host_allreduce_max(value: int) -> int:
    parts = host_allgather(np.array([value], np.int64))
    return int(max(int(p[0]) for p in parts))


def allgather_ragged_rows(rows):
    """All-gather a per-process 2-D int array with varying row counts;
    returns the list of per-process arrays. Rows are padded to the global
    max row count for the collective and trimmed back after."""
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows.reshape(-1, 1)
    n = rows.shape[0]
    n_max = host_allreduce_max(n)
    padded = np.zeros((n_max, rows.shape[1]), rows.dtype)
    padded[:n] = rows
    counts = host_allgather(np.array([n], np.int64))
    gathered = host_allgather(padded)
    return [g[: int(c[0])] for g, c in zip(gathered, counts)]


def host_allgather_object(obj) -> "list":
    """All-gather an arbitrary picklable host object across processes
    (length-prefixed bytes over the host group). Returns ``[obj]`` in
    single-process runs. Used for small host-side statistics that are dicts
    rather than arrays (e.g. pronunciation counts)."""
    if process_count() == 1:
        return [obj]
    payload = np.frombuffer(
        pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), np.uint8
    )
    lengths = host_allgather(np.array([payload.size], np.int64))
    max_len = int(max(int(l[0]) for l in lengths))
    padded = np.zeros(max_len, np.uint8)
    padded[: payload.size] = payload
    gathered = host_allgather(padded)
    return [
        pickle.loads(bytes(g[: int(l[0])]))
        for g, l in zip(gathered, lengths)
    ]


def shard_corpus_for_host(
    corpus, process_index: int, process_count: int
) -> List[int]:
    """Utterance ids this host owns: load-balanced over connected
    components of the speaker<->file graph.

    Two atomicity invariants drive the grouping: a speaker's utterances
    must stay host-local (per-speaker CMVN/fMLLR statistics never cross
    hosts), and a file's tiers must be exported by exactly one host (a
    multi-speaker TextGrid written by two hosts would be last-writer-wins
    with missing tiers). For file-per-speaker corpora (prosodylab layout)
    the components are exactly the speakers, matching the reference's
    speaker bin-packing (``corpus/base.py:994-1015``)."""
    parent: Dict = {}

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:  # path compression
            parent[x], x = root, parent[x]
        return root

    def union(a, b):
        for k in (a, b):
            if k not in parent:
                parent[k] = k
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    for utt in corpus.utterances:
        s = ("s", utt.speaker)
        fp = getattr(utt, "file_path", None)
        union(s, ("f", str(fp)) if fp is not None else s)
    # deterministic component labels: the lexicographically-first speaker
    # (shard_speakers_for_host sorts by them, so every host must agree)
    label: Dict = {}
    for utt in corpus.utterances:
        root = find(("s", utt.speaker))
        if root not in label or utt.speaker < label[root]:
            label[root] = utt.speaker
    counts: Dict[str, int] = defaultdict(int)
    for utt in corpus.utterances:
        counts[label[find(("s", utt.speaker))]] += 1
    # conversational corpora (one speaker across many files, multi-speaker
    # files chaining speakers) can collapse into one giant component,
    # leaving most hosts idle — surface that instead of stalling silently
    total = sum(counts.values())
    largest = max(counts.values(), default=0)
    if process_count > 1 and total and largest > total / process_count:
        _logger.warning(
            "host sharding: the largest speaker<->file component holds "
            "%d/%d utterances (> 1/%d of the corpus) — multi-speaker files "
            "chain speakers into one atomic unit, so scaling will be "
            "limited by it (consider splitting recordings per speaker)",
            largest, total, process_count,
        )
    mine = set(
        shard_speakers_for_host(dict(counts), process_index, process_count)
    )
    return [
        utt.id
        for utt in corpus.utterances
        if label[find(("s", utt.speaker))] in mine
    ]


def shard_corpus(corpus):
    """This rank's part of ``corpus`` and the original ids of its
    utterances, in corpus order: ``(corpus, ids)``; the corpus itself and
    every id on a single process."""
    n = process_count()
    if n == 1:
        return corpus, [u.id for u in corpus.utterances]
    ids = shard_corpus_for_host(corpus, process_index(), n)
    return corpus.subset(ids), ids


def _rank_main(fn, rank, world_size, init_method, backend, device, threads,
               out_path, args):
    """Body of one spawned rank (:func:`run_ranks`)."""
    import torch

    os.environ["LOCAL_RANK"] = str(rank)
    if threads:
        torch.set_num_threads(threads)
    initialize_multihost(init_method, world_size, rank, backend=backend,
                         device=device)
    try:
        result = fn(rank, world_size, *args)
        # every rank finishes its collectives before any leaves the group
        host_barrier("run_ranks_done")
    finally:
        shutdown_multihost()
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world_size: int, args=(), backend: Optional[str] = None,
              device="cpu", timeout: float = 600.0, threads: int = 0,
              workdir=None) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` processes
    started with ``torch.multiprocessing``'s spawn method and joined in one
    process group over a ``file://`` store (no port); returns each rank's
    return value, in rank order. ``fn`` must be importable (a module-level
    function). If a rank fails, or ``timeout`` seconds pass, every rank is
    killed and this raises. ``threads`` sets each rank's CPU threads."""
    import tempfile
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=workdir, prefix="ranks_") as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world_size)]
        procs = [
            ctx.Process(target=_rank_main, args=(
                fn, r, world_size, init, backend, device, threads, outs[r],
                tuple(args)))
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [p for p in procs if p.exitcode not in (None, 0)]
                if bad:
                    failed = f"rank exited with code {bad[0].exitcode}"
                    break
                if time.monotonic() > deadline:
                    failed = f"ranks still running after {timeout:.0f} s"
                    break
                time.sleep(0.05)
            if failed is None:
                bad = [p.exitcode for p in procs if p.exitcode != 0]
                if bad:
                    failed = f"rank exited with code {bad[0]}"
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        if failed is not None:
            raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, "
                               f"{world_size}): {failed}")
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results
