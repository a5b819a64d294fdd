"""Device layout of a multi-GPU run.

Counterpart of ``montreal_forced_aligner_tpu/parallel/mesh.py``. The JAX
package runs one SPMD program over a ``jax.sharding.Mesh`` whose "data" axis
spans every chip. Here the unit is the rank: one process drives one card
(``cuda:{LOCAL_RANK}``), owns a shard of the corpus, and reduces statistics
with the other ranks through ``torch.distributed``
(``parallel/data_parallel.py``). A single process without a process group
may still hold several local devices: the aligner places its batches on them
round-robin (``AlignerConfig.devices``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


def rank_device(device="cuda", backend: Optional[str] = None) -> torch.device:
    """This rank's device: the CPU for CPU runs; ``cuda:{LOCAL_RANK}`` on
    cards. Under NCCL a rank whose ``LOCAL_RANK`` has no card raises (NCCL
    serves one card a rank); under gloo, which the caller names to let ranks
    share cards, ranks map onto the cards round-robin."""
    from montreal_forced_aligner_tpu_torch.device import resolve_device
    from montreal_forced_aligner_tpu_torch.parallel.multihost import (
        local_rank,
        resolve_backend,
    )

    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    if dev.index is not None:
        return dev
    lr = local_rank()
    n = torch.cuda.device_count()
    if resolve_backend(backend, dev) == "nccl":
        if lr >= n:
            raise RuntimeError(
                f"LOCAL_RANK {lr} has no card ({n} visible): NCCL runs one "
                "rank a card; name the gloo backend "
                "(MFA_TPU_TORCH_DIST_BACKEND=gloo) to share cards"
            )
        return torch.device("cuda", lr)
    return torch.device("cuda", lr % n)


@dataclass(frozen=True)
class Mesh:
    """The devices this process drives, and its place among the ranks."""

    devices: Tuple[torch.device, ...]
    rank: int = 0
    world_size: int = 1

    @property
    def device(self) -> torch.device:
        """The process's first (for a rank, its only) device."""
        return self.devices[0]


def get_mesh(devices: Optional[Sequence] = None, device="cuda") -> Mesh:
    """The layout of this process. Under an initialised process group: its
    rank's device (``rank_device``) and its rank. Otherwise one process over
    ``devices`` (default: every visible card, or the CPU for
    ``device="cpu"``)."""
    import torch.distributed as dist

    if dist.is_initialized():
        backend = dist.get_backend()
        dev = (torch.device(devices[0]) if devices
               else rank_device(device, backend=backend))
        return Mesh((dev,), dist.get_rank(), dist.get_world_size())
    if devices:
        return Mesh(tuple(torch.device(d) for d in devices))
    from montreal_forced_aligner_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return Mesh(tuple(torch.device("cuda", i)
                          for i in range(torch.cuda.device_count())))
    return Mesh((dev,))


def _tree_map(fn, tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_leading_axis(mesh: Mesh, tree):
    """This rank's rows of every array in ``tree`` (the utterance-batch
    axis split into ``world_size`` equal blocks, in rank order): tensors on
    its device, host arrays (a graph's label fields) on the host. The
    leading axis must divide evenly over the ranks."""

    def take(x):
        n = x.shape[0]
        if n % mesh.world_size:
            raise ValueError(f"{n} rows do not split over {mesh.world_size} "
                             "ranks; pad the batch")
        b = n // mesh.world_size
        part = x[mesh.rank * b:(mesh.rank + 1) * b]
        return part.to(mesh.device) if isinstance(part, torch.Tensor) else part

    return _tree_map(take, tree)


def replicated(mesh: Mesh, tree):
    """Every array in ``tree`` whole on this rank's device."""
    import numpy as np

    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(mesh.device) if isinstance(x, torch.Tensor) else x

    return _tree_map(put, tree)
