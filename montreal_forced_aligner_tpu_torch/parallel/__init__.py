"""Multi-GPU on ``torch.distributed``: the device layout (``mesh``), the
process group, corpus sharding and host collectives (``multihost``), the
ordered reduction of statistics over ranks (``data_parallel``), the
weak-scaling report (``scaling``) and the dry run of the product path
(``dryrun``)."""

from montreal_forced_aligner_tpu_torch.parallel.mesh import (
    Mesh,
    get_mesh,
    replicated,
    shard_leading_axis,
)
from montreal_forced_aligner_tpu_torch.parallel.data_parallel import (
    make_sharded_accumulate_step,
    make_sharded_fmllr_stats_step,
    ordered_allreduce,
)

__all__ = [
    "Mesh",
    "get_mesh",
    "replicated",
    "shard_leading_axis",
    "make_sharded_accumulate_step",
    "make_sharded_fmllr_stats_step",
    "ordered_allreduce",
]
