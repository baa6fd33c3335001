"""Sharding over ranks on ``torch.distributed`` (parity:
runlmc_tpu/parallel): the mesh helpers, the launcher, and the
collectives of the three layouts (``collectives.py``)."""

from runlmc_tpu_torch.parallel.launcher import (
    global_mesh,
    initialize,
    is_distributed,
)
from runlmc_tpu_torch.parallel.mesh import (
    Mesh,
    default_mesh,
    pad_batch,
    probe_grid_mesh,
    replicated,
    shard_batch,
)

__all__ = [
    "default_mesh",
    "probe_grid_mesh",
    "shard_batch",
    "pad_batch",
    "replicated",
    "initialize",
    "global_mesh",
    "is_distributed",
]
