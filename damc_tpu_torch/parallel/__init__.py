"""Data parallelism over a torch.distributed group (counterpart of
`damc_tpu/parallel`)."""

from .mesh import (
    Mesh, all_max, all_mean, batch_sharding, broadcast_object, gather_rows, make_mesh, pad_rows, replicate,
    shard_batch,
)

__all__ = [
    "Mesh", "all_max", "all_mean", "batch_sharding", "broadcast_object", "gather_rows", "make_mesh",
    "pad_rows", "replicate", "shard_batch",
]
