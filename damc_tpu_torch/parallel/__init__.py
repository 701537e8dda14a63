"""Data parallelism over a torch.distributed group, serving over the
devices of one process, and channel parallelism (counterpart of
`damc_tpu/parallel`)."""

from .mesh import (
    LocalMesh, Mesh, all_max, all_mean, batch_sharding, broadcast_object, gather_rows, make_mesh, pad_rows, replicate,
    shard_batch,
)
from .tp import channel_sharding_spec, channel_sharding_tree, shard_params_channelwise

__all__ = [
    "LocalMesh", "Mesh", "all_max", "all_mean", "batch_sharding", "broadcast_object", "gather_rows", "make_mesh",
    "pad_rows", "replicate", "shard_batch", "channel_sharding_spec", "channel_sharding_tree",
    "shard_params_channelwise",
]
