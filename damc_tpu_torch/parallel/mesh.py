"""Data parallelism over a `torch.distributed` group (counterpart of
`damc_tpu/parallel/mesh.py:1-80`).

The JAX package shards the chain and batch axis over the `data` axis of a
device mesh under one controller, or over the devices of several processes
joined by `jax.distributed`. The port has one model: one process per
device, all of them in one `torch.distributed` group (the default group),
so a `Mesh` is that group seen from one rank: its rank, the world size and
the rank's device.

A global array sharded over `data` is, here, each rank's rows of it: the
rows [rank * n / world, (rank + 1) * n / world) of a batch of n
(`batch_sharding`, `shard_batch`). What every rank holds alike (weights,
optimizer states, the draws made from the run seed) is replicated
(`replicate` broadcasts it from rank 0). Collectives on the card's tensors
are `all_reduce` and `broadcast` alone, which take CUDA tensors under
NCCL and under gloo: a gather is the all-reduce sum of a zeroed buffer in
which each rank has filled its own rows (`gather_rows`). No tensor goes
through the host on the way.

Serving is the one exception (`LocalMesh`): the JAX service spreads each
dispatch over the local devices of its one controller, and so does the
port's, over the devices a `LocalMesh` names, with no process group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

@dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel group."""

    rank: int
    world: int
    device: torch.device


@dataclass(frozen=True)
class LocalMesh:
    """Devices of this process over which one controller splits a batch
    into equal row blocks (the `data` axis of JAX's single-process mesh):
    serving's mesh (`serve.py::SamplerService(mesh=)`). A device may be
    named twice (two replicas sharing a card). Naming a CUDA device that
    this process does not have raises; so does an empty list."""

    devices: Tuple[torch.device, ...]

    def __init__(self, devices: Sequence):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a LocalMesh needs at least one device")
        for d in devs:
            if d.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(f"LocalMesh names {d}, but CUDA is not available")
                if (d.index or 0) >= torch.cuda.device_count():
                    raise RuntimeError(f"LocalMesh names {d}, but this process sees "
                                       f"{torch.cuda.device_count()} CUDA devices")
            elif d.type != "cpu":
                raise ValueError(f"LocalMesh takes cpu and cuda devices, not {d}")
        object.__setattr__(self, "devices", tuple(
            torch.device("cuda", d.index or 0) if d.type == "cuda" else d for d in devs))

    @property
    def world(self) -> int:
        return len(self.devices)

    @classmethod
    def cards(cls) -> "LocalMesh":
        """Every CUDA device this process sees."""
        return cls([torch.device("cuda", i) for i in range(torch.cuda.device_count())])

    def blocks(self, n: int) -> List[slice]:
        """The row block of each device in a batch of n (n must divide)."""
        if n % self.world:
            raise ValueError(f"a batch of {n} rows does not divide over {self.world} devices")
        local = n // self.world
        return [slice(i * local, (i + 1) * local) for i in range(self.world)]


def make_mesh(device) -> Mesh:
    """The mesh of the initialized default group, this rank on `device`."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed group "
                           "(parallel.distributed.initialize_distributed)")
    return Mesh(dist.get_rank(), dist.get_world_size(), torch.device(device))


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a batch of n: the row-slice rule of the `data`
    axis. n must divide over the world."""
    if n % mesh.world:
        raise ValueError(f"a batch of {n} rows does not divide over {mesh.world} ranks")
    local = n // mesh.world
    return slice(mesh.rank * local, (mesh.rank + 1) * local)


def shard_batch(mesh: Mesh, x):
    """This rank's rows of the global batch x (every rank holds x)."""
    return x[batch_sharding(mesh, x.shape[0])]


def pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """t with zero rows appended up to n rows (a batch that does not divide
    over the world is padded so; the pad rows are dropped again)."""
    return t if t.shape[0] == n else torch.cat([t, t.new_zeros((n - t.shape[0], *t.shape[1:]))])


def gather_rows(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's rows (`local`, the same shape on
    every rank): an all-reduce sum of a zeroed buffer in which this rank
    has written its rows. Adding zeros leaves every value as it was, so
    the gathered rows are the ranks' rows bit for bit."""
    n = local.shape[0]
    out = local.new_zeros((n * mesh.world, *local.shape[1:]))
    out[mesh.rank * n:(mesh.rank + 1) * n] = local
    dist.all_reduce(out)
    return out


def broadcast_object(mesh, obj):
    """Rank 0's picklable obj on every rank (obj itself without a mesh)."""
    if mesh is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=mesh.device)
    return box[0]


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


def replicate(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite `tensors` on every rank with rank 0's, in place: one
    broadcast a dtype, through a flat buffer."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = _flat(group)
            dist.broadcast(flat, src=0)
            _unflat_into(flat, group)


def all_mean(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor (float32, one dtype), through
    one all-reduce of a flat buffer. New tensors; the inputs are kept."""
    flat = _flat([t.detach() for t in tensors])
    dist.all_reduce(flat)
    flat /= mesh.world
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def all_max(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum of t over the ranks (a new tensor)."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out
