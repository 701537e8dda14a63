"""Starting the process group (counterpart of
`damc_tpu/parallel/distributed.py:17-71`).

JAX joins processes with `jax.distributed.initialize`, from a TPU pod's
environment or from an explicit coordinator. Here one process runs one
rank, and the group starts from

  * torchrun's environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
    `MASTER_ADDR`, `MASTER_PORT`): `--use_mesh`; a process with no such
    environment, or a world of 1, is the single-device run;
  * an explicit coordinator (`--coordinator_address host:port`,
    `--num_processes`, `--process_id`), a `tcp://` rendezvous: `--multihost`.
    As in the JAX package, an explicit setup that fails raises: it is
    never taken for a single process.

The transport is named by the caller (`--dist_backend`): `nccl`, or `gloo`,
which also runs on the CPU and lets several ranks share one card. It is
never switched: ranks that would share a card under `nccl` (which refuses
that) raise, naming `gloo`.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, gather_rows, make_mesh

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 600


def default_backend(device) -> str:
    """`nccl` for a CUDA device, `gloo` for the CPU: the default of
    `--dist_backend`."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """The device of this rank: for CUDA, card LOCAL_RANK (torchrun's index
    of this process among its machine's ranks; 0 without it) modulo the
    machine's cards, so that ranks beyond the card count share cards (which
    only `gloo` allows); the CPU as it is."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count())


def _card_id(dev: torch.device) -> str:
    return f"{socket.gethostname()}/{torch.cuda.get_device_properties(dev).uuid}"


def _refuse_shared_cards(store, rank: int, world: int, card: str) -> None:
    """Publish this rank's card through the rendezvous store and raise, on
    every rank, when two ranks hold one card (nccl refuses that)."""
    store.set(f"damc/card/{rank}", card)
    cards = [store.get(f"damc/card/{r}").decode() for r in range(world)]
    if len(set(cards)) < world:
        raise ValueError(
            f"{world} ranks on {len(set(cards))} cards: nccl refuses two ranks on one card; "
            "run them with --dist_backend gloo, or start one rank a card"
        )


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the default process group; a no-op when it is joined already
    or when this is a single process (no explicit coordinator, and
    torchrun's WORLD_SIZE unset or 1).

    `backend` ("nccl" or "gloo", default `default_backend(device)`) is the
    transport; `timeout_s` bounds the rendezvous and every collective, so
    a rank that dies fails its peers instead of hanging them. Raises when
    an explicit coordinator cannot be reached, when process_id is not
    below num_processes, for `nccl` on the CPU, and when ranks would share
    a card under `nccl`."""
    if dist.is_initialized():
        return
    backend = backend or default_backend(device)
    if backend not in BACKENDS:
        raise ValueError(f"dist backend must be one of {BACKENDS}, got {backend!r}")
    explicit = coordinator_address is not None or num_processes is not None
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs --coordinator_address, --num_processes "
                             "and --process_id")
        host, port = coordinator_address.rsplit(":", 1)
        world, rank = int(num_processes), int(process_id)
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world == 1:
            return
        host, port = os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"]
        rank = int(os.environ["RANK"])
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} is not below the process count {world}")
    dev = rank_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs CUDA devices, not {dev}; use --dist_backend gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0, timeout=timeout)
    if backend == "nccl":
        _refuse_shared_cards(store, rank, world, _card_id(dev))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world, timeout=timeout)


def world_size() -> int:
    """The ranks of the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(device) -> Mesh:
    """The mesh over every rank of the group, this rank on its device."""
    return make_mesh(rank_device(device))


def make_global_batch(mesh: Mesh, host_batch: np.ndarray) -> torch.Tensor:
    """The global batch, on every rank, from each rank's local rows
    (`host_batch`, global = local * world), on the rank's device."""
    return gather_rows(mesh, torch.as_tensor(host_batch).to(mesh.device))


def shutdown_distributed() -> None:
    """Leave the group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
