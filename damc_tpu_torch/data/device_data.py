"""Device-resident training batches (counterpart of
`damc_tpu/data/device_data.py::DeviceDataset`, the feed the JAX package's
`make_batch_source` picks for stores under the device budget).

The whole uint8 (or float32) NHWC store is copied to the device once. Each
batch is a gather from a fresh per-epoch permutation, drop-last (the
`n % batch_size` tail of every epoch is skipped), a per-sample horizontal
flip with probability 1/2, and uint8 -> [-1, 1] (x / 255 * 2 - 1, clamped),
all on the device. Permutations and flips come from a `torch.Generator` on
the device, in place of `jax.random`: the visit order differs from the JAX
feed's for the same seed; the invariants do not. That generator is seeded
with `data_seed(seed)`, a counter hash of the seed, and not with the seed
itself: a training state made from the same seed seeds its own device
generator with it (`train/state.py::create_state`), and two Philox
generators with one seed give one stream, so the flips would share bits
with the step's draws. The JAX package keeps the two apart the same way
(`PRNGKey(seed)` with `fold_in` here, a split of it for the state).
"""

from __future__ import annotations

import warnings
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.noise import counter_bits

# Stores larger than this take the host feed under data_placement "auto"
# (the JAX package's default, `damc_tpu/data/device_data.py:66`, kept
# although the H100 holds 80 GB; TrainConfig.data_device_budget_gb
# overrides it).
DEFAULT_DEVICE_BUDGET_BYTES = 8 << 30


def fits_device(images, budget_bytes: int = DEFAULT_DEVICE_BUDGET_BYTES) -> bool:
    """Can `images` take the device-resident path? A materialised uint8 or
    float32 (N, H, W, C) ndarray under the byte budget (a lazy
    batch-indexable dataset such as `LSUNImages` cannot be copied whole)."""
    return (
        isinstance(images, np.ndarray)
        and images.ndim == 4
        and images.dtype in (np.uint8, np.float32)
        and images.nbytes <= budget_bytes
    )


# Counter of the hash that gives the data seed: one no training iteration
# reaches, so it is none of the kernels' stream seeds (`train/step.py::stream_seeds`).
DATA_COUNTER = 0xFFFFFFFF


def data_seed(seed: int) -> int:
    """The seed of a dataset's generator for the run seed `seed`:
    fmix32 counter bits of (seed, `DATA_COUNTER`), in [0, 2^32)."""
    return int(counter_bits(torch.tensor([int(seed)]), DATA_COUNTER, 1)[0, 0])


class DeviceDataset:
    """`stream()` yields (batch (B, H, W, C) float32 in [-1, 1], indices (B,))
    forever, both on the device."""

    def __init__(
        self,
        images: np.ndarray,
        batch_size: int = 128,
        augment_flip: bool = False,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ):
        if not (isinstance(images, np.ndarray) and images.ndim == 4 and images.dtype in (np.uint8, np.float32)):
            raise ValueError(
                "DeviceDataset wants a uint8/float32 (N, H, W, C) ndarray, got "
                f"{getattr(images, 'dtype', type(images))} ndim={getattr(images, 'ndim', '?')}"
            )
        self.n = len(images)
        self.batch_size = int(batch_size)
        self.n_batches = self.n // self.batch_size
        if self.n_batches == 0:
            raise ValueError(f"no batches: {self.n} images < batch_size {batch_size} with drop_last")
        self.device = torch.device(device)
        with warnings.catch_warnings():
            # A read-only store (the image folders' memory-mapped .npy cache)
            # is only read: it goes to the device from its pages, with no
            # second host copy.
            warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
            self.data = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        self.augment_flip = augment_flip
        self.gen = torch.Generator(device=self.device).manual_seed(data_seed(seed))

    def __len__(self) -> int:
        return self.n_batches

    def _batch(self, idx: torch.Tensor) -> torch.Tensor:
        batch = self.data.index_select(0, idx).to(torch.float32)
        if self.data.dtype == torch.uint8:
            batch = torch.clamp(batch / 255.0 * 2.0 - 1.0, -1.0, 1.0)
        if self.augment_flip:
            flip = torch.rand(len(idx), generator=self.gen, device=self.device) < 0.5
            batch = torch.where(flip[:, None, None, None], batch.flip(2), batch)
        return batch

    def stream(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        bs = self.batch_size
        while True:
            perm = torch.randperm(self.n, generator=self.gen, device=self.device)
            for b in range(self.n_batches):
                idx = perm[b * bs:(b + 1) * bs]
                yield self._batch(idx), idx
