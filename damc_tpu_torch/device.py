"""Device choice and numerics shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is wanted and missing, rather than falling
    back to the CPU.

    Also pins the numerics the parity and determinism contracts need: no
    TF32 in float32 matmuls or convolutions (the JAX sweep runs its products
    at full fp32), and deterministic cuDNN algorithms chosen without
    benchmarking, so a row's result is the same in every batch."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain versions on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return dev
