"""Deconv generators G: z (B, nz) -> x (B, H, W, nc) in [-1, 1].

Counterpart of `damc_tpu/models/generators.py` (`generator_spec`,
`DeconvGenerator`, `make_generator`). One spec table covers the five
datasets. The stack runs NCHW on `nn.ConvTranspose2d`; the public output is
NHWC like the JAX package's. ConvTranspose2d layers sit at even indices of
`self.gen` (the reference torch layout `gen.0`, `gen.2`, ...), LeakyReLU(0.2)
between them and Tanh at the end.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

# (features, kernel, stride, padding)
DeconvLayer = Tuple[int, int, int, str]


def generator_spec(dataset: str, ngf: int, nc: int) -> Tuple[DeconvLayer, ...]:
    """Per-dataset deconv stack."""
    if dataset == "cifar10":  # 1 -> 8 -> 16 -> 32 -> 32
        return (
            (ngf * 8, 8, 1, "VALID"),
            (ngf * 4, 4, 2, "SAME"),
            (ngf * 2, 4, 2, "SAME"),
            (nc, 3, 1, "SAME"),
        )
    if dataset == "svhn":  # 1 -> 4 -> 8 -> 16 -> 32
        return (
            (ngf * 8, 4, 1, "VALID"),
            (ngf * 4, 4, 2, "SAME"),
            (ngf * 2, 4, 2, "SAME"),
            (nc, 4, 2, "SAME"),
        )
    if dataset == "celeba64":  # 1 -> 4 -> 8 -> 16 -> 32 -> 64
        return (
            (ngf * 8, 4, 1, "VALID"),
            (ngf * 4, 4, 2, "SAME"),
            (ngf * 2, 4, 2, "SAME"),
            (ngf, 4, 2, "SAME"),
            (nc, 4, 2, "SAME"),
        )
    if dataset == "celebaHQ":  # 1 -> 4 -> ... -> 256
        return (
            (ngf * 16, 4, 1, "VALID"),
            (ngf * 8, 4, 2, "SAME"),
            (ngf * 4, 4, 2, "SAME"),
            (ngf * 4, 4, 2, "SAME"),
            (ngf * 2, 4, 2, "SAME"),
            (ngf, 4, 2, "SAME"),
            (nc, 4, 2, "SAME"),
        )
    if dataset == "mnist":  # 1 -> 7 -> 14 -> 28 -> 28
        return (
            (ngf * 8, 7, 1, "VALID"),
            (ngf * 4, 4, 2, "SAME"),
            (ngf * 2, 4, 2, "SAME"),
            (nc, 3, 1, "SAME"),
        )
    raise ValueError(f"unknown dataset {dataset!r}")


def _torch_padding(kernel: int, stride: int, padding: str) -> int:
    """'VALID' -> 0; 'SAME' (output = stride x input) -> (k - s) / 2."""
    if padding == "VALID":
        return 0
    if (kernel - stride) % 2:
        raise ValueError(f"no symmetric SAME padding for k={kernel}, s={stride}")
    return (kernel - stride) // 2


class DeconvGenerator(nn.Module):
    def __init__(self, nz: int, layers: Sequence[DeconvLayer]):
        super().__init__()
        mods = []
        cin = nz
        for i, (features, kernel, stride, padding) in enumerate(layers):
            mods.append(
                nn.ConvTranspose2d(
                    cin, features, kernel, stride, _torch_padding(kernel, stride, padding)
                )
            )
            mods.append(nn.LeakyReLU(0.2) if i < len(layers) - 1 else nn.Tanh())
            cin = features
        self.gen = nn.Sequential(*mods)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.gen(z.reshape(z.shape[0], z.shape[1], 1, 1))
        return x.permute(0, 2, 3, 1)  # NCHW -> NHWC


def make_generator(dataset: str, ngf: int, nc: int, nz: int) -> DeconvGenerator:
    return DeconvGenerator(nz, generator_spec(dataset, ngf, nc))
