"""Deconv generators G: z (B, nz) -> x (B, H, W, nc) in [-1, 1].

Counterpart of `damc_tpu/models/generators.py` (`generator_spec`,
`DeconvGenerator`, `make_generator`, `ToyGenerator`). One spec table covers
the five image datasets; the toy workload's G is a small MLP. The stack runs NCHW on `nn.ConvTranspose2d`; the public output is
NHWC like the JAX package's. ConvTranspose2d layers sit at even indices of
`self.gen` (the reference torch layout `gen.0`, `gen.2`, ...), LeakyReLU(0.2)
between them and Tanh at the end.

`DeconvGenerator(dtype=torch.bfloat16)` computes as flax's `dtype=bfloat16`
does (`models/common.py::promoted_forward`): each layer casts its input,
weight and bias to bfloat16, so the activations, LeakyReLU and Tanh are
bfloat16 and so is the output, while the parameters and their gradients
stay float32. The toy's G stays float32, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .common import promoted_forward

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
    def __init__(self, nz: int, layers: Sequence[DeconvLayer], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
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
        x = z.reshape(z.shape[0], z.shape[1], 1, 1)
        x = self.gen(x) if self.dtype == torch.float32 else promoted_forward(self.gen, x, self.dtype)
        return x.permute(0, 2, 3, 1)  # NCHW -> NHWC


def make_generator(dataset: str, ngf: int, nc: int, nz: int, dtype: torch.dtype = torch.float32) -> DeconvGenerator:
    return DeconvGenerator(nz, generator_spec(dataset, ngf, nc), dtype)


class ToyGenerator(nn.Module):
    """The toy workload's frozen likelihood net, z (B, nz) -> x (B, 2):
    nz (2 in the preset) -> 128 -> 128 -> 128 -> 2 with ReLU (`damc_tpu/models/generators.py:
    204-224`). Linears at `net.0`, `net.2`, `net.4`, `net.6`, the
    reference toy `G` layout. `init_` draws weights from N(0, 0.2^2) and
    biases from N(0, 0.1^2); the toy never trains G."""

    def __init__(self, width: int = 128, in_dim: int = 2, out_dim: int = 2):
        super().__init__()
        dims = (in_dim, width, width, width)
        mods = []
        for a, b in zip(dims, dims[1:]):
            mods += [nn.Linear(a, b), nn.ReLU()]
        self.net = nn.Sequential(*mods, nn.Linear(width, out_dim))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> "ToyGenerator":
        for m in self.net:
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.2, generator=generator)
                m.bias.normal_(0.0, 0.1, generator=generator)
        return self

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.net(z)
