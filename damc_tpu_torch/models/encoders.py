"""Image -> embedding conv encoders (counterpart of
`damc_tpu/models/encoders.py`: `encoder_spec`, `ConvEncoder`), and the toy
workload's MLP encoder (`MLPEncoder`).

Conv -> InstanceNorm2d(affine, eps 1e-5) -> LeakyReLU(0.2) triplets close
with a VALID conv to 1x1, reshaped to (B, nemb). The public input is NHWC;
the stack runs NCHW. Layers keep the reference torch layout: conv at
`net.{3i}`, norm at `net.{3i+1}`. Padding:
  * 'SAME' (3x3, stride 1) -> 1
  * an int (the stride-2 4x4 convs) -> that explicit pad on both sides
  * 'VALID' -> 0

`ConvEncoder(dtype=torch.bfloat16)` computes as flax's `dtype=bfloat16`
does (`models/common.py::promoted_forward`): each conv casts its input,
weight and bias to bfloat16, and each InstanceNorm is flax's
`GroupNorm(group_size=1, dtype=bfloat16)`, its statistics and affine in
float32 and its result in bfloat16. The embedding comes out in bfloat16;
the parameters stay float32.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch import nn

from .common import promoted_forward

# (features, kernel, stride, padding, normalize)
ConvLayer = Tuple[int, int, int, Union[str, int], bool]


def encoder_spec(dataset: str, nemb: int, nif: int) -> Tuple[ConvLayer, ...]:
    """Per-dataset conv stack."""
    if dataset in ("cifar10", "svhn"):  # 32 -> 32 -> 16 -> 8 -> 4 -> 1
        return (
            (nif, 3, 1, "SAME", True),
            (nif * 2, 4, 2, 1, True),
            (nif * 4, 4, 2, 1, True),
            (nif * 8, 4, 2, 1, True),
            (nemb, 4, 1, "VALID", False),
        )
    if dataset == "celeba64":  # 64 -> 64 -> 32 -> 16 -> 8 -> 4 -> 1
        return (
            (nif, 3, 1, "SAME", True),
            (nif * 2, 4, 2, 1, True),
            (nif * 4, 4, 2, 1, True),
            (nif * 8, 4, 2, 1, True),
            (nif * 8, 4, 2, 1, True),
            (nemb, 4, 1, "VALID", False),
        )
    if dataset == "celebaHQ":  # 256 -> ... -> 4 -> 1
        return (
            (nif, 3, 1, "SAME", True),
            (nif * 2, 4, 2, 1, True),
            (nif * 4, 4, 2, 1, True),
            (nif * 4, 4, 2, 1, True),
            (nif * 8, 4, 2, 1, True),
            (nif * 8, 4, 2, 1, True),
            (nif * 8, 4, 2, 1, True),
            (nemb, 4, 1, "VALID", False),
        )
    if dataset == "mnist":  # 28 -> 28 -> 14 -> 7 -> 3 -> 1
        return (
            (nif, 3, 1, "SAME", True),
            (nif * 2, 4, 2, 1, True),
            (nif * 4, 4, 2, 1, True),
            (nif * 8, 4, 2, 1, True),
            (nemb, 3, 1, "VALID", False),
        )
    raise ValueError(f"unknown dataset {dataset!r}")


def _torch_padding(kernel: int, padding: Union[str, int]) -> int:
    if isinstance(padding, int):
        return padding
    if padding == "VALID":
        return 0
    if padding == "SAME" and kernel % 2 == 1:
        return kernel // 2
    raise ValueError(f"unsupported padding {padding!r} for kernel {kernel}")


class ConvEncoder(nn.Module):
    """x (B, H, W, C) -> embedding (B, nemb), in `dtype`."""

    def __init__(self, nc: int, layers: Sequence[ConvLayer], nemb: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nemb = nemb
        self.dtype = dtype
        mods = []
        cin = nc
        for i, (features, kernel, stride, padding, normalize) in enumerate(layers):
            mods.append(nn.Conv2d(cin, features, kernel, stride, _torch_padding(kernel, padding)))
            if i < len(layers) - 1:
                mods.append(
                    nn.InstanceNorm2d(features, eps=1e-5, affine=True)
                    if normalize
                    else nn.Identity()
                )
                mods.append(nn.LeakyReLU(0.2))
            cin = features
        self.net = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        h = self.net(h) if self.dtype == torch.float32 else promoted_forward(self.net, h, self.dtype)
        return h.reshape(h.shape[0], self.nemb)


def make_encoder(dataset: str, nemb: int, nif: int, nc: int, dtype: torch.dtype = torch.float32) -> ConvEncoder:
    return ConvEncoder(nc, encoder_spec(dataset, nemb, nif), nemb, dtype)


class MLPEncoder(nn.Sequential):
    """The toy workload's encoder, x (B, in_dim) -> (B, nemb): in_dim ->
    128 -> 128 -> 128 -> nemb with ReLU (`damc_tpu/models/encoders.py:
    115-139`). Linears at `0`, `2`, `4`, `6`, the reference toy layout;
    torch-default init."""

    def __init__(self, nemb: int, in_dim: int = 2, width: int = 128, depth: int = 3):
        dims = (in_dim,) + (width,) * depth
        mods = []
        for a, b in zip(dims, dims[1:]):
            mods += [nn.Linear(a, b), nn.ReLU()]
        super().__init__(*mods, nn.Linear(width, nemb))
