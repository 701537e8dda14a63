"""Torch-default initialization drawn from an explicit generator.

PyTorch's default Linear/Conv init (kaiming-uniform with a=sqrt(5)) is
U(+-1/sqrt(fan_in)) for kernel and bias, with fan_in taken from the
weight's second axis times the kernel area: in_features for Linear and
Conv2d, out_channels for ConvTranspose2d (whose weight is (in, out, kh, kw)).
The JAX package reproduces this distribution (`damc_tpu/models/common.py`);
here it is drawn again from a caller's `torch.Generator`, so a seed fixes
the weights and no global RNG is touched.
"""

from __future__ import annotations

import math

import torch
from torch import nn

_LAYERS = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)


def _fan_in(weight: torch.Tensor) -> int:
    return weight.shape[1] * math.prod(weight.shape[2:])


@torch.no_grad()
def torch_default_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every Linear/Conv weight and bias of `module` in place from
    U(+-1/sqrt(fan_in)); affine norms get scale 1 and bias 0."""
    for m in module.modules():
        if isinstance(m, _LAYERS):
            bound = 1.0 / math.sqrt(_fan_in(m.weight))
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.InstanceNorm2d) and m.affine:
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
    return module
