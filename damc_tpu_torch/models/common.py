"""Torch-default initialization drawn from an explicit generator, and the
compute-dtype helpers.

PyTorch's default Linear/Conv init (kaiming-uniform with a=sqrt(5)) is
U(+-1/sqrt(fan_in)) for kernel and bias, with fan_in taken from the
weight's second axis times the kernel area: in_features for Linear and
Conv2d, out_channels for ConvTranspose2d (whose weight is (in, out, kh, kw)).
The JAX package reproduces this distribution (`damc_tpu/models/common.py`);
here it is drawn again from a caller's `torch.Generator`, so a seed fixes
the weights and no global RNG is touched.

Compute dtype: `compute_dtype` maps a config's dtype name to a torch dtype;
`promoted_forward` runs a conv stack as flax runs it with `dtype=bfloat16`
(`flax.linen.dtypes.promote_dtype`); `cast_float_leaves` is the port's
counterpart of `damc_tpu/utils/placement.py::cast_float_leaves`, for
running a frozen module in bfloat16 through `torch.func.functional_call`
while its own parameters stay float32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

_LAYERS = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)


def _fan_in(weight: torch.Tensor) -> int:
    return weight.shape[1] * math.prod(weight.shape[2:])


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's `compute_dtype` name."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {tuple(COMPUTE_DTYPES)}, got {name!r}")
    return COMPUTE_DTYPES[name]


def instance_norm_fp32_stats(x: torch.Tensor, norm: nn.InstanceNorm2d) -> torch.Tensor:
    """flax's GroupNorm(group_size=1) on a low-precision x (NCHW): mean and
    variance (E[x^2] - E[x]^2, clipped at 0) of the float32 upcast, the
    normalisation and affine in float32, the result in x's dtype
    (`flax.linen.normalization._compute_stats` and `_normalize`)."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = torch.clamp_min((x32 * x32).mean(dim=(2, 3), keepdim=True) - mean * mean, 0.0)
    c = (1, -1, 1, 1)
    mul = torch.rsqrt(var + norm.eps) * norm.weight.view(c)
    return ((x32 - mean) * mul + norm.bias.view(c)).to(x.dtype)


def promoted_forward(stack: nn.Sequential, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`stack` (convs, transposed convs, InstanceNorm2d, LeakyReLU, Tanh,
    Identity) on x in `dtype`, computed where flax's layers with that
    `dtype` compute: each conv casts its input, weight and bias to dtype
    and adds the bias after the convolution, in dtype; LeakyReLU multiplies
    by its slope rounded to dtype; InstanceNorm takes its statistics in
    float32 (`instance_norm_fp32_stats`). The parameters stay float32 and
    take their gradients through the casts."""
    x = x.to(dtype)
    for m in stack:
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight.to(dtype)
            if isinstance(m, nn.Conv2d):
                x = F.conv2d(x, w, None, m.stride, m.padding, m.dilation, m.groups)
            else:
                x = F.conv_transpose2d(x, w, None, m.stride, m.padding, m.output_padding, m.groups, m.dilation)
            x = x + m.bias.to(dtype).view(1, -1, 1, 1)
        elif isinstance(m, nn.LeakyReLU):
            x = torch.where(x >= 0, x, x * torch.tensor(m.negative_slope, dtype=dtype, device=x.device))
        elif isinstance(m, nn.InstanceNorm2d):
            x = instance_norm_fp32_stats(x, m)
        elif isinstance(m, (nn.Tanh, nn.Identity)):
            x = m(x)
        else:
            raise TypeError(f"promoted_forward does not take {type(m).__name__}")
    return x


def cast_float_leaves(module: nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of `module` by name, the floating-point
    ones cast to `dtype`, for `torch.func.functional_call(module, leaves,
    args)`. The casts stay on the autograd graph; the module itself is not
    changed."""
    leaves = dict(module.named_parameters())
    leaves.update(module.named_buffers())
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in leaves.items()}


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
