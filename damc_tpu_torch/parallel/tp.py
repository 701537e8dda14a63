"""Channel (tensor) parallelism for the large conv stacks (counterpart of
`damc_tpu/parallel/tp.py:27-83`).

The JAX package keeps a `model` axis for the one large component, the
StyleGAN-256 synthesis and encoder and VGG16, and shards the output
channels of their wide kernels over it with GSPMD: it annotates the
parameter leaves and lets XLA partition the layers. The policy: a leaf of
2 or more dims whose output-channel count is at least `min_channels` and
divides by the `model` size is sharded along that axis; everything else
(biases, norm scales, the leaves on a noise path) is replicated.

PyTorch has no GSPMD, so the port takes the policy and the placement
apart:

  * `channel_sharding_tree(mesh, module, min_channels)` applies the policy
    to a module's named parameters in torch layout. The output channel is
    dim 0 of an OIHW convolution or an (out, in) dense weight; a module
    whose parameter keeps it elsewhere says so in `out_channel_dims`
    (StyleGAN's fused up-convolution stores (3, 3, in, out), its constant
    (1, C, 4, 4)). For the StyleGAN networks this selects the leaves JAX's
    `channel_sharding_tree` selects, on the same weights.
  * `shard_params_channelwise(mesh, module, min_channels)` keeps, on each
    rank, its slice of every selected parameter and makes the module read
    the whole parameter through `gather_channels`: an autograd function
    whose forward is `gather_rows`' all-reduce of a zeroed buffer along the
    channel axis and whose backward is the rank's slice of the gradient.
    The gathered weight equals the replicated one bit for bit, so the
    sharded module is a drop-in for it, gradients included, whatever its
    forward does with the weight (a transposed dense kernel, a folded 4x4
    up-convolution, an expanded constant). What it saves is parameter and
    optimizer memory at rest, 1/n of the sharded leaves a rank; the layers'
    arithmetic is not split (GSPMD's is), and every read of a sharded
    parameter is one collective.

The port has no 2-D mesh: the ranks of the group (`parallel.Mesh`) are the
`model` axis; a data x model split is later work.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.utils import parametrize

from .mesh import Mesh


def channel_sharding_spec(mesh: Mesh, min_channels: int = 64) -> Callable[..., Optional[int]]:
    """The leaf rule: fn(tensor, dim=0) -> `dim`, the axis to shard the
    tensor along, or None to replicate it. A tensor of 2 or more dims is
    sharded when its size along `dim` is at least `min_channels` and
    divides by the mesh's ranks (the `model` axis), and the axis has more
    than one rank."""
    n_model = mesh.world

    def leaf(t: torch.Tensor, dim: int = 0) -> Optional[int]:
        if n_model > 1 and t.dim() >= 2:
            c = t.shape[dim]
            if c >= min_channels and c % n_model == 0:
                return dim % t.dim()
        return None

    return leaf


def _on_noise_path(name: str) -> bool:
    return "noise" in name


def out_channel_dim(module: nn.Module, name: str) -> int:
    """The output-channel axis of parameter `name` of `module`: its owner's
    `out_channel_dims[leaf]`, else 0."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    return getattr(owner, "out_channel_dims", {}).get(leaf, 0)


def channel_sharding_tree(mesh: Mesh, module: nn.Module, min_channels: int = 64) -> Dict[str, Optional[int]]:
    """{parameter name: the axis it is sharded along, or None} for every
    named parameter of `module`: output-channel sharding of the wide
    weights, everything on a noise path replicated (JAX's path rule)."""
    leaf = channel_sharding_spec(mesh, min_channels)
    return {
        name: None if _on_noise_path(name) else leaf(p, out_channel_dim(module, name))
        for name, p in module.named_parameters()
    }


class _GatherChannels(torch.autograd.Function):
    """The whole tensor from every rank's slice along `dim` (forward), the
    rank's slice of the gradient (backward)."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, rank: int, world: int, dim: int) -> torch.Tensor:
        n = local.shape[dim]
        ctx.rank, ctx.n, ctx.dim = rank, n, dim
        shape = list(local.shape)
        shape[dim] = n * world
        out = local.new_zeros(shape)
        out.narrow(dim, rank * n, n).copy_(local)
        dist.all_reduce(out)  # adding zeros: every rank's slice bit for bit
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None, None


def gather_channels(mesh: Mesh, local: torch.Tensor, dim: int) -> torch.Tensor:
    """The tensor whose slice along `dim` this rank holds as `local` (every
    rank a slice of the same size), differentiable: the gradient of the
    result reaches `local` as its slice."""
    return _GatherChannels.apply(local, mesh.rank, mesh.world, dim)


class _Gathered(nn.Module):
    """The parametrization of a sharded parameter: the whole tensor from
    this rank's slice."""

    def __init__(self, mesh: Mesh, dim: int):
        super().__init__()
        self.mesh, self.dim = mesh, dim

    def forward(self, local: torch.Tensor) -> torch.Tensor:
        return gather_channels(self.mesh, local, self.dim)


def shard_params_channelwise(mesh: Mesh, module: nn.Module, min_channels: int = 64) -> nn.Module:
    """Shard `module`'s wide parameters over the ranks in place
    (`channel_sharding_tree`) and return it: each rank keeps its slice of
    every selected parameter (a new leaf, with the parameter's
    requires_grad), and the module reads the whole parameter through
    `gather_channels` (module docstring). Every rank must run the same
    forward passes, since each read is a collective. A mesh of one rank
    shards nothing."""
    for name, dim in channel_sharding_tree(mesh, module, min_channels).items():
        if dim is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        full = getattr(owner, leaf)
        n = full.shape[dim] // mesh.world
        local = full.detach().narrow(dim, mesh.rank * n, n).clone()
        owner._parameters[leaf] = nn.Parameter(local, requires_grad=full.requires_grad)
        parametrize.register_parametrization(owner, leaf, _Gathered(mesh, dim), unsafe=True)
    return module
