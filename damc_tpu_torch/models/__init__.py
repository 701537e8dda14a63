"""PyTorch model zoo of the port: generator, EBM, encoder, denoiser, amortizer,
and the StyleGAN inversion stack (`models/stylegan.py`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from ..config import Config
from ..device import resolve_device
from .amortizer import DAMCAmortizer, PriorEmbedder, sample_q, sample_q_per_item, sweep_route
from .common import cast_float_leaves, compute_dtype, torch_default_init_
from .denoiser import ConcatSquashLinear, LatentDenoiser, SinusoidalTimeEmbedding
from .ebm import LatentEBM
from .encoders import ConvEncoder, MLPEncoder, encoder_spec, make_encoder
from .generators import DeconvGenerator, ToyGenerator, generator_spec, make_generator
from .stylegan import (
    StyleGANEncoder, StyleGANGenerator, StyleGANNets, VGG16Features, build_stylegan, generator_apply,
    load_stylegan, sample_w_codes,
)


@dataclass
class ModelBundle:
    generator: Union[DeconvGenerator, ToyGenerator]
    ebm: Optional[LatentEBM]  # None for the toy workload
    amortizer: DAMCAmortizer

    def modules(self):
        return [m for m in (self.generator, self.ebm, self.amortizer) if m is not None]


def build_models(
    cfg: Config,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    trainable: bool = False,
) -> ModelBundle:
    """Models of `cfg` with random torch-default weights drawn from a
    `torch.Generator` seeded with `seed`, on `device` (default CUDA; raises
    if it is missing). Weights are drawn on the CPU, so a seed gives the
    same weights on every device.

    Frozen in eval mode by default (serving); `trainable=True` gives train
    mode with parameters that require grad. No module here computes
    differently in the two modes: there is no dropout, and InstanceNorm2d
    keeps no running statistics (track_running_stats=False). The toy
    workload has no EBM, and its G (`ToyGenerator`) takes its own normal
    init from the same generator.

    `cfg.model.compute_dtype` ("float32" or "bfloat16") is the compute
    dtype of G and the conv encoder (`damc_tpu/train/state.py:102-130`);
    the EBM, Q's denoiser and every parameter stay float32, and the toy's
    G and encoder compute in float32 whatever it says."""
    dev = resolve_device(device)
    m, d = cfg.model, cfg.diffusion
    toy = m.dataset == "toy"
    dtype = compute_dtype(m.compute_dtype)
    with torch.device("meta"):
        generator = ToyGenerator(in_dim=m.nz) if toy else make_generator(
            m.dataset, ngf=m.ngf, nc=m.nc, nz=m.nz, dtype=dtype)
        ebm = None if toy else LatentEBM(m.nz, ndf=m.ndf)
        amortizer = DAMCAmortizer(
            nz=m.nz, nxemb=m.nxemb, ntemb=m.ntemb, nf=m.nf, nif=m.nif, nc=m.nc,
            dataset=m.dataset, n_interval=d.n_interval, logsnr_min=d.logsnr_min,
            logsnr_max=d.logsnr_max, var_type=d.var_type, with_noise=d.with_noise,
            residual=d.residual, encoder_dtype=dtype,
        )
    gen = torch.Generator().manual_seed(int(seed))
    bundle = ModelBundle(generator=generator, ebm=ebm, amortizer=amortizer)
    for module in bundle.modules():
        module.to_empty(device="cpu")
        if isinstance(module, ToyGenerator):
            module.init_(gen)
        else:
            torch_default_init_(module, gen)
    with torch.no_grad():
        amortizer.p.B.normal_(generator=gen)
        amortizer.xemb.zero_()
    for module in bundle.modules():
        module.to(dev).train(trainable).requires_grad_(trainable)
    return bundle


__all__ = [
    "ModelBundle",
    "build_models",
    "DAMCAmortizer",
    "PriorEmbedder",
    "cast_float_leaves",
    "compute_dtype",
    "sample_q",
    "sample_q_per_item",
    "sweep_route",
    "ConcatSquashLinear",
    "LatentDenoiser",
    "SinusoidalTimeEmbedding",
    "LatentEBM",
    "ConvEncoder",
    "MLPEncoder",
    "encoder_spec",
    "make_encoder",
    "DeconvGenerator",
    "ToyGenerator",
    "generator_spec",
    "make_generator",
    "StyleGANEncoder",
    "StyleGANGenerator",
    "StyleGANNets",
    "VGG16Features",
    "build_stylegan",
    "generator_apply",
    "load_stylegan",
    "sample_w_codes",
]
