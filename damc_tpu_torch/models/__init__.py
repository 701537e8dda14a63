"""PyTorch model zoo of the port: generator, EBM, encoder, denoiser, amortizer."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch

from ..config import Config
from ..device import resolve_device
from .amortizer import DAMCAmortizer, PriorEmbedder, sample_q_per_item
from .common import torch_default_init_
from .denoiser import ConcatSquashLinear, LatentDenoiser, SinusoidalTimeEmbedding
from .ebm import LatentEBM
from .encoders import ConvEncoder, encoder_spec, make_encoder
from .generators import DeconvGenerator, generator_spec, make_generator


@dataclass
class ModelBundle:
    generator: DeconvGenerator
    ebm: Optional[LatentEBM]
    amortizer: DAMCAmortizer

    def modules(self):
        return [m for m in (self.generator, self.ebm, self.amortizer) if m is not None]


def build_models(
    cfg: Config, seed: int = 0, device: Optional[Union[str, torch.device]] = None
) -> ModelBundle:
    """Models of `cfg` with random torch-default weights drawn from a
    `torch.Generator` seeded with `seed`, on `device` (default CUDA; raises
    if it is missing). Weights are drawn on the CPU, so a seed gives the
    same weights on every device."""
    dev = resolve_device(device)
    m, d = cfg.model, cfg.diffusion
    if m.dataset == "toy":
        raise ValueError("the toy workload is not ported yet")
    with torch.device("meta"):
        generator = make_generator(m.dataset, ngf=m.ngf, nc=m.nc, nz=m.nz)
        ebm = LatentEBM(m.nz, ndf=m.ndf)
        amortizer = DAMCAmortizer(
            nz=m.nz, nxemb=m.nxemb, ntemb=m.ntemb, nf=m.nf, nif=m.nif, nc=m.nc,
            dataset=m.dataset, n_interval=d.n_interval, logsnr_min=d.logsnr_min,
            logsnr_max=d.logsnr_max, var_type=d.var_type, with_noise=d.with_noise,
            residual=d.residual,
        )
    gen = torch.Generator().manual_seed(int(seed))
    bundle = ModelBundle(generator=generator, ebm=ebm, amortizer=amortizer)
    for module in bundle.modules():
        module.to_empty(device="cpu")
        torch_default_init_(module, gen)
    with torch.no_grad():
        amortizer.p.B.normal_(generator=gen)
        amortizer.xemb.zero_()
    for module in bundle.modules():
        module.to(dev).eval().requires_grad_(False)
    return bundle


__all__ = [
    "ModelBundle",
    "build_models",
    "DAMCAmortizer",
    "PriorEmbedder",
    "sample_q_per_item",
    "ConcatSquashLinear",
    "LatentDenoiser",
    "SinusoidalTimeEmbedding",
    "LatentEBM",
    "ConvEncoder",
    "encoder_spec",
    "make_encoder",
    "DeconvGenerator",
    "generator_spec",
    "make_generator",
]
