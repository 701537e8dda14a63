"""DAMC amortizer Q (counterpart of `damc_tpu/models/amortizer.py`).

Bundles the conv encoder, the prior embedder and the latent denoiser, and
draws Q samples through the reverse-sweep kernel (`sample_q_per_item`).
Keys keep the reference `_netQ_U` layout: `encoder.net.*`, `prior_emb.0`,
`prior_emb.2`, `p.*`, and the reference's unused `xemb` (1, nxemb), held
here as a buffer so a reference-format state dict loads strictly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.cuda.fused_qsweep import denoiser_layer_params, fused_reverse_sweep
from ..ops.diffusion import step_coefficients, sweep_logsnr_grid
from .denoiser import LatentDenoiser
from .encoders import make_encoder


class PriorEmbedder(nn.Sequential):
    """Noise -> prior embedding: nz -> 128 -> LeakyReLU(0.01) -> nxemb."""

    def __init__(self, nz: int, nxemb: int, width: int = 128):
        super().__init__(nn.Linear(nz, width), nn.LeakyReLU(0.01), nn.Linear(width, nxemb))


class DAMCAmortizer(nn.Module):
    """Q: amortized sampler of p(z | x), and of p(z) when unconditioned."""

    def __init__(
        self,
        nz: int,
        nxemb: int = 1024,
        ntemb: int = 128,
        nf: int = 4,
        nif: int = 64,
        nc: int = 3,
        dataset: str = "cifar10",
        n_interval: int = 100,
        logsnr_min: float = -5.1,
        logsnr_max: float = 9.8,
        var_type: str = "large",
        with_noise: bool = True,
        residual: bool = True,
    ):
        super().__init__()
        if dataset in ("toy", "stylegan"):
            raise ValueError(f"dataset {dataset!r} is not ported yet")
        self.nz, self.nxemb = nz, nxemb
        self.n_interval = n_interval
        self.logsnr_min, self.logsnr_max = logsnr_min, logsnr_max
        self.var_type = var_type
        self.with_noise = with_noise
        self.encoder = make_encoder(dataset, nemb=nxemb, nif=nif, nc=nc)
        self.prior_emb = PriorEmbedder(nz, nxemb)
        self.p = LatentDenoiser(nz, nxemb, ntemb, nf=nf, residual=residual)
        self.register_buffer("xemb", torch.zeros(1, nxemb))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def prior_embed(self, noise: torch.Tensor) -> torch.Tensor:
        return self.prior_emb(noise)

    def denoise(self, z, logsnr, xemb):
        return self.p(z, logsnr, xemb)

    def step_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logsnr grid (n,), step coefficients (n, 6)) on `device`, both
        computed on the CPU."""
        n = self.n_interval
        grid, _ = sweep_logsnr_grid(n, self.logsnr_min, self.logsnr_max)
        coeffs = step_coefficients(n, self.logsnr_min, self.logsnr_max, self.var_type)
        return grid.to(device), coeffs.to(device)


@torch.no_grad()
def sample_q_per_item(
    amortizer: DAMCAmortizer,
    z_init: torch.Tensor,
    row_seeds: torch.Tensor,
    x: Optional[torch.Tensor] = None,
    emb_noise: Optional[torch.Tensor] = None,
    layers: Optional[Tuple[torch.Tensor, Sequence[Tuple[torch.Tensor, ...]]]] = None,
) -> torch.Tensor:
    """Q samples whose row i is a pure function of (z_init[i], row_seeds[i])
    and x[i] (posterior) or emb_noise[i] (prior).

    The n-step reverse sweep runs in the fused kernel with per-row counter
    noise. `layers` is `denoiser_layer_params(amortizer.p)`, which a caller
    that samples often computes once."""
    if x is not None:
        xemb = amortizer.encode(x)
    elif emb_noise is not None:
        xemb = amortizer.prior_embed(emb_noise)
    else:
        raise ValueError("sample_q_per_item needs x (posterior) or emb_noise (prior)")
    grid, coeffs = amortizer.step_tables(z_init.device)
    tables = amortizer.p.sample_tables(grid, xemb)
    fourier, layer_tuples = layers if layers is not None else denoiser_layer_params(amortizer.p)
    return fused_reverse_sweep(
        z_init, fourier, layer_tuples, tables["pre_x"], tables["pre_t"], coeffs,
        row_seeds=row_seeds, steps=amortizer.n_interval,
        with_noise=amortizer.with_noise, residual=amortizer.p.residual,
    )
