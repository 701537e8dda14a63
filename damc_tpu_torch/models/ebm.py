"""Latent-space energy-based model E: z -> R (counterpart of
`damc_tpu/models/ebm.py`).

An MLP nz -> ndf (-> ndf)* -> nez with LeakyReLU(0.2): 2 hidden layers for
the image models, 3 for the StyleGAN variant. The Linear layers sit at even
indices of `self.ebm`, the reference torch layout (`ebm.0`, `ebm.2`, ...).
"""

from __future__ import annotations

import torch
from torch import nn


class LatentEBM(nn.Module):
    """Energy head over latents; returns per-sample energies (B,)."""

    def __init__(self, nz: int, ndf: int = 200, n_hidden: int = 2, nez: int = 1):
        super().__init__()
        self.nez = nez
        layers = []
        width = nz
        for _ in range(n_hidden):
            layers += [nn.Linear(width, ndf), nn.LeakyReLU(0.2)]
            width = ndf
        layers.append(nn.Linear(width, nez))
        self.ebm = nn.Sequential(*layers)

    @property
    def n_hidden(self) -> int:
        return len(self.ebm) // 2

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.ebm(z)
        return h.squeeze(-1) if self.nez == 1 else h
