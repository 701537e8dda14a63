"""Short-run Langevin samplers (counterpart of `damc_tpu/ops/langevin.py`).

`langevin_sample` runs unadjusted Langevin dynamics on any energy by
autograd: the posterior refinement of the `recon` serving path goes through
it (through G and E, on cuDNN), as the JAX package runs it through XLA.
`prior_langevin_auto` sends the EBM prior chain to the fused kernel K1
(`ops/cuda/fused_langevin.py`) when the EBM is the standard 2-hidden MLP.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .cuda.fused_langevin import ebm_params_to_dense_weights, fused_prior_langevin

# An energy maps a batch of latents (B, nz) to per-chain energies (B,).
EnergyFn = Callable[[torch.Tensor], torch.Tensor]


def langevin_sample(
    z_init: torch.Tensor,
    energy_fn: EnergyFn,
    steps: int,
    step_size: float,
    with_noise: bool = True,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """z <- z - 0.5 eps^2 dU/dz (+ eps N(0, I) with `with_noise`, drawn from
    `generator`). Returns the final z, detached."""
    z = z_init.detach()
    for _ in range(steps):
        z = z.detach().requires_grad_(True)
        with torch.enable_grad():
            (grad,) = torch.autograd.grad(energy_fn(z).sum(), z)
        z = z.detach() - 0.5 * step_size * step_size * grad
        if with_noise:
            z = z + step_size * torch.randn(
                z.shape, generator=generator, device=z.device, dtype=z.dtype
            )
    return z.detach()


def prior_energy(ebm_fn: Callable[[torch.Tensor], torch.Tensor]) -> EnergyFn:
    """U(z) = E(z) + 0.5 ||z||^2, the tilted-Gaussian EBM prior."""

    def energy(z):
        en = ebm_fn(z).reshape(z.shape[0], -1).sum(dim=-1)
        return en + 0.5 * torch.sum(z * z, dim=-1)

    return energy


def posterior_energy(gen_fn, ebm_fn, x: torch.Tensor, llhd_sigma: float) -> EnergyFn:
    """U(z) = ||G(z) - x||^2 / (2 sigma^2) + E(z) + 0.5 ||z||^2."""
    inv_two_sigma2 = 1.0 / (2.0 * llhd_sigma * llhd_sigma)

    def energy(z):
        recon = torch.sum((gen_fn(z) - x).reshape(z.shape[0], -1) ** 2, dim=-1) * inv_two_sigma2
        en = ebm_fn(z).reshape(z.shape[0], -1).sum(dim=-1)
        return recon + en + 0.5 * torch.sum(z * z, dim=-1)

    return energy


def prior_langevin_auto(
    z_init: torch.Tensor,
    ebm,
    steps: int,
    step_size: float,
    with_noise: bool = True,
    row_seeds: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prior-Langevin chain; returns (z_final, final energy per chain).

    The standard 2-hidden `LatentEBM` runs in the fused chain kernel, with
    per-row counter noise when `row_seeds` is given. Another EBM (the
    3-hidden StyleGAN head) runs `langevin_sample` by autograd, with noise
    from `generator`, and cannot honour `row_seeds`."""
    if ebm.n_hidden == 2 and ebm.nez == 1:
        with torch.no_grad():
            z = fused_prior_langevin(
                z_init, *ebm_params_to_dense_weights(ebm), row_seeds=row_seeds,
                steps=steps, step_size=float(step_size), with_noise=with_noise,
            )
    else:
        if row_seeds is not None:
            raise ValueError("row_seeds (per-row counter noise) needs the fused 2-hidden EBM chain")
        z = langevin_sample(z_init, prior_energy(ebm), steps, step_size, with_noise, generator)
    with torch.no_grad():
        final_energy = prior_energy(ebm)(z)
    return z, final_energy
