"""Short-run Langevin samplers (counterpart of `damc_tpu/ops/langevin.py`).

`langevin_sample` runs unadjusted Langevin dynamics on any energy by
autograd: the posterior refinement of the `recon` serving path and of the
training step goes through it (through G and E, on cuDNN), as the JAX
package runs it through XLA. `prior_langevin_auto` sends the EBM prior chain
to the fused kernel K1 (`ops/cuda/fused_langevin.py`) when the EBM is the
standard 2-hidden MLP and `use_pallas` is on (JAX's switch name), else to
`langevin_sample`; with a `parallel.Mesh` the kernel is K4a, the chains
split over the ranks (`fused_prior_langevin_sharded`). `adam_latent_descent`
is the StyleGAN inversion's Adam refinement of latents.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .cuda.fused_langevin import (
    ebm_params_to_dense_weights, fused_prior_langevin, fused_prior_langevin_sharded,
)

# An energy maps a batch of latents (B, nz) to per-chain energies (B,).
EnergyFn = Callable[[torch.Tensor], torch.Tensor]


class LangevinDiagnostics(NamedTuple):
    """Per-step chain statistics, shape (steps,), left on the device.

    energy_sum[k] is the summed energy of the chain state *before* update k,
    so energy_sum[-1] is the energy of z_{K-1}, not of the returned z_K."""

    energy_sum: torch.Tensor
    grad_mean: torch.Tensor  # mean of the energy gradient's entries


@contextlib.contextmanager
def frozen(*modules: Optional[torch.nn.Module]):
    """No parameter of `modules` requires grad inside the block, so a
    chain's autograd records the graph to z only; each parameter's flag
    comes back after."""
    params = [p for m in modules if m is not None for p in m.parameters()]
    flags = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, f in zip(params, flags):
            p.requires_grad_(f)


def langevin_sample(
    z_init: torch.Tensor,
    energy_fn: EnergyFn,
    steps: int,
    step_size: float,
    with_noise: bool = True,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, LangevinDiagnostics]:
    """z <- z - 0.5 eps^2 dU/dz (+ eps N(0, I) with `with_noise`).

    The per-step normals are `noise[k]` when `noise` (steps, B, nz) is
    given, else drawn from `generator`. The gradient is taken with respect
    to z only; parameters that require grad would record their graph too,
    so callers freeze the networks first (`frozen`). Returns the
    final z, detached, and the diagnostics."""
    # 0.5 eps^2 in float32, as the JAX step computes it from a float32 eps.
    eps32 = np.float32(step_size)
    coeff = float(np.float32(0.5) * eps32 * eps32)
    z = z_init.detach()
    energy_sum, grad_mean = [], []
    for k in range(steps):
        z = z.requires_grad_(True)
        with torch.enable_grad():
            energy = energy_fn(z)
            (grad,) = torch.autograd.grad(energy.sum(), z)
        energy_sum.append(energy.detach().sum())
        grad_mean.append(grad.mean())
        z = z.detach() - coeff * grad
        if with_noise:
            n = noise[k] if noise is not None else torch.randn(
                z.shape, generator=generator, device=z.device, dtype=z.dtype
            )
            z = z + float(eps32) * n
    if steps:
        diag = LangevinDiagnostics(torch.stack(energy_sum), torch.stack(grad_mean))
    else:
        empty = z.new_zeros((0,))
        diag = LangevinDiagnostics(empty, empty)
    return z.detach(), diag


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


def gaussian_posterior_energy(gen_fn, x: torch.Tensor, llhd_sigma: float) -> EnergyFn:
    """U(z) = ||G(z) - x||^2 / (2 sigma^2) + 0.5 ||z||^2: the posterior
    under a plain N(0, I) prior, the toy workload's (no EBM tilt)."""
    inv_two_sigma2 = 1.0 / (2.0 * llhd_sigma * llhd_sigma)

    def energy(z):
        recon = torch.sum((gen_fn(z) - x).reshape(z.shape[0], -1) ** 2, dim=-1) * inv_two_sigma2
        return recon + 0.5 * torch.sum(z * z, dim=-1)

    return energy


def prior_langevin_auto(
    z_init: torch.Tensor,
    ebm,
    steps: int,
    step_size: float,
    with_noise: bool = True,
    row_seeds: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    seed: Optional[int] = None,
    use_pallas: bool = True,
    noise: Optional[torch.Tensor] = None,
    dots_dtype: str = "float32",
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prior-Langevin chain; returns (z_final, final energy per chain).

    With `use_pallas` the standard 2-hidden `LatentEBM` runs in the fused
    chain kernel: with per-row counter noise when `row_seeds` is given
    (serving), else with stream noise from the int32 `seed` (training),
    its products in the precision `dots_dtype` ("float32" or "bfloat16").
    Without it, or for another EBM (the 3-hidden StyleGAN head), the chain
    runs `langevin_sample` by autograd with the EBM frozen, its per-step
    normals `noise` (steps, B, nz) or drawn from `generator`, in float32
    whatever `dots_dtype` says, and honours neither seed
    (`damc_tpu/ops/langevin.py:166-253`).

    With a `mesh` (JAX's `mesh=`, :237-238), z_init is the global batch,
    which every rank holds: the kernel's chains split over the ranks (K4a)
    and every rank gets the whole result, equal to the unsharded chain bit
    for bit; the autograd chain runs the whole batch on every rank."""
    if use_pallas and ebm.n_hidden == 2 and ebm.nez == 1:
        kw = dict(seed=seed, row_seeds=row_seeds, steps=steps, step_size=float(step_size),
                  with_noise=with_noise, dots_dtype=dots_dtype)
        with torch.no_grad():
            if mesh is None:
                z = fused_prior_langevin(z_init, *ebm_params_to_dense_weights(ebm), **kw)
            else:
                z = fused_prior_langevin_sharded(mesh, z_init, *ebm_params_to_dense_weights(ebm), **kw)
    else:
        if row_seeds is not None or seed is not None:
            raise ValueError(
                "row_seeds and seed (kernel noise) need the fused 2-hidden EBM chain (use_pallas)"
            )
        with frozen(ebm):
            z, _ = langevin_sample(
                z_init, prior_energy(ebm), steps, step_size, with_noise, generator, noise
            )
    with torch.no_grad():
        final_energy = prior_energy(ebm)(z)
    return z, final_energy


def adam_latent_descent(
    z_init: torch.Tensor,
    loss_fn: Callable[[torch.Tensor], torch.Tensor],
    steps: int,
    lr: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adam on the latents z for `steps` steps under the gradient of the
    SUM of the per-item losses `loss_fn(z)` (B,) (`damc_tpu/ops/langevin.py:
    258-287`, optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8, m_hat /
    (sqrt(v_hat) + eps)). Only z takes a gradient: the caller freezes the
    networks in loss_fn. Returns (z_final detached, the per-step loss sums
    (steps,), left on the device); loss k is taken before update k."""
    z = z_init.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([z], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(steps):
        with torch.enable_grad():
            loss = torch.sum(loss_fn(z))
            (grad,) = torch.autograd.grad(loss, z)
        losses.append(loss.detach())
        z.grad = grad
        opt.step()
    z.grad = None
    out = torch.stack(losses) if losses else z.new_zeros((0,))
    return z.detach(), out
