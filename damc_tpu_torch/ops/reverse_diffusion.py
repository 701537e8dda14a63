"""The unfused reverse-diffusion sweep: a plain torch loop over the n steps.

Counterpart of `damc_tpu/ops/reverse_diffusion.py:29-108` (JAX's
`lax.scan`). Q samples take this path where the fused sweep kernel K2 does
not: under classifier-free guidance, for a denoiser too wide for K2
(the StyleGAN inversion Q, `models/amortizer.py::sweep_route`), and on the
unfused serving route (`sample_q_per_item(fused=False)`). Each step
is one denoiser forward and the moment update of `ops/diffusion.py`; the
step's logSNR pair comes from `sweep_logsnr_grid`, computed on the host.

Randomness comes in as tensors: `noise` (n, B, nz) holds the ancestral
normals of each step, `guide_noise` (n, B, nz) the normals the guided
branch feeds through the prior embedder (JAX's `cfg_key` draw, :87-88).
Without them the normals are drawn from `generator`, step by step.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from .diffusion import sweep_logsnr_grid, sweep_schedule

# denoise_fn(z_t (B, nz), logsnr (B,)[, step tables]) -> eps_pred (B, nz)
DenoiseFn = Callable[..., torch.Tensor]
# guided_denoise_fn(normals (B, nz), z_t, logsnr (B,)) -> unconditional eps_pred
GuidedFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@torch.no_grad()
def reverse_diffusion_sample(
    denoise_fn: DenoiseFn,
    z_init: torch.Tensor,
    n_interval: int,
    logsnr_min: float,
    logsnr_max: float,
    var_type: str = "large",
    with_noise: bool = True,
    noise: Optional[torch.Tensor] = None,
    guided_denoise_fn: Optional[GuidedFn] = None,
    cond_w: float = 0.0,
    guide_noise: Optional[torch.Tensor] = None,
    step_xs: Optional[List[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Ancestral sampling from z_T = z_init (B, nz) down to z_0, detached.

    Steps i = n-1 .. 0: eps = denoise_fn(z_t, logsnr_t) (with guidance
    (1 + w) eps - w eps_unc), x_hat = pred_x_from_eps(z_t, eps), and
    z_s = mean + std * noise (the mean alone without noise) of
    q(z_s | z_t, x_hat); the last step returns x_hat itself. The steps'
    scalars are the host numbers of `sweep_schedule`, so a traced program
    holds them as constants.

    `step_xs`, when given, is a list of per-layer tables (n, d) indexed
    the way the sweep runs (row 0 = step n-1); denoise_fn then takes the
    step's rows as a third argument."""
    b, n = z_init.shape[0], n_interval
    dev, dtype = z_init.device, z_init.dtype
    grid = sweep_logsnr_grid(n, logsnr_min, logsnr_max)[0].to(dev)
    schedule = sweep_schedule(n, logsnr_min, logsnr_max, var_type)
    use_guidance = guided_denoise_fn is not None and cond_w > 0

    def normals(given, k):
        if given is not None:
            return given[k]
        if generator is None:
            raise ValueError("reverse_diffusion_sample: pass the normals or a generator")
        return torch.randn(z_init.shape, generator=generator, device=dev, dtype=dtype)

    zt = z_init
    for k, (inv_alpha, sigma, mean_z, mean_x, std) in enumerate(schedule):
        lt_vec = grid[k].expand(b)
        if step_xs is None:
            eps = denoise_fn(zt, lt_vec)
        else:
            eps = denoise_fn(zt, lt_vec, [t[k] for t in step_xs])
        if use_guidance:
            eps_unc = guided_denoise_fn(normals(guide_noise, k), zt, lt_vec)
            eps = (1.0 + cond_w) * eps - cond_w * eps_unc
        pred_z = inv_alpha * (zt - eps * sigma)
        if k == n - 1:
            return pred_z.detach()
        mean = mean_z * zt + mean_x * pred_z
        zt = mean + std * normals(noise, k) if with_noise else mean
    raise ValueError("reverse_diffusion_sample needs n_interval >= 1")
