"""Continuous-logSNR diffusion math on torch tensors.

Counterpart of `damc_tpu/ops/diffusion.py`: the variance-preserving
primitives of the DAMC amortizer, with logsnr lambda = log(alpha^2/sigma^2),
alpha^2 = sigmoid(lambda), sigma^2 = sigmoid(-lambda). t runs in [0, 1]
from clean (logsnr_max) to noise (logsnr_min). Schedule math is float32
whatever the payload dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_LOG2 = 0.6931471805599453


class _Log1mexp(torch.autograd.Function):
    """log(1 - exp(-x)) for x > 0, two-branch (Maechler 2012), with the
    exact derivative 1/expm1(x) so the unused branch never poisons the
    gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        big = x > _LOG2
        safe_big = torch.where(big, x, torch.ones_like(x))
        safe_small = torch.where(big, torch.ones_like(x), x)
        return torch.where(
            big,
            torch.log1p(-torch.exp(-safe_big)),
            torch.log(-torch.expm1(-safe_small)),
        )

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad / torch.expm1(x)


def log1mexp(x: torch.Tensor) -> torch.Tensor:
    return _Log1mexp.apply(x)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def logsnr_schedule(t, logsnr_min: float = -20.0, logsnr_max: float = 20.0):
    """-2 log(tan(a t + b)), endpoint-matched: logsnr(0) = logsnr_max and
    logsnr(1) = logsnr_min."""
    t = _f32(t)
    b = torch.arctan(torch.exp(-0.5 * _f32(logsnr_max)))
    a = torch.arctan(torch.exp(-0.5 * _f32(logsnr_min))) - b
    return -2.0 * torch.log(torch.tan(a * t + b))


class Gaussian(NamedTuple):
    mean: torch.Tensor
    std: torch.Tensor
    var: torch.Tensor
    logvar: torch.Tensor


def diffusion_forward(x, logsnr) -> Gaussian:
    """Marginal q(z_t | x) of the VP forward process: mean = x
    sqrt(sigmoid(logsnr)), var = sigmoid(-logsnr)."""
    logsnr = _f32(logsnr)
    var = torch.sigmoid(-logsnr)
    return Gaussian(
        mean=x * torch.sqrt(torch.sigmoid(logsnr)).to(x.dtype),
        std=torch.sqrt(var),
        var=var,
        logvar=torch.nn.functional.logsigmoid(-logsnr),
    )


def pred_x_from_eps(z, eps, logsnr):
    """x0-hat = (z - sigma eps) / alpha, 1/alpha = sqrt(1 + exp(-logsnr)),
    sigma = rsqrt(1 + exp(logsnr))."""
    logsnr = _f32(logsnr)
    inv_alpha = torch.sqrt(1.0 + torch.exp(-logsnr))
    sigma = torch.rsqrt(1.0 + torch.exp(logsnr))
    return (inv_alpha * (z - eps * sigma)).to(z.dtype)


def diffusion_reverse(x, z_t, logsnr_s, logsnr_t, var_type: str = "small") -> Gaussian:
    """Ancestral posterior q(z_s | z_t, x), s < t; 'large' or 'small'
    variance."""
    logsnr_s = _f32(logsnr_s)
    logsnr_t = _f32(logsnr_t)
    alpha_st = torch.sqrt((1.0 + torch.exp(-logsnr_t)) / (1.0 + torch.exp(-logsnr_s)))
    alpha_s = torch.sqrt(torch.sigmoid(logsnr_s))
    r = torch.exp(logsnr_t - logsnr_s)
    one_minus_r = -torch.expm1(logsnr_t - logsnr_s)
    mean = (r * alpha_st * z_t + one_minus_r * alpha_s * x).to(z_t.dtype)
    if var_type == "large":
        var = one_minus_r * torch.sigmoid(-logsnr_t)
        logvar = log1mexp(logsnr_s - logsnr_t) + torch.nn.functional.logsigmoid(-logsnr_t)
    elif var_type == "small":
        a_t = torch.sigmoid(logsnr_t)
        a_s = torch.sigmoid(logsnr_s)
        beta_t = 1.0 - a_t / a_s
        var = (1.0 - a_s) / (1.0 - a_t) * beta_t
        logvar = torch.log(var)
    else:
        raise ValueError(f"unknown var_type {var_type!r}")
    return Gaussian(mean=mean, std=torch.sqrt(var), var=var, logvar=logvar)


def sweep_logsnr_grid(n_interval: int, logsnr_min: float, logsnr_max: float):
    """(logsnr_t, logsnr_s) of the n-step reverse sweep in sweep order
    i = n-1 .. 0. The denoiser's step tables and `step_coefficients` index
    this grid positionally."""
    i_arr = torch.arange(n_interval - 1, -1, -1, dtype=torch.float32)
    logsnr_t = logsnr_schedule(i_arr / (n_interval - 1.0), logsnr_min, logsnr_max)
    logsnr_s = logsnr_schedule(
        torch.clamp(i_arr - 1.0, min=0.0) / (n_interval - 1.0), logsnr_min, logsnr_max
    )
    return logsnr_t, logsnr_s


def step_coefficients(
    n_interval: int, logsnr_min: float, logsnr_max: float, var_type: str
) -> torch.Tensor:
    """(n, 6) float32 table [c1, c2, m_z, m_x, std, is_last] per sweep step,
    read by the reverse-sweep kernel and its plain version.

    x_hat = c1 z - c2 eps and mean = m_z z_t + m_x x_hat are linear, so the
    coefficients are taken from `pred_x_from_eps` and `diffusion_reverse` by
    probing them with ones and zeros: the table holds exactly the numbers
    those functions compute. Built on the CPU."""
    n = n_interval
    i_arr = torch.arange(n - 1, -1, -1, dtype=torch.float32)
    logsnr_t, logsnr_s = sweep_logsnr_grid(n, logsnr_min, logsnr_max)
    one = torch.ones_like(logsnr_t)
    zero = torch.zeros_like(logsnr_t)
    c1 = pred_x_from_eps(one, zero, logsnr_t)
    c2 = -pred_x_from_eps(zero, one, logsnr_t)
    dist_z = diffusion_reverse(zero, one, logsnr_s, logsnr_t, var_type)
    dist_x = diffusion_reverse(one, zero, logsnr_s, logsnr_t, var_type)
    is_last = (i_arr == 0.0).to(torch.float32)
    return torch.stack(
        [c1, c2, dist_z.mean, dist_x.mean, dist_z.std, is_last], dim=-1
    ).to(torch.float32)
