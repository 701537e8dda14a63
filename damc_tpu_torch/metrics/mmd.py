"""RBF-kernel MMD^2 between two sample clouds, the toy workload's parity
statistic (counterpart of `damc_tpu/metrics/mmd.py`), in torch on the
samples' device: at the toy eval's 5,000 x 5,000 pairs it is a few
hundred million kernel values, device work rather than host work.
"""

from __future__ import annotations

from typing import Optional

import torch


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aa = torch.sum(a * a, dim=-1)[:, None]
    bb = torch.sum(b * b, dim=-1)[None, :]
    return torch.clamp(aa + bb - 2.0 * a @ b.T, min=0.0)


def median_heuristic_bandwidth(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sigma^2 = the median of the pooled pairwise squared distances
    (i < j) / 2; of an even count, the mean of the two middle values, as
    `jnp.median` takes it."""
    z = torch.cat([x, y], dim=0)
    n = z.shape[0]
    upper = torch.ones(n, n, dtype=torch.bool, device=z.device).triu_(1)
    d = _sq_dists(z, z)[upper]
    k = d.numel()
    mid = torch.kthvalue(d, (k + 1) // 2).values
    if k % 2 == 0:
        mid = 0.5 * (mid + torch.kthvalue(d, k // 2 + 1).values)
    return mid / 2.0


def mmd2_rbf(x: torch.Tensor, y: torch.Tensor, sigma2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Unbiased MMD^2 of x (n, d) against y (m, d) with the RBF kernel
    exp(-||a - b||^2 / (2 sigma2)); the median heuristic when sigma2 is
    None. A 0-d tensor on the samples' device."""
    if sigma2 is None:
        sigma2 = median_heuristic_bandwidth(x, y)
    gamma = 1.0 / (2.0 * sigma2)
    n, m = x.shape[0], y.shape[0]
    kxx = torch.exp(-gamma * _sq_dists(x, x))
    kyy = torch.exp(-gamma * _sq_dists(y, y))
    kxy = torch.exp(-gamma * _sq_dists(x, y))
    sum_xx = (torch.sum(kxx) - n) / (n * (n - 1))
    sum_yy = (torch.sum(kyy) - m) / (m * (m - 1))
    return sum_xx + sum_yy - 2.0 * torch.mean(kxy)
