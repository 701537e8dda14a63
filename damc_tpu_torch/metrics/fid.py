"""Frechet distance between feature statistics (counterpart of
`damc_tpu/metrics/fid.py:26-71, 119-127, 176-244`).

Features come from a pluggable extractor: the pool3 InceptionV3 of
`models/inception.py` when its weights are on disk (FID), or the
random-feature extractor `make_random_feature_fn` (the metric is then
`frechet_rand`, which is no FID). An extractor maps images (B, H, W, C) in
[0, 1], a tensor on the device, to features (B, D). `RunningStats` keeps
the count, the feature sum and the sum of outer products in float64 on the
features' device and copies them to the host once, at `finalize`, where the
unbiased covariance and the Frechet distance are formed in float64 numpy,
with scipy's `sqrtm` as pytorch-fid does.

The mesh-sharded accumulator of the JAX package (:74-173) is not ported
(ROADMAP.md, queue 1, item 8).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

FeatureFn = Callable[[torch.Tensor], torch.Tensor]  # images (B, H, W, C) -> (B, D)


class RunningStats:
    """Streaming count, sum and sum of outer products, float64 on the
    features' device."""

    def __init__(self, dim: int, device=None):
        self.n = 0
        self.sum = torch.zeros((dim,), dtype=torch.float64, device=device)
        self.outer = torch.zeros((dim, dim), dtype=torch.float64, device=device)

    def update(self, feats) -> None:
        feats = torch.as_tensor(feats).to(device=self.sum.device, dtype=torch.float64)
        self.n += feats.shape[0]
        self.sum += feats.sum(dim=0)
        self.outer += feats.T @ feats

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """(mu, sigma) with the unbiased covariance (np.cov ddof=1, as
        pytorch-fid), float64 numpy."""
        return finalize_stats(self.n, self.sum.cpu().numpy(), self.outer.cpu().numpy())


def finalize_stats(n: int, total: np.ndarray, outer: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(n, sum, sum of outer products) -> (mu, unbiased sigma), float64."""
    if n < 2:
        raise ValueError("need at least 2 samples for covariance")
    mu = np.asarray(total, np.float64) / n
    cov = (np.asarray(outer, np.float64) - n * np.outer(mu, mu)) / (n - 1)
    return mu, cov


def images_to_unit(images: np.ndarray) -> np.ndarray:
    """Host images -> [0, 1] float32 for feature extraction: uint8 [0, 255]
    storage divides by 255; float arrays are taken as [-1, 1] (the
    pipeline's convention) and mapped affinely."""
    if images.dtype == np.uint8:
        return images.astype(np.float32) / 255.0
    return (np.asarray(images, np.float32) + 1.0) / 2.0


def compute_stats(feature_fn: FeatureFn, batches: Iterable) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of extractor features over an iterable of image batches
    (tensors on the extractor's device, or host arrays)."""
    stats: Optional[RunningStats] = None
    with torch.no_grad():
        for batch in batches:
            feats = feature_fn(torch.as_tensor(batch))
            if stats is None:
                stats = RunningStats(feats.shape[-1], feats.device)
            stats.update(feats)
    if stats is None:
        raise ValueError("no batches provided")
    return stats.finalize()


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray, eps: float = 1e-6
) -> float:
    """d^2 = ||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2)), with
    pytorch-fid's numerics: sqrtm, an eps I retry when the root is not
    finite, and the check on the imaginary part."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    # No `disp` argument: SciPy 1.18 removed it, and without it every
    # version returns the matrix alone.
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"sqrtm produced large imaginary component {m}")
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_samples(
    feature_fn: FeatureFn, sample_batches: Iterable, real_mu: np.ndarray, real_sigma: np.ndarray
) -> float:
    """Frechet distance of generated batches against precomputed real
    statistics."""
    mu, sigma = compute_stats(feature_fn, sample_batches)
    return frechet_distance(mu, sigma, real_mu, real_sigma)


def same_pad(size: int, k: int, s: int) -> Tuple[int, int]:
    """(before, after) padding of XLA's SAME for one spatial axis: the
    output has ceil(size / s) entries and the odd pixel goes after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def random_feature_weights(image_shape: Tuple[int, int, int], dim: int = 192):
    """The two HWIO kernels of `make_random_feature_fn`, standard normals
    from a CPU generator seeded with 0, scaled by 1/sqrt(fan-in). The JAX
    package draws its own from jax.random, so the two packages'
    `frechet_rand` numbers differ unless the weights are carried over."""
    c = image_shape[2]
    gen = torch.Generator().manual_seed(0)
    w1 = torch.randn((4, 4, c, 64), generator=gen) / np.sqrt(16 * c)
    w2 = torch.randn((4, 4, 64, dim), generator=gen) / np.sqrt(16 * 64)
    return w1.numpy(), w2.numpy()


def make_random_feature_fn(
    image_shape: Tuple[int, int, int], dim: int = 192, weights=None, device=None
) -> FeatureFn:
    """Deterministic random-projection conv features: x * 2 - 1, a 4x4
    stride-2 SAME conv to 64 channels, ReLU, a 4x4 stride-2 SAME conv to
    `dim`, mean over the pixels. Weight-free stand-in for Inception: a
    valid Frechet metric (zero for identical distributions), not comparable
    to FID. `weights` = (w1, w2) HWIO arrays, by default
    `random_feature_weights(image_shape, dim)`."""
    w1, w2 = weights if weights is not None else random_feature_weights(image_shape, dim)
    k1 = torch.from_numpy(np.array(w1, np.float32)).permute(3, 2, 0, 1).contiguous().to(device)
    k2 = torch.from_numpy(np.array(w2, np.float32)).permute(3, 2, 0, 1).contiguous().to(device)

    def conv(x, k):
        (t, b), (l, r) = same_pad(x.shape[2], 4, 2), same_pad(x.shape[3], 4, 2)
        return F.conv2d(F.pad(x, (l, r, t, b)), k, stride=2)

    def feature_fn(x: torch.Tensor) -> torch.Tensor:
        x = x.to(device=k1.device, dtype=torch.float32).permute(0, 3, 1, 2) * 2.0 - 1.0
        y = torch.relu(conv(x, k1))
        return conv(y, k2).mean(dim=(2, 3))

    return feature_fn
