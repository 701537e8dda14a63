"""2-arm pinwheel latents of the toy posterior workload: the port's own
copy of `damc_tpu/data/pinwheel.py` (NumPy, the same draws bit for bit).

Per-class radial and tangential Gaussian features, an exponential angle
warp, a rotation and a x2 scale, from a seeded RandomState, as the
reference's sampler (`toy_example/toy_example.py:134-155`).
"""

from __future__ import annotations

import numpy as np


def sample_pinwheel(
    batch_size: int,
    seed: int,
    num_classes: int = 2,
    radial_std: float = 0.3,
    tangential_std: float = 0.1,
    rate: float = 0.25,
) -> np.ndarray:
    """(batch_size, 2) float32 pinwheel latents from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    num_per_class = batch_size // num_classes
    rads = np.linspace(0, 2 * np.pi, num_classes, endpoint=False)

    features = rng.randn(num_classes * num_per_class, 2) * np.array([radial_std, tangential_std])
    features[:, 0] += 1.0
    labels = np.repeat(np.arange(num_classes), num_per_class)

    angles = rads[labels] + rate * np.exp(features[:, 0])
    rotations = np.stack([np.cos(angles), -np.sin(angles), np.sin(angles), np.cos(angles)])
    rotations = np.reshape(rotations.T, (-1, 2, 2))
    return (2 * rng.permutation(np.einsum("ti,tij->tj", features, rotations))).astype(np.float32)
