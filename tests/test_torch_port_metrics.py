"""The port's FID statistics (`damc_tpu_torch/metrics/fid.py`) and FID evals
(`train/gen_recon.py::evaluate_fid`) against `damc_tpu/metrics/fid.py` and
`damc_tpu/train/gen_recon.py` on the CPU.

Tolerances: the statistics within 1e-9 relative (both float64; the port
sums on the device in another order); the Frechet distance of the same
statistics within 1e-10 relative (the same scipy calls on the same
arrays); random features within atol 1e-5 (float32 convolutions); the FID
evals within rtol 1e-4 (images that agree to ~1e-6 move the features'
covariance, and sqrtm amplifies that on a few dozen samples)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.metrics import fid as jax_fid
from damc_tpu.train.gen_recon import evaluate_fid as jax_evaluate_fid
from damc_tpu_torch.metrics import fid
from damc_tpu_torch.train.gen_recon import evaluate_fid
from damc_tpu_torch.train.sampling import Draws
from test_torch_port_sampling import noiseless, sample_q_draws
from torch_port_helpers import jax_and_port
import torch_port_helpers


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from torch_port_helpers.one_torch_thread()


def _feats(seed, n, d=12):
    r = np.random.default_rng(seed)
    return (r.normal(size=(n, d)) * r.uniform(0.5, 2.0, d) + r.normal(size=d)).astype(np.float32)


def test_running_stats_match_jax():
    a, b = jax_fid.RunningStats(12), fid.RunningStats(12)
    for i, n in enumerate((7, 30, 1)):
        f = _feats(i, n)
        a.update(f)
        b.update(torch.from_numpy(f))
    (mu_j, s_j), (mu_p, s_p) = a.finalize(), b.finalize()
    assert b.n == a.n == 38 and mu_p.dtype == s_p.dtype == np.float64
    np.testing.assert_allclose(mu_p, mu_j, rtol=1e-9)
    np.testing.assert_allclose(s_p, s_j, rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="2 samples"):
        one = fid.RunningStats(3)
        one.update(np.ones((1, 3), np.float32))
        one.finalize()


def test_compute_stats_and_frechet_distance_match_jax():
    """Over batches of images whose features (a slice, scaled by 2) are
    exact in float32 on both sides, so only the statistics can differ."""
    imgs = [np.random.default_rng(i).uniform(0, 1, (9, 4, 4, 2)).astype(np.float32) for i in range(3)]
    mu_j, s_j = jax_fid.compute_stats(lambda x: x.reshape(x.shape[0], -1)[:, :10] * 2.0, imgs)
    mu_p, s_p = fid.compute_stats(lambda x: x.reshape(x.shape[0], -1)[:, :10] * 2.0, imgs)
    np.testing.assert_allclose(mu_p, mu_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(s_p, s_j, rtol=1e-9, atol=1e-12)
    stats = []
    for seed, scale in ((5, 1.0), (6, 1.3)):
        rs = fid.RunningStats(12)
        rs.update(_feats(seed, 40) * scale)
        stats.append(rs.finalize())
    (mu2, s2), (mu1, s1) = stats
    want = jax_fid.frechet_distance(mu1, s1, mu2, s2)
    assert fid.frechet_distance(mu1, s1, mu2, s2) == pytest.approx(want, rel=1e-10)
    assert fid.frechet_distance(mu1, s1, mu1, s1) == pytest.approx(0.0, abs=1e-6)
    # A singular product takes the eps retry on both sides.
    z = np.zeros((3, 3))
    assert fid.frechet_distance(np.zeros(3), z, np.ones(3), z) == pytest.approx(
        jax_fid.frechet_distance(np.zeros(3), z, np.ones(3), z), rel=1e-10)


def test_images_to_unit_matches_jax_for_both_storage_types():
    u8 = np.random.default_rng(1).integers(0, 256, (3, 5, 5, 3), dtype=np.uint8)
    pm1 = np.random.default_rng(2).uniform(-1, 1, (3, 5, 5, 3)).astype(np.float32)
    for x in (u8, pm1, pm1.astype(np.float64)):
        got = fid.images_to_unit(x)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_fid.images_to_unit(x))


def _jax_random_weights(key, image_shape, dim):
    """The two kernels JAX's `make_random_feature_fn(key, ...)` draws."""
    c = image_shape[2]
    k1, k2 = jax.random.split(key)
    w1 = jax.random.normal(k1, (4, 4, c, 64)) / np.sqrt(16 * c)
    w2 = jax.random.normal(k2, (4, 4, 64, dim)) / np.sqrt(16 * 64)
    return np.asarray(w1), np.asarray(w2)


@pytest.mark.parametrize("shape", [(32, 32, 3), (28, 28, 1), (9, 7, 3)])
def test_random_feature_fn_matches_jax_with_its_weights(shape):
    """SAME padding as XLA computes it, odd sizes included (one more pixel
    after than before)."""
    key = jax.random.PRNGKey(0)
    jfn = jax_fid.make_random_feature_fn(key, shape, dim=24)
    pfn = fid.make_random_feature_fn(shape, dim=24, weights=_jax_random_weights(key, shape, 24))
    x = np.random.default_rng(3).uniform(0, 1, (4, *shape)).astype(np.float32)
    want = np.asarray(jfn(jnp.asarray(x)))
    got = pfn(torch.from_numpy(x))
    assert got.shape == want.shape == (4, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_random_feature_fn_default_weights_are_fixed():
    a = fid.make_random_feature_fn((8, 8, 3), dim=5)
    b = fid.make_random_feature_fn((8, 8, 3), dim=5)
    w1, w2 = fid.random_feature_weights((8, 8, 3), dim=5)
    assert w1.shape == (4, 4, 3, 64) and w2.shape == (4, 4, 64, 5)
    x = torch.rand(2, 8, 8, 3)
    assert torch.equal(a(x), b(x))
    assert torch.equal(a(x), fid.make_random_feature_fn((8, 8, 3), dim=5, weights=(w1, w2))(x))
    assert fid.same_pad(32, 4, 2) == (1, 1) and fid.same_pad(9, 4, 2) == (1, 2) and fid.same_pad(7, 4, 2) == (1, 2)


@pytest.fixture(scope="module")
def pair():
    return jax_and_port(seed=4, edit=noiseless)


@pytest.mark.parametrize("prior", ["damc", "ebm"])
def test_evaluate_fid_matches_jax(pair, prior):
    """Three batches of 16 through each prior, noise off, the port fed the
    z0 (and embedding noise) of JAX's per-batch keys fold_in(key, i)."""
    cfg_j, state, models_j, cfg_p, models_p = pair
    shape = (32, 32, 3)
    key_feat = jax.random.PRNGKey(0)
    jfn = jax_fid.make_random_feature_fn(key_feat, shape)
    pfn = fid.make_random_feature_fn(shape, weights=_jax_random_weights(key_feat, shape, 192))
    real = np.random.default_rng(5).uniform(0, 1, (64, *shape)).astype(np.float32)
    real_mu, real_sigma = jax_fid.compute_stats(jfn, [real[:32], real[32:]])
    key = jax.random.PRNGKey(21)
    want = jax_evaluate_fid(key, state, models_j, cfg_j, jfn, real_mu, real_sigma, 48, 16, prior=prior)
    nz = cfg_p.model.nz

    def draws(i, b):
        k = jax.random.fold_in(key, i)
        if prior == "damc":
            return sample_q_draws(k, b, nz)
        z0 = torch.from_numpy(np.asarray(jax.random.normal(jax.random.split(k)[0], (b, nz))))
        return Draws(z0, torch.zeros_like(z0), 0, 0)

    got = evaluate_fid(models_p, cfg_p, pfn, real_mu, real_sigma, 48, 16, prior, draws)
    assert np.isfinite(got) and got > 0
    assert got == pytest.approx(want, rel=1e-4)
