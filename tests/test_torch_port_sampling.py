"""The port's sampling pipelines (`damc_tpu_torch/train/sampling.py`) against
`damc_tpu/train/sampling.py` on the CPU, at the tiny svhn widths of
`torch_port_helpers.tiny`, and the eval draws' seeds.

The JAX functions draw from a key; the port takes its draws as a `Draws`,
built here from the same key split (`sample_q`: init, embedding, sweep;
the EBM chain: init, chain; `reconstruct`: Q, Langevin). The kernels' noise
is off (`e_l_with_noise=False`, `with_noise=False`): the port's stream
noise is not the TPU's. The JAX package runs its scan sweep and scan chain
here, which are its CPU paths.

Tolerances: images and latents within atol 1e-5 (float32 products summed
in another order, through tanh), as the PR 2 loop tests hold the same
pieces; the per-image MSE and scores within rtol 1e-5."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.train import sampling as jax_sampling
from damc_tpu_torch.config import preset
from damc_tpu_torch.data.device_data import data_seed
from damc_tpu_torch.ops.noise import counter_bits
from damc_tpu_torch.train import sampling
from damc_tpu_torch.train.sampling import Draws, EVAL_TAGS, eval_bits, eval_draws, generator_seed
from damc_tpu_torch.train.step import stream_seeds
from torch_port_helpers import jax_and_port
import torch_port_helpers


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from torch_port_helpers.one_torch_thread()


ATOL = 1e-5
B = 5


def noiseless(cfg):
    return dataclasses.replace(
        cfg,
        mcmc=dataclasses.replace(cfg.mcmc, e_l_with_noise=False, e_l_steps=4),
        diffusion=dataclasses.replace(cfg.diffusion, with_noise=False),
    )


@pytest.fixture(scope="module")
def pair():
    return jax_and_port(seed=3, edit=noiseless)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def sample_q_draws(key, b, nz):
    """`Draws` of the JAX `sample_q(key, ...)`: z_init from the first key
    of its 3-way split, the embedding noise from the second."""
    k_init, k_emb, _ = jax.random.split(key, 3)
    return Draws(_t(jax.random.normal(k_init, (b, nz))), _t(jax.random.normal(k_emb, (b, nz))), 0, 0)


def recon_draws(key, b, nz):
    """`Draws` of the JAX `reconstruct(key, ...)`: its Q key, split first."""
    return sample_q_draws(jax.random.split(key)[0], b, nz)


def test_gen_samples_ebm_prior_matches_jax(pair):
    cfg_j, state, models_j, cfg_p, models_p = pair
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_sampling.gen_samples_ebm_prior(key, state, models_j, cfg_j, B))
    nz = cfg_p.model.nz
    z0 = _t(jax.random.normal(jax.random.split(key)[0], (B, nz)))
    got = sampling.gen_samples_ebm_prior(models_p, cfg_p, Draws(z0, torch.zeros_like(z0), 0, 0))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_gen_samples_damc_prior_matches_jax(pair):
    cfg_j, state, models_j, cfg_p, models_p = pair
    key = jax.random.PRNGKey(12)
    x_j, z_j = jax_sampling.gen_samples_damc_prior(key, state, models_j, cfg_j, B)
    x_p, z_p = sampling.gen_samples_damc_prior(models_p, cfg_p, sample_q_draws(key, B, cfg_p.model.nz))
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_j), atol=ATOL)
    np.testing.assert_allclose(x_p.numpy(), np.asarray(x_j), atol=ATOL)


def _x(b, seed=4):
    return np.random.default_rng(seed).uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("steps", [0, 10])
def test_reconstruct_matches_jax(pair, steps):
    cfg_j, state, models_j, cfg_p, models_p = pair
    key = jax.random.PRNGKey(13)
    x = _x(B)
    xh_j, z_j = jax_sampling.reconstruct(key, state, models_j, cfg_j, jnp.asarray(x), langevin_steps=steps)
    xh_p, z_p = sampling.reconstruct(
        models_p, cfg_p, torch.from_numpy(x), recon_draws(key, B, cfg_p.model.nz), langevin_steps=steps
    )
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_j), atol=ATOL)
    np.testing.assert_allclose(xh_p.numpy(), np.asarray(xh_j), atol=ATOL)
    assert not xh_p.requires_grad and not z_p.requires_grad


def test_reconstruct_leaves_trainable_models_trainable():
    """The Langevin refinement freezes G and E for its autograd and gives
    each parameter its requires_grad flag back."""
    from damc_tpu_torch.models import build_models
    from torch_port_helpers import tiny

    cfg = noiseless(tiny(preset("svhn")))
    models = build_models(cfg, seed=1, device="cpu", trainable=True)
    d = eval_draws(0, "mse", 0, 0, 3, cfg.model.nz, "cpu")
    sampling.reconstruct(models, cfg, torch.from_numpy(_x(3)), d, langevin_steps=2)
    assert all(p.requires_grad for m in models.modules() for p in m.parameters())
    assert all(p.grad is None for m in models.modules() for p in m.parameters())


def test_recon_mse_anomaly_scores_and_unit_range_match_jax(pair):
    cfg_j, state, models_j, cfg_p, models_p = pair
    key = jax.random.PRNGKey(14)
    x = _x(B, seed=5)
    x_hat = _x(B, seed=6)
    np.testing.assert_allclose(
        sampling.recon_mse_per_image(torch.from_numpy(x_hat), torch.from_numpy(x)).numpy(),
        np.asarray(jax_sampling.recon_mse_per_image(jnp.asarray(x_hat), jnp.asarray(x))),
        rtol=1e-5,
    )
    want = np.asarray(jax_sampling.anomaly_scores(key, state, models_j, cfg_j, jnp.asarray(x), langevin_steps=3))
    got = sampling.anomaly_scores(
        models_p, cfg_p, torch.from_numpy(x), recon_draws(key, B, cfg_p.model.nz), langevin_steps=3
    )
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    wide = np.linspace(-1.5, 1.5, 13, dtype=np.float32)
    np.testing.assert_array_equal(
        sampling.to_unit_range(torch.from_numpy(wide)).numpy(),
        np.asarray(jax_sampling.to_unit_range(jnp.asarray(wide))),
    )


def test_eval_draws_are_a_pure_function_of_their_arguments():
    a = eval_draws(7, "fid_damc", 300, 4, 6, 8, "cpu")
    b = eval_draws(7, "fid_damc", 300, 4, 6, 8, "cpu")
    assert torch.equal(a.z0, b.z0) and torch.equal(a.emb_noise, b.emb_noise)
    assert (a.sweep_seed, a.chain_seed) == (b.sweep_seed, b.chain_seed)
    assert not torch.equal(a.z0, a.emb_noise)
    for other in (eval_draws(8, "fid_damc", 300, 4, 6, 8, "cpu"), eval_draws(7, "fid_ebm", 300, 4, 6, 8, "cpu"),
                  eval_draws(7, "fid_damc", 400, 4, 6, 8, "cpu"), eval_draws(7, "fid_damc", 300, 5, 6, 8, "cpu")):
        assert not torch.equal(a.z0, other.z0) and a.sweep_seed != other.sweep_seed
    with pytest.raises(ValueError, match="iteration"):
        eval_draws(7, "mse", 1 << 20, 0, 2, 8, "cpu")
    with pytest.raises(ValueError, match="batches"):
        eval_draws(7, "mse", 0, 256, 2, 8, "cpu")


@pytest.mark.parametrize("seed", [1, 12345])
def test_eval_seeds_never_collide_over_a_full_run(seed):
    """Every draw seed a cifar10-preset run reaches (1,000,000 iterations;
    an eval every 100: 100 FID batches for each prior and 79 recon-MSE
    batches of 128 over the 10,000 test images; the 3 plot consumers every
    1,000 iterations): no K2 stream seed is used twice, across the training
    steps (`stream_seeds`) and every eval consumer, nor any K1 seed; no two
    eval generators share a seed, and none equals the run seed or the data
    seed."""
    tc = preset("cifar10").train
    steps = torch.arange(tc.iterations)
    train = counter_bits(torch.tensor([seed]), steps, 2)
    assert (int(train[5, 0]), int(train[5, 1])) == tuple(s & 0xFFFFFFFF for s in stream_seeds(seed, 5))

    evals = torch.arange(0, tc.iterations, tc.eval_every)
    plots = torch.arange(0, tc.iterations, tc.plot_every)
    n_fid = round(tc.n_fid_samples / tc.fid_batch_size)
    n_mse = -(-10_000 // tc.batch_size)
    reach = {"fid_damc": (evals, n_fid), "fid_ebm": (evals, n_fid), "mse": (evals, n_mse),
             "plot_post": (plots, 1), "plot_q": (plots, 1), "plot_prior": (plots, 1)}
    assert set(reach) == set(EVAL_TAGS)
    bits = []
    for tag, (its, n_b) in reach.items():
        it, bt = torch.meshgrid(its, torch.arange(n_b), indexing="ij")
        bits.append(eval_bits(seed, tag, it, bt))
    bits = torch.cat(bits)
    for col in (0, 1):  # K2, K1
        every = torch.cat([train[:, col], bits[:, col]])
        assert len(torch.unique(every)) == len(every), col
    # As generator_seed, in int64 bits: the top bit makes every one negative.
    gen = (bits[:, 2] << 31) | (bits[:, 3] >> 1) | torch.iinfo(torch.int64).min
    assert len(torch.unique(gen)) == len(gen)
    assert bool((gen < 0).all())  # the top bit is set: at least 2^63 as a uint64
    assert generator_seed(bits[0]) == int(gen[0]) + (1 << 64)
    assert generator_seed(bits[0]) not in (seed, data_seed(seed))
    # The data seed is column 0 at counter 0xFFFFFFFF, which no eval reaches:
    # no K2 seed equals it either.
    assert not bool(torch.isin(torch.tensor([data_seed(seed)]), bits[:, 0]).any())
