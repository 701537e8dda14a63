"""K1 and the Langevin samplers: the plain version of the port's prior-chain
kernel against the JAX Pallas kernel (plain interpreter) at the CIFAR-10
EBM widths, `prior_langevin_auto` on the port's EBM module, the posterior
refinement by autograd, and the wrapper's dispatch rules."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.ops import langevin as jl
from damc_tpu.ops.pallas.fused_langevin import fused_prior_langevin as jax_chain
from damc_tpu_torch.models import LatentEBM
from damc_tpu_torch.ops import langevin as tl
from damc_tpu_torch.ops.cuda import fused_langevin as k1
from torch_port_helpers import jax_and_port

NZ, NDF = 128, 200


def _weights(seed=0):
    """EBM dense weights at the cifar10 widths, torch-default scale."""
    r = np.random.default_rng(seed)
    u = lambda shape, fan: (r.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)
    return (u((NZ, NDF), NZ), u((NDF,), NZ), u((NDF, NDF), NDF), u((NDF,), NDF), u((NDF,), NDF))


def _jax(z, w, **kw):
    return np.asarray(jax_chain(jnp.asarray(z), *map(jnp.asarray, w), interpret="plain", **kw))


def _port(z, w, **kw):
    return k1.prior_langevin_plain(torch.from_numpy(z), *map(torch.from_numpy, w), **kw).numpy()


@pytest.mark.parametrize("b", [5, 16])
def test_plain_chain_matches_jax_noiseless(b):
    """60 noiseless steps at step 0.4, atol 1e-5 (the JAX suite's bound for
    the fused chain against its scan)."""
    z = np.random.default_rng(b).normal(size=(b, NZ)).astype(np.float32)
    w = _weights(b)
    kw = dict(steps=60, step_size=0.4, with_noise=False)
    np.testing.assert_allclose(_port(z, w, **kw), _jax(z, w, **kw), atol=1e-5, rtol=0)


def test_plain_chain_matches_jax_counter_noise_pointwise():
    """60 noisy steps: the counter bits are equal, log/cos differ by ulps;
    the chain contracts, so atol 1e-5 holds pointwise."""
    r = np.random.default_rng(7)
    z = r.normal(size=(9, NZ)).astype(np.float32)
    seeds = r.integers(0, 2**31 - 1, 9).astype(np.int32)
    w = _weights(7)
    got = _port(z, w, steps=60, step_size=0.4, row_seeds=torch.from_numpy(seeds))
    want = _jax(z, w, steps=60, step_size=0.4, row_seeds=jnp.asarray(seeds))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.std(got) > 0.5  # the noise is really there


def test_prior_langevin_auto_on_the_ebm_module():
    """The dense-weight extraction from the port's LatentEBM, through the
    fused dispatch, against JAX's `prior_langevin_auto` (fused, plain
    interpreter), with the final energies."""
    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=1)
    r = np.random.default_rng(3)
    z = r.normal(size=(6, cfg_p.model.nz)).astype(np.float32)
    seeds = r.integers(0, 2**31 - 1, 6).astype(np.int32)
    zj, ej = jl.prior_langevin_auto(
        jax.random.PRNGKey(0), jnp.asarray(z), models_j.ebm, state.params_e, 20, 0.4,
        row_seeds=jnp.asarray(seeds), pallas_interpret="plain",
    )
    before = k1.fused_prior_langevin.launches
    zp, ep = tl.prior_langevin_auto(
        torch.from_numpy(z), models_p.ebm, 20, 0.4, row_seeds=torch.from_numpy(seeds)
    )
    assert k1.fused_prior_langevin.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=1e-5)
    np.testing.assert_allclose(ep.numpy(), np.asarray(ej), atol=1e-4)


def test_posterior_langevin_matches_jax():
    """The recon path's noiseless refinement through G and E by autograd,
    5 steps at 0.1, sigma 0.1: atol 1e-4 (the 1/(2 sigma^2) = 50 gain on the
    reconstruction gradient)."""
    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=2)
    r = np.random.default_rng(4)
    z0 = r.normal(size=(3, cfg_p.model.nz)).astype(np.float32)
    x = r.uniform(-1, 1, size=(3, 32, 32, 3)).astype(np.float32)
    energy_j = jl.posterior_energy(
        lambda z: models_j.generator.apply(state.params_g, z),
        lambda z: models_j.ebm.apply(state.params_e, z), jnp.asarray(x), 0.1,
    )
    zj, _ = jl.langevin_sample(jax.random.PRNGKey(0), jnp.asarray(z0), energy_j, 5, 0.1, with_noise=False)
    energy_p = tl.posterior_energy(models_p.generator, models_p.ebm, torch.from_numpy(x), 0.1)
    zp = tl.langevin_sample(torch.from_numpy(z0), energy_p, 5, 0.1, with_noise=False)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=1e-4)
    assert not zp.requires_grad


def test_three_hidden_ebm_takes_autograd_and_refuses_row_seeds():
    torch.manual_seed(0)
    ebm = LatentEBM(8, ndf=16, n_hidden=3)
    z = torch.randn(4, 8)
    with pytest.raises(ValueError, match="row_seeds"):
        tl.prior_langevin_auto(z, ebm, 3, 0.1, row_seeds=torch.zeros(4, dtype=torch.int32))
    zn, _ = tl.prior_langevin_auto(z, ebm, 3, 0.1, with_noise=False)
    ref = tl.langevin_sample(z, tl.prior_energy(ebm), 3, 0.1, with_noise=False)
    assert torch.equal(zn, ref)


def test_wrapper_dispatch_rules():
    w = [torch.from_numpy(a) for a in _weights()]
    z = torch.zeros(2, NZ)
    with pytest.raises(ValueError, match="row_seeds"):
        k1.fused_prior_langevin(z, *w, steps=1)  # stream-mode noise is not ported
    with pytest.raises(ValueError, match="device"):
        k1.fused_prior_langevin(z.to("meta"), *w, steps=1, with_noise=False)
    assert k1.fits_smem(NZ, NDF) and not k1.fits_smem(NZ, 512)
    assert k1.smem_bytes(NZ, NDF) == 4 * (NDF * NDF + k1.ROWS * (2 * NZ + 4 * NDF))
