"""K1 and the Langevin samplers: the plain version of the port's prior-chain
kernel against the JAX Pallas kernel (plain interpreter) at the CIFAR-10
EBM widths, `prior_langevin_auto` on the port's EBM module, the posterior
refinement by autograd, stream-mode noise against the JAX scan chain in
distribution, and the wrapper's dispatch rules."""

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
from damc_tpu_torch.ops.noise import counter_normals, stream_row_seeds
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
    zp, _ = tl.langevin_sample(torch.from_numpy(z0), energy_p, 5, 0.1, with_noise=False)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=1e-4)
    assert not zp.requires_grad


def test_three_hidden_ebm_takes_autograd_and_refuses_row_seeds():
    """An EBM K1 does not take runs by autograd: with `row_seeds` its step
    noise is the counter normals K1 would draw for them (the unfused serving
    route), while K1's stream `seed` is refused, as it is for any autograd
    chain."""
    torch.manual_seed(0)
    ebm = LatentEBM(8, ndf=16, n_hidden=3)
    z = torch.randn(4, 8)
    seeds = torch.tensor([3, -7, 11, 2**31 - 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="fits_ebm"):
        tl.prior_langevin_auto(z, ebm, 3, 0.1, seed=5)
    zc, _ = tl.prior_langevin_auto(z, ebm, 3, 0.1, row_seeds=seeds)
    ref, _ = tl.langevin_sample(z, tl.prior_energy(ebm), 3, 0.1, noise=counter_normals(seeds, 3, 8))
    assert torch.equal(zc, ref)
    zn, _ = tl.prior_langevin_auto(z, ebm, 3, 0.1, with_noise=False)
    ref, _ = tl.langevin_sample(z, tl.prior_energy(ebm), 3, 0.1, with_noise=False)
    assert torch.equal(zn, ref)


def test_wrapper_dispatch_rules():
    w = [torch.from_numpy(a) for a in _weights()]
    z = torch.zeros(2, NZ)
    with pytest.raises(ValueError, match="row_seeds"):
        k1.fused_prior_langevin(z, *w, steps=1)  # noise needs seed or row_seeds
    with pytest.raises(ValueError, match="device"):
        k1.fused_prior_langevin(z.to("meta"), *w, steps=1, with_noise=False)
    # The fit rule over a cluster of 4: cifar10 fits; ndf=512 exceeds a
    # block's shared memory; widths that do not split over the cluster, or
    # break float4 reads, do not.
    assert k1.fits_smem(NZ, NDF, 4) and k1.smem_bytes(NZ, NDF, True, 4) <= k1.SMEM_LIMIT
    assert not k1.fits_smem(NZ, 512, 4)
    assert not k1.fits_smem(NZ, NDF + 2, 4) and not k1.fits_smem(NZ + 2, NDF, 4)



def test_fit_rule_at_nz100():
    """K1 at nz = 100 (svhn, celeba64): a multiple of 4, as the float4 reads
    of z need; 88,128 bytes of shared memory a block; each block 50 of the
    200 hidden columns, its slices at a row stride of 52 floats."""
    assert k1.fits_smem(100, 200, 4) and k1.smem_bytes(100, 200, True, 4) == 88128
    assert k1.slice_ld(50) == 52 and k1.column_ranges(200, 4) == [(0, 50), (50, 100), (100, 150), (150, 200)]

@pytest.mark.parametrize("ndf", [8, 16, 200, 512])
def test_blocks_hold_every_hidden_column_once(ndf):
    """The blocks of a cluster of 4 hold every hidden column exactly once, a split
    that depends on ndf alone, so a chain's partial sums, added in rank
    order, do not depend on B or on the chain's slot; the weight slices'
    row stride is a multiple of 4 with an odd quarter and holds the
    slice."""
    ranges = k1.column_ranges(ndf, 4)
    assert len(ranges) == 4
    assert [j for a, e in ranges for j in range(a, e)] == list(range(ndf))
    j = ndf // 4
    ld = k1.slice_ld(j)
    assert ld >= j and ld % 4 == 0 and (ld // 4) % 2 == 1

def _moments_close(got, want, n):
    """Per-dimension mean within 5 sd of a difference of two means
    (5 sigma sqrt(2 / n)) and std within 5 sd of a difference of two sample
    stds (5 sigma sqrt(1 / n)), sigma the dimension's std."""
    sigma = want.std(0)
    d_mean = np.abs(got.mean(0) - want.mean(0))
    d_std = np.abs(got.std(0) - sigma)
    assert (d_mean <= 5 * sigma * np.sqrt(2 / n)).all(), (d_mean, sigma)
    assert (d_std <= 5 * sigma * np.sqrt(1 / n)).all(), (d_std, sigma)


def test_stream_mode_chain_matches_jax_scan_in_distribution():
    """The port's stream-mode chain (plain version) against the JAX scan
    chain with threefry noise, over 4096 chains from the same starts at
    tiny widths (nz=8, ndf=16), 60 steps of 0.4: the noise differs, the
    distribution of z_60 must not (bounds in `_moments_close`)."""
    n, nz, ndf = 4096, 8, 16
    r = np.random.default_rng(11)
    u = lambda shape, fan: (r.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)
    w = (u((nz, ndf), nz), u((ndf,), nz), u((ndf, ndf), ndf), u((ndf,), ndf), u((ndf,), ndf))
    z = r.normal(size=(n, nz)).astype(np.float32)
    k1w, b1, k2w, b2, k3 = map(jnp.asarray, w)
    lrelu = lambda h: jnp.where(h >= 0, h, 0.2 * h)
    ebm_fn = lambda zz: lrelu(lrelu(zz @ k1w + b1) @ k2w + b2) @ k3
    want, _ = jl.langevin_sample(jax.random.PRNGKey(5), jnp.asarray(z), jl.prior_energy(ebm_fn), 60, 0.4)
    got = _port(z, w, seed=12345, steps=60, step_size=0.4)
    _moments_close(got, np.asarray(want), n)
    assert np.abs(got - np.asarray(want)).max() > 0.5  # other noise, pointwise apart


def test_stream_and_counter_modes_of_the_plain_chain():
    """Stream mode equals counter mode fed `stream_row_seeds(seed, B)`, and
    `row_seeds` wins when both are given."""
    r = np.random.default_rng(12)
    z = r.normal(size=(6, NZ)).astype(np.float32)
    w = _weights(12)
    kw = dict(steps=3, step_size=0.4)
    rows = stream_row_seeds(77, 6)
    stream = _port(z, w, seed=77, **kw)
    assert np.array_equal(stream, _port(z, w, row_seeds=rows, **kw))
    counter = _port(z, w, row_seeds=torch.arange(6), **kw)
    assert np.array_equal(_port(z, w, seed=77, row_seeds=torch.arange(6), **kw), counter)
    assert not np.array_equal(stream, counter)
