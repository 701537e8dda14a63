"""K2, the reverse sweep: the plain version of the port's sweep kernel
against the JAX Pallas kernel (plain interpreter) at the CIFAR-10 denoiser
widths, the weight extraction from the port's denoiser, the Hopper fit
rule and the wrapper's dispatch rules."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.ops.pallas.fused_qsweep import fused_reverse_sweep as jax_sweep
from damc_tpu.ops.pallas.fused_qsweep import step_coefficients as jax_coeffs
from damc_tpu_torch.models import LatentDenoiser
from damc_tpu_torch.ops.cuda import fused_qsweep as k2

NZ, NARROW, WIDE = 128, 128, 256
DINS = [2 * NZ, NARROW, WIDE, WIDE, 2 * WIDE, 2 * WIDE, 2 * NARROW]
DOUTS = [NARROW, WIDE, WIDE, WIDE, WIDE, NARROW, NZ]


def _inputs(b, n, seed, scale=1.0):
    """Random weights (torch-default scale; `scale` damps the layers), step
    and sample tables at the cifar10 widths."""
    r = np.random.default_rng(seed)
    u = lambda shape, fan: (scale * r.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)
    fourier = r.normal(size=(NZ, NZ // 2)).astype(np.float32)
    layers = [
        (u((i, o), i), u((o,), i), u((i, o), i), u((o,), i), u((o, o), o), u((o,), o), u((o, o), o))
        for i, o in zip(DINS, DOUTS)
    ]
    pre_x = [r.normal(size=(b, o)).astype(np.float32) for o in DOUTS]
    pre_t = [r.normal(size=(n, o)).astype(np.float32) for o in DOUTS]
    z = r.normal(size=(b, NZ)).astype(np.float32)
    seeds = r.integers(0, 2**31 - 1, b).astype(np.int32)
    coeffs = np.array(jax_coeffs(n, -5.1, 9.8, "large"))
    return z, fourier, layers, pre_x, pre_t, coeffs, seeds


def _jax(z, fourier, layers, pre_x, pre_t, coeffs, seeds, n, noisy):
    j = jnp.asarray
    return np.asarray(
        jax_sweep(
            j(z), j(fourier), [tuple(map(j, lt)) for lt in layers], [j(t) for t in pre_x],
            [j(t) for t in pre_t], j(coeffs), steps=n, with_noise=noisy, residual=True,
            interpret="plain", row_seeds=j(seeds) if noisy else None,
        )
    )


def _port(z, fourier, layers, pre_x, pre_t, coeffs, seeds, n, noisy):
    t = torch.from_numpy
    return k2.reverse_sweep_plain(
        t(z), t(fourier), [tuple(map(t, lt)) for lt in layers], [t(a) for a in pre_x],
        [t(a) for a in pre_t], t(coeffs), row_seeds=t(seeds) if noisy else None, steps=n,
        with_noise=noisy, residual=True,
    ).numpy()


@pytest.mark.parametrize("noisy", [False, True], ids=["noiseless", "counter_noise"])
def test_plain_sweep_matches_jax_n6(noisy):
    """Six steps, atol 2e-4 / rtol 1e-4 (the JAX suite's bound for the fused
    sweep against its scan at n=6). The layers are damped to half the
    torch-default scale: at full scale random weights amplify float32
    rounding ~1e4-fold in six steps (1.4e-2 between fp32 and fp64 of the
    same plain version), beyond any fp32 pair's reach. Counter noise
    enters with the same bits on both sides."""
    args = _inputs(10, 6, seed=11, scale=0.5)
    got, want = _port(*args, 6, noisy), _jax(*args, 6, noisy)
    assert np.isfinite(got).all() and got.shape == (10, NZ)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_plain_sweep_matches_jax_full_scale_two_steps():
    """Full-scale random weights over two noisy steps, atol 2e-4 / rtol 1e-4."""
    args = _inputs(8, 2, seed=12)
    np.testing.assert_allclose(_port(*args, 2, True), _jax(*args, 2, True), atol=2e-4, rtol=1e-4)


def test_denoiser_layer_params_follow_the_module():
    torch.manual_seed(0)
    den = LatentDenoiser(NZ, nxemb=32, ntemb=16, nf=4, residual=True)
    fourier, layers = k2.denoiser_layer_params(den)
    assert fourier.shape == (NZ, NZ // 2) and len(layers) == 7
    assert [tuple(lt[0].shape) for lt in layers] == list(zip(DINS, DOUTS))
    lin = den.out_layers[1]._layer[0]
    assert torch.equal(layers[5][0], lin.weight.t()) and layers[5][0].is_contiguous()
    assert layers[0][6].shape == (NARROW, NARROW)  # hyper_k, no bias
    h = torch.randn(3, DINS[2])
    assert torch.allclose(h @ layers[2][2] + layers[2][3], den.in_layers[2]._skip(h), atol=1e-6)


def test_fit_rule():
    """CIFAR-10 widths fit a Hopper block at 8 rows; the StyleGAN width
    (1024 hidden, nz=7168) does not and waits for its own slice."""
    assert k2.fits_smem(NZ, DINS, DOUTS)
    assert k2.smem_bytes(NZ, DINS, DOUTS) == 4 * 8 * (NZ + 512 + 2 * 256 + 128 + 256 + 256)
    nz, w = 7168, 1024
    s_dins = [2 * nz, w, w, w, 2 * w, 2 * w, 2 * w]
    s_douts = [w, w, w, w, w, w, nz]
    assert not k2.fits_smem(nz, s_dins, s_douts)
    assert not k2.fits_smem(NZ + 2, [d + 2 * (i == 0) for i, d in enumerate(DINS)], DOUTS)  # float4 rows


def test_wrapper_dispatch_rules():
    z, fourier, layers, pre_x, pre_t, coeffs, seeds = _inputs(3, 2, seed=13)
    t = torch.from_numpy
    args = (t(z), t(fourier), [tuple(map(t, lt)) for lt in layers], [t(a) for a in pre_x],
            [t(a) for a in pre_t], t(coeffs))
    before = k2.fused_reverse_sweep.launches
    out = k2.fused_reverse_sweep(*args, row_seeds=t(seeds), steps=2)
    assert k2.fused_reverse_sweep.launches == before  # CPU tensors: the plain version
    assert torch.equal(out, k2.reverse_sweep_plain(*args, row_seeds=t(seeds), steps=2))
    with pytest.raises(ValueError, match="row_seeds"):
        k2.fused_reverse_sweep(*args, steps=2)
    meta = (args[0].to("meta"),) + args[1:]
    with pytest.raises(ValueError, match="device"):
        k2.fused_reverse_sweep(*meta, steps=2, with_noise=False)
