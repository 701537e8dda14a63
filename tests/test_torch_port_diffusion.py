"""The port's diffusion math (`damc_tpu_torch/ops/diffusion.py`) against
`damc_tpu/ops/diffusion.py` and the sweep kernel's coefficient table.
All float32 on both sides; tolerances are a few float32 ulps."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.ops import diffusion as jd
from damc_tpu.ops.pallas.fused_qsweep import step_coefficients as jax_step_coefficients
from damc_tpu_torch.ops import diffusion as td

LMIN, LMAX = -5.1, 9.8


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def test_logsnr_schedule():
    t = np.linspace(0.0, 1.0, 101, dtype=np.float32)
    want = np.asarray(jd.logsnr_schedule(t, LMIN, LMAX))
    got = td.logsnr_schedule(_t(t), LMIN, LMAX).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert abs(got[0] - LMAX) < 1e-4 and abs(got[-1] - LMIN) < 1e-4


@pytest.mark.parametrize("x", [1e-3, 0.3, 0.6931, 0.7, 2.0, 15.0])
def test_log1mexp_value_and_gradient_both_branches(x):
    want = float(jd.log1mexp(jnp.float32(x)))
    want_grad = float(jax.grad(jd.log1mexp)(jnp.float32(x)))
    xt = torch.tensor(x, dtype=torch.float32, requires_grad=True)
    y = td.log1mexp(xt)
    y.backward()
    assert y.item() == pytest.approx(want, rel=1e-5, abs=1e-6)
    assert xt.grad.item() == pytest.approx(want_grad, rel=1e-5)
    assert xt.grad.item() == pytest.approx(1.0 / np.expm1(x), rel=1e-5)


def test_pred_x_from_eps():
    rng = np.random.default_rng(0)
    z, eps = rng.normal(size=(2, 6, 4)).astype(np.float32)
    logsnr = rng.uniform(LMIN, LMAX, size=(6, 1)).astype(np.float32)
    want = np.asarray(jd.pred_x_from_eps(z, eps, logsnr))
    got = td.pred_x_from_eps(_t(z), _t(eps), _t(logsnr)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("var_type", ["large", "small"])
def test_diffusion_reverse(var_type):
    rng = np.random.default_rng(1)
    x, z = rng.normal(size=(2, 8, 3)).astype(np.float32)
    lt, ls = jd.sweep_logsnr_grid(8, LMIN, LMAX)
    lt, ls = np.asarray(lt)[:, None], np.asarray(ls)[:, None]
    want = jd.diffusion_reverse(x, z, ls, lt, var_type)
    got = td.diffusion_reverse(_t(x), _t(z), _t(ls), _t(lt), var_type)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=1e-5)
    with pytest.raises(ValueError):
        td.diffusion_reverse(_t(x), _t(z), _t(ls), _t(lt), "medium")


def test_sweep_logsnr_grid():
    for w, g in zip(jd.sweep_logsnr_grid(100, LMIN, LMAX), td.sweep_logsnr_grid(100, LMIN, LMAX)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("var_type", ["large", "small"])
def test_step_coefficients_n100(var_type):
    """The (100, 6) table the sweep kernel reads, against the JAX kernel's
    own table, atol 1e-6."""
    want = np.asarray(jax_step_coefficients(100, LMIN, LMAX, var_type))
    got = td.step_coefficients(100, LMIN, LMAX, var_type).numpy()
    assert got.shape == (100, 6) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert got[-1, 5] == 1.0 and got[:-1, 5].sum() == 0.0


def test_denoise_true():
    """`denoise_true` against JAX's with the same normals (JAX's own draw
    from its key), per-row logSNR pairs of the 8-step grid, 'small' std;
    with a generator instead of normals the step is the same function of
    the generator's normals."""
    rng = np.random.default_rng(2)
    b, nz = 8, 5
    z, x0 = rng.normal(size=(2, b, nz)).astype(np.float32)
    lt, ls = (np.asarray(a) for a in jd.sweep_logsnr_grid(b, LMIN, LMAX))
    key = jax.random.PRNGKey(3)
    want = np.asarray(jd.denoise_true(key, jnp.asarray(z), jnp.asarray(x0), jnp.asarray(lt), jnp.asarray(ls)))
    noise = np.asarray(jax.random.normal(key, z.shape, jnp.float32))
    got = td.denoise_true(_t(z), _t(x0), _t(lt), _t(ls), noise=_t(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)
    drawn = td.denoise_true(_t(z), _t(x0), _t(lt), _t(ls), generator=torch.Generator().manual_seed(4))
    normals = torch.randn(z.shape, generator=torch.Generator().manual_seed(4))
    assert torch.equal(drawn, td.denoise_true(_t(z), _t(x0), _t(lt), _t(ls), noise=normals))
