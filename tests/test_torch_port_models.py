"""The port's models against the JAX package's, with the JAX weights carried
over by `damc_tpu_torch.convert`: G, the encoder, the EBM, the prior
embedder, the denoiser (full call and the hoisted tables), plus weight
loading and seeded init. Tolerances: fp32 on both sides with sums taken in
other orders (atol 1e-5 on O(1) outputs unless stated)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from damc_tpu.ops.diffusion import sweep_logsnr_grid
from damc_tpu.utils import torch_compat
from damc_tpu_torch.config import preset
from damc_tpu_torch.convert import load_reference_checkpoint, state_dicts_from_jax
from damc_tpu_torch.models import build_models
from torch_port_helpers import jax_and_port, tiny, to_numpy

ATOL = 1e-5


@pytest.fixture(scope="module", params=["cifar10", "svhn"])
def pair(request):
    return jax_and_port(seed=3, preset_name=request.param)


def _np(t):
    return t.detach().numpy()


def _rng(seed=0):
    return np.random.default_rng(seed)


def test_generator_forward(pair):
    cfg_j, state, models_j, cfg_p, models_p = pair
    z = _rng().normal(size=(3, cfg_p.model.nz)).astype(np.float32)
    want = np.asarray(models_j.generator.apply(state.params_g, z))
    got = _np(models_p.generator(torch.from_numpy(z)))
    assert got.shape == want.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_encoder_forward(pair):
    cfg_j, state, models_j, cfg_p, models_p = pair
    x = _rng(1).uniform(-1, 1, size=(3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(models_j.amortizer.apply(state.params_q, x, method="encode"))
    got = _np(models_p.amortizer.encode(torch.from_numpy(x)))
    assert got.shape == want.shape == (3, cfg_p.model.nxemb)
    np.testing.assert_allclose(got, want, atol=1e-4)  # instance norms over 1-4 pixels amplify


def test_ebm_forward(pair):
    cfg_j, state, models_j, cfg_p, models_p = pair
    z = _rng(2).normal(size=(5, cfg_p.model.nz)).astype(np.float32)
    want = np.asarray(models_j.ebm.apply(state.params_e, z))
    got = _np(models_p.ebm(torch.from_numpy(z)))
    assert got.shape == want.shape == (5,)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_prior_embedder_forward(pair):
    cfg_j, state, models_j, cfg_p, models_p = pair
    noise = _rng(3).normal(size=(4, cfg_p.model.nz)).astype(np.float32)
    want = np.asarray(models_j.amortizer.apply(state.params_q, noise, method="prior_embed"))
    got = _np(models_p.amortizer.prior_embed(torch.from_numpy(noise)))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_denoiser_forward(pair):
    cfg_j, state, models_j, cfg_p, models_p = pair
    r = _rng(4)
    b, nz, nxemb = 4, cfg_p.model.nz, cfg_p.model.nxemb
    z = r.normal(size=(b, nz)).astype(np.float32)
    logsnr = r.uniform(-5, 9, size=(b,)).astype(np.float32)
    xemb = r.normal(size=(b, nxemb)).astype(np.float32)
    want = np.asarray(models_j.amortizer.apply(state.params_q, z, logsnr, xemb, method="denoise"))
    got = _np(models_p.amortizer.denoise(*map(torch.from_numpy, (z, logsnr, xemb))))
    np.testing.assert_allclose(got, want, atol=1e-4)  # 2 pi z B reaches tens of radians


def test_sample_tables_and_denoise_from_tables(pair):
    cfg_j, state, models_j, cfg_p, models_p = pair
    r = _rng(5)
    b, nz, nxemb = 3, cfg_p.model.nz, cfg_p.model.nxemb
    grid, _ = sweep_logsnr_grid(7, -5.1, 9.8)
    xemb = r.normal(size=(b, nxemb)).astype(np.float32)
    z = r.normal(size=(b, nz)).astype(np.float32)
    tabs_j = models_j.amortizer.apply(
        state.params_q, grid, xemb, method=lambda m, g, e: m.p.sample_tables(g, e)
    )
    p = models_p.amortizer.p
    tabs_p = p.sample_tables(torch.from_numpy(np.array(grid)), torch.from_numpy(xemb))
    for key in ("pre_t", "pre_x"):
        assert len(tabs_p[key]) == 7
        for g, w in zip(tabs_p[key], tabs_j[key]):
            np.testing.assert_allclose(_np(g), np.asarray(w), atol=ATOL)
    step = 2
    want = np.asarray(
        models_j.amortizer.apply(
            state.params_q, z, [t[step] for t in tabs_j["pre_t"]], tabs_j["pre_x"],
            method=lambda m, zz, t, xx: m.p.denoise_from_tables(zz, t, xx),
        )
    )
    got = _np(p.denoise_from_tables(torch.from_numpy(z), [t[step] for t in tabs_p["pre_t"]], tabs_p["pre_x"]))
    np.testing.assert_allclose(got, want, atol=1e-4)
    # The hoisted split equals the full call at the same logsnr.
    full = _np(p(torch.from_numpy(z), torch.full((b,), float(grid[step])), torch.from_numpy(xemb)))
    np.testing.assert_allclose(got, full, atol=1e-4)


def test_state_dicts_equal_the_jax_packages_export(pair):
    """The port's own copy of the export maps gives exactly the arrays of
    `damc_tpu.utils.torch_compat.export_*`."""
    cfg_j, state, models_j, cfg_p, models_p = pair
    sds = state_dicts_from_jax(
        {"params_g": to_numpy(state.params_g), "params_e": to_numpy(state.params_e),
         "params_q": to_numpy(state.params_q)}
    )
    refs = {
        "generator": torch_compat.export_generator(state.params_g),
        "ebm": torch_compat.export_ebm(state.params_e),
        "amortizer": torch_compat.export_amortizer(state.params_q, cfg_j.model.dataset, cfg_j.model.nxemb),
    }
    for name, ref in refs.items():
        assert set(sds[name]) == set(ref), name
        for k, v in ref.items():
            assert np.array_equal(sds[name][k].numpy(), np.asarray(v)), (name, k)


def test_reference_checkpoint_loads_strictly(pair, tmp_path):
    """A `.pth.tar` written by the JAX package's exporter (with the
    reference's unused `xemb` key) loads strictly into the port."""
    cfg_j, state, models_j, cfg_p, models_p = pair
    path = str(tmp_path / "ckpt.pth.tar")
    torch_compat.export_reference_checkpoint(
        state, path, dataset=cfg_j.model.dataset, nxemb=cfg_j.model.nxemb
    )
    fresh = build_models(cfg_p, seed=99, device="cpu")
    assert load_reference_checkpoint(fresh, path) == int(state.step)
    for a, b in zip(fresh.modules(), models_p.modules()):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)


def test_build_models_seeded_torch_default_init():
    cfg = tiny(preset("cifar10"))
    a = build_models(cfg, seed=4, device="cpu")
    b = build_models(cfg, seed=4, device="cpu")
    c = build_models(cfg, seed=5, device="cpu")
    for ma, mb, mc in zip(a.modules(), b.modules(), c.modules()):
        for (k, va), vb, vc in zip(ma.state_dict().items(), mb.state_dict().values(), mc.state_dict().values()):
            assert torch.equal(va, vb), k
            if k != "xemb" and not k.endswith("norm") and va.numel() > 1 and va.std() > 0:
                assert not torch.equal(va, vc), k
    lin = a.ebm.ebm[0]
    bound = 1 / math.sqrt(lin.in_features)
    assert lin.weight.abs().max() <= bound and lin.weight.abs().max() > 0.5 * bound
    deconv = a.generator.gen[2]  # fan_in from the output channels, as torch
    bound = 1 / math.sqrt(deconv.weight.shape[1] * 16)
    assert deconv.weight.abs().max() <= bound and deconv.bias.abs().max() <= bound
    assert abs(a.amortizer.p.B.std().item() - 1.0) < 0.5  # N(0, 1) Fourier features
    assert not any(p.requires_grad for m in a.modules() for p in m.parameters())
