"""The port's toy 2-D workload (`damc_tpu_torch/{data/pinwheel,
metrics/mmd,train/toy,cli/toy}.py`, the toy models and K2 at nz = 2) on the
CPU against the JAX package: the pinwheel sampler bit for bit, MMD^2 to
1e-6, `ToyGenerator`, `MLPEncoder`, the toy amortizer's loss and the
Gaussian posterior energy with the JAX weights carried by `convert.py`,
K2's plain version at the toy's widths against JAX's fused sweep (plain
interpreter), the parity eval on the JAX draws, the KDE plot's density grid
and colours, and the CLI at tiny sizes. The two-iteration toy step is in
tests/test_torch_port_train.py."""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.data.pinwheel import sample_pinwheel as jax_pinwheel
from damc_tpu.metrics import mmd as jax_mmd
from damc_tpu.ops.langevin import gaussian_posterior_energy as jax_energy
from damc_tpu.ops.pallas.fused_qsweep import fused_reverse_sweep as jax_sweep
from damc_tpu.ops.pallas.fused_qsweep import step_coefficients as jax_coeffs
from damc_tpu.train import toy as jax_toy
from damc_tpu_torch.cli import toy as toy_cli
from damc_tpu_torch.config import preset
from damc_tpu_torch.data.pinwheel import sample_pinwheel
from damc_tpu_torch.metrics import mmd
from damc_tpu_torch.models import MLPEncoder, ToyGenerator, build_models
from damc_tpu_torch.ops.cuda import fused_qsweep as k2
from damc_tpu_torch.ops.langevin import gaussian_posterior_energy
from damc_tpu_torch.train import toy
from damc_tpu_torch.train.state import create_state
from damc_tpu_torch.utils import logging as port_logging
from damc_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint, state_payload
from torch_port_helpers import jax_and_port, loss_draws
import torch_port_helpers


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from torch_port_helpers.one_torch_thread()


def _noiseless(cfg):
    return dataclasses.replace(cfg, diffusion=dataclasses.replace(cfg.diffusion, with_noise=False))


@pytest.fixture(scope="module")
def pair():
    """(jax cfg, jax state, jax models, port cfg, port models) of the toy at
    its own nz = 2 with tiny denoiser and embedding widths, noiseless Q."""
    return jax_and_port(seed=2, preset_name="toy", edit=_noiseless)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("batch,seed", [(500, 1), (7, 12), (64, 7920)])
def test_sample_pinwheel_equals_jax_bit_for_bit(batch, seed):
    got, want = sample_pinwheel(batch, seed), jax_pinwheel(batch, seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,m,given", [(200, 200, False), (151, 90, False), (120, 130, True)])
def test_mmd2_rbf_matches_jax(n, m, given):
    """The unbiased estimate within 1e-6 of JAX's, with the median-heuristic
    bandwidth (also within 1e-6 relative) or a given one; an even and an odd
    count of pooled pairs."""
    r = np.random.default_rng(n + m)
    x = r.normal(size=(n, 2)).astype(np.float32)
    y = (r.normal(size=(m, 2)) * 1.2 + 0.3).astype(np.float32)
    sigma2 = 0.7 if given else None
    want = float(jax_mmd.mmd2_rbf(jnp.asarray(x), jnp.asarray(y), sigma2))
    got = float(mmd.mmd2_rbf(torch.from_numpy(x), torch.from_numpy(y), sigma2))
    assert abs(got - want) <= 1e-6, (got, want)
    bw_j = float(jax_mmd.median_heuristic_bandwidth(jnp.asarray(x), jnp.asarray(y)))
    bw_p = float(mmd.median_heuristic_bandwidth(torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(bw_p - bw_j) <= 1e-6 * bw_j


def test_toy_models_match_jax(pair):
    """G (2 -> 128 -> 128 -> 128 -> 2) and Q's MLP encoder with the JAX
    weights carried by `state_dicts_from_jax`: atol 1e-5 (float32 products
    in another order). The bundle has no EBM."""
    cfg_j, state, models_j, cfg_p, models_p = pair
    assert models_p.ebm is None and isinstance(models_p.generator, ToyGenerator)
    assert isinstance(models_p.amortizer.encoder, MLPEncoder)
    r = np.random.default_rng(0)
    z = r.normal(size=(9, 2)).astype(np.float32)
    want = np.asarray(models_j.generator.apply(state.params_g, jnp.asarray(z)))
    with torch.no_grad():
        got = models_p.generator(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    x = r.normal(size=(9, 2)).astype(np.float32)
    want = np.asarray(models_j.amortizer.apply(state.params_q, jnp.asarray(x), method="encode"))
    with torch.no_grad():
        got = models_p.amortizer.encode(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_toy_amortizer_loss_and_gaussian_energy_match_jax(pair):
    """The masked DSM loss on 2-D observations with the JAX key's draws
    (atol 1e-5), and U(z) = ||G(z) - x||^2 / (2 0.25^2) + ||z||^2 / 2 with
    its gradient in z (rtol 1e-5)."""
    cfg_j, state, models_j, cfg_p, models_p = pair
    r = np.random.default_rng(1)
    b = 6
    z = r.normal(size=(b, 2)).astype(np.float32)
    x = r.normal(size=(b, 2)).astype(np.float32)
    mask = (r.uniform(size=(b, 1)) > 0.3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(models_j.amortizer.apply(
        state.params_q, key, jnp.asarray(z), jnp.asarray(x), jnp.asarray(mask), method="loss"))
    prior_noise, u, eps = (torch.from_numpy(a.copy()) for a in loss_draws(key, b, 2))
    with torch.no_grad():
        got = models_p.amortizer.loss(torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(mask),
                                      prior_noise=prior_noise, u=u, eps=eps)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    sigma = cfg_p.mcmc.g_llhd_sigma
    e_j = jax_energy(lambda zz: models_j.generator.apply(state.params_g, zz), jnp.asarray(x), sigma)
    g_j = np.asarray(jax.grad(lambda zz: e_j(zz).sum())(jnp.asarray(z)))
    e_p = gaussian_posterior_energy(models_p.generator, torch.from_numpy(x), sigma)
    zt = torch.from_numpy(z).requires_grad_(True)
    en = e_p(zt)
    (g_p,) = torch.autograd.grad(en.sum(), zt)
    np.testing.assert_allclose(en.detach().numpy(), np.asarray(e_j(jnp.asarray(z))), rtol=1e-5)
    np.testing.assert_allclose(g_p.numpy(), g_j, rtol=1e-5, atol=1e-5)


TOY_DINS = [4, 128, 256, 256, 512, 512, 256]
TOY_DOUTS = [128, 256, 256, 256, 256, 128, 2]


def _toy_sweep_inputs(b, n, seed, scale=0.5):
    """Random weights at the toy preset's denoiser widths (nz = 2, one
    Fourier pair, the last layer 2 wide), damped to `scale` of the
    torch-default range as the cifar10 sweep test damps them."""
    r = np.random.default_rng(seed)
    u = lambda shape, fan: (scale * r.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)
    fourier = r.normal(size=(2, 1)).astype(np.float32)
    layers = [
        (u((i, o), i), u((o,), i), u((i, o), i), u((o,), i), u((o, o), o), u((o,), o), u((o, o), o))
        for i, o in zip(TOY_DINS, TOY_DOUTS)
    ]
    pre_x = [r.normal(size=(b, o)).astype(np.float32) for o in TOY_DOUTS]
    pre_t = [r.normal(size=(n, o)).astype(np.float32) for o in TOY_DOUTS]
    z = r.normal(size=(b, 2)).astype(np.float32)
    seeds = r.integers(0, 2**31 - 1, b).astype(np.int32)
    coeffs = np.array(jax_coeffs(n, -5.1, 9.8, "large"))
    return z, fourier, layers, pre_x, pre_t, coeffs, seeds


@pytest.mark.parametrize("noisy", [False, True], ids=["noiseless", "counter_noise"])
def test_plain_sweep_at_nz2_matches_jax_fused_sweep(noisy):
    """K2's plain version at the toy's widths against JAX's fused Pallas
    sweep (plain interpreter), six steps: atol 2e-4 / rtol 1e-4, the bound
    of the cifar10-width test. The fit rule takes these widths, so on a
    card the wrapper launches the kernel for them."""
    z, fourier, layers, pre_x, pre_t, coeffs, seeds = _toy_sweep_inputs(10, 6, seed=3)
    assert k2.fits_smem(2, TOY_DINS, TOY_DOUTS)
    j = jnp.asarray
    want = np.asarray(jax_sweep(
        j(z), j(fourier), [tuple(map(j, lt)) for lt in layers], [j(a) for a in pre_x], [j(a) for a in pre_t],
        j(coeffs), steps=6, with_noise=noisy, residual=True, interpret="plain",
        row_seeds=j(seeds) if noisy else None,
    ))
    t = torch.from_numpy
    got = k2.fused_reverse_sweep(
        t(z), t(fourier), [tuple(map(t, lt)) for lt in layers], [t(a) for a in pre_x], [t(a) for a in pre_t],
        t(coeffs), row_seeds=t(seeds) if noisy else None, steps=6, with_noise=noisy, residual=True,
    ).numpy()
    assert got.shape == (10, 2) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_toy_bundle_and_state(pair):
    """build_models draws the toy G from N(0, 0.2^2) weights and N(0, 0.1^2)
    biases (the reference's init, moments within 5 sigma), the state trains
    Q alone with AdamW at weight decay 1e-2, and G stays frozen."""
    cfg = preset("toy")
    models = build_models(cfg, seed=0, device="cpu")
    ws = torch.cat([m.weight.flatten() for m in models.generator.net if isinstance(m, torch.nn.Linear)])
    bs = torch.cat([m.bias.flatten() for m in models.generator.net if isinstance(m, torch.nn.Linear)])
    for v, std in ((ws, 0.2), (bs, 0.1)):
        n = v.numel()
        assert abs(float(v.mean())) < 5 * std / n**0.5
        assert abs(float(v.std()) - std) < 5 * std / (2 * n) ** 0.5
    st = create_state(cfg, seed=0, device="cpu")
    assert st.models.ebm is None and st.opts.g is None and st.opts.e is None
    assert not any(p.requires_grad for p in st.models.generator.parameters())
    assert st.opts.q.opt.param_groups[0]["weight_decay"] == 1e-2


def test_toy_state_checkpoint_round_trip(tmp_path):
    """A toy state (no E, no G or E optimizer) saves with those parts as
    None and restores into another toy state; a checkpoint that holds a
    part the target lacks is refused."""
    cfg = preset("toy")
    src = create_state(cfg, seed=0, device="cpu")
    src.step = 5
    src.opts.q.count = 3
    save_checkpoint(str(tmp_path), "5", src)
    dst = restore_checkpoint(str(tmp_path), "5", create_state(cfg, seed=1, device="cpu"))
    assert dst.step == 5 and dst.seed == 0 and dst.opts.q.count == 3
    assert dst.models.ebm is None and dst.opts.g is None and dst.opts.e is None
    for mod in ("generator", "amortizer"):
        for a, b in zip(getattr(src.models, mod).parameters(), getattr(dst.models, mod).parameters()):
            assert torch.equal(a, b)
    payload = state_payload(src)
    payload["ebm"] = {}
    os.makedirs(tmp_path / "bad")
    torch.save(payload, tmp_path / "bad" / "state.pt")
    with pytest.raises(ValueError, match="'ebm'"):
        restore_checkpoint(str(tmp_path), "bad", dst)


def _jax_parity_draws(key, b, nz, gt_steps):
    """`toy.ToyDraws` holding the numbers the JAX `make_toy_parity_fn`
    draws from `key` (noiseless sweep: its stream seed unused)."""
    k_x, k_q, k_gt_init, k_gt = jax.random.split(key, 4)
    k_init = jax.random.split(k_q, 3)[0]
    gt = jax.vmap(lambda k: jax.random.normal(k, (b, nz)))(jax.random.split(k_gt, gt_steps))
    return toy.ToyDraws(
        _t(jax.random.normal(k_x, (b, 2))), _t(jax.random.normal(k_init, (b, nz))), 0,
        _t(jax.random.normal(k_gt_init, (b, nz))), _t(gt),
    )


def test_eval_toy_parity_matches_jax(pair):
    """Two batches of 40 with 20 ground-truth steps, every draw the JAX
    eval's (`fold_in(PRNGKey(seed), 10000 + i)`): both clouds at atol 1e-4,
    the recon losses at rtol 1e-5 and MMD^2 within 1e-6."""
    cfg_j, state, models_j, cfg_p, models_p = pair
    seed, b, gt_steps = 4, 40, 20
    want = jax_toy.eval_toy_parity(state, models_j, cfg_j, seed=seed, n_batches=2, batch=b, gt_steps=gt_steps)
    port = create_state(cfg_p, seed=0, device="cpu")
    port.models = models_p
    draws = lambda i, bb: _jax_parity_draws(jax.random.fold_in(jax.random.PRNGKey(seed), 10_000 + i), bb, 2, gt_steps)
    got = toy.eval_toy_parity(port, cfg_p, draws, seed=seed, n_batches=2, batch=b, gt_steps=gt_steps)
    np.testing.assert_allclose(got["zq"], want["zq"], atol=1e-4)
    np.testing.assert_allclose(got["zl"], want["zl"], atol=1e-4)
    for k in ("g_loss_q", "g_loss_l"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert abs(got["mmd2"] - want["mmd2"]) <= 1e-6


def test_toy_draws_are_a_pure_function_of_seed_iteration_and_batch():
    a = toy.toy_draws_fn(3, 100, 2, 5, "cpu")(1, 8)
    b = toy.toy_draws_fn(3, 100, 2, 5, "cpu")(1, 8)
    assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("obs_noise", "z0", "gt_init", "gt_noise"))
    assert a.gt_noise.shape == (5, 8, 2) and a.sweep_seed == b.sweep_seed
    for other in (toy.toy_draws_fn(4, 100, 2, 5, "cpu")(1, 8), toy.toy_draws_fn(3, 200, 2, 5, "cpu")(1, 8),
                  toy.toy_draws_fn(3, 100, 2, 5, "cpu")(2, 8)):
        assert not torch.equal(a.z0, other.z0) and a.sweep_seed != other.sweep_seed


def test_kde_grid_and_colours_match_the_jax_plot(monkeypatch, tmp_path):
    """The density grid the JAX `save_kde_plot` hands to `imshow` equals the
    port's, and each cell of the port's PNG has the colour matplotlib's
    viridis gives it (pixel equality with the figure is not the aim)."""
    import matplotlib
    import matplotlib.pyplot as plt
    from matplotlib.colors import Normalize

    from damc_tpu.utils.logging import save_kde_plot as jax_save_kde_plot

    samples = np.random.default_rng(2).normal(size=(300, 2)).astype(np.float32)
    seen = {}
    monkeypatch.setattr(plt, "imshow", lambda zs, **kw: seen.setdefault("zs", np.array(zs)))
    jax_save_kde_plot(samples, str(tmp_path / "jax.png"))
    zs = port_logging.kde_grid(samples)
    np.testing.assert_array_equal(zs, seen["zs"])
    px = port_logging.kde_pixels(zs)
    assert px.shape == (600, 600, 3) and px.dtype == np.uint8
    want = matplotlib.colormaps["viridis"](Normalize()(zs), bytes=True)[..., :3]
    np.testing.assert_array_equal(px[::port_logging.KDE_CELL, ::port_logging.KDE_CELL], want)
    path = tmp_path / "port.png"
    port_logging.save_kde_plot(samples, str(path))
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == port_logging.PNG_SIGNATURE and int.from_bytes(head[16:20], "big") == 600


def test_toy_cli_on_cpu(tmp_path):
    """Two iterations with a viz eval at each and a final one (2 reverse
    steps, 5 ground-truth steps, one batch of 500): eval rows with finite
    losses and MMD^2, a train row at 0, and two KDE plots per eval."""
    logs = str(tmp_path / "logs")
    state, res = toy_cli.main(["--iterations", "2", "--viz_iter", "1", "--viz_batches", "1", "--gt_steps", "5",
                               "--n_interval", "2", "--log_path", logs, "--device", "cpu"])
    assert state.step == 2 and res["zq"].shape == (500, 2)
    (run,) = os.listdir(os.path.join(logs, "toy"))
    run = os.path.join(logs, "toy", run)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    evals = [r for r in rows if r["phase"] == "eval"]
    assert [r["step"] for r in evals] == [0, 1, 2]
    assert all(np.isfinite(r[k]) for r in evals for k in ("g_loss_q", "g_loss_l", "mmd2"))
    assert [r["step"] for r in rows if r["phase"] == "train"] == [0]
    want = {f"{n}_lang_post_{w}.png" for n in ("0", "1", "final") for w in ("Q", "gt")}
    assert set(os.listdir(os.path.join(run, "viz"))) == want
