"""The unfused reverse sweep and the autograd prior chain against the JAX
package on the CPU: `ops/reverse_diffusion.py` against JAX's scan (noiseless,
with JAX's noise, guided, with hoisted step tables), `sample_q`'s three
routes against JAX's `sample_q(..., fused=False)`, the static route rule,
`prior_langevin_auto(use_pallas=False)` and one training iteration with
`use_pallas=False` against JAX's scan chain.

Randomness is JAX's own: the tests split the JAX keys as the JAX functions
do and pass the normals to the port. Tolerance of the sweeps, SWEEP_TOL:
`tests/test_reverse_diffusion.py`'s rtol 1e-5 / atol 1e-6 holds for its
linear stand-in denoiser, not for a real one. Each step's x0-prediction
multiplies the denoiser's float32 rounding by 1/alpha (12.8 at logsnr
-5.1) after the cancellation z - sigma eps (sigma 0.997 there), so the two
libraries' sums, taken in other orders, part by 1.4e-6 to 1.2e-5 after 6
steps (measured on the tiny svhn-width Q, nz 8, and on the StyleGAN-family
Q, 1024-wide, nz 8). The tests hold them at atol 5e-5 / rtol 1e-4, about
four times the widest gap; the K2 tests hold their sweep at atol 2e-4 /
rtol 1e-4."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.models.amortizer import DAMCAmortizer as JaxAmortizer
from damc_tpu.models.amortizer import sample_q as jax_sample_q
from damc_tpu.ops.diffusion import sweep_logsnr_grid as jax_sweep_grid
from damc_tpu.ops.langevin import prior_langevin_auto as jax_prior_langevin_auto
from damc_tpu.ops.reverse_diffusion import reverse_diffusion_sample as jax_reverse
from damc_tpu.train.state import create_state as jax_create_state
from damc_tpu.train.step import make_train_step as jax_make_train_step
from damc_tpu_torch.convert import amortizer_state, train_state_from_jax
from damc_tpu_torch.models import DAMCAmortizer, sample_q, sample_q_per_item, sweep_route
from damc_tpu_torch.ops.diffusion import sweep_logsnr_grid
from damc_tpu_torch.ops.langevin import prior_langevin_auto
from damc_tpu_torch.ops.noise import counter_normals
from damc_tpu_torch.ops.reverse_diffusion import reverse_diffusion_sample
from damc_tpu_torch.train.state import create_state
from damc_tpu_torch.train.step import draw_step, make_train_step
from test_torch_port_train import _assert_metrics, _assert_state, _noiseless, _x
from torch_port_helpers import jax_and_port, jax_step_draws, one_torch_thread, to_numpy, train_cfgs

N = 6
LO, HI = -5.1, 9.8
SWEEP_TOL = dict(atol=5e-5, rtol=1e-4)  # module docstring


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def sweep_draws(key, n, b, nz, guided):
    """(ancestral normals (n, B, nz), guide normals or None) of JAX's
    `reverse_diffusion_sample(key, ...)` (:84-96): one key a step, split in
    two under guidance (the first feeds the unconditional embedding)."""
    noise, guide = [], []
    for sk in jax.random.split(key, n):
        if guided:
            ck, sk = jax.random.split(sk)
            guide.append(np.asarray(jax.random.normal(ck, (b, nz))))
        noise.append(np.asarray(jax.random.normal(sk, (b, nz))))
    return t(np.stack(noise)), (t(np.stack(guide)) if guided else None)


@pytest.mark.parametrize("mode", ["noiseless", "noise", "guided", "step_xs"])
def test_unfused_sweep_matches_jax(mode):
    """`reverse_diffusion_sample` over the tiny Q's denoiser against JAX's
    scan on the same z_T and JAX's draws, 6 steps, at SWEEP_TOL."""
    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=3)
    q_j, q_p, params = models_j.amortizer, models_p.amortizer, state.params_q
    b, nz = 5, cfg_p.model.nz
    r = np.random.default_rng(0)
    z0 = r.normal(size=(b, nz)).astype(np.float32)
    xemb = r.normal(size=(b, cfg_p.model.nxemb)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    with_noise, guided = mode != "noiseless", mode == "guided"
    noise, guide = sweep_draws(key, N, b, nz, guided)
    kw_j, kw_p = {}, {}
    if mode == "step_xs":
        grid, _ = jax_sweep_grid(N, LO, HI)
        tabs = q_j.apply(params, grid, jnp.asarray(xemb), method=lambda m, g, e: m.p.sample_tables(g, e))
        den_j = lambda z, l, s: q_j.apply(
            params, z, s, tabs["pre_x"], method=lambda m, zz, tt, xx: m.p.denoise_from_tables(zz, tt, xx))
        tabs_p = q_p.p.sample_tables(sweep_logsnr_grid(N, LO, HI)[0], t(xemb))
        den_p = lambda z, l, s: q_p.p.denoise_from_tables(z, s, tabs_p["pre_x"])
        kw_j["step_xs"], kw_p["step_xs"] = tabs["pre_t"], tabs_p["pre_t"]
    else:
        den_j = lambda z, l: q_j.apply(params, z, l, jnp.asarray(xemb), method="denoise")
        den_p = lambda z, l: q_p.denoise(z, l, t(xemb))
    if guided:
        kw_j.update(cond_w=0.5, guided_denoise_fn=lambda k, z, l: q_j.apply(
            params, z, l, q_j.apply(params, jax.random.normal(k, (b, nz)), method="prior_embed"),
            method="denoise"))
        kw_p.update(cond_w=0.5, guide_noise=guide,
                    guided_denoise_fn=lambda g, z, l: q_p.denoise(z, l, q_p.prior_embed(g)))
    want = np.asarray(jax_reverse(key, den_j, jnp.asarray(z0), N, LO, HI, "large", with_noise, **kw_j))
    with torch.no_grad():
        got = reverse_diffusion_sample(den_p, t(z0), N, LO, HI, "large", with_noise, noise=noise, **kw_p)
    np.testing.assert_allclose(got.numpy(), want, **SWEEP_TOL)
    if guided:  # guidance moves the result
        plain = reverse_diffusion_sample(den_p, t(z0), N, LO, HI, "large", True, noise=noise)
        assert float((plain - got).abs().max()) > 1e-3


def _stylegan_family(seed: int, nz: int = 8):
    """The StyleGAN Q's structure (no encoder, 1024-wide hidden layers) at
    nz = nxemb = 8, ntemb 16, n = 6: JAX's init carried into the port."""
    kw = dict(nz=nz, nxemb=nz, ntemb=16, dataset="stylegan", n_interval=N)
    q_j = JaxAmortizer(**kw)
    params = q_j.init(jax.random.PRNGKey(seed), jnp.zeros((1, nz)))
    q_p = DAMCAmortizer(**kw)
    q_p.load_state_dict({k: t(v) for k, v in amortizer_state(to_numpy(params), nz).items()}, strict=True)
    return q_j, params, q_p.eval()


@pytest.mark.parametrize("case", ["guided_x", "guided_xemb", "tables_xemb"])
def test_sample_q_routes_match_jax(case):
    """`sample_q` against JAX's `sample_q(..., fused=False)` from one key:
    z_init and every normal taken from JAX's split. guided_x: the tiny Q
    conditioned on images, cond_w 0.5 (route "guided"); guided_xemb: the
    StyleGAN-family Q on an embedding, cond_w 0.5 ("guided"); tables_xemb:
    the same Q without guidance, which K2 does not take ("tables", JAX's
    hoisted scan). At SWEEP_TOL."""
    key = jax.random.PRNGKey(5)
    k_init, _, k_sweep = jax.random.split(key, 3)
    r = np.random.default_rng(1)
    b = 4
    cond_w = 0.0 if case == "tables_xemb" else 0.5
    if case == "guided_x":
        cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=4)
        q_j, params, q_p = models_j.amortizer, state.params_q, models_p.amortizer
        x = r.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
        want = jax_sample_q(params, q_j, key, x=jnp.asarray(x), cond_w=cond_w, fused=False)
        cond = dict(x=t(x))
    else:
        q_j, params, q_p = _stylegan_family(seed=6)
        xemb = r.normal(size=(b, q_p.nxemb)).astype(np.float32)
        want = jax_sample_q(params, q_j, key, xemb=jnp.asarray(xemb), cond_w=cond_w, fused=False)
        cond = dict(x=None, xemb=t(xemb))
    nz = q_p.nz
    assert sweep_route(q_p, cond_w, True) == ("tables" if case == "tables_xemb" else "guided")
    noise, guide = sweep_draws(k_sweep, q_p.n_interval, b, nz, cond_w > 0)
    z_init = t(jax.random.normal(k_init, (b, nz)))
    x_arg = cond.pop("x")
    got = sample_q(q_p, x_arg, z_init, 0, cond_w=cond_w, noise=noise, guide_noise=guide, **cond)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SWEEP_TOL)


def test_sweep_route_is_static():
    """The rule at the cifar10, toy and StyleGAN widths, from shapes alone
    (the modules live on the meta device): K2 for the first two, the
    tables loop for the StyleGAN Q (nz 7168, widths 1024), guidance only on
    a conditional draw. Per-item serving runs the tables loop for a
    denoiser K2 cannot take, with K2's counter normals for its row seeds
    (the same loop as `sample_q` fed those normals), and refuses K2 for it
    when asked."""
    with torch.device("meta"):
        cifar = DAMCAmortizer(nz=128, nxemb=1024, ntemb=128, dataset="cifar10")
        toy = DAMCAmortizer(nz=2, nxemb=128, ntemb=128, dataset="toy", nc=2)
        sg = DAMCAmortizer(nz=7168, nxemb=7168, ntemb=128, dataset="stylegan")
    assert [sweep_route(q) for q in (cifar, toy, sg)] == ["k2", "k2", "tables"]
    assert [sweep_route(q, 0.5, True) for q in (cifar, toy, sg)] == ["guided"] * 3
    assert [sweep_route(q, 0.5, False) for q in (cifar, toy, sg)] == ["k2", "k2", "tables"]
    assert sg.encoder is None and not any(k.startswith("encoder.") for k in sg.state_dict())
    widths = {(l.dim_in, l.dim_out) for l in sg.p.all_layers}
    assert widths == {(2 * 7168, 1024), (1024, 1024), (2048, 1024), (2048, 7168)}
    small = _stylegan_family(seed=0)[2]
    r = np.random.default_rng(2)
    z, emb = t(r.normal(size=(3, 8))), t(r.normal(size=(3, 8)))
    seeds = torch.tensor([5, -9, 2**31 - 1], dtype=torch.int32)
    got = sample_q_per_item(small, z, seeds, emb_noise=emb)
    want = sample_q(small, None, z, 0, emb_noise=emb, noise=counter_normals(seeds, N - 1, 8))
    assert torch.equal(got, want)
    assert torch.equal(sample_q_per_item(small, z, seeds, emb_noise=emb, fused=False), got)
    with pytest.raises(ValueError, match="fits_smem"):
        sample_q_per_item(small, z, seeds, emb_noise=emb, fused=True)


@pytest.mark.parametrize("with_noise", [False, True], ids=["noiseless", "noise"])
def test_prior_langevin_without_pallas_matches_jax(with_noise):
    """`prior_langevin_auto(use_pallas=False)` runs the standard 2-hidden
    EBM by autograd, as JAX's scan path: 6 steps at 0.4 over 7 chains, JAX's
    per-step normals injected; chains and final energies at atol 1e-5."""
    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=2)
    r = np.random.default_rng(3)
    z = r.normal(size=(7, cfg_p.model.nz)).astype(np.float32)
    key, steps = jax.random.PRNGKey(9), 6
    zj, ej = jax_prior_langevin_auto(key, jnp.asarray(z), models_j.ebm, state.params_e, steps, 0.4,
                                     with_noise, use_pallas=False)
    noise = t(np.stack([np.asarray(jax.random.normal(k, z.shape)) for k in jax.random.split(key, steps)]))
    ebm = models_p.ebm.requires_grad_(True)
    zp, ep = prior_langevin_auto(t(z), ebm, steps, 0.4, with_noise, use_pallas=False, noise=noise)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=1e-5)
    np.testing.assert_allclose(ep.numpy(), np.asarray(ej), atol=1e-5, rtol=1e-6)
    assert all(p.requires_grad for p in ebm.parameters())  # frozen only inside the chain
    with pytest.raises(ValueError, match="use_pallas"):
        prior_langevin_auto(t(z), ebm, steps, 0.4, with_noise, use_pallas=False, seed=1)


def test_train_step_without_pallas_matches_jax():
    """One iteration of `make_train_step` with use_pallas=False (the prior
    chain by autograd, with its noise on) against JAX's step on its scan
    paths, every draw from the JAX key tree (the chain's normals from the
    prior key): metrics at rtol 1e-5 and parameters as in
    test_torch_port_train."""
    def edit(cfg):
        cfg = _noiseless(cfg)
        return dataclasses.replace(
            cfg, mcmc=dataclasses.replace(cfg.mcmc, e_l_with_noise=True),
            train=dataclasses.replace(cfg.train, use_pallas=False),
        )

    cfg_j, cfg_p = map(edit, train_cfgs("svhn"))
    state, models_j, opts_j = jax_create_state(jax.random.PRNGKey(0), cfg_j)
    port = train_state_from_jax(to_numpy(state), cfg_p, device="cpu")
    x = _x(cfg_j, np.random.default_rng(5))
    draws = jax_step_draws(state.rng, cfg_j, len(x))
    assert draws.chain_noise is not None and draws.chain_noise.shape == (cfg_j.mcmc.e_l_steps, 2 * len(x), 8)
    state, mj = jax.jit(jax_make_train_step(models_j, opts_j, cfg_j))(state, jnp.asarray(x))
    port, mp = make_train_step(port.models, port.opts, cfg_p)(port, torch.from_numpy(x), draws)
    _assert_metrics(mp, mj)
    _assert_state(port, state, cfg_j, 1)


def test_draw_step_adds_chain_noise_last():
    """With use_pallas off, draw_step adds the chain's normals after every
    other draw, so the K1 path's draws do not change."""
    _, cfg = train_cfgs("svhn")
    off = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_pallas=False))
    d_on = draw_step(cfg, 4, create_state(cfg, seed=1, device="cpu"))
    d_off = draw_step(off, 4, create_state(off, seed=1, device="cpu"))
    assert d_on.chain_noise is None and d_off.chain_noise.shape == (cfg.mcmc.e_l_steps, 8, cfg.model.nz)
    assert torch.equal(d_on.post_noise, d_off.post_noise) and torch.equal(d_on.q[-1][0].eps, d_off.q[-1][0].eps)


def test_ebm_prior_samples_follow_use_pallas():
    """The eval sampler passes `use_pallas` on, as JAX's does: off, the
    chain runs by autograd with normals from a device generator seeded with
    the draws' K1 seed, so two calls agree and equal that chain decoded."""
    from damc_tpu_torch.train.sampling import eval_draws, gen_samples_ebm_prior

    _, cfg = train_cfgs("svhn")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_pallas=False))
    models = create_state(cfg, seed=2, device="cpu").models
    d = eval_draws(3, "fid_ebm", 0, 0, 4, cfg.model.nz, "cpu")
    a, b = gen_samples_ebm_prior(models, cfg, d), gen_samples_ebm_prior(models, cfg, d)
    mc = cfg.mcmc
    gen = torch.Generator().manual_seed(d.chain_seed & 0xFFFFFFFF)
    z, _ = prior_langevin_auto(d.z0, models.ebm, mc.e_l_steps, mc.e_l_step_size, mc.e_l_with_noise,
                               use_pallas=False, generator=gen)
    with torch.no_grad():
        want = models.generator(z)
    assert torch.equal(a, b) and torch.equal(a, want)
