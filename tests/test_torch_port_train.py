"""The port's training slice against the JAX package on the CPU, at the tiny
svhn widths of `torch_port_helpers.tiny`: the DSM loss and its gradients,
the LR schedule, one clip + Adam/AdamW update against optax, two whole
iterations of `make_train_step` with every draw taken from the JAX key tree,
and `train_state_from_jax` continuing a JAX run.

The JAX step runs its own CPU paths: the scan sweep and scan chains. The
kernels' noise is off in the step tests (`e_l_with_noise=False`,
`with_noise=False`), because the port's stream noise is not the TPU's; the
posterior chain's noise is fed to both from the JAX keys.

Parameter tolerance after optimizer updates: Adam divides each gradient by
its own running RMS, so an element whose true gradient is zero (the conv
biases in front of InstanceNorm) or below Adam's eps = 1e-8 takes full
steps in a direction set by rounding noise, on either side. So at most
0.05% of a network's elements may differ by more than 1e-5 (about 1e-4 of
them do), and no element by more than `adam_cap`, the most two Adam runs of
that many updates can part."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from damc_tpu.train.state import create_state as jax_create_state
from damc_tpu.train.state import lr_schedule as jax_lr_schedule
from damc_tpu.train.state import make_optimizers as jax_make_optimizers
from damc_tpu.train.step import make_train_step as jax_make_train_step
from damc_tpu_torch.convert import (
    amortizer_state, ebm_state, generator_state, state_dicts_from_jax, train_state_from_jax,
)
from damc_tpu_torch.train.state import clip_by_global_norm_, create_state, lr_schedule
from damc_tpu_torch.train.step import draw_step, make_train_step
from torch_port_helpers import (
    adam_cap, jax_and_port, jax_step_draws, loss_draws, to_numpy, train_cfgs,
)

SHARE = 5e-4  # share of elements allowed past 1e-5 (module docstring)


def _noiseless(cfg):
    return dataclasses.replace(
        cfg,
        mcmc=dataclasses.replace(cfg.mcmc, e_l_with_noise=False, g_l_steps=5),
        diffusion=dataclasses.replace(cfg.diffusion, with_noise=False),
    )


def _assert_params(module, ref, lr, updates, what):
    sd = module.state_dict()
    total = bad = 0
    for k, v in ref.items():
        diff = (sd[k] - v).abs()
        total += diff.numel()
        bad += int((diff > 1e-5).sum())
        assert float(diff.max()) <= adam_cap(lr, updates, (0.5, 0.999)) + 1e-5, (what, k, float(diff.max()))
    assert bad <= SHARE * total, (what, bad, total)


def _jax_sds(state):
    sds = state_dicts_from_jax({
        "params_g": to_numpy(state.params_g), "params_e": to_numpy(state.params_e),
        "params_q": to_numpy(state.params_q),
    })
    sds["ema"] = state_dicts_from_jax(
        {"params_g": to_numpy(state.params_g), "params_q": to_numpy(state.params_q_ema)}
    )["amortizer"]
    return sds


def _assert_state(port, state, cfg, iters):
    o, q_up = cfg.optim, cfg.train.q_updates
    sds = _jax_sds(state)
    m = port.models
    _assert_params(m.generator, sds["generator"], o.g_lr, iters, "G")
    if m.ebm is not None:  # the toy has no EBM
        _assert_params(m.ebm, sds["ebm"], o.e_lr, iters, "E")
    _assert_params(m.amortizer, sds["amortizer"], o.q_lr, iters * q_up, "Q")
    _assert_params(port.amortizer_ema, sds["ema"], o.q_lr, iters * q_up, "Q_ema")


def _assert_metrics(mp, mj):
    """Every metric within rtol 1e-5 / atol 1e-5: float32 sums taken in other
    orders, on values up to O(1e4) (the posterior energy)."""
    assert set(mp) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mp[k]), float(mj[k]), rtol=1e-5, atol=1e-5, err_msg=k)


def _x(cfg, rng):
    m = cfg.model
    b, s = cfg.train.batch_size, m.image_size
    if m.dataset == "toy":  # 2-D observations
        return rng.normal(size=(b, 2)).astype(np.float32)
    if m.dataset in ("celeba64", "celebaHQ"):
        # Photo-like images: 16x16 noise enlarged, plus a fifth of pixel
        # noise. On white noise at 256x256 so many of the encoder's
        # gradients sit at rounding level that Adam's first step (lr times
        # each gradient's sign) sets 0.16% of Q by rounding, past SHARE;
        # on these, only the conv biases in front of InstanceNorm (0.018%).
        k = s // 16
        big = np.repeat(np.repeat(rng.uniform(-1, 1, (b, 16, 16, m.nc)), k, 1), k, 2)
        return (0.8 * big + 0.2 * rng.uniform(-1, 1, (b, s, s, m.nc))).astype(np.float32)
    return rng.uniform(-1, 1, (b, s, s, m.nc)).astype(np.float32)


@pytest.mark.parametrize("branch", ["masked", "unmasked", "prior_only"])
def test_amortizer_loss_values_and_gradients(branch):
    """DSM loss per sample and its parameter gradients (mean loss) against
    JAX with the draws of the JAX key split: atol 1e-5 on the loss, and
    gradients within 1e-4 + 1e-3 relative (the encoder's instance norms
    over 1-4 pixels amplify rounding, as in test_torch_port_models)."""
    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=5)
    r = np.random.default_rng(1)
    b, nz = 5, cfg_p.model.nz
    z = r.normal(size=(b, nz)).astype(np.float32)
    x = r.uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
    mask = (r.uniform(size=(b, 1)) > 0.4).astype(np.float32)
    key = jax.random.PRNGKey(7)
    prior_noise, u, eps = (torch.from_numpy(a.copy()) for a in loss_draws(key, b, nz))
    kw = {
        "masked": dict(x=x, mask=mask), "unmasked": dict(x=x), "prior_only": {},
    }[branch]

    def jax_loss(p):
        return models_j.amortizer.apply(p, key, jnp.asarray(z), method="loss", **kw)

    want = np.asarray(jax_loss(state.params_q))
    grads_j = jax.grad(lambda p: jax_loss(p).mean())(state.params_q)
    q = models_p.amortizer.requires_grad_(True)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    got = q.loss(torch.from_numpy(z), **tkw, prior_noise=prior_noise, u=u, eps=eps)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    got.mean().backward()
    ref = amortizer_state(to_numpy(grads_j), cfg_p.model.nxemb)
    for name, p in q.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), ref[name], atol=1e-4, rtol=1e-3, err_msg=name)


def test_terminal_reg():
    """0.5 ||z_T||^2 with the JAX key's normals: atol 1e-5 / rtol 1e-6, the
    float32 rounding of a few elementwise ops and one sum over nz."""
    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=6)
    z = np.random.default_rng(2).normal(size=(4, cfg_p.model.nz)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(models_j.amortizer.apply(state.params_q, key, jnp.asarray(z), method="terminal_reg"))
    eps = torch.from_numpy(np.array(jax.random.normal(key, z.shape)))
    got = models_p.amortizer.terminal_reg(torch.from_numpy(z), eps)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("updates_per_iter", [1, 6])
def test_lr_schedule_matches_jax(updates_per_iter):
    """float64 here against float32 there: rtol 1e-6."""
    cfg_j, cfg_p = train_cfgs("cifar10")
    want = jax_lr_schedule(2e-4, cfg_j, updates_per_iter)
    got = lr_schedule(2e-4, cfg_p, updates_per_iter)
    u = updates_per_iter
    for count in (0, 1, 999 * u, 1000 * u - 1, 1000 * u, 1000 * u + 1, 5500 * u, 10**7 * u):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, err_msg=str(count))
    assert got(1000 * u - 1) == 2e-4 and got(10**9) == 1e-5


def test_clip_by_global_norm_matches_optax():
    """Below and above max_norm: the norm within 1e-5 and the clipped
    gradients within rtol 1e-6 (float32 sums of squares in another order)."""
    r = np.random.default_rng(3)
    for scale in (0.1, 10.0):  # below and above max_norm
        gs = [r.normal(size=s).astype(np.float32) * scale for s in ((7, 3), (11,), (2, 2, 5))]
        want, _ = optax.clip_by_global_norm(5.0).update([jnp.asarray(g) for g in gs], None)
        got = [torch.from_numpy(g.copy()) for g in gs]
        norm = clip_by_global_norm_(got, 5.0)
        assert abs(float(norm) - float(optax.global_norm(gs))) < 1e-5
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("net", ["g", "e", "q"])
@pytest.mark.parametrize("scale", [1e-3, 1e3], ids=["below_max_norm", "above_max_norm"])
def test_optimizer_updates_match_optax(net, scale):
    """Two updates of clip + Adam (G, E) or clip + AdamW (Q) from the same
    gradients, against optax: atol 1e-7 plus rtol 5e-7 (four float32 ulps
    of the parameter; the two libraries round the moments and the step
    differently) on parameters that move by about lr = 2e-4 per update.
    Gradient elements are N(0, scale^2), far above Adam's eps."""
    cfg_j, cfg_p = train_cfgs("svhn")
    state, models_j, _ = jax_create_state(jax.random.PRNGKey(0), cfg_j)
    opt_j = getattr(jax_make_optimizers(cfg_j), net)
    port = train_state_from_jax(to_numpy(state), cfg_p, device="cpu")
    params = {"g": state.params_g, "e": state.params_e, "q": state.params_q}[net]
    module = {"g": port.models.generator, "e": port.models.ebm, "q": port.models.amortizer}[net]
    nxemb = cfg_p.model.nxemb
    sd_fn = {"g": generator_state, "e": ebm_state,
             "q": lambda t: {k: v for k, v in amortizer_state(t, nxemb).items() if k != "xemb"}}[net]
    opt_p = getattr(port.opts, net)
    opt_state = opt_j.init(params)
    r = np.random.default_rng(4)
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(r.normal(size=p.shape).astype(np.float32) * scale), params)
        updates, opt_state = opt_j.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        g_sd = sd_fn(to_numpy(grads))
        opt_p.step([torch.from_numpy(np.array(g_sd[n])) for n, _ in module.named_parameters()])
    want = sd_fn(to_numpy(params))
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-7, rtol=5e-7, err_msg=name)
    assert opt_p.count == 2


@pytest.mark.parametrize("preset_name, remat", [
    ("svhn", False), ("mnist_anomaly", False), ("toy", False), ("celeba64", False), ("celebaHQ", False),
    ("celebaHQ", True),
], ids=["svhn", "mnist_anomaly", "toy", "celeba64", "celebaHQ", "celebaHQ-remat_generator"])
def test_two_train_steps_match_jax(preset_name, remat):
    """Two iterations with ema_every=2 (the EMA mix fires on the second),
    every draw from the JAX key tree: every metric (rtol 1e-5) and every
    parameter of G, E, Q and Q_ema (module docstring). mnist_anomaly runs
    the single prior chains, the fixed mask and both Q loss branches; the
    toy (nz = 2) the Gaussian posterior, no EBM and no prior chains, the
    g_loss monitor without a G update and Q's weight decay of 1e-2.
    celeba64 (64x64) and celebaHQ (256x256, g_llhd_sigma 1) run their
    deeper G and encoder at the tiny widths; with `remat_generator` JAX
    wraps G in `jax.checkpoint` and the port in `torch.utils.checkpoint`."""
    cfg_j, cfg_p = map(_noiseless, train_cfgs(preset_name, ema_every=2, remat_generator=remat))
    state, models_j, opts_j = jax_create_state(jax.random.PRNGKey(0), cfg_j)
    port = train_state_from_jax(to_numpy(state), cfg_p, device="cpu")
    step_j = jax.jit(jax_make_train_step(models_j, opts_j, cfg_j))
    step_p = make_train_step(port.models, port.opts, cfg_p)
    r = np.random.default_rng(0)
    ema0 = {k: v.clone() for k, v in port.amortizer_ema.state_dict().items()}
    for it in range(2):
        x = _x(cfg_j, r)
        draws = jax_step_draws(state.rng, cfg_j, len(x))
        state, mj = step_j(state, jnp.asarray(x))
        port, mp = step_p(port, torch.from_numpy(x), draws)
        _assert_metrics(mp, mj)
        _assert_state(port, state, cfg_j, it + 1)
        ema_moved = any(not torch.equal(v, ema0[k]) for k, v in port.amortizer_ema.state_dict().items())
        assert ema_moved == (it == 1)
    assert port.step == int(state.step) == 2


@pytest.mark.parametrize("preset_name", ["svhn", "celebaHQ"])
def test_remat_generator_is_bit_identical(preset_name):
    """One iteration from one state and one set of draws with
    `remat_generator` off and on: G's recomputed forward is the same
    arithmetic, so every metric and every parameter is equal, bit for bit."""
    _, cfg = train_cfgs(preset_name)
    r = np.random.default_rng(2)
    x = torch.from_numpy(_x(cfg, r))
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat_generator=remat))
        state = create_state(c, seed=3, device="cpu")
        draws = draw_step(c, len(x), state)
        state, metrics = make_train_step(state.models, state.opts, c)(state, x, draws)
        out.append((metrics, [p.detach().clone() for m in state.models.modules() for p in m.parameters()]))
    (m_off, p_off), (m_on, p_on) = out
    assert set(m_off) == set(m_on) and all(torch.equal(m_off[k], m_on[k]) for k in m_off)
    assert len(p_off) == len(p_on) and all(torch.equal(a, b) for a, b in zip(p_off, p_on))


def test_train_state_from_jax_continues_a_jax_run():
    """One JAX step, the state carried over (weights, Q_ema, step, Adam
    moments and counts), then one port step against the second JAX step."""
    cfg_j, cfg_p = map(_noiseless, train_cfgs("svhn"))
    state, models_j, opts_j = jax_create_state(jax.random.PRNGKey(1), cfg_j)
    step_j = jax.jit(jax_make_train_step(models_j, opts_j, cfg_j))
    r = np.random.default_rng(1)
    state, _ = step_j(state, jnp.asarray(_x(cfg_j, r)))
    port = train_state_from_jax(to_numpy(state), cfg_p, device="cpu")
    assert port.step == 1 and port.opts.q.count == cfg_p.train.q_updates and port.opts.g.count == 1
    _assert_state(port, state, cfg_j, 0)  # carried over exactly
    p0 = next(port.models.generator.parameters())
    mu = port.opts.g.opt.state[p0]["exp_avg"]
    assert mu.abs().max() > 0
    x = _x(cfg_j, r)
    draws = jax_step_draws(state.rng, cfg_j, len(x))
    state, mj = step_j(state, jnp.asarray(x))
    port, mp = make_train_step(port.models, port.opts, cfg_p)(port, torch.from_numpy(x), draws)
    _assert_metrics(mp, mj)
    _assert_state(port, state, cfg_j, 1)


def test_stylegan_amortizer_is_not_ported():
    """The StyleGAN-width Q is ported now (its name predates that): it has
    no encoder of its own (the frozen inversion encoder's code comes in as
    xemb, and `encode` raises), its hidden layers are 1024 wide, and its
    state dict holds no encoder key."""
    from damc_tpu_torch.models import DAMCAmortizer

    with torch.device("meta"):
        q = DAMCAmortizer(nz=8, nxemb=8, dataset="stylegan")
    assert q.encoder is None and not any(k.startswith("encoder.") for k in q.state_dict())
    assert {l.dim_out for l in q.p.all_layers} == {1024, 8}
    with pytest.raises(ValueError, match="no encoder"):
        q.encode(torch.zeros(1, 3, 8, 8, device="meta"))
