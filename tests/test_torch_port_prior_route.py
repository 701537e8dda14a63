"""The prior chain at every EBM width, on the CPU against the JAX package:
the train step, the anomaly step, the two-rank step and the EBM-prior eval
batch at widths K1 pads.

The JAX package sends every 2-hidden EBM to its TPU kernel, at any width
(`damc_tpu/ops/langevin.py:157-250`, padding only the batch). So does the
port: `fits_ebm` takes the layout alone, and the launch pads nz to a
multiple of 4 and ndf to one of the cluster with zero weights
(`ops/cuda/fused_langevin.py::launch_widths`, `pad_widths`), holding the
weights in shared memory where a block's share fits and reading them from
L2 where it does not (ndf=512 at nz=128). On the CPU the op runs the plain
version at the widths as given; the padding tests below show that the
padded chain's first nz columns are the unpadded chain's.

The step tests run JAX's step on its CPU paths (its scan chain), every draw
from the JAX key tree (`torch_port_helpers.jax_step_draws`), the chains
noiseless (the port's K1 stream noise is not the TPU's), and hold the
metrics at rtol 1e-5 and the parameters as tests/test_torch_port_train.py
does (its docstring gives the limits)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_gloo as gloo
from damc_tpu.train import sampling as jax_sampling
from damc_tpu.train.state import create_state as jax_create_state
from damc_tpu.train.step import make_train_step as jax_make_train_step
from damc_tpu_torch.config import preset
from damc_tpu_torch.convert import train_state_from_jax
from damc_tpu_torch.models import LatentEBM
from damc_tpu_torch.ops.cuda import fused_langevin as k1
from damc_tpu_torch.ops.langevin import prior_langevin_auto
from damc_tpu_torch.ops.noise import stream_row_seeds
from damc_tpu_torch.train import sampling
from damc_tpu_torch.train.sampling import Draws, eval_draws, gen_samples_ebm_prior
from damc_tpu_torch.train.state import create_state
from damc_tpu_torch.train.step import draw_step, make_train_step
from damc_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from test_torch_port_data_parallel import _assert_close_params
from test_torch_port_train import _assert_metrics, _assert_state, _noiseless, _x
from torch_port_helpers import jax_and_port, jax_step_draws, one_torch_thread, to_numpy, train_cfgs

PRESETS = ("cifar10", "cifar10-stable", "svhn", "celeba64", "celebaHQ", "mnist_anomaly")
# Widths the kernel pads: nz not a multiple of 4 (float4 reads), and
# ndf=512 at nz=128 (a block's slices would take 386 KB of shared memory).
PADDED = {"nz10": dict(nz=10), "ndf512": dict(nz=128, ndf=512)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def group():
    yield from gloo.groups()


def _widths(cfg, **model):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))


def _k1_calls(monkeypatch):
    """Record the batch of every call of K1's plain version (what the op
    runs on the CPU)."""
    calls, plain = [], k1.prior_langevin_plain

    def counting(z, *a, **kw):
        calls.append(int(z.shape[0]))
        return plain(z, *a, **kw)

    monkeypatch.setattr(k1, "prior_langevin_plain", counting)
    return calls


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("widths", [None, *PADDED], ids=["preset", *PADDED])
def test_k1_takes_every_two_hidden_ebm(name, widths):
    """`fits_ebm` takes the EBM `build_models` makes at every image preset's
    widths and at nz=10 and ndf=512; each preset launches at its own widths
    with the weights in shared memory, nz=10 padded to 12, ndf=512 with the
    weights read from L2."""
    cfg = preset(name)
    if widths is not None:
        cfg = _widths(cfg, **PADDED[widths])
    m = cfg.model
    with torch.device("meta"):
        ebm = LatentEBM(m.nz, ndf=m.ndf)
    assert k1.fits_ebm(ebm)
    want = {None: (m.nz, m.ndf, True), "nz10": (12, m.ndf, True), "ndf512": (128, 512, False)}[widths]
    assert k1.launch_widths(m.nz, m.ndf) == want


def test_launch_widths_rule():
    """Widths that fit launch as they are; others are padded, nz to a
    multiple of 4 and ndf to one of the cluster (4), then, where a block's
    share of the weights overflows 227 KB, ndf to one of 16 with the
    weights in L2 (57,344 B of activations a block at nz=128, ndf=512);
    past that (ndf=2400) the kernel takes no width and the launch raises.
    A 3-hidden EBM is not the layout K1 hand-codes."""
    assert k1.launch_widths(7, 10) == (8, 12, True)
    assert k1.launch_widths(100, 510) == (100, 512, False)
    assert k1.launch_widths(128, 500) == (128, 512, False)
    assert k1.smem_bytes(128, 512, smem_weights=False) == 57344 and k1.smem_bytes(128, 512) > k1.SMEM_LIMIT
    assert k1.launch_widths(128, 2336) is not None and k1.launch_widths(128, 2400) is None
    assert not k1.fits_ebm(LatentEBM(8, ndf=16, n_hidden=3))


def _weights(nz, ndf, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(nz, ndf, generator=g) / nz**0.5, torch.randn(ndf, generator=g) * 0.1,
            torch.randn(ndf, ndf, generator=g) / ndf**0.5, torch.randn(ndf, generator=g) * 0.1,
            torch.randn(ndf, generator=g) / ndf**0.5], torch.randn(6, nz, generator=g)


NOISE = {"stream": dict(seed=-987), "counter": dict(row_seeds=torch.tensor([3, -7, 11, 2**31 - 1, 0, 5])),
         "noiseless": dict(with_noise=False)}


@pytest.mark.parametrize("dots", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(NOISE))
@pytest.mark.parametrize("nz, ndf", [(10, 200), (7, 10), (128, 510), (10, 512)])
def test_padded_chain_is_the_unpadded_chain(nz, ndf, mode, dots):
    """The chain on `pad_widths`' inputs, at the widths `launch_widths`
    gives, is the unpadded chain in its first nz columns, in every noise
    mode and dot precision: a zero weight adds exact zeros, a padded
    hidden unit's pre-activation is 0 and feeds nothing, and a column's
    noise depends on its index alone. Where only nz is padded the products
    are the same sums, so the two agree bit for bit; where ndf is padded
    the plain version's matmuls block the sums otherwise, so they agree to
    float32 rounding over 6 steps (1e-6; bf16 operands 1e-5, where a
    one-ulp sum can flip an operand's rounding)."""
    w, z = _weights(nz, ndf, nz + ndf)
    nz_p, ndf_p, _ = k1.launch_widths(nz, ndf)
    kw = dict(steps=6, step_size=0.4, dots_dtype=dots, **NOISE[mode])
    want = k1.prior_langevin_plain(z, *w, **kw)
    padded = k1.pad_widths(z, *w, nz_p, ndf_p)
    assert padded[0].shape == (6, nz_p) and padded[3].shape == (ndf_p, ndf_p)
    got = k1.prior_langevin_plain(*padded, **kw)[:, :nz]
    if ndf_p == ndf:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 if dots == "bfloat16" else 1e-6)


@pytest.mark.parametrize("name, widths", [("cifar10", "nz10"), ("cifar10", "ndf512"), ("mnist_anomaly", "nz10")],
                         ids=["cifar10-nz10", "cifar10-ndf512", "anomaly-nz10"])
def test_train_step_at_padded_widths_matches_jax(name, widths, monkeypatch):
    """One iteration with `use_pallas` on at widths K1 pads against JAX's
    step: the port's chains run on K1 (its plain version here, once a step
    over the 2B chains, or the B chains of the anomaly step), JAX's on its
    scan chain. The anomaly step runs its single chains, fixed mask and
    both Q loss branches."""
    cfg_j, cfg_p = (_noiseless(_widths(c, **PADDED[widths])) for c in train_cfgs(name))
    assert cfg_p.train.use_pallas and cfg_j.train.use_pallas
    state, models_j, opts_j = jax_create_state(jax.random.PRNGKey(0), cfg_j)
    port = train_state_from_jax(to_numpy(state), cfg_p, device="cpu")
    x = _x(cfg_j, np.random.default_rng(5))
    draws = jax_step_draws(state.rng, cfg_j, len(x))
    assert draws.chain_noise is None
    calls = _k1_calls(monkeypatch)
    state, mj = jax.jit(jax_make_train_step(models_j, opts_j, cfg_j))(state, jnp.asarray(x))
    port, mp = make_train_step(port.models, port.opts, cfg_p)(port, torch.from_numpy(x), draws)
    assert calls == [2 * len(x) if cfg_p.train.prior_chains == "double" else len(x)]
    _assert_metrics(mp, mj)
    _assert_state(port, state, cfg_j, 1)


def _nz10(cfg):
    return dataclasses.replace(
        _widths(cfg, nz=10),
        mcmc=dataclasses.replace(cfg.mcmc, e_l_with_noise=False, e_l_steps=4),
        diffusion=dataclasses.replace(cfg.diffusion, with_noise=False),
    )


def test_ebm_prior_batch_at_nz10_matches_jax(monkeypatch):
    """The EBM-prior eval batch at nz=10 with `use_pallas` on against JAX's
    `gen_samples_ebm_prior` on the same z0, the chain's noise off on both
    sides, as tests/test_torch_port_sampling.py holds it at nz=8 (atol
    1e-5): K1 runs the chain once."""
    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=3, edit=_nz10)
    assert cfg_p.train.use_pallas and cfg_p.model.nz == 10
    key, b = jax.random.PRNGKey(11), 5
    want = np.asarray(jax_sampling.gen_samples_ebm_prior(key, state, models_j, cfg_j, b))
    z0 = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[0], (b, 10)), np.float32))
    calls = _k1_calls(monkeypatch)
    got = sampling.gen_samples_ebm_prior(models_p, cfg_p, Draws(z0, torch.zeros_like(z0), 0, 0))
    assert calls == [b] and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_ebm_prior_batch_at_nz10_is_a_function_of_its_draws(monkeypatch):
    """With the chain's noise on, an EBM-prior batch at nz=10 is K1 on the
    draws' stream seed: two calls agree bit for bit and equal that chain,
    run through `prior_langevin_auto`, decoded by G."""
    _, cfg = train_cfgs("cifar10")
    cfg = _widths(cfg, nz=10)
    assert cfg.train.use_pallas and cfg.mcmc.e_l_with_noise
    models = create_state(cfg, seed=2, device="cpu").models
    d = eval_draws(3, "fid_ebm", 0, 0, 6, 10, "cpu")
    calls = _k1_calls(monkeypatch)
    a, b = gen_samples_ebm_prior(models, cfg, d), gen_samples_ebm_prior(models, cfg, d)
    assert calls == [6, 6] and torch.equal(a, b) and bool(torch.isfinite(a).all())
    mc = cfg.mcmc
    z, _ = prior_langevin_auto(d.z0, models.ebm, mc.e_l_steps, mc.e_l_step_size, mc.e_l_with_noise,
                               seed=d.chain_seed)
    w = k1.ebm_params_to_dense_weights(models.ebm)
    plain = k1.prior_langevin_plain(d.z0, *w, steps=mc.e_l_steps, step_size=mc.e_l_step_size,
                                    row_seeds=stream_row_seeds(d.chain_seed, 6))
    assert torch.equal(z, plain)
    with torch.no_grad():
        assert torch.equal(a, models.generator(z))


def _draws_by_hand(cfg, b, seed, chains=None):
    """The draws of `draw_step` in its order (mask uniforms, the sweep's
    start, the fresh chain starts, the posterior normals, each Q update's
    (prior noise, u, eps) per branch), then, when `chains` is given, the
    (e_l_steps, chains, nz) normals of the autograd chain."""
    tc, nz = cfg.train, cfg.model.nz
    gen = torch.Generator().manual_seed(seed)
    normal = lambda *shape: torch.randn(shape, generator=gen)
    out = [torch.rand((b,), generator=gen), normal(b, nz)]
    if tc.prior_chains == "double":
        out.append(normal(b, nz))
    out.append(normal(cfg.mcmc.g_l_steps, b, nz))
    for _ in range(tc.q_updates):
        for _ in range(2 if tc.q_loss_both_branches else 1):
            out += [normal(b, nz), torch.rand((b,), generator=gen), normal(b, nz)]
    if chains is not None:
        out.append(normal(cfg.mcmc.e_l_steps, chains, nz))
    return out


def _flat(d):
    out = [d.mask_u, d.z0_init] + ([d.neg_init] if d.neg_init is not None else []) + [d.post_noise]
    for pair in d.q:
        for qd in pair:
            if qd is not None:
                out += [qd.prior_noise, qd.u, qd.eps]
    return out + ([d.chain_noise] if d.chain_noise is not None else [])


@pytest.mark.parametrize("name", ["cifar10", "mnist_anomaly"])
@pytest.mark.parametrize("widths", list(PADDED))
def test_draw_step_does_not_depend_on_the_ebm_widths(widths, name):
    """At nz=10 and ndf=512 `draw_step` draws what it draws at any width:
    with `use_pallas` on no chain normals (K1 draws its own from the
    stream seed), every draw the generator's sequence in its order; with
    `use_pallas` off the autograd chain's (e_l_steps, chains, nz) normals
    after every other draw."""
    _, cfg = train_cfgs(name)
    cfg = _widths(cfg, **PADDED[widths])
    b = cfg.train.batch_size
    chains = 2 * b if cfg.train.prior_chains == "double" else b
    off = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_pallas=False))
    for c, on_k1 in ((cfg, True), (off, False)):
        d = draw_step(c, b, create_state(c, seed=1, device="cpu"))
        want = _draws_by_hand(c, b, 1, None if on_k1 else chains)
        got = _flat(d)
        assert (d.chain_noise is None) == on_k1 and len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        if not on_k1:
            assert d.chain_noise.shape == (c.mcmc.e_l_steps, chains, c.model.nz)


def test_two_rank_step_at_nz10_equals_world_one(group, tmp_path):
    """Two steps at nz=10 with the chains' noise on, on 2 gloo ranks, each
    rank drawing the global batch's draws from its own generator as a run
    does: K4a splits the 2B chains (each rank K1 on B of them from its
    first global row), K4b the Q rows; the replicas are equal, and the
    metrics and parameters are the world-1 steps' within
    tests/test_torch_port_data_parallel.py's limits (the order of the
    reductions alone differs; a chain's noise is its global row's)."""
    _, cfg = train_cfgs("cifar10", ema_every=2)
    cfg = _widths(_noiseless(cfg), nz=10)
    cfg = dataclasses.replace(cfg, mcmc=dataclasses.replace(cfg.mcmc, e_l_with_noise=True))
    save_checkpoint(str(tmp_path), "0", create_state(cfg, 0, "cpu"))
    r = np.random.default_rng(0)
    xs = [_x(cfg, r) for _ in range(2)]
    (m0, a0, n0, c0), (m1, a1, n1, c1) = group(2).run(gloo.drawn_train_steps, cfg, str(tmp_path), xs)

    one = restore_checkpoint(str(tmp_path), "0", create_state(cfg, 0, "cpu"))
    step = make_train_step(one.models, one.opts, cfg)
    metrics_1 = []
    for x in xs:
        one, m = step(one, torch.from_numpy(x), draw_step(cfg, len(x), one))
        metrics_1.append(m)

    b = cfg.train.batch_size
    assert n0 == n1 == [None, None]
    for rank, calls in enumerate((c0, c1)):
        assert sorted(calls) == sorted([("K1", b, rank * b), ("K2", b // 2, rank * b // 2)] * 2)
    assert m0 == m1 and all(np.array_equal(a0[k], a1[k]) for k in a0)
    for got, want in zip(m0, metrics_1):
        _assert_metrics(got, want)
    _assert_close_params(a0, gloo.state_arrays(one), cfg)
