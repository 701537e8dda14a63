"""The port's bfloat16 paths against the JAX package's on the CPU: K1's
bf16-dot variant (plain version against JAX's Pallas kernel in the plain
interpreter), G and the conv encoder with `compute_dtype="bfloat16"`
against flax's `dtype=bfloat16`, one whole bf16 training iteration against
JAX's (K1 and K2 through the interpreter, so both run bf16 dots), the
pipelines, serving and checkpoints in bf16, the StyleGAN synthesis and
VGG16 in bf16 and the inversion's bf16 Adam refine.

bf16 keeps 8 significant bits, so two implementations that round at the
same places still differ where a float32 sum taken in another order lands
on the other side of a bf16 rounding boundary. Each test states its
tolerance and, where it can, shows that the port is nearer to JAX's bf16
result than the float32 computation is, so that a test cannot pass on a
path that quietly stayed in float32."""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.models import stylegan as jsg
from damc_tpu.ops.pallas.fused_langevin import fused_prior_langevin as jax_chain
from damc_tpu.train import stylegan_inv as jinv
from damc_tpu.train.state import create_state as jax_create_state
from damc_tpu.train.step import make_train_step as jax_make_train_step
from damc_tpu.utils.config import preset as jax_preset
from damc_tpu.utils.placement import cast_float_leaves as jax_cast_float_leaves
from damc_tpu_torch.config import preset
from damc_tpu_torch.convert import amortizer_state, train_state_from_jax
from damc_tpu_torch.models import build_models, cast_float_leaves
from damc_tpu_torch.models.stylegan import W_DIM, build_stylegan
from damc_tpu_torch.ops import langevin as tl
from damc_tpu_torch.ops.cuda import fused_langevin as k1
from damc_tpu_torch.train import sampling
from damc_tpu_torch.train import stylegan_inv as inv
from damc_tpu_torch.train.state import create_state
from damc_tpu_torch.train.step import draw_step, make_train_step
from test_torch_port_train import _jax_sds, _noiseless, _x
from torch_port_helpers import adam_cap, jax_and_port, jax_step_draws, one_torch_thread, tiny, to_numpy, train_cfgs

NDF = 200
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


def _bf16(cfg, dots="bfloat16"):
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"),
        train=dataclasses.replace(cfg.train, pallas_dots_dtype=dots),
    )


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# --------------------------------------------------------------------------
# K1, bf16-dot variant
# --------------------------------------------------------------------------


def _ebm_weights(nz, seed):
    r = np.random.default_rng(seed)
    u = lambda shape, fan: (r.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)
    return (u((nz, NDF), nz), u((NDF,), nz), u((NDF, NDF), NDF), u((NDF,), NDF), u((NDF,), NDF)), r


@pytest.mark.parametrize("mode", ["noiseless", "counter"])
@pytest.mark.parametrize("nz", [8, 100, 128])
def test_k1_plain_bf16_matches_jax_bf16_kernel(nz, mode):
    """6 steps at 0.4 (the training step size) at nz 8 (anomaly), 100
    (svhn, celeba64) and 128 (cifar10, celebaHQ), ndf 200. The port's plain
    bf16 version rounds the same operands as JAX's kernel and differs from
    it in summation order alone: atol 1e-5 (measured 6e-8 to 5e-7). JAX's
    float32 kernel is 2e-4 to 1e-3 away (measured), and the port must be
    at least 20 times nearer to JAX's bf16 output than to it."""
    w, r = _ebm_weights(nz, nz)
    z = r.normal(size=(9, nz)).astype(np.float32)
    kw, jkw, pkw = dict(steps=6, step_size=0.4), {}, {}
    if mode == "noiseless":
        kw["with_noise"] = False
    else:
        seeds = r.integers(0, 2**31 - 1, 9).astype(np.int32)
        jkw, pkw = dict(row_seeds=jnp.asarray(seeds)), dict(row_seeds=torch.from_numpy(seeds))
    jax_out = {
        dt: np.asarray(jax_chain(jnp.asarray(z), *map(jnp.asarray, w), interpret="plain", dots_dtype=dt,
                                 **kw, **jkw))
        for dt in ("float32", "bfloat16")
    }
    got = k1.fused_prior_langevin(torch.from_numpy(z), *map(torch.from_numpy, w), dots_dtype="bfloat16",
                                  **kw, **pkw).numpy()
    near = float(np.abs(got - jax_out["bfloat16"]).max())
    far = float(np.abs(got - jax_out["float32"]).max())
    assert near <= 1e-5, near
    assert far >= 20 * max(near, 1e-7), (near, far)


@pytest.mark.parametrize("mode", ["noiseless", "counter"])
@pytest.mark.parametrize("nz", [8, 100, 128])
def test_k1_plain_bf16_at_the_tensor_core_widths_matches_jax_bf16_kernel(nz, mode):
    """The plain bf16 chain at the widths the tensor-core variant pads to
    in shared memory (nz 8 -> 16, 100 -> 112, ndf 200 -> 208:
    `launch_widths(nz, 200, "bfloat16")`), zero-padded by `pad_widths` and
    sliced back to nz columns, against JAX's bf16 kernel at the real widths
    in the plain interpreter, as the test above holds the unpadded chain:
    atol 1e-5, and at least 20 times nearer to JAX's bf16 output than to
    its float32 one."""
    w, r = _ebm_weights(nz, nz)
    z = r.normal(size=(9, nz)).astype(np.float32)
    kw, jkw, pkw = dict(steps=6, step_size=0.4), {}, {}
    if mode == "noiseless":
        kw["with_noise"] = False
    else:
        seeds = r.integers(0, 2**31 - 1, 9).astype(np.int32)
        jkw, pkw = dict(row_seeds=jnp.asarray(seeds)), dict(row_seeds=torch.from_numpy(seeds))
    jax_out = {
        dt: np.asarray(jax_chain(jnp.asarray(z), *map(jnp.asarray, w), interpret="plain", dots_dtype=dt,
                                 **kw, **jkw))
        for dt in ("float32", "bfloat16")
    }
    launch = k1.launch_widths(nz, NDF, "bfloat16")
    assert launch.mma and launch.cluster == 1 and launch.ndf == 208 and launch.nz == -(-nz // 16) * 16
    padded = k1.pad_widths(torch.from_numpy(z), *map(torch.from_numpy, w), launch.nz, launch.ndf)
    got = k1.prior_langevin_plain(*padded, dots_dtype="bfloat16", **kw, **pkw)[:, :nz].numpy()
    near = float(np.abs(got - jax_out["bfloat16"]).max())
    far = float(np.abs(got - jax_out["float32"]).max())
    assert near <= 1e-5, near
    assert far >= 20 * max(near, 1e-7), (near, far)


def test_k1_dots_dtype_is_checked_and_the_float32_variant_unchanged():
    """An unknown dots_dtype raises on the CPU as on the card; "float32"
    is the variant that existed before the bf16 one, bit for bit."""
    w, r = _ebm_weights(8, 1)
    z = torch.from_numpy(r.normal(size=(3, 8)).astype(np.float32))
    wt = list(map(torch.from_numpy, w))
    with pytest.raises(ValueError, match="dots_dtype"):
        k1.fused_prior_langevin(z, *wt, steps=2, with_noise=False, dots_dtype="float16")
    a = k1.fused_prior_langevin(z, *wt, steps=4, step_size=0.4, with_noise=False)
    b = k1.fused_prior_langevin(z, *wt, steps=4, step_size=0.4, with_noise=False, dots_dtype="float32")
    assert torch.equal(a, b)
    c = k1.fused_prior_langevin(z, *wt, steps=4, step_size=0.4, with_noise=False, dots_dtype="bfloat16")
    assert not torch.equal(a, c)


def test_prior_langevin_auto_passes_dots_dtype_to_the_fused_chain_only():
    """`prior_langevin_auto(dots_dtype="bfloat16")` reaches K1's bf16
    variant; the autograd chain (use_pallas=False) stays float32 whatever
    dots_dtype says, as JAX's scan chain does."""
    _, _, _, cfg_p, models_p = jax_and_port(seed=2)
    ebm = models_p.ebm
    z = torch.from_numpy(np.random.default_rng(4).normal(size=(5, cfg_p.model.nz)).astype(np.float32))
    w = k1.ebm_params_to_dense_weights(ebm)
    fused, _ = tl.prior_langevin_auto(z, ebm, 6, 0.4, with_noise=False, dots_dtype="bfloat16")
    want = k1.prior_langevin_plain(z, *w, steps=6, step_size=0.4, with_noise=False, dots_dtype="bfloat16")
    assert torch.equal(fused, want)
    scan = [tl.prior_langevin_auto(z, ebm, 6, 0.4, with_noise=False, use_pallas=False, dots_dtype=dt)[0]
            for dt in ("float32", "bfloat16")]
    assert torch.equal(scan[0], scan[1])


# --------------------------------------------------------------------------
# G and the conv encoder in bf16
# --------------------------------------------------------------------------


_PAIRS = {}


def _pair(preset_name):
    """(bf16 JAX state and models, bf16 port models, float32 port models)
    of one weight set at the tiny widths."""
    if preset_name not in _PAIRS:
        cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=1, preset_name=preset_name, edit=_bf16)
        models_32 = jax_and_port(seed=1, preset_name=preset_name)[4]
        _PAIRS[preset_name] = (cfg_p, state, models_j, models_p, models_32)
    return _PAIRS[preset_name]


@pytest.mark.parametrize("net", ["generator", "encoder"])
@pytest.mark.parametrize("preset_name", ["cifar10", "celeba64", "mnist_anomaly"])
def test_conv_nets_in_bf16_match_flax(preset_name, net):
    """G (z -> image) and the conv encoder (image -> embedding) with
    compute_dtype bfloat16, against flax with dtype=bfloat16 on the same
    weights: the output is bf16 on both sides; G agrees within one bf16 ulp
    at |x| <= 1 (atol 2^-8; measured: equal, element for element) and the
    encoder, whose InstanceNorms scale a one-ulp difference of a conv sum up
    to an ulp of the normalised value, within atol 2^-6 (measured 2^-7).
    The mean absolute difference must be below half that of the float32
    port's output (measured 0 and 0.1-0.3 of it)."""
    cfg_p, state, models_j, models_p, models_32 = _pair(preset_name)
    r = np.random.default_rng(0)
    m = cfg_p.model
    if net == "generator":
        arg = r.normal(size=(4, m.nz)).astype(np.float32)
        want = models_j.generator.apply(state.params_g, jnp.asarray(arg))
        run = lambda models: models.generator(torch.from_numpy(arg))
        atol = 2.0**-8
    else:
        arg = r.uniform(-1, 1, (4, m.image_size, m.image_size, m.nc)).astype(np.float32)
        want = models_j.amortizer.apply(state.params_q, jnp.asarray(arg), method="encode")
        run = lambda models: models.amortizer.encoder(torch.from_numpy(arg))
        atol = 2.0**-6
    with torch.no_grad():
        got, got32 = run(models_p), run(models_32)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16 and got32.dtype == torch.float32
    want = np.asarray(want, np.float32)
    diff = np.abs(got.float().numpy() - want)
    assert float(diff.max()) <= atol, float(diff.max())
    assert float(diff.mean()) < 0.5 * float(np.abs(got32.numpy() - want).mean())


def test_bf16_embedding_enters_q_in_float32():
    """`DAMCAmortizer.encode` hands a bf16 encoder's embedding to Q's
    float32 layers in float32 (JAX's promotion there), with the same
    values; the gradient reaches the encoder's float32 parameters."""
    cfg_p, _, _, models_p, _ = _pair("cifar10")
    q = models_p.amortizer
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32))
    emb = q.encode(x)
    assert emb.dtype == torch.float32 and torch.equal(emb, q.encoder(x).float())
    q.requires_grad_(True)
    try:
        q.loss(torch.zeros(2, cfg_p.model.nz), x, prior_noise=None, u=torch.full((2,), 0.5),
               eps=torch.ones(2, cfg_p.model.nz)).sum().backward()
        grads = [p.grad for p in q.encoder.parameters()]
        assert all(g is not None and g.dtype == torch.float32 for g in grads)
        assert any(float(g.abs().max()) > 0 for g in grads)
    finally:
        q.requires_grad_(False).zero_grad(set_to_none=True)


# --------------------------------------------------------------------------
# One training iteration in bf16
# --------------------------------------------------------------------------


def test_bf16_train_step_matches_jax():
    """One svhn iteration with compute_dtype and pallas_dots_dtype
    "bfloat16", every draw from the JAX key tree, against JAX's step with
    its kernels in the plain interpreter (so its K1 runs bf16 dots, as the
    port's plain K1 does); kernel noise off as in test_torch_port_train.

    Metrics: rtol 5e-3. The encoder's bf16 rounding moves the Q loss by
    1.4e-3 (measured); the rest by at most 1e-3. G is bit-equal to flax's
    here, so g_loss must also sit nearer to JAX's than the float32 port's
    does (measured 4e-6 against 6e-4). Parameters: no element past
    `adam_cap`, the most two runs of one Adam update can part. Where a
    gradient element is of the order of the bf16 rounding of the gradient,
    its sign, and so Adam's first step (lr times it), is set by rounding:
    past 1e-5 are at most 2% of G's and E's elements (measured 0.8% and
    0.04%) and 25% of Q's (19%: the encoder's gradients are bf16)."""
    cfg_j, cfg_p = map(_noiseless, train_cfgs("svhn"))
    cfg_j, cfg_p, cfg_32 = _bf16(cfg_j), _bf16(cfg_p), cfg_p
    state0, models_j, opts_j = jax_create_state(jax.random.PRNGKey(0), cfg_j)
    x = _x(cfg_j, np.random.default_rng(0))
    draws = jax_step_draws(state0.rng, cfg_j, len(x))
    state, mj = jax.jit(jax_make_train_step(models_j, opts_j, cfg_j, pallas_interpret="plain"))(
        state0, jnp.asarray(x))
    out = {}
    for tag, cfg in (("bf16", cfg_p), ("fp32", cfg_32)):
        port = train_state_from_jax(to_numpy(state0), cfg, device="cpu")
        out[tag] = make_train_step(port.models, port.opts, cfg)(port, torch.from_numpy(x), draws)
    port, mp = out["bf16"]
    assert port.models.generator.dtype == BF16 and port.models.amortizer.encoder.dtype == BF16
    assert set(mp) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mp[k]), float(mj[k]), rtol=5e-3, err_msg=k)
    rel = lambda m: abs(float(m["g_loss"]) - float(mj["g_loss"]))
    assert rel(mp) < rel(out["fp32"][1])
    sds = _jax_sds(state)
    o = cfg_j.optim
    for name, module, lr, share in (("generator", port.models.generator, o.g_lr, 0.02),
                                    ("ebm", port.models.ebm, o.e_lr, 0.02),
                                    ("amortizer", port.models.amortizer, o.q_lr, 0.25)):
        sd, total, bad = module.state_dict(), 0, 0
        updates = cfg_j.train.q_updates if name == "amortizer" else 1
        for k, v in sds[name].items():
            diff = (sd[k] - torch.from_numpy(np.asarray(v))).abs()
            total += diff.numel()
            bad += int((diff > 1e-5).sum())
            assert float(diff.max()) <= adam_cap(lr, updates, (0.5, 0.999)) + 1e-5, (name, k)
            assert sd[k].dtype == torch.float32
        assert bad <= share * total, (name, bad, total)


# --------------------------------------------------------------------------
# Pipelines, serving, checkpoints and the CLIs
# --------------------------------------------------------------------------


def test_gen_samples_ebm_prior_runs_k1_with_pallas_dots_dtype(monkeypatch):
    """The EBM-prior sampler hands `pallas_dots_dtype` to K1 (JAX's
    `train/sampling.py:52`), and its images are G's bf16 output."""
    cfg = _bf16(tiny(preset("svhn")))
    models = build_models(cfg, seed=0, device="cpu")
    seen = []
    chain = tl.fused_prior_langevin
    monkeypatch.setattr(tl, "fused_prior_langevin", lambda *a, **kw: seen.append(kw["dots_dtype"]) or chain(*a, **kw))
    d = sampling.eval_draws(0, "fid_ebm", 0, 0, 4, cfg.model.nz, "cpu")
    x = sampling.gen_samples_ebm_prior(models, cfg, d)
    assert seen == ["bfloat16"] and x.dtype == BF16 and x.shape == (4, 32, 32, 3)
    assert sampling.to_unit_range(x).dtype == BF16  # the FID features cast it themselves
    x_hat, z = sampling.reconstruct(models, cfg, torch.zeros(4, 32, 32, 3), d, langevin_steps=2)
    assert x_hat.dtype == BF16 and z.dtype == torch.float32
    mse = sampling.recon_mse_per_image(x_hat, torch.zeros(4, 32, 32, 3))
    assert mse.dtype == torch.float32 and bool(torch.isfinite(mse).all())


def test_bf16_serving_keeps_k1_in_float32():
    """Serving with a bf16 G and encoder answers float32 images and z of
    the right shapes; the `ebm` path's K1 keeps float32 products whatever
    pallas_dots_dtype says (JAX's serving passes none), so its images are
    equal under either setting, and differ from a float32 G's."""
    from damc_tpu_torch.serve import build_serving_fns, item_draws, stack_draws

    base = tiny(preset("svhn"))
    draws = stack_draws([item_draws(3, i, base.model.nz) for i in range(4)], "cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32))
    out = {}
    for tag, cfg in (("dots_bf16", _bf16(base)), ("dots_fp32", _bf16(base, dots="float32")), ("fp32", base)):
        fns = build_serving_fns(build_models(cfg, seed=0, device="cpu"), cfg, recon_langevin_steps=2)
        with torch.no_grad():
            out[tag] = {"damc": fns["damc"](draws), "ebm": fns["ebm"](draws), "recon": fns["recon"](draws, x)}
    got = out["dots_bf16"]
    for path in ("damc", "ebm"):
        assert got[path].dtype == torch.float32 and got[path].shape == (4, 32, 32, 3)
        assert bool(torch.isfinite(got[path]).all())
    assert got["recon"][0].dtype == torch.float32 and got["recon"][1].shape == (4, base.model.nz)
    assert torch.equal(got["ebm"], out["dots_fp32"]["ebm"])
    assert not torch.equal(got["ebm"], out["fp32"]["ebm"])


def test_bf16_checkpoint_loads_into_float32_and_back(tmp_path):
    """A bf16 run's checkpoint holds float32 master weights and optimizer
    states: it restores into a float32 run's state and back, every tensor
    equal."""
    from damc_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    cfg32 = tiny(preset("svhn"))
    cfg = _bf16(cfg32)
    state = create_state(cfg, seed=0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32))
    state, _ = make_train_step(state.models, state.opts, cfg)(state, x, draw_step(cfg, 4, state))
    save_checkpoint(str(tmp_path), "a", state)
    as32 = restore_checkpoint(str(tmp_path), "a", create_state(cfg32, seed=5, device="cpu"))
    save_checkpoint(str(tmp_path), "b", as32)
    back = restore_checkpoint(str(tmp_path), "b", create_state(cfg, seed=6, device="cpu"))
    assert as32.step == back.step == 1 and as32.models.generator.dtype == torch.float32
    for restored in (as32, back):
        for m, r in zip(state.models.modules(), restored.models.modules()):
            for (n, p), (_, q) in zip(m.state_dict().items(), r.state_dict().items()):
                assert p.dtype == q.dtype == torch.float32 and torch.equal(p, q), n


def test_bf16_train_and_eval_cli_round_trip_on_cpu(tmp_path):
    """`--compute_dtype bfloat16` through the train CLI (2 iterations, an
    eval and the grids at 0) and the eval CLI on its checkpoint: the run's
    config says bfloat16, the grids are written and the eval numbers are
    finite and the same twice."""
    from damc_tpu_torch.cli import eval_gen_recon, train_gen_recon
    from test_cli_integration import fake_cifar
    from test_torch_port_cli import TINY

    data, logs = str(tmp_path / "data"), str(tmp_path / "logs")
    fake_cifar(data, n_train=40, n_test=13)
    args = ["--dataset", "cifar10", "--data_path", data, "--log_path", logs, "--device", "cpu",
            "--compute_dtype", "bfloat16", *TINY]
    state = train_gen_recon.main(args + ["--iterations", "2", "--eval_every", "2", "--plot_every", "2"])
    assert state.step == 2 and state.models.generator.dtype == BF16
    (run,) = os.listdir(os.path.join(logs, "cifar10"))
    run = os.path.join(logs, "cifar10", run)
    with open(os.path.join(run, "config.json")) as f:
        assert '"compute_dtype": "bfloat16"' in f.read()
    assert any(n.endswith("_post.png") for n in os.listdir(os.path.join(run, "imgs")))
    ev = args + ["--ckpt_dir", os.path.join(run, "ckpt"), "--ckpt_name", "best"]
    a, b = eval_gen_recon.main(ev), eval_gen_recon.main(ev)
    assert a == b and all(np.isfinite(v) for v in a.values())


# --------------------------------------------------------------------------
# StyleGAN inversion: the nets in bf16 and the bf16 Adam refine
# --------------------------------------------------------------------------


def _stylegan_pair(res):
    nets = build_stylegan(res, seed=0, device="cpu")
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    sp = {
        "generator": jsg.convert_generator_state_dict(sd(nets.generator), res),
        "encoder": jsg.convert_encoder_state_dict(sd(nets.encoder), res),
        "vgg": jsg.convert_vgg16_state_dict(sd(nets.vgg)),
    }
    return nets, sp


def test_stylegan_synthesis_and_vgg_stay_in_bf16():
    """The synthesis and VGG16 with their parameters and buffers cast by
    `cast_float_leaves` (the noise maps, the blur kernel and the VGG mean
    among them) compute in bf16 end to end: the output is bf16, and it is
    near JAX's bf16 forward of the same weights (`cast_float_leaves` there)
    within the bf16 rounding of a deep stack, atol 0.05 on images in
    [-1, 1] and 0.05 of the features' largest value, and nearer to it, on
    average, than the float32 forward is."""
    res = 8
    nets, sp = _stylegan_pair(res)
    r = np.random.RandomState(0)
    z = r.normal(size=(2, 4 * W_DIM)).astype(np.float32)
    x = r.uniform(-1, 1, (2, res, res, 3)).astype(np.float32)
    call = lambda m, a: torch.func.functional_call(m, cast_float_leaves(m, BF16), (torch.from_numpy(a).to(BF16),))
    with torch.no_grad():
        img, img32 = call(nets.generator, z), nets.generator(torch.from_numpy(z))
        feat = call(nets.vgg, np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
        feat32 = nets.vgg(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert img.dtype == feat.dtype == BF16
    want_img = np.asarray(jsg.generator_apply(jax_cast_float_leaves(sp["generator"], jnp.bfloat16),
                                              jnp.asarray(z, jnp.bfloat16), res), np.float32)
    want_feat = np.asarray(jsg.vgg16_features(jax_cast_float_leaves(sp["vgg"], jnp.bfloat16),
                                              jnp.asarray(x, jnp.bfloat16)), np.float32)
    got_img = img.float().permute(0, 2, 3, 1).numpy()
    got_feat = feat.float().permute(0, 2, 3, 1).numpy()
    scale = float(np.abs(want_feat).max())
    assert float(np.abs(got_img - want_img).max()) <= 0.05
    assert float(np.abs(got_feat - want_feat).max()) <= 0.05 * scale
    assert np.abs(got_img - want_img).mean() < np.abs(img32.permute(0, 2, 3, 1).numpy() - want_img).mean()
    assert np.abs(got_feat - want_feat).mean() < np.abs(feat32.permute(0, 2, 3, 1).numpy() - want_feat).mean()
    assert all(p.dtype == torch.float32 for p in nets.generator.parameters())


def test_invert_batch_bf16_quality_parity():
    """The port's analogue of tests/test_stylegan_inversion.py::
    test_invert_batch_bf16_quality_parity: resolution 32, B=2, 20 Adam
    steps at lr 0.05, the same draws for every run. The bf16 refine's final
    recon MSE is within 5% of the port's float32 one and of JAX's bf16 one,
    its loss falls, and its x_hat is float32 and differs from the float32
    run's (the refine really ran in bf16). Q is JAX's init at n_interval 3
    with its Fourier matrix damped by 100, as test_torch_port_stylegan_inv
    conditions it."""
    res, b, n = 32, 2, 3
    nets, sp = _stylegan_pair(res)
    cfg_j = jax_preset("cifar10")
    cfg_j = dataclasses.replace(cfg_j, diffusion=dataclasses.replace(cfg_j.diffusion, n_interval=n))
    cfg_p = preset("cifar10")
    cfg_p = dataclasses.replace(cfg_p, diffusion=dataclasses.replace(cfg_p.diffusion, n_interval=n))
    q_j = jinv.make_stylegan_amortizer(cfg_j, res)
    params = to_numpy(jax.jit(q_j.init)(jax.random.PRNGKey(0), jnp.zeros((1, q_j.nz))))
    params["params"]["p"]["fourier_b"] = params["params"]["p"]["fourier_b"] * 0.01
    q_p = inv.make_stylegan_amortizer(cfg_p, res, device="cpu")
    q_p.load_state_dict({k: _t(v) for k, v in amortizer_state(params, q_j.nz).items()}, strict=True)
    x = np.random.RandomState(0).uniform(-1, 1, (b, res, res, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    xh_j, _, _ = jax.jit(lambda p, s, xx, k: jinv.invert_batch(
        k, p, q_j, s, xx, steps=20, lr=0.05, resolution=res, compute_dtype=jnp.bfloat16))(
        params, sp, jnp.asarray(x), key)
    k_q, k_rescue = jax.random.split(key)
    k_init, _, k_sweep = jax.random.split(k_q, 3)
    draws = inv.InversionDraws(
        _t(jax.random.normal(k_init, (b, q_j.nz))),
        _t(np.stack([np.asarray(jax.random.normal(k, (b, q_j.nz))) for k in jax.random.split(k_sweep, n)])),
        _t(jax.random.normal(k_rescue, (b, W_DIM))),
    )
    out = {dt: inv.invert_batch(q_p, nets, _t(x), draws, steps=20, lr=0.05, compute_dtype=dt)
           for dt in (torch.float32, BF16)}
    mse = lambda xh: float(np.mean((np.asarray(xh, np.float32) - x) ** 2))
    xh16, _, losses16 = out[BF16]
    assert xh16.dtype == torch.float32 and bool(torch.isfinite(xh16).all())
    assert float(losses16[-1]) < float(losses16[0])
    assert not torch.equal(xh16, out[torch.float32][0])
    m16, m32, mj = mse(xh16.numpy()), mse(out[torch.float32][0].numpy()), mse(xh_j)
    assert abs(m16 - m32) / m32 < 0.05, (m16, m32)
    assert abs(m16 - mj) / mj < 0.05, (m16, mj)
