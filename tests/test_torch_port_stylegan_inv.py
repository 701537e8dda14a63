"""The StyleGAN inversion workload of the port (`train/stylegan_inv.py`,
`ops/langevin.py::adam_latent_descent`, `cli/eval_stylegan_inv.py`)
against the JAX package on the CPU.

Resolution 8 keeps the Q small: nz = nxemb = 4 x 512 = 2048 with the
1024-wide hidden layers (about 65M weights), n_interval 3. The StyleGAN
networks are the port's random ones (`build_stylegan`), carried into JAX
through its own converters, and Q is JAX's init carried into the port.
Every draw is JAX's own, taken from its key splits.

Conditioning. With the init's unit-normal Fourier matrix at nz 2048, the
Fourier arguments 2 pi z B reach a few hundred, where the float32 rounding
of the 2048-term sums moves the sines by ~1e-5; three sweep steps carry
that to 1e-2 in z0, and Adam's steps, which divide each gradient by its
own scale, carry it on (measured: z0 1.2e-2, refined z 0.34 apart). So
the tests damp the Fourier matrix by 100 on both sides, where the sweep is
well conditioned: z0 then agrees within 3.7e-6 and the refined z and x_hat
within 3.7e-5 after 5 Adam steps at lr 0.05 (measured). Tolerances, about
ten times those: z0 atol 5e-5, refined z and x_hat atol 5e-4, per-step
losses rtol 2e-5."""

from __future__ import annotations

import copy
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.models import stylegan as jsg
from damc_tpu.ops.langevin import adam_latent_descent as jax_adam
from damc_tpu.train import stylegan_inv as jinv
from damc_tpu.train.state import make_optimizers as jax_make_optimizers
from damc_tpu.utils.config import preset as jax_preset
from damc_tpu_torch.config import preset
from damc_tpu_torch.convert import amortizer_state
from damc_tpu_torch.models import sample_q, sweep_route
from damc_tpu_torch.models.stylegan import W_DIM, build_stylegan
from damc_tpu_torch.ops.langevin import adam_latent_descent
from damc_tpu_torch.train import stylegan_inv as inv
from damc_tpu_torch.train.state import ClippedAdam
from damc_tpu_torch.train.step import QDraws
from damc_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_port_train import _assert_params
from torch_port_helpers import loss_draws, lsun_jpeg_db, one_torch_thread, to_numpy

RES, N, B = 8, 3, 2
FOURIER_DAMP = 0.01  # module docstring


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cfgs(q_updates=6):
    def one(c):
        return dataclasses.replace(
            c, diffusion=dataclasses.replace(c.diffusion, n_interval=N),
            train=dataclasses.replace(c.train, q_updates=q_updates),
        )
    return one(jax_preset("cifar10")), one(preset("cifar10"))


@pytest.fixture(scope="module")
def pair():
    """(port nets, JAX StyleGAN trees, JAX Q model, JAX Q params, port Q)."""
    nets = build_stylegan(RES, seed=0, device="cpu")
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    sp = {
        "generator": jsg.convert_generator_state_dict(sd(nets.generator), RES),
        "encoder": jsg.convert_encoder_state_dict(sd(nets.encoder), RES),
        "vgg": jsg.convert_vgg16_state_dict(sd(nets.vgg)),
    }
    cfg_j, cfg_p = _cfgs()
    q_j = jinv.make_stylegan_amortizer(cfg_j, RES)
    params = to_numpy(q_j.init(jax.random.PRNGKey(0), jnp.zeros((1, q_j.nz))))
    params["params"]["p"]["fourier_b"] = params["params"]["p"]["fourier_b"] * FOURIER_DAMP
    q_p = inv.make_stylegan_amortizer(cfg_p, RES, device="cpu")
    q_p.load_state_dict({k: t(v) for k, v in amortizer_state(params, q_j.nz).items()}, strict=True)
    return nets, sp, q_j, params, q_p


def _images(seed, n=B):
    return np.random.RandomState(seed).uniform(-1, 1, (n, RES, RES, 3)).astype(np.float32)


def _inv_draws(key, nz):
    """The port's draws of JAX's `invert_batch(key, ...)`: its Q key split
    in three (z_init, unused embedding key, sweep), its rescue key."""
    k_q, k_rescue = jax.random.split(key)
    k_init, _, k_sweep = jax.random.split(k_q, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (B, nz))) for k in jax.random.split(k_sweep, N)])
    return inv.InversionDraws(t(jax.random.normal(k_init, (B, nz))), t(noise),
                              t(jax.random.normal(k_rescue, (B, W_DIM))))


def test_adam_latent_descent_matches_optax():
    """Adam on z under the gradient of the summed loss, 8 steps at lr 0.05,
    against JAX's optax loop on a smooth nonlinear loss. The two libraries
    arrange m_hat / (sqrt(v_hat) + eps) differently; where a gradient
    element nearly cancels, its rounding sets the step, and z parts by up to
    3.0e-6 after 8 steps and the loss sums by 1.8e-6 relative (measured):
    z atol 1e-5, the per-step loss sums rtol 1e-5."""
    r = np.random.default_rng(0)
    a = r.normal(size=(6, 5)).astype(np.float32)
    z0 = r.normal(size=(4, 6)).astype(np.float32)
    zj, lj = jax_adam(
        jnp.asarray(z0), lambda z: jnp.sum(jnp.tanh(z @ jnp.asarray(a)) ** 2, -1) + 0.1 * jnp.sum(z**2, -1),
        steps=8, lr=0.05)
    at = t(a)
    zp, lp = adam_latent_descent(
        t(z0), lambda z: torch.sum(torch.tanh(z @ at) ** 2, -1) + 0.1 * torch.sum(z**2, -1), steps=8, lr=0.05)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), rtol=1e-5)
    assert not zp.requires_grad and lp.shape == (8,)


def test_nan_rescue_replaces_only_nan_rows(pair):
    nets, sp, *_ = pair
    nz = 4 * W_DIM
    z = np.random.RandomState(2).normal(size=(2, nz)).astype(np.float32)
    z[0, 5] = np.nan
    x = _images(3)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jinv.nan_rescue(key, sp["generator"], jnp.asarray(z), jnp.asarray(x), RES))
    normals = t(jax.random.normal(key, (2, W_DIM)))
    got = inv.nan_rescue(nets, t(z), t(x), normals)
    assert torch.isfinite(got[0]).all() and torch.equal(got[1], t(z)[1])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_invert_batch_matches_jax(pair):
    """Encoder -> Q sweep ("tables" route) -> rescue -> 5 Adam steps at lr
    0.05, against JAX's `invert_batch` on the same key's draws."""
    nets, sp, q_j, params, q_p = pair
    assert sweep_route(q_p) == "tables"
    x = _images(0)
    key = jax.random.PRNGKey(1)
    xh_j, z_j, l_j = jinv.invert_batch(key, params, q_j, sp, jnp.asarray(x), steps=5, lr=0.05, resolution=RES)
    d = _inv_draws(key, q_j.nz)
    xh_p, z_p, l_p = inv.invert_batch(q_p, nets, t(x), d, steps=5, lr=0.05)
    xemb = jsg.encoder_apply(sp["encoder"], jnp.asarray(x), RES)
    z0_j = jinv.sample_q(params, q_j, jax.random.split(key)[0], xemb=xemb, fused=False)
    with torch.no_grad():
        z0_p = sample_q(q_p, None, d.z_init, 0, xemb=nets.encoder(t(x).permute(0, 3, 1, 2)), noise=d.sweep_noise)
    np.testing.assert_allclose(z0_p.numpy(), np.asarray(z0_j), atol=5e-5)
    np.testing.assert_allclose(l_p.numpy(), np.asarray(l_j), rtol=2e-5)
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_j), atol=5e-4)
    assert xh_p.shape == (B, RES, RES, 3)
    np.testing.assert_allclose(xh_p.numpy(), np.asarray(xh_j), atol=5e-4)
    assert float(l_p[-1]) < float(l_p[0])


def test_inversion_train_step_matches_jax(pair, monkeypatch):
    """One iteration (5 refine steps, 2 Q updates, p_mask 0.2) against JAX's
    `make_inversion_train_step` with the preset's clip + AdamW, every draw
    from the JAX key tree.

    The refined latents are the Q updates' target, and JAX's and the
    port's differ by up to 3.7e-5 (test_invert_batch_matches_jax). A fifth
    of the 1024-wide Q's gradient elements are below 1e-4 of their layer's
    largest, so that gap sets the sign of Adam's first step (lr times the
    gradient's sign) in 7.5% of Q's elements (measured), where gradients
    from equal inputs agree within 1.7e-6 relative and part in sign in
    4e-7 of them. So the JAX step refines through the port's
    `invert_batch` result (its own is held above) and both sides update Q
    from the same target: metrics at rtol 1e-4, Q's parameters as in
    test_torch_port_train (at most 0.05% past 1e-5, none past `adam_cap`)."""
    nets, sp, q_j, params, q_p = pair
    cfg_j, cfg_p = _cfgs(q_updates=2)
    q = copy.deepcopy(q_p).train().requires_grad_(True)
    o = cfg_p.optim
    opt = ClippedAdam(q.parameters(), o.q_lr, cfg_p, o.q_max_norm, weight_decay=o.q_weight_decay,
                      updates_per_iter=2)
    x = _images(5)
    key = jax.random.PRNGKey(8)
    k_inv, k_mask, k_loss = jax.random.split(key, 3)
    qd = [QDraws(*map(t, loss_draws(jax.random.fold_in(k_loss, i), B, q.nz))) for i in range(2)]
    draws = inv.InversionStepDraws(_inv_draws(k_inv, q.nz), t(jax.random.uniform(k_mask, (B,))), qd)
    refined = []
    port_invert = inv.invert_batch
    monkeypatch.setattr(inv, "invert_batch", lambda *a, **k: refined.append(port_invert(*a, **k)) or refined[-1])
    mp = inv.make_inversion_train_step(q, nets, opt, refine_steps=5, refine_lr=0.05, q_updates=2)(t(x), draws)

    monkeypatch.setattr(jinv, "invert_batch",
                        lambda *a, **k: tuple(jnp.asarray(v.detach().numpy()) for v in refined[0]))
    opt_j = jax_make_optimizers(cfg_j).q
    step_j = jinv.make_inversion_train_step(q_j, sp, opt_j, refine_steps=5, refine_lr=0.05, resolution=RES,
                                            q_updates=2)
    new_params, _, mj = step_j(params, opt_j.init(params), jnp.asarray(x), key)
    assert set(mp) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mp[k]), float(mj[k]), rtol=1e-4, err_msg=k)
    ref = {k: t(v) for k, v in amortizer_state(to_numpy(new_params), q.nz).items()}
    _assert_params(q, ref, o.q_lr, 2, "Q")
    assert opt.count == 2 and any(not torch.equal(a, b) for a, b in zip(q.parameters(), q_p.parameters()))


def test_evaluate_inversion_covers_a_tail_batch(pair):
    """3 images in batches of 2: the tail is padded by repeating its last
    image and sliced back, the MSE is the mean of the per-image MSEs, the
    features of all 3 reconstructions stream into the statistics, and two
    runs agree exactly."""
    from damc_tpu_torch.metrics.fid import make_random_feature_fn

    nets, _, _, _, q_p = pair
    images = _images(6, n=3)
    feats = []
    fn = make_random_feature_fn((RES, RES, 3))
    record = lambda x: feats.append(x.shape[0]) or fn(x)
    mu, sigma = np.zeros(192), np.eye(192)
    out = inv.evaluate_inversion(q_p, nets, images, batch=2, steps=2, lr=0.05, seed=3, feature_fn=record,
                                 real_mu=mu, real_sigma=sigma, fid_metric_name="frechet_rand")
    assert feats == [2, 1] and np.isfinite(out["frechet_rand"])
    mse = []
    for bi, i in enumerate((0, 2)):
        xb = t(images[i:i + 2])
        if len(xb) < 2:
            xb = torch.cat([xb, xb[-1:]])
        d = inv.inversion_draws(inv.batch_generator(3, bi, "cpu"), 2, q_p.nz, N)
        xh, _, _ = inv.invert_batch(q_p, nets, xb, d, 2, 0.05)
        n = min(2, 3 - i)
        mse += torch.mean((xh[:n] - xb[:n]).reshape(n, -1) ** 2, -1).tolist()
    assert out["recon_mse"] == pytest.approx(float(np.mean(mse)), rel=1e-6)
    assert inv.evaluate_inversion(q_p, nets, images, batch=2, steps=2, lr=0.05, seed=3) == {
        "recon_mse": out["recon_mse"]}


def test_eval_cli_round_trip_on_cpu(pair, tmp_path, capsys):
    """The eval CLI on tiny seeded `.pth` files (res 8) and 3 PNGs at 16x16
    (resized to 8): twice from a saved Q checkpoint, identical output; with
    `--compute_dtype bfloat16` a recon MSE within 5% of the float32 run's
    (the bound of tests/test_cli_stylegan_inv.py) and not equal to it; and
    `--use_mesh` in one process, the same numbers (it raised before the
    mesh was ported)."""
    from damc_tpu_torch.cli import eval_stylegan_inv
    from damc_tpu_torch.data.datasets import synthetic_image_tree

    nets = pair[0]
    paths = {}
    for name, flag in (("generator", "G"), ("encoder", "E"), ("vgg", "F")):
        paths[flag] = str(tmp_path / f"{name}.pth")
        torch.save(getattr(nets, name).state_dict(), paths[flag])
    imgs = tmp_path / "imgs"
    synthetic_image_tree(str(imgs), 3, (16, 16), seed=1)
    cfg = preset("celebaHQ")
    state = inv.create_inversion_state(cfg, RES, seed=2, device="cpu")
    state.step = 7
    save_checkpoint(str(tmp_path / "ckpt"), "best", state)
    argv = ["--dataset", "ffhq", "--data_path", str(imgs), "--resolution", str(RES), "--batch_size", "2",
            "--g_l_steps", "2", "--limit", "3", "--n_fid_samples", "3", "--device", "cpu",
            "--q_ckpt_dir", str(tmp_path / "ckpt")] + [a for f, p in paths.items()
                                                       for a in (f"--pretrained_{f}_path", p)]
    outs = [eval_stylegan_inv.main(argv) for _ in range(2)]
    printed = capsys.readouterr().out
    assert outs[0] == outs[1] and set(outs[0]) == {"recon_mse", "frechet_rand"}
    assert np.isfinite(outs[0]["recon_mse"]) and np.isfinite(outs[0]["frechet_rand"])
    assert printed.count("restored Q (step 7)") == 2
    closing = [l for l in printed.splitlines() if l.startswith("[damc] recon MSE")]
    assert len(closing) == 2 and closing[0] == closing[1] and "frechet_rand" in closing[0]
    bf16 = eval_stylegan_inv.main(argv + ["--compute_dtype", "bfloat16"])
    assert np.isfinite(bf16["recon_mse"]) and bf16["recon_mse"] != outs[0]["recon_mse"]
    assert abs(bf16["recon_mse"] - outs[0]["recon_mse"]) / outs[0]["recon_mse"] < 0.05
    # --use_mesh is ported (tests/test_torch_port_stylegan_mesh.py runs it on
    # two ranks); in one process it starts no group and changes nothing.
    assert eval_stylegan_inv.main(argv + ["--use_mesh"]) == outs[0]
    assert not torch.distributed.is_initialized()
    # LSUN's lmdb databases are read since item 4b: an empty directory is no database.
    os.makedirs(tmp_path / "lsun" / "tower_val_lmdb")
    with pytest.raises(OSError, match="cannot open LMDB env"):
        eval_stylegan_inv.main(argv + ["--dataset", "lsun_tower", "--data_path", str(tmp_path / "lsun")])
    shutil.rmtree(tmp_path / "lsun")
    lsun_jpeg_db(str(tmp_path / "lsun"), "tower_val", 4, seed=5, max_size=(40, 30))
    lsun = eval_stylegan_inv.main(argv + ["--dataset", "lsun_tower", "--data_path", str(tmp_path / "lsun")])
    assert set(lsun) == {"recon_mse", "frechet_rand"} and all(np.isfinite(v) for v in lsun.values())
    assert lsun["recon_mse"] != outs[0]["recon_mse"]  # the LMDB's images, not the folder's
