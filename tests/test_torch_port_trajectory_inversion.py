"""Loop-level parity of the port's StyleGAN inversion against the JAX
package's, in the slow tier (`-m slow`): the protocol of
`tools/trajectory_parity_inversion.py` and
tests/test_trajectory_parity_inversion.py, with the JAX pipeline where the
tool runs the reference and the port's in the place of the JAX one.

Both sides hold the same weights: the port's random StyleGAN synthesis,
encoder and VGG16 (`build_stylegan`), carried into JAX by its own
converters, and JAX's Q init carried into the port by
`convert.amortizer_state`. Once the two draws are shared, the pipeline is
deterministic, so the comparison is numeric:

  A. a shared z0 refined for STEPS Adam steps under 1.5 pixel MSE + 5e-5
     VGG16 feature MSE: JAX's `adam_latent_descent` + `inversion_loss_fn`
     (the tool's `run_damc_invert`) against the port's;
  B. a shared z_T through each side's noiseless reverse sweep under the
     frozen encoder's code (JAX's `reverse_diffusion_sample` as the tool
     runs it; the port's `invert_batch`, whose sweep is `sample_q`'s tables
     loop), each side then refining its own sweep output.

The sweep of a random denoiser is chaotic (the tool's docstring), so leg B
compares the encoder's code and the final recon MSE; the sweep's z is
printed, not held.
Tolerances are the JAX-side test's. res 32 (nz 4096), B=2, 30 steps at
lr 0.01, 5 sweep steps."""

from __future__ import annotations

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.models import stylegan as jsg
from damc_tpu.ops.reverse_diffusion import reverse_diffusion_sample as jax_reverse
from damc_tpu.train import stylegan_inv as jinv
from damc_tpu.utils.config import preset as jax_preset
from damc_tpu_torch.config import preset
from damc_tpu_torch.convert import amortizer_state
from damc_tpu_torch.models import sample_q
from damc_tpu_torch.models.stylegan import W_DIM, build_stylegan
from damc_tpu_torch.ops.langevin import adam_latent_descent
from damc_tpu_torch.train import stylegan_inv as inv
from torch_port_helpers import one_torch_thread, to_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from trajectory_parity_inversion import rel_l2, run_damc_invert, synthetic_images  # noqa: E402

RES, B, STEPS, LR, N_INTERVAL, SEED = 32, 2, 30, 0.01, 5, 0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


def _cfg(cfg):
    """The tool's sweep config: cifar10's diffusion at N_INTERVAL steps, noiseless."""
    return dataclasses.replace(cfg, diffusion=dataclasses.replace(cfg.diffusion, n_interval=N_INTERVAL,
                                                                  with_noise=False))


def _mse(x_hat, x):
    """The tool's recon MSE: per-image mean square error, averaged over images."""
    return float(np.mean((x_hat - x).reshape(len(x), -1) ** 2, -1).sum()) / len(x)


def _port_refine(nets, x, z0):
    """Leg A's port side: Adam on z0 under the inversion loss; (z, MSE, losses)."""
    xt = torch.from_numpy(x)
    z, losses = adam_latent_descent(torch.from_numpy(z0), inv.inversion_loss_fn(nets, xt), steps=STEPS, lr=LR)
    with torch.no_grad():
        x_hat = nets.generator(z).permute(0, 2, 3, 1).numpy()
    return z.numpy(), _mse(x_hat, x), losses.numpy()


@pytest.mark.slow
def test_inversion_pipeline_matches_the_jax_pipeline_numerically():
    nets = build_stylegan(RES, seed=SEED, device="cpu")
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}
    sg_params = {
        "generator": jsg.convert_generator_state_dict(sd(nets.generator), RES),
        "encoder": jsg.convert_encoder_state_dict(sd(nets.encoder), RES),
        "vgg": jsg.convert_vgg16_state_dict(sd(nets.vgg)),
    }
    nz = (2 * int(np.log2(RES)) - 2) * W_DIM
    x = synthetic_images(B, RES)

    # Leg A: a shared z0, the Adam refine, no noise anywhere.
    z0 = np.random.RandomState(11).randn(B, nz).astype(np.float32)
    z_j, mse_j, _ = run_damc_invert(sg_params, x, z0, STEPS, LR, RES)
    z_p, mse_p, losses_p = _port_refine(nets, x, z0)
    leg_a = {"z_rel_l2": rel_l2(z_p, z_j), "recon_mse": {"ref": mse_j, "damc": mse_p,
             "rel_diff": abs(mse_p - mse_j) / max(mse_j, 1e-12)}, "loss_decreased": bool(losses_p[-1] < losses_p[0])}

    # Leg B: a shared z_T, each side's noiseless sweep, each side's refine.
    cfg_j, cfg_p = _cfg(jax_preset("cifar10")), _cfg(preset("cifar10"))
    q_j = jinv.make_stylegan_amortizer(cfg_j, RES)
    params = to_numpy(q_j.init(jax.random.PRNGKey(SEED + 1), jnp.zeros((1, q_j.nz))))
    q_p = inv.make_stylegan_amortizer(cfg_p, RES, device="cpu")
    q_p.load_state_dict(
        {k: torch.from_numpy(np.array(v, np.float32)) for k, v in amortizer_state(params, nz).items()}, strict=True)
    assert q_j.nz == q_p.nz == nz and not q_p.with_noise
    torch.manual_seed(707)
    zt = torch.randn(B, nz).numpy()
    xemb_j = jsg.encoder_apply(sg_params["encoder"], jnp.asarray(x), RES)
    d = cfg_j.diffusion
    z0_j = np.asarray(jax_reverse(
        jax.random.PRNGKey(0), lambda z, logsnr: q_j.apply(params, z, logsnr, xemb_j, method="denoise"),
        jnp.asarray(zt), n_interval=N_INTERVAL, logsnr_min=d.logsnr_min, logsnr_max=d.logsnr_max,
        var_type=d.var_type, with_noise=False))
    zB_j, mseB_j, _ = run_damc_invert(sg_params, x, z0_j, STEPS, LR, RES)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        xemb_p = nets.encoder(xt.permute(0, 3, 1, 2))
    rescue = torch.randn(B, W_DIM, generator=torch.Generator().manual_seed(3))  # used by a NaN row alone
    draws = inv.InversionDraws(torch.from_numpy(zt), None, rescue)
    x_hat_p, zB_p, _ = inv.invert_batch(q_p, nets, xt, draws, steps=STEPS, lr=LR, xemb=xemb_p)
    mseB_p = _mse(x_hat_p.numpy(), x)
    z0_p = sample_q(q_p, None, torch.from_numpy(zt), 0, xemb=xemb_p)  # invert_batch's sweep, for the record
    leg_b = {"xemb_rel_l2": rel_l2(xemb_p.numpy(), np.asarray(xemb_j)), "sweep_z0_rel_l2": rel_l2(z0_p.numpy(), z0_j),
             "recon_mse": {"ref": mseB_j, "damc": mseB_p, "rel_diff": abs(mseB_p - mseB_j) / max(mseB_j, 1e-12)}}
    print({"leg_a_adam_refine": leg_a, "leg_b_full_pipeline": leg_b})
    assert np.isfinite(zB_p.numpy()).all() and np.isfinite(zB_j).all()
    assert leg_a["z_rel_l2"] < 0.05, leg_a
    assert leg_a["recon_mse"]["rel_diff"] < 1e-2, leg_a
    assert leg_a["loss_decreased"], leg_a
    assert leg_b["xemb_rel_l2"] < 1e-4, leg_b
    assert leg_b["recon_mse"]["rel_diff"] < 5e-2, leg_b
