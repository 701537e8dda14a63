"""Trajectory parity of the port's toy training loop against the JAX
package's, in the slow tier (`-m slow`): the protocol of
`tools/trajectory_parity_toy.py` and tests/test_trajectory_parity_toy.py,
with the JAX loop where the tool runs the reference and the port's loop in
the place of the JAX one.

Both loops start from identical weights, the frozen likelihood G included
(the JAX state carried into the port by `convert.train_state_from_jax`),
take the same observation stream (the tool's `make_observation_stream`,
x = G(z) + 0.25 eps precomputed once) and the same conditional-mask
sequence (replayed from the JAX key chain, fed to the port as its mask
uniforms), and draw every other random number from their own generators.
The trajectories are compared in the tail means of g_loss and q_loss; the
end states by the tool's quality protocol on shared eval data (pinwheel
latents `seed + 7919 + i`, observation noise from `RandomState(seed * 31 +
1000 + i)`): each side's Q samples and `GT_STEPS` steps of noisy posterior
Langevin from N(0, I) on its own draws, the recon losses g_loss(Q) and
g_loss(L), and the MMD^2 between the two sides' Q clouds; JAX's side as
the tool computes it, the port's through `train/toy.py::eval_toy_parity`.
Tolerances are the JAX-side test's. Tiny sizes (nxemb 24, ntemb 8, 6
sweep steps, 8 posterior steps), B=64, 48 iterations, 3 eval batches of
200."""

from __future__ import annotations

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.data.pinwheel import sample_pinwheel as jax_pinwheel
from damc_tpu.metrics.mmd import mmd2_rbf as jax_mmd2
from damc_tpu.models.amortizer import sample_q as jax_sample_q
from damc_tpu.ops.langevin import gaussian_posterior_energy as jax_energy
from damc_tpu.ops.langevin import langevin_sample as jax_langevin
from damc_tpu.train.state import create_state as jax_create_state
from damc_tpu_torch.config import preset
from damc_tpu_torch.convert import train_state_from_jax
from damc_tpu_torch.train.step import draw_step, make_train_step
from damc_tpu_torch.train.toy import eval_toy_parity, toy_draws_fn
from torch_port_helpers import one_torch_thread, to_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from trajectory_parity import mask_sequence  # noqa: E402
from trajectory_parity_toy import (  # noqa: E402
    compare_toy_trajectories, make_observation_stream, run_damc_toy, tiny_toy_config,
)

ITERS, SEED = 48, 0
SIZES = dict(batch_size=64, g_l_steps=8, n_interval=6, nxemb=24, ntemb=8)
EVAL_BATCHES, EVAL_BATCH, GT_STEPS = 3, 200, 600


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


def _port_cfg():
    cfg = preset("toy")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, nxemb=SIZES["nxemb"], ntemb=SIZES["ntemb"]),
        diffusion=dataclasses.replace(cfg.diffusion, n_interval=SIZES["n_interval"]),
        mcmc=dataclasses.replace(cfg.mcmc, g_l_steps=SIZES["g_l_steps"]),
        train=dataclasses.replace(cfg.train, batch_size=SIZES["batch_size"]),
    )


def _run_port(cfg, state, xs, masks):
    step = make_train_step(state.models, state.opts, cfg)
    traj = {"g_loss": [], "q_loss": []}
    for t in range(len(xs)):
        draws = draw_step(cfg, len(xs[t]), state)
        draws.mask_u = torch.from_numpy(masks[t])  # 1.0 >= p_mask: conditional; 0.0: not
        state, metrics = step(state, torch.from_numpy(xs[t]), draws)
        for k in traj:
            traj[k].append(float(metrics[k]))
    return {k: np.asarray(v) for k, v in traj.items()}, state


def _eval_noise(i):
    """The tool's observation noise of eval batch i."""
    return np.random.RandomState(SEED * 31 + 1000 + i).randn(EVAL_BATCH, 2).astype(np.float32)


def _jax_eval(cfg, state, models):
    """The JAX side of the tool's `final_state_eval`: Q samples (key
    fold_in(seed, 20000 + i)) and GT_STEPS of noisy posterior Langevin."""
    mc = cfg.mcmc
    gen_fn = lambda z: models.generator.apply(state.params_g, z)
    zq_all, loss_q, loss_l = [], 0.0, 0.0
    for i in range(EVAL_BATCHES):
        z_data = np.asarray(jax_pinwheel(EVAL_BATCH, SEED + 7919 + i), np.float32)
        x = jnp.asarray(np.asarray(gen_fn(jnp.asarray(z_data)), np.float32) + 0.25 * _eval_noise(i))
        k_q, k_init, k_gt = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), 20_000 + i), 3)
        zq = jax_sample_q(state.params_q, models.amortizer, k_q, x=x)
        zl, _ = jax_langevin(k_gt, jax.random.normal(k_init, z_data.shape), jax_energy(gen_fn, x, mc.g_llhd_sigma),
                             GT_STEPS, mc.g_l_step_size, with_noise=True)
        loss_q += float(jnp.sum((gen_fn(zq) - x) ** 2))
        loss_l += float(jnp.sum((gen_fn(zl) - x) ** 2))
        zq_all.append(np.asarray(zq))
    n = EVAL_BATCHES * EVAL_BATCH
    return loss_q / n, loss_l / n, np.concatenate(zq_all)


def _port_eval(cfg, state):
    """`eval_toy_parity` on the port's own eval draws, with the tool's
    observation noise in place of the drawn one."""
    draws = toy_draws_fn(SEED, ITERS, cfg.model.nz, GT_STEPS, "cpu")

    def shared(i, b):
        d = draws(i, b)
        d.obs_noise = torch.from_numpy(_eval_noise(i))
        return d

    out = eval_toy_parity(state, cfg, shared, seed=SEED, n_batches=EVAL_BATCHES, batch=EVAL_BATCH, gt_steps=GT_STEPS)
    return out["g_loss_q"], out["g_loss_l"], out["zq"]


@pytest.mark.slow
def test_toy_trajectories_track_the_jax_loop():
    cfg_j = tiny_toy_config(**SIZES)
    cfg_p = _port_cfg()
    assert cfg_p.diffusion.p_mask == cfg_j.diffusion.p_mask > 0.0 and cfg_p.train.random_mask
    state, models, opts = jax_create_state(jax.random.PRNGKey(SEED), cfg_j)
    _, xs = make_observation_stream(cfg_j, state.params_g, models, ITERS, SEED)
    masks = mask_sequence(state.rng, ITERS, cfg_j.train.batch_size, cfg_j.diffusion.p_mask)
    port = train_state_from_jax(to_numpy(state), cfg_p, seed=SEED, device="cpu")
    jax_traj, jax_state = run_damc_toy(cfg_j, state, models, opts, xs)
    port_traj, port = _run_port(cfg_p, port, xs, masks)
    for traj in (jax_traj, port_traj):
        assert all(np.isfinite(v).all() for v in traj.values())
    summary = compare_toy_trajectories(jax_traj, port_traj)  # "ref" is the JAX loop, "damc" the port's
    q_j, l_j, zq_j = _jax_eval(cfg_j, jax_state, models)
    q_p, l_p, zq_p = _port_eval(cfg_p, port)
    fe = summary["final_eval"] = {
        "g_loss_q": {"ref": q_j, "damc": q_p, "rel_diff": abs(q_j - q_p) / max(abs(q_j), 1e-12)},
        "g_loss_l": {"ref": l_j, "damc": l_p, "rel_diff": abs(l_j - l_p) / max(abs(l_j), 1e-12)},
        "mmd2_q_ref_vs_q_damc": float(jax_mmd2(jnp.asarray(zq_j), jnp.asarray(zq_p))),
    }
    print(summary)
    assert summary["q_loss"]["rel_diff"] < 0.35, summary["q_loss"]
    assert summary["g_loss"]["rel_diff"] < 0.95, summary["g_loss"]
    assert fe["g_loss_l"]["rel_diff"] < 0.35, fe
    ratio = fe["g_loss_q"]["damc"] / max(fe["g_loss_q"]["ref"], 1e-12)
    assert 1.0 / 3.0 < ratio < 3.0, fe
    assert fe["mmd2_q_ref_vs_q_damc"] < 0.5, fe
