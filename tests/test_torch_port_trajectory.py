"""Trajectory parity of the port's gen_recon training loop against the JAX
package's, in the slow tier (`-m slow`): the protocol of
`tools/trajectory_parity.py`, with the port's loop in the place of the
reference's.

Both loops start from identical weights (the JAX state carried into the
port by `convert.train_state_from_jax`), take the same synthetic images in
the same batch order and the same conditional-mask sequence (replayed from
the JAX key chain and fed to the port as its mask uniforms), and draw every
other random number from their own generators: threefry on the JAX side,
the port's device generator and the kernels' counter streams (their plain
versions here) on the other. So the trajectories are compared in
statistics: the means of the last quarter of g_loss and q_loss, and of
e_pos - e_neg on the scale of the energies, within the tolerances
tests/test_trajectory_parity.py holds the JAX loop to against the
reference, and both loops must improve their reconstructions. Tiny widths
(nz 16, ngf 8, nif 8, ndf 32, nxemb 24, ntemb 8, 6 sweep steps), B=32,
200 iterations."""

from __future__ import annotations

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from damc_tpu.train.state import create_state as jax_create_state
from damc_tpu.train.step import make_train_step as jax_make_train_step
from damc_tpu_torch.config import preset
from damc_tpu_torch.convert import train_state_from_jax
from damc_tpu_torch.train.step import draw_step, make_train_step
from torch_port_helpers import one_torch_thread, to_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from trajectory_parity import (  # noqa: E402
    METRIC_KEYS, batch_schedule, compare_trajectories, mask_sequence, synthetic_images, tiny_config,
)

ITERS, N_IMAGES, SEED = 200, 128, 0
WIDTHS = dict(nz=16, ngf=8, nif=8, ndf=32, nxemb=24, ntemb=8)
SIZES = dict(batch_size=32, g_l_steps=10, e_l_steps=12, n_interval=6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


def _port_cfg():
    cfg = preset("cifar10")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, **WIDTHS),
        diffusion=dataclasses.replace(cfg.diffusion, n_interval=SIZES["n_interval"]),
        mcmc=dataclasses.replace(cfg.mcmc, g_l_steps=SIZES["g_l_steps"], e_l_steps=SIZES["e_l_steps"]),
        train=dataclasses.replace(cfg.train, batch_size=SIZES["batch_size"]),
    )


def _run_jax(cfg, state, models, opts, images, sched):
    step = jax.jit(jax_make_train_step(models, opts, cfg))
    traj = {k: [] for k in METRIC_KEYS}
    for t in range(len(sched)):
        state, metrics = step(state, jax.numpy.asarray(images[sched[t]]))
        for k in METRIC_KEYS:
            traj[k].append(float(metrics[k]))
    return {k: np.asarray(v) for k, v in traj.items()}


def _run_port(cfg, state, images, sched, masks):
    step = make_train_step(state.models, state.opts, cfg)
    traj = {k: [] for k in METRIC_KEYS}
    for t in range(len(sched)):
        draws = draw_step(cfg, len(sched[t]), state)
        draws.mask_u = torch.from_numpy(masks[t])  # 1.0 >= p_mask: conditional; 0.0: not
        state, metrics = step(state, torch.from_numpy(images[sched[t]]), draws)
        for k in METRIC_KEYS:
            traj[k].append(float(metrics[k]))
    return {k: np.asarray(v) for k, v in traj.items()}


@pytest.mark.slow
def test_gen_recon_trajectories_track_the_jax_loop():
    cfg_j = tiny_config(**WIDTHS, **SIZES)
    cfg_p = _port_cfg()
    images = synthetic_images(N_IMAGES, res=cfg_j.model.image_size, seed=SEED)
    sched = batch_schedule(N_IMAGES, cfg_j.train.batch_size, ITERS, seed=SEED + 1)
    state, models, opts = jax_create_state(jax.random.PRNGKey(SEED), cfg_j)
    masks = mask_sequence(state.rng, ITERS, cfg_j.train.batch_size, cfg_j.diffusion.p_mask)
    assert 0.0 < cfg_p.diffusion.p_mask == cfg_j.diffusion.p_mask
    port = train_state_from_jax(to_numpy(state), cfg_p, seed=SEED, device="cpu")
    jax_traj = _run_jax(cfg_j, state, models, opts, images, sched)
    port_traj = _run_port(cfg_p, port, images, sched, masks)
    for traj in (jax_traj, port_traj):
        assert all(np.isfinite(v).all() for v in traj.values())
    summary = compare_trajectories(jax_traj, port_traj)  # "ref" is the JAX loop, "damc" the port's
    print(summary)
    assert summary["g_loss"]["rel_diff"] < 0.05, summary["g_loss"]
    assert summary["q_loss"]["rel_diff"] < 0.30, summary["q_loss"]
    assert summary["cd_gap"]["abs_diff_over_escale"] < 0.5, summary["cd_gap"]
    assert summary["g_improvement"]["ref"] > 1.0, summary["g_improvement"]
    assert summary["g_improvement"]["damc"] > 1.0, summary["g_improvement"]
