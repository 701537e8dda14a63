"""Trajectory parity of the port's anomaly training loop against the JAX
package's, in the slow tier (`-m slow`): the protocol of
`tools/trajectory_parity_anomaly.py` and tests/test_trajectory_parity_anomaly.py,
with the JAX loop where the tool runs the reference and the port's loop in
the place of the JAX one.

Both loops start from identical weights (the JAX state carried into the
port by `convert.train_state_from_jax`) and take the same synthetic MNIST
split (the tool's `anomaly_data`) in the same batch order. The anomaly
loop's mask is the fixed all-ones one, so nothing is replayed: each loop
draws its Q-loss, Langevin and kernel noise from its own generators. The
trajectories are compared in statistics (the means of the last quarter of
g_loss and of the dual-branch q_loss, e_pos - e_neg on the scale of the
energies), both loops must improve their reconstructions, and the end
states are scored by each side's AUPRC eval (JAX's `evaluate_auprc` on its
key, the port's on its own eval draws), within the JAX-side test's
tolerances. Tiny widths (nz 8, ngf 8, nif 8, ndf 32, nxemb 24, ntemb 8, 6
sweep steps), B=32, 12 iterations, 600/100/100 images a split."""

from __future__ import annotations

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

from damc_tpu.train.anomaly import evaluate_auprc as jax_evaluate_auprc
from damc_tpu.train.state import create_state as jax_create_state
from damc_tpu_torch.config import preset
from damc_tpu_torch.convert import train_state_from_jax
from damc_tpu_torch.train.anomaly import evaluate_auprc
from damc_tpu_torch.train.gen_recon import make_draws_fn
from damc_tpu_torch.train.step import draw_step, make_train_step
from torch_port_helpers import one_torch_thread, to_numpy

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
from trajectory_parity import METRIC_KEYS, batch_schedule, compare_trajectories, run_damc  # noqa: E402
from trajectory_parity_anomaly import anomaly_data, tiny_anomaly_config  # noqa: E402

ITERS, SEED, N_PER_SPLIT = 12, 0, (600, 100, 100)
WIDTHS = dict(ngf=8, nif=8, ndf=32, nxemb=24, ntemb=8)
SIZES = dict(batch_size=32, g_l_steps=8, e_l_steps=10, n_interval=6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


def _port_cfg():
    cfg = preset("mnist_anomaly")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, **WIDTHS),
        diffusion=dataclasses.replace(cfg.diffusion, n_interval=SIZES["n_interval"]),
        mcmc=dataclasses.replace(cfg.mcmc, g_l_steps=SIZES["g_l_steps"], e_l_steps=SIZES["e_l_steps"]),
        train=dataclasses.replace(cfg.train, batch_size=SIZES["batch_size"]),
    )


def _run_port(cfg, state, images, sched):
    step = make_train_step(state.models, state.opts, cfg)
    traj = {k: [] for k in METRIC_KEYS}
    for t in range(len(sched)):
        state, metrics = step(state, torch.from_numpy(images[sched[t]]), draw_step(cfg, len(sched[t]), state))
        for k in METRIC_KEYS:
            traj[k].append(float(metrics[k]))
    return {k: np.asarray(v) for k, v in traj.items()}, state


@pytest.mark.slow
def test_anomaly_trajectories_track_the_jax_loop(tmp_path):
    cfg_j = tiny_anomaly_config(**SIZES, **WIDTHS)
    cfg_p = _port_cfg()
    assert not cfg_p.train.random_mask and cfg_p.train.q_loss_both_branches
    assert cfg_p.train.prior_chains == cfg_j.train.prior_chains == "single"
    assert cfg_p.model.nz == cfg_j.model.nz == 8
    train_x, test_x, test_y = anomaly_data(str(tmp_path), heldout=cfg_j.train.heldout_digit,
                                           n_per_split=N_PER_SPLIT, seed=SEED)
    sched = batch_schedule(len(train_x), cfg_j.train.batch_size, ITERS, seed=SEED + 1)
    state, models, opts = jax_create_state(jax.random.PRNGKey(SEED), cfg_j)
    port = train_state_from_jax(to_numpy(state), cfg_p, seed=SEED, device="cpu")
    jax_traj, jax_state = run_damc(cfg_j, state, models, opts, train_x, sched)
    port_traj, port = _run_port(cfg_p, port, train_x, sched)
    for traj in (jax_traj, port_traj):
        assert all(np.isfinite(v).all() for v in traj.values())
    summary = compare_trajectories(jax_traj, port_traj)  # "ref" is the JAX loop, "damc" the port's
    eval_batch = min(200, len(test_x))
    fa = summary["final_auprc"] = {
        "ref": float(jax_evaluate_auprc(jax.random.PRNGKey(SEED + 11), jax_state, models, cfg_j, test_x, test_y,
                                        batch=eval_batch)),
        "damc": evaluate_auprc(port.models, cfg_p, test_x, test_y,
                               make_draws_fn(SEED, "auprc", ITERS, cfg_p.model.nz, "cpu"), batch=eval_batch),
        "anomaly_rate": float(np.mean(test_y)),
    }
    fa["abs_diff"] = abs(fa["ref"] - fa["damc"])
    print(summary)
    assert summary["g_loss"]["rel_diff"] < 0.05, summary["g_loss"]
    assert summary["q_loss"]["rel_diff"] < 0.40, summary["q_loss"]
    assert summary["cd_gap"]["abs_diff_over_escale"] < 0.5, summary["cd_gap"]
    assert summary["g_improvement"]["ref"] > 1.0, summary["g_improvement"]
    assert summary["g_improvement"]["damc"] > 1.0, summary["g_improvement"]
    assert fa["abs_diff"] < 0.15, fa
