"""Data-parallel gen_recon on the CPU: the train step, the sharded FID
statistics and the training loop's multi-process pieces, on gloo ranks
(`torch_port_gloo.GlooGroup`, one group of 2 for the module), against the
JAX package's 2-device mesh and the port's world of 1.

  * One port train step on 2 ranks from JAX's weights, twice, with every
    draw from the JAX key tree and the kernels' noise off (as in
    tests/test_torch_port_train.py), against JAX's `make_train_step(mesh=
    make_mesh(n_data=2), pallas_interpret="plain")` on 2 of the conftest's
    CPU devices, and against the port's world-1 step on the same draws:
    metrics within rtol 1e-5 / atol 1e-5 and parameters within that test's
    Adam limits (its docstring gives them). World 2 and world 1 differ by
    the order of the reductions alone (each rank's mean gradient, then the
    mean over the ranks), so the world-1 comparison takes the same limits.
    The ranks' replicas are equal bit for bit.
  * `compute_stats_sharded` against `compute_stats` on the same global
    batches, at float64 rounding (rtol 1e-12).
  * `cli.train_gen_recon --use_mesh` on 2 ranks: 2 iterations with evals,
    grids and a checkpoint, then a resume to 3; the replicas are equal,
    rank 0 alone writes, every rank resumes from the same checkpoint.
    `cli.eval_gen_recon --use_mesh` then prints the world-1 run's numbers
    within rtol 1e-4: the generated rows agree to the plain versions'
    1e-6 (tests/test_torch_port_sharding.py) and the feature statistics
    are summed in another order.
  * A SIGTERM on one rank stops both at the same iteration
    (`shutdown_agreed`).
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_port_gloo as gloo
from damc_tpu.parallel import batch_sharding as jax_batch_sharding
from damc_tpu.parallel import make_mesh as jax_make_mesh
from damc_tpu.parallel import replicate as jax_replicate
from damc_tpu.parallel import replicated as jax_replicated
from damc_tpu.parallel import shard_batch as jax_shard_batch
from damc_tpu.train.state import create_state as jax_create_state
from damc_tpu.train.step import make_train_step as jax_make_train_step
from damc_tpu_torch.cli import eval_gen_recon
from damc_tpu_torch.convert import train_state_from_jax
from damc_tpu_torch.metrics.fid import compute_stats
from damc_tpu_torch.train.step import make_train_step
from damc_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from damc_tpu_torch.train.state import create_state
from test_cli_integration import fake_cifar
from test_torch_port_cli import TINY
from test_torch_port_train import _assert_metrics, _assert_state, _noiseless, _x
from torch_port_helpers import adam_cap, jax_step_draws, one_torch_thread, to_numpy, train_cfgs

SHARE = 5e-4  # tests/test_torch_port_train.py's share of elements allowed past 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def group():
    yield from gloo.groups()


def _assert_close_params(got: dict, want: dict, cfg):
    """Each network's tensors within tests/test_torch_port_train.py's Adam
    limits (2 iterations; Q and Q_ema take q_updates a step)."""
    o, q = cfg.optim, cfg.train.q_updates
    limits = {"G": (o.g_lr, 2), "E": (o.e_lr, 2), "Q": (o.q_lr, 2 * q), "Q_ema": (o.q_lr, 2 * q)}
    for net, (lr, updates) in limits.items():
        keys = [k for k in want if k.startswith(net + ".")]
        diffs = [np.abs(got[k] - want[k]) for k in keys]
        total, bad = sum(d.size for d in diffs), sum(int((d > 1e-5).sum()) for d in diffs)
        assert max(float(d.max()) for d in diffs) <= adam_cap(lr, updates, (0.5, 0.999)) + 1e-5, net
        assert bad <= SHARE * total, (net, bad, total)


def test_two_rank_train_steps_match_jax_mesh_and_world_one(group, tmp_path):
    cfg_j, cfg_p = map(_noiseless, train_cfgs("svhn", ema_every=2))
    state, models_j, opts_j = jax_create_state(jax.random.PRNGKey(0), cfg_j)
    port = train_state_from_jax(to_numpy(state), cfg_p, device="cpu")
    save_checkpoint(str(tmp_path), "0", port)
    mesh = jax_make_mesh(n_data=2)
    step_j = jax.jit(
        jax_make_train_step(models_j, opts_j, cfg_j, mesh=mesh, pallas_interpret="plain"),
        in_shardings=(jax_replicated(mesh), jax_batch_sharding(mesh)),
        out_shardings=(jax_replicated(mesh), jax_replicated(mesh)),
    )
    state = jax_replicate(mesh, state)
    r = np.random.default_rng(0)
    xs, draws, metrics_j = [], [], []
    for _ in range(2):
        x = _x(cfg_j, r)
        draws.append(jax_step_draws(state.rng, cfg_j, len(x)))
        state, m = step_j(state, jax_shard_batch(mesh, x))
        xs.append(x)
        metrics_j.append(m)

    results = group(2).run(gloo.train_steps, cfg_p, str(tmp_path), xs, draws)
    one = restore_checkpoint(str(tmp_path), "0", create_state(cfg_p, 0, "cpu"))
    step_1 = make_train_step(one.models, one.opts, cfg_p)
    metrics_1 = []
    for x, d in zip(xs, draws):
        one, m = step_1(one, torch.from_numpy(x), d)
        metrics_1.append(m)
    arrays_1 = gloo.state_arrays(one)

    (m0, arrays0), (m1, arrays1) = results
    assert m0 == m1 and all(np.array_equal(arrays0[k], arrays1[k]) for k in arrays0)
    for got, want_j, want_1 in zip(m0, metrics_j, metrics_1):
        _assert_metrics(got, want_j)
        _assert_metrics(got, want_1)
    _assert_close_params(arrays0, arrays_1, cfg_p)
    # Against JAX's mesh state, as tests/test_torch_port_train.py holds the world of 1.
    restored = create_state(cfg_p, 0, "cpu")
    for net, mod in (("G", restored.models.generator), ("E", restored.models.ebm),
                     ("Q", restored.models.amortizer), ("Q_ema", restored.amortizer_ema)):
        mod.load_state_dict({k[len(net) + 1:]: torch.from_numpy(v) for k, v in arrays0.items()
                             if k.startswith(net + ".")})
    _assert_state(restored, jax.tree.map(np.asarray, state), cfg_j, 2)


def test_compute_stats_sharded_matches_compute_stats(group):
    r = np.random.default_rng(3)
    batches = [r.normal(size=(8, 6)).astype(np.float32) for _ in range(5)]
    want = compute_stats(lambda t: t, [torch.from_numpy(b) for b in batches])
    for mu, sigma in group(2).run(gloo.sharded_stats, batches, 2):  # folds after batches 2, 4 and 5
        np.testing.assert_allclose(mu, want[0], rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(sigma, want[1], rtol=1e-12, atol=1e-15)


def test_train_cli_with_use_mesh_on_two_ranks(group, tmp_path):
    data, logs = str(tmp_path / "data"), str(tmp_path / "logs")
    fake_cifar(data, n_train=40, n_test=13)
    common_args = ["--dataset", "cifar10", "--data_path", data, "--log_path", logs, "--device", "cpu", *TINY]
    mesh_args = ["--use_mesh", "--dist_backend", "gloo", "--eval_every", "1", "--plot_every", "1"]
    (s0, g0, r0, step0, a0), (s1, g1, r1, step1, a1) = group(2).run(
        gloo.train_cli, common_args + mesh_args + ["--iterations", "2"])
    assert step0 == step1 == 2 and all(np.array_equal(a0[k], a1[k]) for k in a0)
    (run,) = os.listdir(os.path.join(logs, "cifar10"))  # rank 0 made the run directory
    run = os.path.join(logs, "cifar10", run)
    assert sorted(s0) == ["1", "best"] and s1 == []  # the tail checkpoint and the first eval's best
    assert g1 == [] and r1 == []
    assert {"0_obs.png", "0_post.png", "0_post_Q.png", "0_prior.png", "1_fid_damc.png"} <= set(g0)
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["1", "best"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(l) for l in f]
    assert [(r["phase"], r["step"]) for r in rows if r["phase"] == "eval"] == [("eval", 0), ("eval", 1)]

    (s0, _, _, step0, b0), (s1, _, _, step1, b1) = group(2).run(
        gloo.train_cli, common_args + mesh_args + ["--iterations", "3", "--resume_path", "auto"])
    assert step0 == step1 == 3 and all(np.array_equal(b0[k], b1[k]) for k in b0)
    assert s1 == [] and "2" in s0 and any(not np.array_equal(a0[k], b0[k]) for k in a0)
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["1", "2", "best"]

    ev = common_args + ["--ckpt_dir", os.path.join(run, "ckpt"), "--ckpt_name", "2", "--e_l_steps", "3"]
    (n0, out0), (n1, out1) = group(2).run(gloo.eval_cli, ev + ["--use_mesh", "--dist_backend", "gloo"])
    assert n0 == n1 and "recon MSE" in out0 and "recon MSE" not in out1  # rank 0 prints the numbers
    want = eval_gen_recon.main(ev)
    assert set(n0) == set(want)
    for k in want:
        np.testing.assert_allclose(n0[k], want[k], rtol=1e-4, err_msg=k)


def test_a_signal_on_one_rank_stops_every_rank_at_the_same_iteration(group):
    (ran0, stopped0), (ran1, stopped1) = group(2).run(gloo.preempted_loop, 10, 1, 3)
    assert ran0 == ran1 == [0, 1, 2, 3] and stopped0 and stopped1
