"""Data-parallel anomaly detection on the CPU: the anomaly variant of the
train step, the sharded AUPRC eval and both anomaly CLIs with
`--use_mesh`, on gloo ranks (`torch_port_gloo.GlooGroup`, one group of 2
for the module), against the JAX package's 2-device mesh and the port's
world of 1.

  * One anomaly train step on 2 ranks from JAX's weights, twice, every
    draw from the JAX key tree and the kernels' noise off, against JAX's
    `make_train_step(mesh=make_mesh(n_data=2), pallas_interpret="plain")`
    and against the port's world-1 step on the same draws, at the limits
    of tests/test_torch_port_data_parallel.py. The anomaly step's prior
    chains are the B gathered z0 rows (not 2B): each rank runs K1 on its
    B / 2 of them at its row_base and K2 on its B / 2 rows.
  * `evaluate_auprc` on 2 ranks against world 1 over 23 images in batches
    of 10 (rounded up over the ranks; the tail of 3 padded): the gathered
    scores at rtol 1e-5 (the ranks' convolutions and products run at 5
    rows where world 1 runs 10, so they round apart) and the same AUPRC;
    each rank scores its 5 rows of every batch at its row_base.
  * `cli.train_anomaly_det --use_mesh` on 2 ranks: 2 iterations with
    evals, then a resume to 3; replicas equal, rank 0 alone writes; then
    `cli.eval_anomaly_det --use_mesh` prints the world-1 CLI's AUPRC.
"""

from __future__ import annotations

import json
import os
import shutil

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
from damc_tpu_torch.cli import eval_anomaly_det
from damc_tpu_torch.config import preset
from damc_tpu_torch.convert import train_state_from_jax
from damc_tpu_torch.data import datasets
from damc_tpu_torch.train import anomaly
from damc_tpu_torch.train.gen_recon import make_draws_fn
from damc_tpu_torch.train.state import create_state
from damc_tpu_torch.train.step import make_train_step
from damc_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from test_torch_port_anomaly import TINY
from test_torch_port_data_parallel import _assert_close_params
from test_torch_port_train import _assert_metrics, _assert_state, _noiseless, _x
from torch_port_helpers import jax_step_draws, one_torch_thread, tiny, to_numpy, train_cfgs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def group():
    yield from gloo.groups()


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    """An MNIST-shaped mnist.npz made from seed 0 (600/100/100 images)."""
    d = tmp_path_factory.mktemp("mnist")
    datasets.synthetic_mnist_npz(str(d / "mnist.npz"), (600, 100, 100), seed=0)
    return str(d)


def test_two_rank_anomaly_steps_match_jax_mesh_and_world_one(group, tmp_path):
    cfg_j, cfg_p = map(_noiseless, train_cfgs("mnist_anomaly", ema_every=2))
    assert cfg_p.train.prior_chains == "single" and not cfg_p.train.random_mask
    assert cfg_p.train.q_loss_both_branches
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

    results = group(2).run(gloo.counted_train_steps, cfg_p, str(tmp_path), xs, draws)
    one = restore_checkpoint(str(tmp_path), "0", create_state(cfg_p, 0, "cpu"))
    step_1 = make_train_step(one.models, one.opts, cfg_p)
    metrics_1 = []
    for x, d in zip(xs, draws):
        one, m = step_1(one, torch.from_numpy(x), d)
        metrics_1.append(m)

    (m0, arrays0, calls0), (m1, arrays1, calls1) = results
    b = cfg_p.train.batch_size
    for rank, calls in enumerate((calls0, calls1)):
        # Each step: K2 on the rank's B / 2 rows, K1 on its B / 2 of the B chains.
        assert calls == [("K2", b // 2, rank * b // 2), ("K1", b // 2, rank * b // 2)] * 2, calls
    assert m0 == m1 and all(np.array_equal(arrays0[k], arrays1[k]) for k in arrays0)
    for got, want_j, want_1 in zip(m0, metrics_j, metrics_1):
        _assert_metrics(got, want_j)
        _assert_metrics(got, want_1)
    _assert_close_params(arrays0, gloo.state_arrays(one), cfg_p)
    restored = create_state(cfg_p, 0, "cpu")
    for net, mod in (("G", restored.models.generator), ("E", restored.models.ebm),
                     ("Q", restored.models.amortizer), ("Q_ema", restored.amortizer_ema)):
        mod.load_state_dict({k[len(net) + 1:]: torch.from_numpy(v) for k, v in arrays0.items()
                             if k.startswith(net + ".")})
    _assert_state(restored, jax.tree.map(np.asarray, state), cfg_j, 2)


def test_sharded_auprc_eval_matches_world_one(group, mnist_dir, tmp_path):
    cfg = tiny(preset("mnist_anomaly"))
    save_checkpoint(str(tmp_path), "0", create_state(cfg, 5, "cpu"))
    x, y = datasets.load_mnist_anomaly(mnist_dir, 9, "test", cache=False)
    x, y = x[:23], y[:23]
    assert 0 < y.sum() < 23
    (a0, s0, c0), (a1, s1, c1) = group(2).run(gloo.auprc_eval, cfg, str(tmp_path), x, y, 10, 4, 11)
    state = restore_checkpoint(str(tmp_path), "0", create_state(cfg, 0, "cpu"))
    seen = []
    original = anomaly.auprc
    anomaly.auprc = lambda s, lbl: (seen.append(np.array(s)), original(s, lbl))[1]
    try:
        want = anomaly.evaluate_auprc(state.models, cfg, x, y, make_draws_fn(11, "auprc", 0, cfg.model.nz, "cpu"),
                                      batch=10, langevin_steps=4)
    finally:
        anomaly.auprc = original
    assert np.array_equal(s0, s1) and a0 == a1 and s0.shape == (23,)
    np.testing.assert_allclose(s0, seen[0], rtol=1e-5)
    assert a0 == want
    for rank, calls in enumerate((c0, c1)):
        assert calls == [("K2", 5, rank * 5)] * 3, calls


def test_anomaly_clis_with_use_mesh_on_two_ranks(group, mnist_dir, tmp_path):
    data, logs = str(tmp_path / "data"), str(tmp_path / "logs")
    os.makedirs(data)
    shutil.copy(os.path.join(mnist_dir, "mnist.npz"), data)
    common = ["--data_path", data, "--label", "9", "--device", "cpu", *TINY]
    mesh_args = ["--log_path", logs, "--use_mesh", "--dist_backend", "gloo", "--eval_every", "1"]
    (s0, r0, step0, a0, best0), (s1, r1, step1, a1, best1) = group(2).run(
        gloo.anomaly_cli, "train", common + mesh_args + ["--iterations", "2"])
    assert step0 == step1 == 2 and all(np.array_equal(a0[k], a1[k]) for k in a0)
    assert best0 == best1 and 0.0 < best0 <= 1.0
    (run,) = os.listdir(os.path.join(logs, "mnist"))  # rank 0 made the run directory
    run = os.path.join(logs, "mnist", run)
    assert sorted(s0) == ["1", "best"] and s1 == [] and r1 == []
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["1", "best"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rows = [json.loads(l) for l in f]
    assert [r["step"] for r in rows if r["phase"] == "eval"] == [0, 1]

    (s0, _, step0, b0, _), (s1, _, step1, b1, _) = group(2).run(
        gloo.anomaly_cli, "train", common + mesh_args + ["--iterations", "3", "--resume_path", "auto"])
    assert step0 == step1 == 3 and all(np.array_equal(b0[k], b1[k]) for k in b0)
    assert s1 == [] and "2" in s0 and any(not np.array_equal(a0[k], b0[k]) for k in a0)
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["1", "2", "best"]

    ev = common + ["--log_path", logs, "--ckpt_dir", os.path.join(run, "ckpt"), "--ckpt_name", "2"]
    (n0, out0), (n1, out1) = group(2).run(gloo.anomaly_cli, "eval", ev + ["--use_mesh", "--dist_backend", "gloo"])
    want = eval_anomaly_det.main(ev)
    assert n0 == n1 == want and 0.0 < want <= 1.0
    assert "AUPRC" in out0 and "AUPRC" not in out1  # rank 0 prints the number
