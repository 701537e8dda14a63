"""The port's anomaly-detection workload (`damc_tpu_torch/{data/datasets,
metrics/prauc,train/anomaly,cli/train_anomaly_det,cli/eval_anomaly_det}
.py`) on the CPU against the JAX package: the MNIST split and labels of a
`synthetic_mnist_npz` file with its cache, AUPRC on ties and all-negative
labels, the AUPRC eval on the JAX draws over a ragged set, a 3-iteration
run with an eval, a `best` checkpoint and a resume, and both CLIs at tiny
widths."""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from damc_tpu.data import datasets as jax_datasets
from damc_tpu.metrics.prauc import auprc as jax_auprc
from damc_tpu.train.anomaly import evaluate_auprc as jax_evaluate_auprc
from damc_tpu_torch.cli import eval_anomaly_det, eval_gen_recon, toy as toy_cli, train_anomaly_det
from damc_tpu_torch.cli import train_gen_recon
from damc_tpu_torch.config import preset
from damc_tpu_torch.data import datasets
from damc_tpu_torch.metrics.prauc import auprc
from damc_tpu_torch.train.anomaly import evaluate_auprc, train_anomaly
from damc_tpu_torch.utils.checkpoint import latest_step
from test_torch_port_sampling import recon_draws
from torch_port_helpers import jax_and_port, tiny
import torch_port_helpers


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from torch_port_helpers.one_torch_thread()


@pytest.fixture(scope="module")
def mnist_dir(tmp_path_factory):
    """An MNIST-shaped mnist.npz made from seed 0 (600/100/100 images)."""
    d = tmp_path_factory.mktemp("mnist")
    datasets.synthetic_mnist_npz(str(d / "mnist.npz"), (600, 100, 100), seed=0)
    return str(d)


def test_synthetic_mnist_npz_equals_jax(tmp_path):
    jax_datasets.synthetic_mnist_npz(str(tmp_path / "j.npz"), (70, 13, 9), seed=5)
    datasets.synthetic_mnist_npz(str(tmp_path / "p.npz"), (70, 13, 9), seed=5)
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "p.npz") as p:
        assert sorted(j.files) == sorted(p.files)
        for k in j.files:
            assert j[k].dtype == p[k].dtype
            np.testing.assert_array_equal(j[k], p[k], err_msg=k)


@pytest.mark.parametrize("heldout", [9, 1])
@pytest.mark.parametrize("split", ["train", "test"])
def test_mnist_split_equals_jax_with_its_cache(mnist_dir, tmp_path, heldout, split):
    """The split and labels equal JAX's, fresh and from each side's cache
    file (the port reads the JAX package's cache and the JAX package the
    port's); uint8 files scale as JAX scales them."""
    jdir, pdir = tmp_path / "j", tmp_path / "p"
    for d in (jdir, pdir):
        d.mkdir()
        shutil.copy(os.path.join(mnist_dir, "mnist.npz"), d / "mnist.npz")
    want = jax_datasets.load_mnist_anomaly(str(jdir), heldout, split)
    got = datasets.load_mnist_anomaly(str(pdir), heldout, split)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    imgs, lbls = got
    assert imgs.shape[1:] == (28, 28, 1) and imgs.min() >= -1.0 and imgs.max() <= 1.0
    assert (lbls.sum() == 0) if split == "train" else (0 < lbls.sum() < len(lbls))
    cache = f"heldout_{heldout}_{split}.npy"
    assert os.path.exists(jdir / cache) and os.path.exists(pdir / cache)
    os.remove(jdir / "mnist.npz")
    os.remove(pdir / "mnist.npz")
    shutil.copy(jdir / cache, pdir / cache)
    for g, w in zip(datasets.load_mnist_anomaly(str(pdir), heldout, split), want):
        np.testing.assert_array_equal(g, w)
    np.save(jdir / cache, {"img": (np.load(pdir / cache, allow_pickle=True).item()["img"] * 0).astype(np.uint8),
                           "lbl": want[1]})
    for g, w in zip(datasets.load_mnist_anomaly(str(jdir), heldout, split),
                    jax_datasets.load_mnist_anomaly(str(jdir), heldout, split)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="split"):
        datasets.load_mnist_anomaly(str(pdir), heldout, "valid")


def test_mnist_cache_is_renamed_into_place(mnist_dir, tmp_path, monkeypatch):
    """The split cache is written to a file of its own and renamed onto its
    name, so a second process that finds the name (the other rank of a
    two-rank run on one host, loading the same directory) never reads a
    file still being written: no write goes to the cache's name, and the
    cached split reads back equal."""
    shutil.copy(os.path.join(mnist_dir, "mnist.npz"), tmp_path / "mnist.npz")
    cache = str(tmp_path / "heldout_9_train.npy")
    targets, save = [], np.save
    monkeypatch.setattr(np, "save", lambda f, *a, **kw: (targets.append(getattr(f, "name", f)), save(f, *a, **kw)))
    fresh = datasets.load_mnist_anomaly(str(tmp_path), 9, "train")
    assert targets and cache not in map(str, targets)
    assert sorted(os.listdir(tmp_path)) == ["heldout_9_train.npy", "mnist.npz"]  # no file left behind
    for g, w in zip(datasets.load_mnist_anomaly(str(tmp_path), 9, "train"), fresh):
        np.testing.assert_array_equal(g, w)


CASES = {
    "ties": (np.array([0.5, 0.5, 0.2, 0.9, 0.9, 0.9, 0.1]), np.array([1, 0, 1, 0, 1, 1, 0])),
    "all_negative": (np.array([0.3, 0.1, 0.7]), np.array([0, 0, 0])),
    "all_positive": (np.array([0.3, 0.1, 0.7]), np.array([1, 1, 1])),
    "random": (np.random.default_rng(0).normal(size=500), np.random.default_rng(1).integers(0, 2, 500)),
    "rounded": (np.round(np.random.default_rng(2).normal(size=300), 1), np.random.default_rng(3).integers(0, 2, 300)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_auprc_equals_jax(case):
    scores, labels = CASES[case]
    assert auprc(scores, labels) == jax_auprc(scores, labels)
    if case == "all_negative":
        assert auprc(scores, labels) == 0.0


def _noiseless(cfg):
    return dataclasses.replace(
        cfg,
        mcmc=dataclasses.replace(cfg.mcmc, e_l_with_noise=False),
        diffusion=dataclasses.replace(cfg.diffusion, with_noise=False),
    )


def test_evaluate_auprc_matches_jax(mnist_dir):
    """23 test images in batches of 10 (the tail of 3 padded with its last
    image), 4 noiseless posterior steps, each batch's Q draws from the JAX
    eval's key (`fold_in(key, first image)`): the AUPRC within 1e-6."""
    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=7, preset_name="mnist_anomaly", edit=_noiseless)
    x, y = datasets.load_mnist_anomaly(mnist_dir, 9, "test", cache=False)
    x, y = x[:23], y[:23]
    assert 0 < y.sum() < 23
    key = jax.random.PRNGKey(3)
    want = jax_evaluate_auprc(key, state, models_j, cfg_j, x, y, batch=10, langevin_steps=4)
    nz = cfg_p.model.nz
    draws = lambda i, b: recon_draws(jax.random.fold_in(key, i * 10), b, nz)
    got = evaluate_auprc(models_p, cfg_p, x, y, draws, batch=10, langevin_steps=4)
    assert abs(got - want) <= 1e-6, (got, want)


def _tiny_anomaly(**train_kw):
    cfg = tiny(preset("mnist_anomaly"))
    return dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, batch_size=8, q_updates=2, **train_kw)
    )


def test_train_anomaly_three_iterations_eval_best_and_resume(mnist_dir, tmp_path):
    """Three iterations with an eval every 2 (at 0 and 2) and checkpoints
    every 2 (2, then the terminal one is 2 too): eval rows with the AUPRC
    and its best, ckpt/best from the first eval; then `auto` resumes at
    iteration 3 and runs to 4 in the same directory."""
    cfg = _tiny_anomaly(eval_every=2, ckpt_every=2, print_every=1)
    tr, _ = datasets.load_mnist_anomaly(mnist_dir, 9, "train", cache=False)
    te, tl = datasets.load_mnist_anomaly(mnist_dir, 9, "test", cache=False)
    log_dir = str(tmp_path / "run")
    state, best = train_anomaly(cfg, tr[:64], te[:30], tl[:30], iterations=3, seed=4, device="cpu",
                                log_dir=log_dir)
    assert state.step == 3 and 0.0 < best <= 1.0
    assert sorted(os.listdir(os.path.join(log_dir, "ckpt"))) == ["2", "best"]
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    evals = [r for r in rows if r["phase"] == "eval"]
    assert [r["step"] for r in evals] == [0, 2]
    assert best == max(r["auprc"] for r in evals) == evals[-1]["auprc_best"]
    assert evals[0]["auprc_best"] == evals[0]["auprc"]
    train_rows = [r for r in rows if r["phase"] == "train"]
    assert [r["step"] for r in train_rows] == [0, 1, 2] and "prior_energy_final" in train_rows[0]

    resumed, _ = train_anomaly(cfg, tr[:64], te[:30], tl[:30], iterations=4, seed=4, device="cpu",
                               log_dir=log_dir, resume_path="auto")
    assert resumed.step == 4 and latest_step(os.path.join(log_dir, "ckpt")) == 3
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        steps = [r["step"] for r in map(json.loads, f) if r["phase"] == "train"]
    assert steps == [0, 1, 2, 3]


TINY = ["--nz", "8", "--ngf", "8", "--nif", "8", "--nxemb", "16", "--ntemb", "16", "--n_interval", "2",
        "--g_l_steps", "2", "--e_l_steps", "2", "--batch_size", "8"]


def test_anomaly_clis_round_trip_on_cpu(mnist_dir, tmp_path):
    """Train 3 iterations through the CLI (evals at 0 and 2), then score
    ckpt/best twice through the eval CLI (5 noiseless steps, the per-label
    sigma): the same AUPRC both times."""
    data = str(tmp_path / "data")
    os.makedirs(data)
    shutil.copy(os.path.join(mnist_dir, "mnist.npz"), data)
    common = ["--data_path", data, "--log_path", str(tmp_path / "logs"), "--label", "9", "--device", "cpu", *TINY]
    state, best = train_anomaly_det.main(common + ["--iterations", "3", "--eval_every", "2"])
    assert state.step == 3 and 0.0 < best <= 1.0
    (run,) = os.listdir(tmp_path / "logs" / "mnist")
    ckpt = str(tmp_path / "logs" / "mnist" / run / "ckpt")
    assert "best" in os.listdir(ckpt)
    assert {"heldout_9_train.npy", "heldout_9_test.npy"} <= set(os.listdir(data))
    ev = common + ["--ckpt_dir", ckpt]
    a, b = eval_anomaly_det.main(ev), eval_anomaly_det.main(ev)
    assert a == b and 0.0 < a <= 1.0
    assert eval_anomaly_det.PER_LABEL_SIGMA[9] == 1.0


CLIS = {
    "train_gen_recon": train_gen_recon.main, "eval_gen_recon": eval_gen_recon.main,
    "train_anomaly_det": train_anomaly_det.main, "eval_anomaly_det": eval_anomaly_det.main,
    "toy": toy_cli.main,
}


@pytest.mark.parametrize("cli", ["train_anomaly_det", "eval_anomaly_det", "toy"])
def test_new_clis_need_cuda_without_device(tmp_path, cli):
    """Without a card and without --device, each new CLI raises before it
    reads or trains anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    argv = {"toy": ["--log_path", str(tmp_path)],
            "train_anomaly_det": ["--data_path", str(tmp_path), "--log_path", str(tmp_path)],
            "eval_anomaly_det": ["--data_path", str(tmp_path), "--ckpt_dir", str(tmp_path)]}[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CLIS[cli](argv)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flag", ["--use_mesh", "--multihost"])
def test_anomaly_clis_refuse_meshes(tmp_path, flag):
    """Both CLIs take the mesh flags now (the name predates that;
    tests/test_torch_port_anomaly_mesh.py runs them on two ranks): in one
    process the flag starts no group and the CLI goes on to read its data
    (here, none: mnist.npz is missing); an explicit coordinator setup that
    cannot be joined raises before anything is read."""
    for main in (train_anomaly_det.main, eval_anomaly_det.main):
        argv = ["--data_path", str(tmp_path), "--ckpt_dir", str(tmp_path)] if main is eval_anomaly_det.main else []
        argv += [flag, "--device", "cpu", "--log_path", str(tmp_path / "logs")]
        with pytest.raises(FileNotFoundError, match="mnist"):
            main(argv)
        assert not torch.distributed.is_initialized()
        with pytest.raises(ValueError, match="process id 5"):
            main(argv + ["--multihost", "--coordinator_address", "127.0.0.1:1", "--num_processes", "2",
                         "--process_id", "5"])
        assert not torch.distributed.is_initialized()
