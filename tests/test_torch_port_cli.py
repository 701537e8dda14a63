"""The port's CLIs (`damc_tpu_torch/cli/{common,train_gen_recon,
eval_gen_recon}.py`) on the CPU: flags -> Config against the JAX package's
`config_from_args` for the same argv lists, the run directory's `auto`
adoption, and a train -> eval round trip through both CLIs with
`--device cpu` over a fabricated CIFAR-10 pickle tree (as
`tests/test_cli_integration.py` makes one)."""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from damc_tpu.cli import common as jax_common
from damc_tpu_torch.cli import common, eval_gen_recon, serve, train_gen_recon
from damc_tpu_torch.config import preset
from test_cli_integration import fake_cifar
import torch_port_helpers


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from torch_port_helpers.one_torch_thread()


ARGVS = [
    [],
    ["--dataset", "svhn", "--seed", "3", "--batch_size", "64", "--iterations", "10"],
    ["--nz", "8", "--ngf", "8", "--nif", "8", "--nxemb", "16", "--ntemb", "16", "--n_interval_posterior", "2",
     "--g_l_steps", "2", "--e_l_steps", "2", "--e_l_step_size", "1.6", "--e_l_with_noise", "false"],
    ["--print_iter", "5", "--plot_iter", "6", "--ckpt_iter", "7", "--fid_iter", "8", "--n_fid_samples", "100",
     "--fid_batch_size", "50"],
    ["--eval_iter", "9", "--q_is_grad_clamp", "false", "--e_max_norm", "5", "--g_is_grad_clamp", "true",
     "--Q_with_noise", "no", "--diffusion_residual", "0", "--var_type", "small"],
    ["--dataset", "cifar10-stable", "--resume_path", "auto", "--log_path", "/tmp/x", "--data_path", "/d",
     "--g_lr", "1e-3", "--e_lr", "2e-3", "--q_lr", "3e-3", "--e_energy_reg", "2e-4", "--p_mask", "0.3",
     "--cond_w", "0.5", "--logsnr_min", "-4", "--logsnr_max", "9", "--g_llhd_sigma", "0.3", "--nc", "3",
     "--data_placement", "device", "--data_device_budget_gb", "4", "--label", "2", "--compute_dtype", "float32"],
    ["--n_interval", "5", "--n_interval_prior", "7", "--g_l_step_size", "0.05", "--g_l_with_noise", "f"],
]


def _parse(add_flags, argv):
    p = argparse.ArgumentParser()
    add_flags(p)
    return p.parse_args(argv)


@pytest.mark.parametrize("argv", ARGVS, ids=[str(i) for i in range(len(ARGVS))])
def test_config_from_args_matches_jax(argv):
    want = jax_common.config_from_args(_parse(jax_common.add_common_flags, argv))
    got = common.config_from_args(_parse(common.add_common_flags, argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_port_flags_are_the_jax_flags_plus_device():
    def dests(add):
        p = argparse.ArgumentParser()
        add(p)
        return {a.dest: sorted(a.option_strings) for a in p._actions}

    port, jax_flags = dests(common.add_common_flags), dests(jax_common.add_common_flags)
    assert port.pop("device") == ["--device"]
    # torch has two transports where JAX has one; the choice changes no result.
    assert port.pop("dist_backend") == ["--dist_backend"]
    assert port == jax_flags
    assert _parse(common.add_common_flags, []).device == "cuda"


def test_unported_options_raise(tmp_path):
    # gen_recon's --use_mesh and --multihost are ported: the config is the
    # one without them; --multihost implies --use_mesh, and in one process
    # with no coordinator starts no group; an explicit coordinator setup
    # that cannot be joined raises (JAX's tests/test_distributed.py:107).
    plain = dataclasses.asdict(common.config_from_args(_parse(common.add_common_flags, [])))
    for flag in ("--use_mesh", "--multihost"):
        args = _parse(common.add_common_flags, [flag, "--device", "cpu"])
        assert dataclasses.asdict(common.config_from_args(args)) == plain
        assert common.init_distributed(args, torch.device("cpu")) == torch.device("cpu")
        assert args.use_mesh and not torch.distributed.is_initialized()
    bad = _parse(common.add_common_flags, ["--multihost", "--coordinator_address", "127.0.0.1:1",
                                           "--num_processes", "2", "--process_id", "5"])
    with pytest.raises(ValueError, match="process id 5"):
        common.init_distributed(bad, torch.device("cpu"))
    assert not torch.distributed.is_initialized()
    # celeba64 reads its folders of PNG, JPEG, BMP and WebP files (items 4b
    # and 4c), progressive JPEGs among them; a 12-bit JPEG there, which PIL
    # does not decode either, raises naming the file and the feature.
    for split in ("celeba64_train", "celeba64_test"):
        (tmp_path / split).mkdir()
        Image.new("RGB", (8, 8), (20, 140, 200)).save(tmp_path / split / "000001.jpg", progressive=True)
        Image.new("RGB", (8, 8), (200, 40, 20)).save(tmp_path / split / "000002.webp")
    cfg = preset("celeba64")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, data_path=str(tmp_path)))
    train, ref, test = common.load_dataset(cfg)
    assert train.shape == ref.shape == test.shape == (2, 64, 64, 3)
    rare = tmp_path / "rare"
    (rare / "celeba64_train").mkdir(parents=True)
    buf = io.BytesIO()
    Image.new("RGB", (8, 8)).save(buf, "JPEG")
    (rare / "celeba64_train" / "000001.jpg").write_bytes(
        buf.getvalue().replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c", 1))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, data_path=str(rare)))
    with pytest.raises(NotImplementedError, match=r"000001\.jpg: .*12-bit samples.*neither by the port nor by PIL"):
        common.load_dataset(cfg)
    with pytest.raises(ValueError, match="unknown gen_recon dataset 'mnist'"):
        common.load_dataset(preset("mnist_anomaly"))


def test_celeba64_arithmetic_and_lossless_folders_equal_jax(tmp_path):
    """celeba64's folders of arithmetic-coded (sequential, progressive) and
    lossless JPEGs at CelebA's 178x218: the port's `load_dataset` (train
    split cached as `celeba64_train_64.npy`, the test split decoded) equals
    the JAX package's PIL pipeline on a copy of the same files."""
    from damc_tpu.utils.config import preset as jax_preset
    from damc_tpu_torch.tools.jpeg_writer import write_jpeg, write_lossless_jpeg

    rng = np.random.default_rng(9)
    files = {}
    for split in ("celeba64_train", "celeba64_test"):
        for i in range(3):
            low = rng.integers(0, 256, (14, 12, 3), dtype=np.uint8)
            pix = np.asarray(Image.fromarray(low).resize((178, 218), Image.BILINEAR))
            files[f"{split}/{i:06d}.jpg"] = [
                write_jpeg(pix, [(2, 2), (1, 1), (1, 1)], 75, arithmetic=True, restart=i * 6),
                write_jpeg(pix, [(1, 1)] * 3, 90, arithmetic=True, progressive=True),
                write_lossless_jpeg(pix, predictor=1 + 3 * i, pt=i % 2)][i]
    for side in ("port", "jax"):
        for rel, data in files.items():
            (tmp_path / side / rel).parent.mkdir(parents=True, exist_ok=True)
            (tmp_path / side / rel).write_bytes(data)
    cfg = preset("celeba64")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, data_path=str(tmp_path / "port")))
    jcfg = jax_preset("celeba64")
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, data_path=str(tmp_path / "jax")))
    got, want = common.load_dataset(cfg), jax_common.load_dataset(jcfg)
    assert got[0].shape == (3, 64, 64, 3) and (tmp_path / "port" / "celeba64_train_64.npy").exists()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_make_log_dir_adopts_the_newest_run_with_auto(tmp_path):
    base = tmp_path / "cifar10"
    for d in ("20240101_000000", "20250101_120000", "baseline_sweep1", "20991231_23595"):
        (base / d).mkdir(parents=True)
    (base / "20990101_000000").write_text("a file, not a run")
    auto = preset("cifar10")
    auto = dataclasses.replace(auto, train=dataclasses.replace(auto.train, log_path=str(tmp_path), resume_path="auto"))
    got = common.make_log_dir(auto)
    assert got == str(base / "20250101_120000")
    with open(os.path.join(got, "config.json")) as f:
        assert json.load(f)["train"]["resume_path"] == "auto"
    changed = dataclasses.replace(auto, train=dataclasses.replace(auto.train, iterations=7))
    assert common.make_log_dir(changed) == got
    assert any(n.startswith("config.resume.") for n in os.listdir(got))
    fresh = dataclasses.replace(auto, train=dataclasses.replace(auto.train, resume_path=None))
    new = common.make_log_dir(fresh)
    assert new != got and os.path.basename(new) not in ("20240101_000000", "20250101_120000")
    assert common.make_log_dir(fresh) != new  # a second fresh run in the same second bumps its stamp
    # With no run to adopt, `auto` starts one.
    lone = dataclasses.replace(auto, train=dataclasses.replace(auto.train, log_path=str(tmp_path / "empty")))
    assert os.path.isdir(common.make_log_dir(lone))


TINY = ["--nz", "8", "--ngf", "8", "--nif", "8", "--nxemb", "16", "--ntemb", "16",
        "--n_interval", "2", "--g_l_steps", "2", "--e_l_steps", "2", "--batch_size", "8",
        "--n_fid_samples", "16"]


def test_train_and_eval_cli_round_trip_on_cpu(tmp_path):
    """Train 3 iterations (evals at 0 and 2, grids at 0), then score
    ckpt/best twice through the eval CLI: the same numbers both times."""
    data, logs = str(tmp_path / "data"), str(tmp_path / "logs")
    fake_cifar(data, n_train=40, n_test=13)
    common_args = ["--dataset", "cifar10", "--data_path", data, "--log_path", logs, "--device", "cpu", *TINY]
    state = train_gen_recon.main(common_args + ["--iterations", "3", "--eval_every", "2", "--plot_every", "2"])
    assert state.step == 3
    runs = os.listdir(os.path.join(logs, "cifar10"))
    assert len(runs) == 1
    run = os.path.join(logs, "cifar10", runs[0])
    assert {"config.json", "metrics.jsonl", "ckpt", "imgs"} <= set(os.listdir(run))
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == ["2", "best"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if r["phase"] == "eval"]
    assert [r["step"] for r in evals] == [0, 2] and "frechet_rand_damc" in evals[0]

    ev = common_args + ["--ckpt_dir", os.path.join(run, "ckpt"), "--ckpt_name", "best", "--e_l_steps", "3"]
    a, b = eval_gen_recon.main(ev), eval_gen_recon.main(ev)
    assert a == b and set(a) == {"frechet_rand_damc", "frechet_rand_ebm", "recon_mse"}
    assert all(v == v and v >= 0 for v in a.values())


def test_serve_cli_restores_a_port_checkpoint(tmp_path):
    """Train 2 tiny iterations through the CLI, then build the service from
    ckpt/1 with --ckpt_dir/--ckpt_name: it serves the restored state's
    networks, so /sample (damc and ebm) and /reconstruct equal the serving
    core run in process on that state, bit for bit, at the same padded
    batch (deterministic mode pads to --max_batch). --ckpt with --ckpt_dir,
    and a checkpoint that is not there, raise."""
    from damc_tpu_torch.serve import build_serving_fns, item_draws, stack_draws
    from damc_tpu_torch.train.state import create_state
    from damc_tpu_torch.utils.checkpoint import restore_checkpoint

    data, logs = str(tmp_path / "data"), str(tmp_path / "logs")
    fake_cifar(data, n_train=40, n_test=13)
    common_args = ["--dataset", "cifar10", "--data_path", data, "--log_path", logs, "--device", "cpu", *TINY]
    train_gen_recon.main(common_args + ["--iterations", "2", "--eval_every", "0", "--plot_every", "0"])
    (run,) = os.listdir(os.path.join(logs, "cifar10"))
    ckpt = os.path.join(logs, "cifar10", run, "ckpt")
    serve_args = common_args + ["--ckpt_dir", ckpt, "--ckpt_name", "1", "--max_batch", "4",
                                "--recon_langevin_steps", "2"]
    service, args = serve.build_service(serve_args)
    try:
        cfg = common.config_from_args(args)
        state = restore_checkpoint(ckpt, "1", create_state(cfg, 5, "cpu"))
        assert state.step == 2
        fns = build_serving_fns(state.models, cfg, recon_langevin_steps=2)
        # Items 0 and 1 of seed 3, padded to max_batch with the last, as the service pads.
        draws = stack_draws([item_draws(3, i, cfg.model.nz) for i in (0, 1, 1, 1)], "cpu")
        x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
        with torch.no_grad():
            for prior in ("damc", "ebm"):
                np.testing.assert_array_equal(service.sample(2, prior, seed=3), fns[prior](draws)[:2].numpy())
            x_hat, z = service.reconstruct(x, seed=3)
            want = fns["recon"](draws, torch.from_numpy(x[[0, 1, 1, 1]]))
        np.testing.assert_array_equal(x_hat, want[0][:2].numpy())
        np.testing.assert_array_equal(z, want[1][:2].numpy())
    finally:
        service.close()
    with pytest.raises(ValueError, match="exclusive"):
        serve.build_service(serve_args + ["--ckpt", "ref.pth.tar"])
    with pytest.raises(FileNotFoundError):
        serve.build_service(common_args + ["--ckpt_dir", ckpt, "--ckpt_name", "77"])


@pytest.mark.parametrize("cli", ["train", "eval"])
def test_clis_need_cuda_without_device(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    argv = ["--data_path", str(tmp_path)] + (["--ckpt_dir", str(tmp_path)] if cli == "eval" else [])
    main = train_gen_recon.main if cli == "train" else eval_gen_recon.main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
