"""Shared CLI plumbing of the port (counterpart of
`damc_tpu/cli/common.py:57-297, 300-476`): flags -> Config overrides, the
run directory, dataset loading and the FID feature extractor.

The flags are the JAX CLI's, aliases included, plus `--device` (default
`cuda`; `cpu` runs the plain versions of the kernels) and `--dist_backend`
(`nccl` or `gloo`; by default `nccl` on `cuda`, `gloo` on `cpu`), the
transport of a data-parallel run, which torch has two of and JAX one.

`--use_mesh` trains or scores gen_recon and the anomaly workload
data-parallel, one process a rank, the group started from torchrun's
environment; `--multihost` starts it from `--coordinator_address`,
`--num_processes` and `--process_id` (or, without them, from that
environment) and implies `--use_mesh`, as the JAX CLI's
`maybe_init_multihost` does (`init_distributed`). The serve CLI spreads
its dispatches over the cards of its one process under `--use_mesh`
(`parallel.mesh.LocalMesh`) and refuses `--multihost`, as JAX's does;
the checkpoint converter, which has no mesh in JAX either, refuses both
(`refuse_mesh`).
`load_dataset` reads the gen_recon datasets cifar10, svhn, celeba64 and
celebaHQ; mnist is the anomaly workload's (`cli/train_anomaly_det.py`).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime as dt
import json
import math
import os
import os.path as osp
from typing import Optional, Tuple

import numpy as np

from ..config import Config, preset
from ..data.datasets import load_cifar10, load_image_folder, load_image_folder_cached, load_svhn


def str2bool(v: str) -> bool:
    """Strict bool flag parser (the reference's `type=bool` took any
    non-empty string, "False" included, as true)."""
    if isinstance(v, bool):
        return v
    s = v.strip().lower()
    if s in ("true", "t", "yes", "y", "1"):
        return True
    if s in ("false", "f", "no", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dataset", type=str, default="cifar10")
    p.add_argument("--log_path", type=str, default="logs")
    p.add_argument("--data_path", type=str, default="data")
    p.add_argument(
        "--resume_path", type=str, default=None,
        help="checkpoint to resume from, or 'auto' to continue from the "
        "newest checkpoint in the run dir (preemption recovery)",
    )
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--n_fid_samples", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument(
        "--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
        help="transport of a data-parallel run (default nccl on cuda, gloo on cpu); gloo also lets "
        "several ranks share one card, which nccl refuses",
    )
    # architecture
    p.add_argument(
        "--compute_dtype", type=str, default=None, choices=["float32", "bfloat16"],
        help="compute dtype of G and the conv encoder (parameters, the EBM and Q's denoiser "
        "stay float32)",
    )
    p.add_argument("--nz", type=int, default=None)
    p.add_argument("--ngf", type=int, default=None)
    p.add_argument("--nif", type=int, default=None)
    p.add_argument("--nc", type=int, default=None, help="image channels")
    p.add_argument("--nxemb", type=int, default=None)
    p.add_argument("--ntemb", type=int, default=None)
    # diffusion
    p.add_argument(
        "--n_interval", "--n_interval_posterior", dest="n_interval", type=int, default=None,
        help="reverse-diffusion steps (reference --n_interval_posterior)",
    )
    p.add_argument(
        "--n_interval_prior", type=int, default=None,
        help="accepted for reference-CLI parity; the reference parses but never uses it",
    )
    p.add_argument("--logsnr_min", type=float, default=None)
    p.add_argument("--logsnr_max", type=float, default=None)
    p.add_argument(
        "--diffusion_residual", type=str2bool, default=None,
        help="denoiser predicts a residual on z (reference default True)",
    )
    p.add_argument("--var_type", type=str, default=None, choices=["large", "small"])
    p.add_argument(
        "--Q_with_noise", type=str2bool, default=None,
        help="stochastic ancestral steps in Q.sample (reference default True)",
    )
    p.add_argument("--p_mask", type=float, default=None)
    p.add_argument("--cond_w", type=float, default=None)
    # mcmc
    p.add_argument("--g_l_steps", type=int, default=None)
    p.add_argument("--g_l_step_size", type=float, default=None)
    p.add_argument("--g_l_with_noise", type=str2bool, default=None)
    p.add_argument("--g_llhd_sigma", type=float, default=None)
    p.add_argument("--e_l_steps", type=int, default=None)
    p.add_argument("--e_l_step_size", type=float, default=None)
    p.add_argument("--e_l_with_noise", type=str2bool, default=None)
    # optim
    p.add_argument("--g_lr", type=float, default=None)
    p.add_argument("--e_lr", type=float, default=None)
    p.add_argument("--q_lr", type=float, default=None)
    # grad-clip norms (reference: max_norm=100 behind *_is_grad_clamp)
    p.add_argument("--q_max_norm", type=float, default=None)
    p.add_argument("--e_max_norm", type=float, default=None)
    p.add_argument("--g_max_norm", type=float, default=None)
    p.add_argument(
        "--e_energy_reg", type=float, default=None,
        help="EBM energy-magnitude regularizer alpha (default 0 = exact reference CD; "
        "2e-4 stabilizes long horizons, artifacts/CD_DIVERGENCE.md)",
    )
    p.add_argument(
        "--fid_batch_size", type=int, default=None,
        help="FID sample-generation batch (reference MCMC.py:130: 500)",
    )
    p.add_argument(
        "--data_placement", type=str, default=None, choices=["auto", "device", "host"],
        help="training-batch feed: 'device' keeps the whole store on the card; 'host' makes each batch on "
        "the host (C++ engine or NumPy loader, prefetched) and copies it over; 'auto' (default) takes "
        "'device' for an array store within --data_device_budget_gb, 'host' otherwise",
    )
    p.add_argument(
        "--data_device_budget_gb", type=float, default=None,
        help="largest store, in GiB, that 'auto' puts on the card and 'device' accepts (default 8)",
    )
    # grad-clip on/off toggles (reference-CLI compatibility): False maps to
    # max_norm=inf, an exact no-op clip.
    p.add_argument("--q_is_grad_clamp", type=str2bool, default=None,
                   help="False disables Q grad clipping (max_norm=inf)")
    p.add_argument("--e_is_grad_clamp", type=str2bool, default=None,
                   help="False disables E grad clipping (max_norm=inf)")
    p.add_argument("--g_is_grad_clamp", type=str2bool, default=None,
                   help="False disables G grad clipping (max_norm=inf)")
    # intervals, each under the reference's spelling too
    p.add_argument("--print_every", "--print_iter", dest="print_every", type=int, default=None)
    p.add_argument("--plot_every", "--plot_iter", dest="plot_every", type=int, default=None)
    p.add_argument("--ckpt_every", "--ckpt_iter", dest="ckpt_every", type=int, default=None)
    p.add_argument("--eval_every", "--fid_iter", "--eval_iter", dest="eval_every", type=int,
                   default=None, help="fid/auprc eval interval")
    # misc
    p.add_argument("--label", type=int, default=None, help="anomaly held-out digit")
    p.add_argument("--use_mesh", action="store_true",
                   help="data-parallel over the ranks torchrun started, one rank a process")
    p.add_argument("--multihost", action="store_true",
                   help="start the process group from --coordinator_address, --num_processes and "
                   "--process_id (else torchrun's environment); implies --use_mesh")
    p.add_argument("--coordinator_address", default=None, help="host:port of process 0 (with --multihost)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)


def refuse_mesh(args) -> None:
    """Raise for `--use_mesh` and `--multihost` in a CLI that runs in one
    process on one device, as its JAX counterpart does."""
    if getattr(args, "use_mesh", False) or getattr(args, "multihost", False):
        raise NotImplementedError(
            "--use_mesh and --multihost: this CLI runs in one process on one device, as the JAX "
            "package's does (it takes no mesh)"
        )


def init_distributed(args, device):
    """Start the process group of a data-parallel run (JAX's
    `maybe_init_multihost`, before anything else uses the device):
    `--multihost` joins the explicit coordinator when its flags are given
    and implies `--use_mesh`; `--use_mesh` joins the group of torchrun's
    environment, a no-op in a single process. Returns the device of this
    rank (`device` itself outside a group)."""
    from ..parallel.distributed import initialize_distributed, rank_device, world_size

    if args.multihost:
        args.use_mesh = True
        initialize_distributed(args.coordinator_address, args.num_processes, args.process_id,
                               backend=args.dist_backend, device=device)
    elif args.use_mesh:
        initialize_distributed(backend=args.dist_backend, device=device)
    return rank_device(device) if args.use_mesh and world_size() > 1 else device


def config_from_args(args, preset_name: Optional[str] = None) -> Config:
    """The preset of `--dataset` with every flag that was given on top."""
    cfg = preset(preset_name or args.dataset)

    def over(section, **kw):
        nonlocal cfg
        kw = {k: v for k, v in kw.items() if v is not None}
        if kw:
            cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **kw)})

    if args.n_interval_prior is not None and args.n_interval_prior != (
        args.n_interval if args.n_interval is not None else cfg.diffusion.n_interval
    ):
        print(
            "[damc] NOTE: --n_interval_prior is accepted for reference-CLI "
            "parity but has no effect (the reference never uses it either, "
            "train_gen_recon.py:373)."
        )
    over(
        "model", nz=args.nz, ngf=args.ngf, nif=args.nif, nc=args.nc,
        nxemb=args.nxemb, ntemb=args.ntemb, compute_dtype=args.compute_dtype,
    )
    over(
        "diffusion", n_interval=args.n_interval, logsnr_min=args.logsnr_min,
        logsnr_max=args.logsnr_max, residual=args.diffusion_residual, var_type=args.var_type,
        with_noise=args.Q_with_noise, p_mask=args.p_mask, cond_w=args.cond_w,
    )
    over(
        "mcmc", g_l_steps=args.g_l_steps, g_l_step_size=args.g_l_step_size,
        g_l_with_noise=args.g_l_with_noise, g_llhd_sigma=args.g_llhd_sigma,
        e_l_steps=args.e_l_steps, e_l_step_size=args.e_l_step_size,
        e_l_with_noise=args.e_l_with_noise,
    )
    over(
        "optim", g_lr=args.g_lr, e_lr=args.e_lr, q_lr=args.q_lr,
        q_max_norm=args.q_max_norm, e_max_norm=args.e_max_norm, g_max_norm=args.g_max_norm,
    )
    # --x_is_grad_clamp false == no clipping, whatever max_norm says.
    over("optim", **{
        norm_field: float("inf")
        for norm_field, toggle in (
            ("q_max_norm", args.q_is_grad_clamp),
            ("e_max_norm", args.e_is_grad_clamp),
            ("g_max_norm", args.g_is_grad_clamp),
        )
        if toggle is False
    })
    over(
        "train", seed=args.seed, batch_size=args.batch_size, iterations=args.iterations,
        n_fid_samples=args.n_fid_samples, fid_batch_size=args.fid_batch_size,
        log_path=args.log_path, data_path=args.data_path, resume_path=args.resume_path,
        heldout_digit=args.label, print_every=args.print_every, plot_every=args.plot_every,
        ckpt_every=args.ckpt_every, eval_every=args.eval_every, e_energy_reg=args.e_energy_reg,
        data_placement=args.data_placement, data_device_budget_gb=args.data_device_budget_gb,
    )
    return cfg


def _is_run_name(d: str) -> bool:
    """A run directory's name: a timestamp YYYYmmdd_HHMMSS, exactly."""
    return len(d) == 15 and d[8] == "_" and (d[:8] + d[9:]).isdigit()


def _json_safe(obj):
    """Non-finite floats as strings, so config.json stays strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def make_log_dir(cfg: Config) -> str:
    """<log_path>/<dataset>/<timestamp>, with the full config in
    config.json. With `resume_path='auto'` the newest existing run dir is
    adopted instead, since preemption recovery reruns the same command and
    must land where the interrupted run's checkpoints and metrics are; a
    relaunch with other settings records them in config.resume.<time>.json.
    A fresh run claims its directory by creating it, bumping the stamp a
    second at a time on a collision (an `auto` run adopts the winner)."""
    base = osp.join(cfg.train.log_path, cfg.model.dataset)
    now = dt.datetime.now()
    stamp = now.strftime("%Y%m%d_%H%M%S")
    adopted = False
    if cfg.train.resume_path == "auto" and osp.isdir(base):
        runs = sorted(d for d in os.listdir(base) if _is_run_name(d) and osp.isdir(osp.join(base, d)))
        if runs:
            stamp = runs[-1]
            adopted = True
    if not adopted:
        while True:
            try:
                os.makedirs(osp.join(base, stamp), exist_ok=False)
                break
            except FileExistsError:
                if cfg.train.resume_path == "auto":
                    break
                now += dt.timedelta(seconds=1)
                stamp = now.strftime("%Y%m%d_%H%M%S")
    log_dir = osp.join(base, stamp)
    os.makedirs(log_dir, exist_ok=True)
    serialized = json.dumps(_json_safe(dataclasses.asdict(cfg)), indent=2, default=str)
    main_cfg = osp.join(log_dir, "config.json")
    if not osp.exists(main_cfg):
        with open(main_cfg, "w") as f:
            f.write(serialized)
    else:
        with open(main_cfg) as f:
            same = f.read() == serialized
        if not same:
            resumed = osp.join(log_dir, f"config.resume.{dt.datetime.now().strftime('%Y%m%d_%H%M%S')}.json")
            with open(resumed, "w") as f:
                f.write(serialized)
    return log_dir


def to_pm1(u8: np.ndarray) -> np.ndarray:
    return u8.astype(np.float32) / 255.0 * 2.0 - 1.0


def load_dataset(cfg: Config) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(train_images uint8, FID reference images uint8, recon-MSE eval
    images in [-1, 1]): FID statistics from the train split, MSE from the
    test split (`train_gen_recon.py:58-111`). The image folders' train
    splits come through the `.npy` cache, memory-mapped
    (`damc_tpu/cli/common.py:433-440`)."""
    d, root = cfg.model.dataset, cfg.train.data_path
    if d == "cifar10":
        tr = load_cifar10(root, "train")
        return tr, tr, to_pm1(load_cifar10(root, "test"))
    if d == "svhn":
        tr = load_svhn(root, "train")
        return tr, tr, to_pm1(load_svhn(root, "test"))
    if d == "celeba64":
        tr = load_image_folder_cached(osp.join(root, "celeba64_train"), 64)
        return tr, tr, to_pm1(load_image_folder(osp.join(root, "celeba64_test"), 64))
    if d == "celebaHQ":
        tr = load_image_folder_cached(osp.join(root, "train"), 256)
        return tr, tr, to_pm1(load_image_folder(osp.join(root, "test"), 256))
    raise ValueError(
        f"unknown gen_recon dataset {d!r} (mnist is the anomaly workload: "
        "python -m damc_tpu_torch.cli.train_anomaly_det)"
    )


def make_feature_fn(cfg: Config, device=None):
    """(feature_fn, metric_name): pool3 Inception and 'fid' when the
    pytorch-fid weights are on disk ($DAMC_INCEPTION_WEIGHTS or the default
    paths), else the random-feature extractor and 'frechet_rand', whose
    numbers are not comparable to published FID."""
    from ..metrics.fid import make_random_feature_fn
    from ..models.inception import try_load_inception_feature_fn

    fn = try_load_inception_feature_fn(device=device)
    if fn is not None:
        return fn, "fid"
    print(
        "[damc] WARNING: InceptionV3 weights unavailable — using the "
        "random-feature Frechet metric, reported as 'frechet_rand' "
        "(NOT comparable to published FID)."
    )
    m = cfg.model
    return make_random_feature_fn((m.image_size, m.image_size, m.nc), device=device), "frechet_rand"
