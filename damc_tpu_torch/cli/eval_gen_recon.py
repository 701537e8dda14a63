"""CLI: score a gen_recon checkpoint (FID through both priors, recon MSE).

    python -m damc_tpu_torch.cli.eval_gen_recon --dataset cifar10 --data_path <dir> \
        --ckpt_dir <run>/ckpt [--ckpt_name best] [--device cpu]

As `python -m damc_tpu.cli.eval_gen_recon`: FID via the DAMC prior and via
the EBM prior's Langevin chain with the eval defaults (e_l_steps 100;
e_l_step_size 1.6 for cifar10), and the test-set recon MSE (Q, then 10
noiseless Langevin steps) in batches of `fid_batch_size` (500). Every draw
comes from `--seed` (`train/sampling.py::eval_draws`, iteration 0), so two
runs on one checkpoint print the same numbers.

With `--use_mesh` (under torchrun) or `--multihost` the FID batches are
generated with their rows split over the ranks (the batch rounded down to
a multiple of the world) and their statistics all-reduced; the recon MSE
runs on every rank's replica; rank 0's numbers are printed.
"""

from __future__ import annotations

import argparse
import dataclasses

from .common import add_common_flags, config_from_args, init_distributed, load_dataset, make_feature_fn


def main(argv=None):
    """Score the checkpoint; returns {metric: value}."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(p)
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--ckpt_name", type=str, default="best")
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..parallel.distributed import global_mesh, world_size
    from ..train.driver_utils import broadcast_metric, is_primary
    from ..train.gen_recon import evaluate_fid, evaluate_mse, fid_batch_size, make_draws_fn, real_stats
    from ..train.state import create_state
    from ..utils.checkpoint import restore_checkpoint

    cfg = config_from_args(args)
    if args.e_l_steps is None:  # eval default: 100 prior Langevin steps
        cfg = dataclasses.replace(cfg, mcmc=dataclasses.replace(cfg.mcmc, e_l_steps=100))
    # README eval recipes: e_l_step_size 1.6 for CIFAR-10, 0.4 elsewhere.
    if args.e_l_step_size is None and cfg.model.dataset == "cifar10":
        cfg = dataclasses.replace(cfg, mcmc=dataclasses.replace(cfg.mcmc, e_l_step_size=1.6))
    device = init_distributed(args, resolve_device(args.device))
    mesh = global_mesh(device) if args.use_mesh and world_size() > 1 else None

    _, fid_images, mse_images = load_dataset(cfg)
    feature_fn, metric_name = make_feature_fn(cfg, device)
    state = create_state(cfg, 0, device)
    state = restore_checkpoint(args.ckpt_dir, args.ckpt_name, state)
    if is_primary(mesh):
        print(f"[damc] restored step {state.step} from {args.ckpt_dir}/{args.ckpt_name}", flush=True)

    tc, nz = cfg.train, cfg.model.nz
    real_mu, real_sigma = real_stats(feature_fn, fid_images, device)
    fid_bs = fid_batch_size(tc, mesh)
    draws = lambda tag: make_draws_fn(tc.seed, tag, 0, nz, device)
    out = {
        f"{metric_name}_{prior}": evaluate_fid(
            state.models, cfg, feature_fn, real_mu, real_sigma, tc.n_fid_samples, fid_bs, prior,
            draws(f"fid_{prior}"), mesh=mesh,
        )
        for prior in ("damc", "ebm")
    }
    # The reference's mset loader takes batches of 500 (eval_gen_recon.py:110).
    out["recon_mse"] = evaluate_mse(state.models, cfg, mse_images, tc.fid_batch_size, draws("mse"))
    out = {k: broadcast_metric(v, mesh) for k, v in out.items()}  # rank 0's numbers everywhere
    if not is_primary(mesh):
        return out
    label = "FID" if metric_name == "fid" else metric_name
    print(f"[damc] {label} (DAMC prior): {out[f'{metric_name}_damc']:.3f}")
    print(f"[damc] {label} (EBM prior):  {out[f'{metric_name}_ebm']:.3f}")
    print(f"[damc] recon MSE:        {out['recon_mse']:.5f}", flush=True)
    return out


if __name__ == "__main__":
    from ..parallel.distributed import shutdown_distributed

    try:
        main()
    finally:
        shutdown_distributed()
