"""CLI: the AUPRC of a trained anomaly-detection checkpoint.

    python -m damc_tpu_torch.cli.eval_anomaly_det --label 9 --data_path <dir with mnist.npz> \
        --ckpt_dir <run>/ckpt [--ckpt_name best] [--device cpu]

As `python -m damc_tpu.cli.eval_anomaly_det`: the test split's anomaly
scores after Q and 5 noiseless posterior Langevin steps
(`eval_anomaly_det.py:108-112`), with the per-label g_llhd_sigma of the
reference's README unless --g_llhd_sigma is given. Every draw comes from
`--seed` (`train/sampling.py::eval_draws`, tag `auprc`, iteration 0), so two
runs on one checkpoint print the same number.

With `--use_mesh` (under torchrun) or `--multihost` each batch of 500 is
scored with its rows split over the ranks and the scores gathered
(`train/anomaly.py::evaluate_auprc`): the AUPRC of one process. The JAX CLI
scores per host under `--multihost`; the AUPRC is the same function. Rank
0 prints it.
"""

from __future__ import annotations

import argparse
import dataclasses

from .common import add_common_flags, config_from_args, init_distributed

PER_LABEL_SIGMA = {1: 0.1, 4: 1.0, 5: 1.0, 7: 1.0, 9: 1.0}  # README.md:64-72 of the reference


def main(argv=None):
    """Score the checkpoint; returns its AUPRC."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(p)
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--ckpt_name", type=str, default="best")
    args = p.parse_args(argv)

    from ..data.datasets import load_mnist_anomaly
    from ..device import resolve_device
    from ..parallel.distributed import global_mesh, world_size
    from ..train.anomaly import evaluate_auprc
    from ..train.driver_utils import broadcast_metric, is_primary
    from ..train.gen_recon import make_draws_fn
    from ..train.state import create_state
    from ..utils.checkpoint import restore_checkpoint

    cfg = config_from_args(args, preset_name="mnist_anomaly")
    if args.g_llhd_sigma is None:
        sigma = PER_LABEL_SIGMA.get(cfg.train.heldout_digit, 1.0)
        cfg = dataclasses.replace(cfg, mcmc=dataclasses.replace(cfg.mcmc, g_llhd_sigma=sigma))
    device = init_distributed(args, resolve_device(args.device))
    mesh = global_mesh(device) if args.use_mesh and world_size() > 1 else None

    tc = cfg.train
    test_x, test_y = load_mnist_anomaly(tc.data_path, tc.heldout_digit, "test")
    state = create_state(cfg, 0, device)
    state = restore_checkpoint(args.ckpt_dir, args.ckpt_name, state)
    if is_primary(mesh):
        print(f"[damc] restored step {state.step} from {args.ckpt_dir}/{args.ckpt_name}", flush=True)
    score = evaluate_auprc(
        state.models, cfg, test_x, test_y, make_draws_fn(tc.seed, "auprc", 0, cfg.model.nz, device),
        langevin_steps=5, mesh=mesh,
    )
    score = broadcast_metric(score, mesh)  # rank 0's number everywhere
    if is_primary(mesh):
        print(f"[damc] heldout digit {tc.heldout_digit} AUPRC: {score:.4f}", flush=True)
    return score


if __name__ == "__main__":
    from ..parallel.distributed import shutdown_distributed

    try:
        main()
    finally:
        shutdown_distributed()
