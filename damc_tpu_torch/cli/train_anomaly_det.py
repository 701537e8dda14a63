"""CLI: MNIST anomaly-detection training (the AUPRC workload) on one GPU.

    python -m damc_tpu_torch.cli.train_anomaly_det --label 9 --data_path <dir with mnist.npz>
    python -m damc_tpu_torch.cli.train_anomaly_det ... --resume_path auto   # after preemption
    python -m damc_tpu_torch.cli.train_anomaly_det ... --device cpu         # plain versions
    torchrun --nproc_per_node N -m damc_tpu_torch.cli.train_anomaly_det ... --use_mesh

The same flags as `python -m damc_tpu.cli.train_anomaly_det`, with
`--dist_backend` (`cli/common.py`), on the `mnist_anomaly` preset. The run
writes <log_path>/mnist/<timestamp>/ with config.json, metrics.jsonl
(train rows, and eval rows with `auprc`) and ckpt/<iteration> (and
ckpt/best, the best AUPRC); in a data-parallel run rank 0 picks the
directory and writes it alone, and the AUPRC batches are scored with
their rows split over the ranks. The split of mnist.npz is cached beside
it as heldout_<label>_{train,test}.npy.
"""

from __future__ import annotations

import argparse

from .common import add_common_flags, config_from_args, init_distributed, make_log_dir


def main(argv=None):
    """Train; returns (final `TrainState`, best AUPRC)."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(p)
    args = p.parse_args(argv)

    from ..data.datasets import load_mnist_anomaly
    from ..device import resolve_device
    from ..parallel.distributed import global_mesh, world_size
    from ..parallel.mesh import broadcast_object
    from ..train.anomaly import train_anomaly

    cfg = config_from_args(args, preset_name="mnist_anomaly")
    device = init_distributed(args, resolve_device(args.device))
    mesh = global_mesh(device) if args.use_mesh and world_size() > 1 else None
    primary = mesh is None or mesh.rank == 0
    log_dir = broadcast_object(mesh, make_log_dir(cfg) if primary else None)
    if primary:
        print(f"[damc] logging to {log_dir}", flush=True)
    tc = cfg.train
    train_x, _ = load_mnist_anomaly(tc.data_path, tc.heldout_digit, "train")
    test_x, test_y = load_mnist_anomaly(tc.data_path, tc.heldout_digit, "test")
    state, auc_best = train_anomaly(
        cfg, train_x, test_images=test_x, test_labels=test_y, device=device, log_dir=log_dir,
        use_mesh=args.use_mesh,
    )
    if primary:
        print(f"[damc] best AUPRC: {auc_best:.4f}", flush=True)
    return state, auc_best


if __name__ == "__main__":
    from ..parallel.distributed import shutdown_distributed

    try:
        main()
    finally:
        shutdown_distributed()
