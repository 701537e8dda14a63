"""CLI: MNIST anomaly-detection training (the AUPRC workload) on one GPU.

    python -m damc_tpu_torch.cli.train_anomaly_det --label 9 --data_path <dir with mnist.npz>
    python -m damc_tpu_torch.cli.train_anomaly_det ... --resume_path auto   # after preemption
    python -m damc_tpu_torch.cli.train_anomaly_det ... --device cpu         # plain versions

The same flags as `python -m damc_tpu.cli.train_anomaly_det`, on the
`mnist_anomaly` preset. The run writes <log_path>/mnist/<timestamp>/ with
config.json, metrics.jsonl (train rows, and eval rows with `auprc`) and
ckpt/<iteration> (and ckpt/best, the best AUPRC). The split of mnist.npz is
cached beside it as heldout_<label>_{train,test}.npy.
"""

from __future__ import annotations

import argparse

from .common import add_common_flags, config_from_args, refuse_mesh, make_log_dir


def main(argv=None):
    """Train; returns (final `TrainState`, best AUPRC)."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(p)
    args = p.parse_args(argv)

    from ..data.datasets import load_mnist_anomaly
    from ..device import resolve_device
    from ..train.anomaly import train_anomaly

    refuse_mesh(args)
    cfg = config_from_args(args, preset_name="mnist_anomaly")
    device = resolve_device(args.device)
    log_dir = make_log_dir(cfg)
    print(f"[damc] logging to {log_dir}", flush=True)
    tc = cfg.train
    train_x, _ = load_mnist_anomaly(tc.data_path, tc.heldout_digit, "train")
    test_x, test_y = load_mnist_anomaly(tc.data_path, tc.heldout_digit, "test")
    state, auc_best = train_anomaly(
        cfg, train_x, test_images=test_x, test_labels=test_y, device=device, log_dir=log_dir,
    )
    print(f"[damc] best AUPRC: {auc_best:.4f}", flush=True)
    return state, auc_best


if __name__ == "__main__":
    main()
