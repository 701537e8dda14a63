"""CLI: image generation + reconstruction training on one GPU.

    python -m damc_tpu_torch.cli.train_gen_recon --dataset cifar10 --data_path <dir>
    python -m damc_tpu_torch.cli.train_gen_recon ... --resume_path auto   # after preemption
    python -m damc_tpu_torch.cli.train_gen_recon ... --device cpu         # plain versions
    torchrun --nproc_per_node N -m damc_tpu_torch.cli.train_gen_recon ... --use_mesh

The same flags as `python -m damc_tpu.cli.train_gen_recon`, with
`--dist_backend` (`cli/common.py`). The run writes
<log_path>/<dataset>/<timestamp>/ with config.json, metrics.jsonl, imgs/
and ckpt/<iteration> (and ckpt/best, the best DAMC-prior FID); in a
data-parallel run rank 0 picks the directory and writes it alone.
"""

from __future__ import annotations

import argparse

from .common import (
    add_common_flags, config_from_args, init_distributed, load_dataset, make_feature_fn, make_log_dir,
)


def main(argv=None):
    """Train; returns the final `TrainState`."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(p)
    args = p.parse_args(argv)

    from ..device import resolve_device
    from ..parallel.distributed import global_mesh, world_size
    from ..parallel.mesh import broadcast_object
    from ..train.gen_recon import train_gen_recon

    cfg = config_from_args(args)
    device = init_distributed(args, resolve_device(args.device))
    mesh = global_mesh(device) if args.use_mesh and world_size() > 1 else None
    log_dir = broadcast_object(mesh, make_log_dir(cfg) if mesh is None or mesh.rank == 0 else None)
    if mesh is None or mesh.rank == 0:
        print(f"[damc] logging to {log_dir}", flush=True)
    train_images, fid_images, mse_images = load_dataset(cfg)
    feature_fn, metric_name = make_feature_fn(cfg, device)
    return train_gen_recon(
        cfg, train_images, device=device, fid_images=fid_images, mse_images=mse_images,
        feature_fn=feature_fn, log_dir=log_dir, fid_metric_name=metric_name, use_mesh=args.use_mesh,
    )


if __name__ == "__main__":
    from ..parallel.distributed import shutdown_distributed

    try:
        main()
    finally:
        shutdown_distributed()
