"""CLI: the 2-D toy posterior workload (DAMC against long-run Langevin).

    python -m damc_tpu_torch.cli.toy [--iterations 3000] [--viz_iter 100] [--device cpu]

As `python -m damc_tpu.cli.toy`: trains Q on the pinwheel posterior, logs
the step's metrics every 100 iterations, and every `--viz_iter` iterations
and once at the end compares Q's samples with `--gt_steps` of noisy
Langevin (recon losses and MMD^2, `eval` rows of metrics.jsonl) and writes
the two KDE plots of the clouds to <log_path>/toy/<timestamp>/viz/.
"""

from __future__ import annotations

import argparse
import dataclasses
import os


def main(argv=None):
    """Train and evaluate; returns (final `TrainState`, the last eval's
    results)."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--iterations", type=int, default=3000)
    p.add_argument(
        "--viz_iter", type=int, default=100,
        help="period of the in-training KDE-plot + parity eval "
        "(reference `toy_example.py:251-302`); 0 disables",
    )
    p.add_argument("--viz_batches", type=int, default=10, help="500-sample batches per viz eval (reference uses 10)")
    p.add_argument("--gt_steps", type=int, default=1000)
    p.add_argument("--log_path", type=str, default="logs")
    p.add_argument("--n_interval", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..config import preset
    from ..device import resolve_device
    from ..train.toy import eval_toy_parity, toy_draws_fn, train_toy
    from ..utils.logging import MetricsLogger, save_kde_plot
    from .common import make_log_dir

    device = resolve_device(args.device)
    cfg = preset("toy")
    if args.n_interval is not None:
        cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(cfg.diffusion, n_interval=args.n_interval))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, seed=args.seed, log_path=args.log_path))
    log_dir = make_log_dir(cfg)
    viz_dir = os.path.join(log_dir, "viz")
    logger = MetricsLogger(log_dir)
    print(f"[damc] logging to {log_dir}", flush=True)
    keys = ("g_loss_q", "g_loss_l", "mmd2")

    def viz(it, state, name, data_seed):
        res = eval_toy_parity(
            state, cfg, toy_draws_fn(args.seed, it, cfg.model.nz, args.gt_steps, device),
            seed=data_seed, n_batches=args.viz_batches, gt_steps=args.gt_steps,
        )
        logger.log(it, {k: res[k] for k in keys}, prefix="eval")
        save_kde_plot(res["zq"], f"{viz_dir}/{name}_lang_post_Q.png")
        save_kde_plot(res["zl"], f"{viz_dir}/{name}_lang_post_gt.png")
        print(f"[damc] it {name} viz: g_loss Q {res['g_loss_q']:.6f} | g_loss L {res['g_loss_l']:.6f} | "
              f"mmd2 {res['mmd2']:.6f}", flush=True)
        return res

    def callback(it, state, metrics):
        if it % 100 == 0:
            logger.log(it, metrics)
        if args.viz_iter and it % args.viz_iter == 0:
            # Fresh pinwheel draws per viz, like the reference's
            # `sample_z(bs, seed + it)` (`toy_example.py:262`).
            viz(it, state, str(it), args.seed + it)

    state = train_toy(cfg, iterations=args.iterations, seed=args.seed, device=device, callback=callback)
    return state, viz(args.iterations, state, "final", args.seed)


if __name__ == "__main__":
    main()
