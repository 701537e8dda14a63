"""CLI: serve DAMC over HTTP with dynamic batching, on one GPU.

    python -m damc_tpu_torch.cli.serve --dataset cifar10 \
        --ckpt_dir logs/cifar10/<run>/ckpt --ckpt_name best --port 8787

    curl -s localhost:8787/healthz
    curl -s -X POST localhost:8787/sample -d '{"n": 4, "prior": "damc", "seed": 7}'

As `python -m damc_tpu.cli.serve`: the common flags give the configuration
(a run's width flags included), and `--ckpt_dir`/`--ckpt_name` restore a
training checkpoint of the port's train CLIs (<run>/ckpt/<iteration|best>)
and serve its G, E and Q. `--ckpt` instead takes a reference-format
`.pth.tar` (G/E/Q state dicts), such as `python -m
damc_tpu.cli.export_checkpoint` writes; the two are exclusive. With
neither, the models get random weights from `--seed` (default 0), loudly: a
smoke test of a deployment.
"""

from __future__ import annotations

import argparse

from .common import add_common_flags, config_from_args


def build_service(argv=None):
    """(SamplerService, parsed args) of the command line `argv`: the networks
    of the restored training state with --ckpt_dir, else models seeded
    with --seed (0 by default), loaded from the reference checkpoint --ckpt
    when it is given."""
    from ..convert import load_reference_checkpoint
    from ..models import build_models
    from ..serve import SamplerService
    from ..train.state import create_state
    from ..utils.checkpoint import restore_checkpoint

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(p)
    p.add_argument("--ckpt_dir", default=None, help="a training run's checkpoint directory, <run>/ckpt")
    p.add_argument("--ckpt_name", default="best", help="the checkpoint under --ckpt_dir: an iteration or best")
    p.add_argument("--ckpt", default=None, help="reference-format .pth.tar (exclusive with --ckpt_dir)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--max_batch", type=int, default=16, help="dynamic-batching bucket cap")
    p.add_argument(
        "--window_ms", type=float, default=3.0,
        help="how long the batcher waits for more requests before dispatching",
    )
    p.add_argument(
        "--bucketed", action="store_true",
        help="power-of-two batch buckets instead of the single max_batch bucket: less "
        "padded compute at low load, but a result may then differ in the last bits "
        "with batch composition (deterministic mode is the default)",
    )
    p.add_argument(
        "--recon_langevin_steps", type=int, default=10,
        help="noiseless posterior-Langevin steps on /reconstruct",
    )
    args = p.parse_args(argv)
    if args.ckpt and args.ckpt_dir:
        raise ValueError("--ckpt (a reference .pth.tar) and --ckpt_dir (a training checkpoint) are exclusive")
    cfg = config_from_args(args)
    seed = 0 if args.seed is None else args.seed
    if args.ckpt_dir:
        state = restore_checkpoint(args.ckpt_dir, args.ckpt_name, create_state(cfg, seed, args.device))
        print(f"[damc] serving the step-{state.step} checkpoint {args.ckpt_dir}/{args.ckpt_name}")
        models = state.models
        for module in models.modules():  # frozen in eval mode, as build_models serves them
            module.eval().requires_grad_(False)
    else:
        models = build_models(cfg, seed=seed, device=args.device)
        if args.ckpt:
            step = load_reference_checkpoint(models, args.ckpt)
            print(f"[damc] serving step-{step} checkpoint {args.ckpt}")
        else:
            print(f"[damc] WARNING: no --ckpt_dir or --ckpt, serving RANDOM weights (seed {seed})")
    service = SamplerService(
        models, cfg, max_batch=args.max_batch, window_ms=args.window_ms,
        recon_langevin_steps=args.recon_langevin_steps,
        deterministic=not args.bucketed, device=args.device,
    )
    return service, args


def main(argv=None):
    from ..serve import make_http_server

    service, args = build_service(argv)
    print("[damc] warming up (building kernels)...")
    service.warmup()
    server = make_http_server(service, args.host, args.port)
    host, port = server.server_address[:2]
    print(
        f"[damc] serving {sorted(service.paths)} on http://{host}:{port} "
        f"(max_batch={service.max_batch}, window={args.window_ms}ms, device={service.device})"
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[damc] shutting down")
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
