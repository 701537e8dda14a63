"""CLI: serve DAMC over HTTP with dynamic batching, on one GPU.

    python -m damc_tpu_torch.cli.serve --dataset cifar10 \
        --ckpt run.pth.tar --port 8787

    curl -s localhost:8787/healthz
    curl -s -X POST localhost:8787/sample -d '{"n": 4, "prior": "damc", "seed": 7}'

`--ckpt` takes a reference-format checkpoint (G/E/Q state dicts), such as
`python -m damc_tpu.cli.export_checkpoint` writes. Without it the models
get random weights from `--seed` (loudly): a smoke test of a deployment.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="cifar10", help="a preset of damc_tpu_torch.config")
    p.add_argument("--ckpt", default=None, help="reference-format .pth.tar")
    p.add_argument("--seed", type=int, default=0, help="weight seed without --ckpt")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
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

    from ..config import preset
    from ..convert import load_reference_checkpoint
    from ..models import build_models
    from ..serve import SamplerService, make_http_server

    cfg = preset(args.dataset)
    models = build_models(cfg, seed=args.seed, device=args.device)
    if args.ckpt:
        step = load_reference_checkpoint(models, args.ckpt)
        print(f"[damc] serving step-{step} checkpoint {args.ckpt}")
    else:
        print(f"[damc] WARNING: no --ckpt, serving RANDOM weights (seed {args.seed})")
    service = SamplerService(
        models, cfg, max_batch=args.max_batch, window_ms=args.window_ms,
        recon_langevin_steps=args.recon_langevin_steps,
        deterministic=not args.bucketed, device=args.device,
    )
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
