"""CLI: serve DAMC over HTTP with dynamic batching, on one GPU or several.

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

Serving artifacts (`damc_tpu_torch.artifact`): `--export_artifact DIR`
traces the serving programs of those same models at batch size
`--max_batch` into DIR and exits; `--artifact DIR` serves from such a
directory instead of building models, importing no model code. The two are
exclusive.

    python -m damc_tpu_torch.cli.serve --dataset cifar10 --ckpt_dir <run>/ckpt \
        --export_artifact art/cifar10
    python -m damc_tpu_torch.cli.serve --artifact art/cifar10 --port 8787

`--use_mesh` serves over every card this process sees when there is more
than one (`parallel.LocalMesh`: a replica a card, each dispatch's rows
split over them; `--max_batch` must divide by the card count) and is a
no-op on one card, as in JAX. Serving is one process: `--multihost` is
refused.
"""

from __future__ import annotations

import argparse

from .common import add_common_flags, config_from_args


def parse_args(argv=None) -> argparse.Namespace:
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
        "--recon_langevin_steps", type=int, default=None,
        help="noiseless posterior-Langevin steps on /reconstruct (default 10)",
    )
    p.add_argument(
        "--artifact", default=None,
        help="serve from a serving-artifact directory instead of building models: traced "
        "programs with the weights baked in; the model, checkpoint and batching flags are "
        "ignored, --recon_langevin_steps and --bucketed too (baked into the programs)",
    )
    p.add_argument(
        "--export_artifact", default=None,
        help="write a serving artifact of the models to this directory and exit "
        "(batch size = --max_batch)",
    )
    p.add_argument(
        "--artifact_platforms", default="cpu,cuda",
        help="comma-separated device types the exported artifact may be loaded on",
    )
    args = p.parse_args(argv)
    if args.multihost:
        raise SystemExit("serving is single-process; --multihost is invalid")
    if args.artifact and args.export_artifact:
        raise SystemExit("--artifact and --export_artifact are exclusive")
    if args.ckpt and args.ckpt_dir:
        raise ValueError("--ckpt (a reference .pth.tar) and --ckpt_dir (a training checkpoint) are exclusive")
    return args


def _recon_steps(args) -> int:
    return 10 if args.recon_langevin_steps is None else args.recon_langevin_steps


def _models(args):
    """(models, cfg, trained step) of the command line: the networks of the
    restored training state with --ckpt_dir, else models seeded with --seed
    (0 by default), loaded from the reference checkpoint --ckpt when it is
    given."""
    from ..convert import load_reference_checkpoint
    from ..models import build_models
    from ..train.state import create_state
    from ..utils.checkpoint import restore_checkpoint

    cfg = config_from_args(args)
    seed = 0 if args.seed is None else args.seed
    step = 0
    if args.ckpt_dir:
        state = restore_checkpoint(args.ckpt_dir, args.ckpt_name, create_state(cfg, seed, args.device))
        step = state.step
        print(f"[damc] serving the step-{step} checkpoint {args.ckpt_dir}/{args.ckpt_name}")
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
    return models, cfg, step


def export_artifact(args) -> dict:
    """Write the serving artifact of the command line's models to
    --export_artifact; returns its meta."""
    from ..artifact import export_serving_artifact

    models, cfg, step = _models(args)
    meta = export_serving_artifact(
        models, cfg, args.export_artifact, batch_size=args.max_batch,
        recon_langevin_steps=_recon_steps(args),
        platforms=tuple(s for s in args.artifact_platforms.split(",") if s), trained_step=step,
    )
    print(
        f"[damc] wrote serving artifact to {args.export_artifact}: paths={meta['paths']}, "
        f"batch={meta['batch_size']}, platforms={meta['platforms']}"
    )
    return meta


def service_from_args(args):
    """The SamplerService of parsed command-line args: over --artifact, or
    over the models of `_models`."""
    from ..serve import SamplerService

    if args.artifact:
        for flag, is_set in (
            ("--recon_langevin_steps", args.recon_langevin_steps is not None),
            ("--bucketed", args.bucketed),
        ):
            if is_set:
                print(f"[damc] WARNING: {flag} is ignored with --artifact (baked into the exported program)")
        service = SamplerService.from_artifact(args.artifact, window_ms=args.window_ms, device=args.device)
        meta = service.artifact_meta
        print(
            f"[damc] serving artifact {args.artifact} (dataset={meta['dataset']}, "
            f"step={meta['trained_step']}, batch={meta['batch_size']}, platforms={meta['platforms']})"
        )
        return service
    models, cfg, _ = _models(args)
    return SamplerService(
        models, cfg, max_batch=args.max_batch, window_ms=args.window_ms,
        recon_langevin_steps=_recon_steps(args),
        deterministic=not args.bucketed, device=args.device, mesh=serving_mesh(args),
    )


def serving_mesh(args):
    """`--use_mesh`: a LocalMesh of every card this process sees, when the
    service runs on CUDA and there is more than one; else None (JAX's
    `len(jax.devices()) > 1`)."""
    import torch

    from ..parallel.mesh import LocalMesh

    if not args.use_mesh or torch.device(args.device).type != "cuda" or torch.cuda.device_count() < 2:
        return None
    mesh = LocalMesh.cards()
    print(f"[damc] data-parallel serving over {mesh.world} devices")
    return mesh


def build_service(argv=None):
    """(SamplerService, parsed args) of the command line `argv`, without the
    HTTP loop."""
    args = parse_args(argv)
    return service_from_args(args), args


def main(argv=None):
    from ..serve import make_http_server

    args = parse_args(argv)
    if args.export_artifact:
        export_artifact(args)
        return
    service = service_from_args(args)
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
