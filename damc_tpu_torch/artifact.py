"""Serving artifacts: the serving programs, traced and saved with their weights.

Counterpart of `damc_tpu/artifact.py`. There `jax.export` serializes each
jitted serving program; here each path of `serve.build_serving_fns` is
traced into an ATen graph and saved with `torch.export`:

  1. `make_fx(fn, tracing_mode="real")` runs the path once at the fixed
     batch size and records every ATen op it dispatches, the posterior
     Langevin's backward included (the autograd engine's backward ops are
     recorded as plain ops, so the program needs no autograd), and each
     kernel as one node: K1 and K2 are the custom ops
     `torch.ops.damc.fused_prior_langevin` and `torch.ops.damc.fused_reverse_sweep`
     (`ops/cuda/`). The weights are the trace's constants. The route is the
     one the live service would take (`serve.serving_fused_auto`), or the
     caller's `fused`: an unfused program holds no kernel node, but the
     sweep's loop, the autograd EBM chain's backward and the counter-noise
     hash of its draws, recorded the same way.
  2. `torch.export.export` of that graph module, then `torch.export.save`
     to `<path>_b<B>.pt2`, its constants moved to the CPU so the file
     loads anywhere.

`torch.export.export` alone does not do: without strictness it refuses the
constants, with it the traced backward keeps the example input's saved
activations as constants. A graph traced with `pre_dispatch=True` has the
same fault. Neither AOTInductor nor `torch.compile` is used: either would
compile the ops' plain versions around the kernels.

Layout of an artifact directory:

    meta.json          format, paths, shapes, draws scheme, route, torch version
    damc_b<B>.pt2      (z_init, emb_noise, sweep_seed, chain_seed) -> images
    ebm_b<B>.pt2       the same inputs -> images   [when there is an EBM]
    recon_b<B>.pt2     (the same, x (B, H, W, C)) -> (x_hat, z)

The inputs are the stacked `serve.RowDraws` of `serve.item_draws` (the
"counter-v1" draws), so a loaded program answers item i of a request with
seed s exactly as the live service does. Loading needs only this module and
`damc_tpu_torch.ops` (which registers the two ops): no model code, no
checkpoint. A `.pt2` file is read by the torch release that wrote it;
`load_serving_artifact` names that release when another cannot read it.

One device-dependent op is re-chosen at load: the trace records the batch
norm kernel that the encoder's InstanceNorm reached on the tracing device
(`cudnn_batch_norm` on the card, `native_batch_norm` on the CPU). The loader
turns each such node back into `aten._batch_norm_impl_index`, the op that
makes that choice in eager mode, so a program exported on either device
runs the serving device's own kernel, as the live service does.
"""

from __future__ import annotations

import json
import operator
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from .device import resolve_device
from .ops.cuda import fused_langevin, fused_qsweep  # noqa: F401  (registers torch.ops.damc.*)

FORMAT_VERSION = 1
KIND = "damc_serving_artifact"
DRAWS = "counter-v1"  # serve.item_draws: counter hashes of (seed, item)
PLATFORMS = ("cpu", "cuda")
_META = "meta.json"
_DRAW_INPUTS = 4  # z_init, emb_noise, sweep_seed, chain_seed

_aten = torch.ops.aten
# Batch-norm kernels the tracing device may have chosen: op -> whether it
# carries running statistics in its arguments (`no_stats` does not).
_BATCH_NORMS = {
    _aten.native_batch_norm.default: True,
    _aten.cudnn_batch_norm.default: True,
    _aten._native_batch_norm_legit.default: True,
    _aten._native_batch_norm_legit_no_training.default: True,
    _aten._native_batch_norm_legit.no_stats: False,
}


def _program_file(path: str, batch_size: int) -> str:
    return f"{path}_b{batch_size}.pt2"


def _trace(fn: Callable, example: Tuple[torch.Tensor, ...]) -> torch.export.ExportedProgram:
    """make_fx, then torch.export, of fn at the example's shapes; constants
    on the CPU."""
    import torch.export.passes
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(fn, tracing_mode="real")(*example)
    gm.graph.eliminate_dead_code()  # the chains' diagnostics, which serving drops
    gm.recompile()
    with torch.no_grad():
        ep = torch.export.export(gm, example)
    return torch.export.passes.move_to_device_pass(ep, "cpu")


def _flat(path: str, fn: Callable) -> Callable:
    """The serving function with its RowDraws spread into tensors."""
    from .serve import RowDraws

    if path == "recon":
        return lambda z, e, s, c, x: fn(RowDraws(z, e, s, c), x)
    return lambda z, e, s, c: fn(RowDraws(z, e, s, c))


def export_serving_artifact(
    models,
    cfg,
    out_dir,
    batch_size: int = 16,
    recon_langevin_steps: int = 10,
    platforms: Sequence[str] = PLATFORMS,
    trained_step: int = 0,
    fused: Optional[bool] = None,
) -> Dict[str, Any]:
    """Trace and save the serving programs of `models` (on their device)
    into `out_dir`, one per path at one fixed batch size (the deterministic
    serving bucket). Returns the written meta dict. `platforms` lists the
    device types the artifact may be loaded on. `fused` picks the route as
    `SamplerService(fused=)` does (None: `serving_fused_auto`); the meta
    records it."""
    from .serve import build_serving_fns, item_draws, serving_fused_auto, stack_draws

    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms must be a non-empty subset of {PLATFORMS}, got {list(platforms)}")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    device = models.amortizer.xemb.device
    image_shape = (cfg.model.image_size, cfg.model.image_size, cfg.model.nc)
    draws = tuple(stack_draws([item_draws(0, i, cfg.model.nz) for i in range(batch_size)], device))
    gen = torch.Generator().manual_seed(0)
    x = (torch.rand((batch_size,) + image_shape, generator=gen) * 2.0 - 1.0).to(device)

    fused = serving_fused_auto(models) if fused is None else bool(fused)
    files = {}
    for path, fn in build_serving_fns(models, cfg, recon_langevin_steps, fused).items():
        example = draws + (x,) if path == "recon" else draws
        fname = _program_file(path, batch_size)
        torch.export.save(_trace(_flat(path, fn), example), str(out / fname))
        files[path] = fname

    meta: Dict[str, Any] = {
        "format_version": FORMAT_VERSION,
        "kind": KIND,
        "paths": sorted(files),
        "files": files,
        "batch_size": int(batch_size),
        "image_shape": list(image_shape),
        "nz": int(cfg.model.nz),
        "dataset": cfg.model.dataset,
        "recon_langevin_steps": int(recon_langevin_steps),
        "platforms": list(platforms),
        "torch_version": torch.__version__,
        "trained_step": int(trained_step),
        "draws": DRAWS,
        "fused": fused,
        "compute_dtype": cfg.model.compute_dtype,
    }
    (out / _META).write_text(json.dumps(meta, indent=2))
    return meta


def _portable_batch_norm(gm: torch.fx.GraphModule) -> None:
    """Turn every batch-norm kernel node into `_batch_norm_impl_index`,
    which picks the kernel for the device it runs on (cuDNN's on the card,
    as the live service's eager InstanceNorm does). Its first three outputs
    are the kernels' (out, save_mean, save_invstd); cuDNN's fourth (its
    reserve space) may be taken by a getitem nobody reads, which goes, and
    a node whose other outputs are read (a batch-norm backward) is
    refused."""
    changed = False
    for node in list(gm.graph.nodes):
        stats = _BATCH_NORMS.get(node.target) if node.op == "call_function" else None
        if stats is None:
            continue
        for user in list(node.users):
            if user.target is not operator.getitem:
                raise ValueError(f"serving artifact: unexpected use of batch norm {node.name} by {user.name}")
            if user.args[1] >= 3:
                if user.users:
                    raise ValueError(f"serving artifact: {user.name} reads output {user.args[1]} of {node.name}")
                gm.graph.erase_node(user)
        args = list(node.args)
        if not stats:
            args[3:3] = [None, None]
        if node.target is _aten._native_batch_norm_legit_no_training.default:
            args[5:5] = [False]
        node.target = _aten._batch_norm_impl_index.default
        node.args = tuple(args[:8]) + (torch.backends.cudnn.enabled,)
        node.kwargs = {}
        changed = True
    if changed:
        gm.recompile()


def _runner(path: str, program: torch.nn.Module) -> Callable:
    if path == "recon":
        return torch.no_grad()(lambda d, x: program(*d, x))
    return torch.no_grad()(lambda d: program(*d))


def _read_meta(artifact_dir) -> Dict[str, Any]:
    """The checked meta.json of an artifact directory."""
    d = Path(artifact_dir)
    meta_path = d / _META
    if not meta_path.is_file():
        raise ValueError(f"{d} is not a serving artifact: no {_META}")
    meta = json.loads(meta_path.read_text())
    if meta.get("kind") != KIND:
        raise ValueError(f"{meta_path} is not a damc serving artifact (kind {meta.get('kind')!r})")
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"artifact format_version {meta.get('format_version')} not supported "
            f"(this build reads {FORMAT_VERSION})"
        )
    if meta.get("draws") != DRAWS:
        raise ValueError(
            f"artifact draws scheme {meta.get('draws')!r} unknown: this build feeds {DRAWS!r} "
            "(serve.item_draws)"
        )
    meta.setdefault("fused", True)  # an artifact written before the unfused route holds the kernels
    return meta


def load_serving_artifact(
    artifact_dir, device: Optional[torch.device] = None
) -> Tuple[Dict[str, Callable], Dict[str, Any]]:
    """(fns, meta) of an artifact directory: `fns` maps each path to its
    loaded program on `device` (default CUDA, raising without it), called as the live
    `build_serving_fns` core is (draws, and x for recon). Raises ValueError
    on a missing or foreign meta, an unknown format or draws scheme, a
    device type the artifact was not exported for, or a missing program
    file; RuntimeError, naming both torch releases, when this torch cannot
    read a program."""
    import torch.export.passes

    d = Path(artifact_dir)
    meta = _read_meta(d)
    device = resolve_device(device)
    if device.type not in meta["platforms"]:
        raise ValueError(
            f"artifact was exported for platforms {meta['platforms']}; this device is {device.type!r}"
        )
    fns: Dict[str, Callable] = {}
    for path in meta["paths"]:
        f = d / meta["files"][path]
        if not f.is_file():
            raise ValueError(f"artifact is missing program file {f}")
        try:
            ep = torch.export.load(str(f))
        except Exception as e:
            raise RuntimeError(
                f"cannot load {f}: the artifact was exported by torch {meta.get('torch_version')}, "
                f"this is torch {torch.__version__} ({type(e).__name__}: {e})"
            ) from e
        program = torch.export.passes.move_to_device_pass(ep, device).module()
        _portable_batch_norm(program)
        n_in = _DRAW_INPUTS + (path == "recon")
        if len(ep.graph_signature.user_inputs) != n_in:
            raise ValueError(f"{f}: {len(ep.graph_signature.user_inputs)} inputs, expected {n_in}")
        fns[path] = _runner(path, program)
    return fns, meta
