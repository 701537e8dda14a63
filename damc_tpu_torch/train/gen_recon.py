"""Image generation + reconstruction training loop (counterpart of the loop
of `damc_tpu/train/gen_recon.py:326-355`).

Batches come from `DeviceDataset` (the whole store on the device, flips on),
each iteration is one call of `make_train_step`'s function, and every
`print_every` iterations the metrics are read back, checked for non-finite
values (`gen_recon.py:336-347`) and printed. FID and MSE evals, image
grids, checkpoints and resume are not ported yet (ROADMAP.md, queue 1,
item 3): asking for them raises.
"""

from __future__ import annotations

import json
import math
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..data.device_data import DeviceDataset
from ..device import resolve_device
from .state import TrainState, create_state
from .step import Metrics, make_train_step

# Called after every iteration with (iteration, state, metrics on the device).
StepCallback = Callable[[int, TrainState, Metrics], None]


def train_gen_recon(
    cfg: Config,
    train_images: np.ndarray,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    fid_images: Optional[np.ndarray] = None,
    mse_images: Optional[np.ndarray] = None,
    feature_fn: Optional[Callable] = None,
    log_dir: Optional[str] = None,
    resume_path: Optional[str] = None,
    on_step: Optional[StepCallback] = None,
) -> TrainState:
    """Train from `seed` (default `cfg.train.seed`) for `iterations`
    (default `cfg.train.iterations`) on `train_images` (N, H, W, C) uint8 or
    float32; returns the final state. Runs on CUDA unless `device` says
    otherwise."""
    unported = {
        "fid_images": fid_images, "mse_images": mse_images, "feature_fn": feature_fn,
        "log_dir": log_dir, "resume_path": resume_path or cfg.train.resume_path,
    }
    asked = [k for k, v in unported.items() if v is not None]
    if asked:
        raise NotImplementedError(
            f"{asked}: evals, logs and checkpoints are not ported (ROADMAP.md, queue 1, item 3)"
        )
    tc = cfg.train
    seed = tc.seed if seed is None else int(seed)
    iterations = tc.iterations if iterations is None else int(iterations)
    dev = resolve_device(device)
    state = create_state(cfg, seed, dev)
    step = make_train_step(state.models, state.opts, cfg)
    stream = DeviceDataset(
        train_images, batch_size=tc.batch_size, augment_flip=True, seed=seed, device=dev,
    ).stream()
    t_last, it_last = time.perf_counter(), 0
    for it in range(iterations):
        x, _ = next(stream)
        state, metrics = step(state, x)
        if on_step is not None:
            on_step(it, state, metrics)
        if tc.print_every > 0 and it % tc.print_every == 0:
            host = {k: float(v) for k, v in metrics.items()}
            bad = [k for k, v in host.items() if not math.isfinite(v)]
            if bad:
                raise FloatingPointError(
                    f"non-finite training metrics {bad} at iteration {it}; last metrics: {host}"
                )
            now = time.perf_counter()
            if it > it_last:
                host["iters_per_s_wall"] = (it - it_last) / (now - t_last)
            t_last, it_last = now, it
            print("[train] " + json.dumps({"iter": it, **host}), flush=True)
    return state
