"""MNIST anomaly-detection training driver, the AUPRC workload
(counterpart of `damc_tpu/train/anomaly.py`).

The anomaly variant of the step (`preset("mnist_anomaly")`: B prior
chains, a fixed all-ones mask, both Q loss branches) on batches without
flips from `driver_utils.make_batch_source` (the store on the device, or
the host `Loader` with prefetch), in the loop that gen_recon runs
(`driver_utils.run_loop`): metrics every `print_every` iterations with the
CD-gap monitor, checkpoints every `ckpt_every`, the AUPRC eval every
`eval_every` with a `best` checkpoint whenever it improves, a terminal
checkpoint and eval, SIGTERM checkpoints and `resume_path="auto"`.

The eval scores each test image by ||x_hat - x||^2 + E(z) + 0.5 ||z||^2
after Q (kernel K2) and noiseless posterior Langevin through G and E
(`sampling.anomaly_scores`), in batches of 500 with the tail padded by
repeating the last image, as the JAX eval pads it; every draw comes from
the run seed (`sampling.eval_draws`, tag `auprc`).

`use_mesh` with a started process group of more than one rank trains
data-parallel as `train/gen_recon.py` does (JAX's `make_mesh()` under
`use_mesh`, `damc_tpu/train/anomaly.py:113-125`): each rank its shard of
the training set and B / world rows a step; the B prior chains are the
gathered z0 rows, split over the ranks by K4a; gradients averaged before
every update; rank 0 writes the logs and checkpoints. The AUPRC eval then
shards each batch of 500 (rounded up to a multiple of the world) over the
ranks: each rank scores its rows of the global batch's draws (K4b's rows
at the rank's row_base), the scores are gathered and the padding dropped
after the gather, so every rank holds the world-1 scores; the best
checkpoint is gated on rank 0's AUPRC. The JAX package scores per host
under several processes; the AUPRC is the same function either way.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..metrics.prauc import auprc
from ..parallel.distributed import global_mesh, world_size
from ..parallel.mesh import batch_sharding, gather_rows
from . import sampling
from .driver_utils import (
    CDGapMonitor,
    MetricsReport,
    broadcast_metric,
    cd_gap_ceiling,
    cd_history_path,
    init_driver_logging,
    is_primary,
    make_batch_source,
    replicate_state,
    restore_for_resume,
    run_loop,
    save_state,
)
from .gen_recon import DrawsFn, make_draws_fn
from .state import TrainState, create_state
from .step import make_train_step

EVAL_BATCH = 500  # the reference's AUPRC batch (`train_anomaly_det.py:206-248`)


def evaluate_auprc(
    models, cfg: Config, test_images: np.ndarray, test_labels: np.ndarray, draws_fn: DrawsFn,
    batch: int = EVAL_BATCH, langevin_steps: int = 10, mesh=None,
) -> float:
    """AUPRC of the anomaly scores of `test_images` (N, 28, 28, 1) in
    [-1, 1] against `test_labels` (N,), 1 = anomalous. Every batch holds
    `batch` images, the last one padded with copies of its last image (one
    shape for every launch, as the JAX eval keeps one compiled program);
    batch i takes `draws_fn(i, batch)`. With a `mesh` the batch rounds up
    to a multiple of the world and each rank scores its rows of it
    (`damc_tpu/train/anomaly.py:74-89`); every rank returns the AUPRC of
    the gathered scores."""
    dev = next(models.generator.parameters()).device
    n = len(test_images)
    if n == 0 or len(test_labels) != n:
        raise ValueError(f"evaluate_auprc: {n} images and {len(test_labels)} labels")
    if mesh is not None:
        batch = -(-batch // mesh.world) * mesh.world
        rows = batch_sharding(mesh, batch)
    scores = []
    for bi, i in enumerate(range(0, n, batch)):
        x = np.asarray(test_images[i : i + batch], np.float32)
        kept = len(x)
        if kept < batch:
            x = np.concatenate([x, np.repeat(x[-1:], batch - kept, axis=0)], axis=0)
        x, d = torch.from_numpy(x).to(dev), draws_fn(bi, batch)
        if mesh is None:
            s = sampling.anomaly_scores(models, cfg, x, d, langevin_steps)
        else:
            s = sampling.anomaly_scores(models, cfg, x[rows], sampling.shard_draws(mesh, d), langevin_steps,
                                        row_base=rows.start)
            s = gather_rows(mesh, s)  # the padding is dropped from the gathered batch
        scores.append(s[:kept].double().cpu().numpy())
    return auprc(np.concatenate(scores), np.asarray(test_labels))


def train_anomaly(
    cfg: Config,
    train_images: np.ndarray,
    test_images: Optional[np.ndarray] = None,
    test_labels: Optional[np.ndarray] = None,
    iterations: Optional[int] = None,
    seed: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    log_dir: Optional[str] = None,
    resume_path: Optional[str] = None,
    use_mesh: bool = False,
) -> Tuple[TrainState, float]:
    """Train from `seed` (default `cfg.train.seed`) for `iterations`
    (default `cfg.train.iterations`) on `train_images` (N, 28, 28, 1) in
    [-1, 1]; returns (final state, best AUPRC). `test_images` with
    `test_labels` enable the AUPRC eval, `log_dir` the metrics file and
    checkpoints; `resume_path` (default `cfg.train.resume_path`) is a
    checkpoint directory or 'auto'. Runs on CUDA unless `device` says
    otherwise. `use_mesh` trains data-parallel over the started process
    group when it has more than one rank (module docstring); `log_dir`
    must then be the same directory on every rank."""
    if (test_images is None) != (test_labels is None):
        raise ValueError("test_images and test_labels must be supplied together (AUPRC needs both)")
    tc, nz = cfg.train, cfg.model.nz
    seed = tc.seed if seed is None else int(seed)
    iterations = tc.iterations if iterations is None else int(iterations)
    resume_path = tc.resume_path if resume_path is None else resume_path
    dev = resolve_device(device)
    mesh = global_mesh(dev) if use_mesh and world_size() > 1 else None
    if mesh is not None:
        dev = mesh.device
    logger, ckpt_dir = init_driver_logging(log_dir, mesh)

    state = create_state(cfg, seed, dev)
    state, start_iter = restore_for_resume(state, resume_path, ckpt_dir, mesh)
    replicate_state(mesh, state, tc.batch_size)
    step = make_train_step(state.models, state.opts, cfg, mesh=mesh)
    # No flips: the reference's anomaly loader does not augment
    # (`train_anomaly_det.py:49-56`).
    next_batch, close_data, placement = make_batch_source(
        np.asarray(train_images, np.float32), tc, seed, dev, augment_flip=False, mesh=mesh)
    if is_primary(mesh):
        print(f"[damc] training-batch placement: {placement}", flush=True)

    cd_monitor = CDGapMonitor(gap_ceiling=cd_gap_ceiling(tc.e_energy_reg))
    if start_iter > 0:
        cd_monitor.seed_from_history(cd_history_path(logger.path, resume_path), start_iter)
    report = MetricsReport(logger, cd_monitor)
    auc_best = 0.0

    def run_eval(it: int) -> None:
        """The AUPRC of the current state, with best-checkpoint gating."""
        nonlocal auc_best
        score = evaluate_auprc(
            state.models, cfg, test_images, test_labels, make_draws_fn(seed, "auprc", it, nz, dev), mesh=mesh
        )
        # The best-checkpoint branch is a save every rank takes part in:
        # gate it on rank 0's score.
        score = broadcast_metric(score, mesh)
        if score > auc_best:
            auc_best = score
            if ckpt_dir:
                save_state(ckpt_dir, "best", state, mesh)
        logger.log(it, {"auprc": score, "auprc_best": auc_best}, prefix="eval")

    def iterate(it: int) -> None:
        nonlocal state
        state, metrics = step(state, next_batch())
        if tc.print_every > 0 and it % tc.print_every == 0:
            report(it, metrics)

    try:
        run_loop(tc, state, start_iter, iterations, ckpt_dir, iterate,
                 run_eval if test_images is not None else None, mesh)
    finally:
        close_data()
    return state, auc_best
