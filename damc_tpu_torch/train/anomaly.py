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
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..metrics.prauc import auprc
from ..utils.checkpoint import save_checkpoint
from . import sampling
from .driver_utils import (
    CDGapMonitor,
    MetricsReport,
    cd_gap_ceiling,
    cd_history_path,
    init_driver_logging,
    make_batch_source,
    restore_for_resume,
    run_loop,
)
from .gen_recon import DrawsFn, make_draws_fn
from .state import TrainState, create_state
from .step import make_train_step

EVAL_BATCH = 500  # the reference's AUPRC batch (`train_anomaly_det.py:206-248`)


def evaluate_auprc(
    models, cfg: Config, test_images: np.ndarray, test_labels: np.ndarray, draws_fn: DrawsFn,
    batch: int = EVAL_BATCH, langevin_steps: int = 10,
) -> float:
    """AUPRC of the anomaly scores of `test_images` (N, 28, 28, 1) in
    [-1, 1] against `test_labels` (N,), 1 = anomalous. Every batch holds
    `batch` images, the last one padded with copies of its last image (one
    shape for every launch, as the JAX eval keeps one compiled program);
    batch i takes `draws_fn(i, batch)`."""
    dev = next(models.generator.parameters()).device
    n = len(test_images)
    if n == 0 or len(test_labels) != n:
        raise ValueError(f"evaluate_auprc: {n} images and {len(test_labels)} labels")
    scores = []
    for bi, i in enumerate(range(0, n, batch)):
        x = np.asarray(test_images[i : i + batch], np.float32)
        kept = len(x)
        if kept < batch:
            x = np.concatenate([x, np.repeat(x[-1:], batch - kept, axis=0)], axis=0)
        s = sampling.anomaly_scores(models, cfg, torch.from_numpy(x).to(dev), draws_fn(bi, batch), langevin_steps)
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
) -> Tuple[TrainState, float]:
    """Train from `seed` (default `cfg.train.seed`) for `iterations`
    (default `cfg.train.iterations`) on `train_images` (N, 28, 28, 1) in
    [-1, 1]; returns (final state, best AUPRC). `test_images` with
    `test_labels` enable the AUPRC eval, `log_dir` the metrics file and
    checkpoints; `resume_path` (default `cfg.train.resume_path`) is a
    checkpoint directory or 'auto'. Runs on CUDA unless `device` says otherwise."""
    if (test_images is None) != (test_labels is None):
        raise ValueError("test_images and test_labels must be supplied together (AUPRC needs both)")
    tc, nz = cfg.train, cfg.model.nz
    seed = tc.seed if seed is None else int(seed)
    iterations = tc.iterations if iterations is None else int(iterations)
    resume_path = tc.resume_path if resume_path is None else resume_path
    dev = resolve_device(device)
    logger, ckpt_dir = init_driver_logging(log_dir)

    state = create_state(cfg, seed, dev)
    state, start_iter = restore_for_resume(state, resume_path, ckpt_dir)
    step = make_train_step(state.models, state.opts, cfg)
    # No flips: the reference's anomaly loader does not augment
    # (`train_anomaly_det.py:49-56`).
    next_batch, close_data, placement = make_batch_source(
        np.asarray(train_images, np.float32), tc, seed, dev, augment_flip=False)
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
            state.models, cfg, test_images, test_labels, make_draws_fn(seed, "auprc", it, nz, dev)
        )
        if score > auc_best:
            auc_best = score
            if ckpt_dir:
                save_checkpoint(ckpt_dir, "best", state)
        logger.log(it, {"auprc": score, "auprc_best": auc_best}, prefix="eval")

    def iterate(it: int) -> None:
        nonlocal state
        state, metrics = step(state, next_batch())
        if tc.print_every > 0 and it % tc.print_every == 0:
            report(it, metrics)

    try:
        run_loop(tc, state, start_iter, iterations, ckpt_dir, iterate,
                 run_eval if test_images is not None else None)
    finally:
        close_data()
    return state, auc_best
