"""Image generation + reconstruction training driver (counterpart of
`damc_tpu/train/gen_recon.py:44-394`).

Batches come from `DeviceDataset` (the whole store on the device, flips
on); each iteration is one call of `make_train_step`'s function. Around
it, as in the JAX loop:
  * every `print_every` iterations the metrics are read back, checked for
    non-finite values, fed to the CD-gap monitor and logged;
  * every `plot_every` iterations four grids go to <log_dir>/imgs: the
    batch (`obs`), its reconstruction (`post`: Q then g_l_steps of
    noiseless Langevin), Q_ema's sample alone decoded (`post_Q`) and DAMC
    prior samples (`prior`);
  * every `ckpt_every` iterations (not at 0) a full-state checkpoint;
  * every `eval_every` iterations the FID through both priors (when a
    feature extractor and real images are given) and the test-set recon
    MSE (when eval images are given), with a `best` checkpoint whenever
    the DAMC-prior FID improves;
  * after the last iteration a checkpoint and an eval, unless the
    intervals just made them;
  * SIGTERM or SIGINT checkpoints at the next iteration boundary and
    returns; `resume_path="auto"` continues from the newest checkpoint of
    <log_dir>/ckpt. A resumed run restarts the data stream from the run
    seed, as the JAX feed restarts its epoch stream.

Every eval draw comes from the run seed (`sampling.eval_draws`), so an
eval is a pure function of the weights and the seed. The host data feed
(`data_placement="host"`) and meshes are not ported (ROADMAP.md, queue 1,
items 4 and 8).
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..data.device_data import DeviceDataset
from ..device import resolve_device
from ..metrics.fid import compute_stats, fid_from_samples, images_to_unit
from ..models import sample_q
from ..utils.checkpoint import save_checkpoint
from ..utils.logging import save_image_grid
from ..utils.preemption import graceful_shutdown
from ..utils.profiling import StepTimer
from . import sampling
from .driver_utils import (
    CDGapMonitor,
    cd_gap_ceiling,
    cd_history_path,
    init_driver_logging,
    preemption_checkpoint,
    restore_for_resume,
)
from .state import TrainState, create_state
from .step import Metrics, make_train_step

# Called after every iteration with (iteration, state, metrics on the device).
StepCallback = Callable[[int, TrainState, Metrics], None]
# (batch index, batch size) -> the draws of that batch of one eval.
DrawsFn = Callable[[int, int], sampling.Draws]

REAL_STATS_CHUNK = 256  # images a feature call when computing the real-image statistics


def make_draws_fn(seed: int, tag: str, it: int, nz: int, device) -> DrawsFn:
    """The eval draws of consumer `tag` at iteration `it` of a run seeded
    `seed`, batch by batch."""
    return lambda i, b: sampling.eval_draws(seed, tag, it, i, b, nz, device)


def make_fid_batch_fn(models, cfg: Config, prior: str) -> Callable[[sampling.Draws], torch.Tensor]:
    """fn(draws) -> one batch of generated images (B, H, W, C) in [0, 1],
    through the DAMC prior (K2) or the EBM prior (K1)."""
    if prior == "damc":
        return lambda d: sampling.to_unit_range(sampling.gen_samples_damc_prior(models, cfg, d)[0])
    if prior == "ebm":
        return lambda d: sampling.to_unit_range(sampling.gen_samples_ebm_prior(models, cfg, d))
    raise ValueError(f"prior must be damc or ebm, got {prior!r}")


def evaluate_fid(
    models, cfg: Config, feature_fn, real_mu, real_sigma, n_samples: int, batch: int,
    prior: str, draws_fn: DrawsFn, grid_path: Optional[str] = None,
) -> float:
    """Frechet distance of round(n_samples / batch) batches (at least one)
    generated through `prior` against the real statistics; batch i takes
    `draws_fn(i, batch)`. With `grid_path`, an 8x8 grid of the first
    batch is saved there."""
    one_batch = make_fid_batch_fn(models, cfg, prior)
    n_batches = max(int(round(n_samples / batch)), 1)

    def batches():
        for i in range(n_batches):
            b = one_batch(draws_fn(i, batch))
            if i == 0 and grid_path:
                save_image_grid(b[:64].cpu().numpy() * 2.0 - 1.0, grid_path)
            yield b

    return fid_from_samples(feature_fn, batches(), real_mu, real_sigma)


def make_recon_fn(models, cfg: Config):
    """fn(x, draws) -> per-image recon MSE (B,) after Q and 10 steps of
    noiseless posterior Langevin (the reference's eval protocol)."""

    def recon(x: torch.Tensor, d: sampling.Draws) -> torch.Tensor:
        x_hat, _ = sampling.reconstruct(models, cfg, x, d, langevin_steps=10)
        return sampling.recon_mse_per_image(x_hat, x)

    return recon


def evaluate_mse(
    models, cfg: Config, eval_images: np.ndarray, batch: int, draws_fn: DrawsFn
) -> float:
    """Test-set recon MSE over the whole eval set, divided by the true
    image count (the reference's drop_last=False protocol). The last batch
    runs at its own size; batch i takes `draws_fn(i, len(x_i))`."""
    recon = make_recon_fn(models, cfg)
    dev = next(models.generator.parameters()).device
    n = len(eval_images)
    if n == 0:
        raise ValueError("evaluate_mse: empty eval set")
    batch = min(batch, n)
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for bi, i in enumerate(range(0, n, batch)):
        x = torch.as_tensor(np.asarray(eval_images[i : i + batch], np.float32)).to(dev)
        total += recon(x, draws_fn(bi, len(x))).double().sum()
    return float(total) / n


def real_stats(feature_fn, fid_images: np.ndarray, device):
    """(mu, sigma) of the real images' features, in chunks of 256."""
    n = len(fid_images)
    chunks = (
        torch.from_numpy(images_to_unit(fid_images[i : i + REAL_STATS_CHUNK])).to(device)
        for i in range(0, n, REAL_STATS_CHUNK)
    )
    return compute_stats(feature_fn, chunks)


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
    fid_metric_name: str = "fid",
) -> TrainState:
    """Train from `seed` (default `cfg.train.seed`) for `iterations`
    (default `cfg.train.iterations`) on `train_images` (N, H, W, C) uint8 or
    float32; returns the final state. `fid_images` (uint8, or float in
    [-1, 1]) and `feature_fn` enable the FID evals, `mse_images` (float in
    [-1, 1]) the recon MSE, `log_dir` the metrics file, grids and
    checkpoints; `resume_path` (default `cfg.train.resume_path`) is a
    checkpoint directory or 'auto'. Runs on CUDA unless `device` says
    otherwise."""
    tc, nz = cfg.train, cfg.model.nz
    if tc.data_placement == "host":
        raise NotImplementedError(
            "data_placement='host' (the host loader) is not ported (ROADMAP.md, queue 1, item 4)"
        )
    seed = tc.seed if seed is None else int(seed)
    iterations = tc.iterations if iterations is None else int(iterations)
    resume_path = tc.resume_path if resume_path is None else resume_path
    dev = resolve_device(device)
    logger, ckpt_dir = init_driver_logging(log_dir)
    img_dir = os.path.join(log_dir, "imgs") if log_dir else None

    state = create_state(cfg, seed, dev)
    state, start_iter = restore_for_resume(state, resume_path, ckpt_dir)
    step = make_train_step(state.models, state.opts, cfg)
    models = state.models

    real_mu = real_sigma = None
    if feature_fn is not None and fid_images is not None:
        real_mu, real_sigma = real_stats(feature_fn, fid_images, dev)

    stream = DeviceDataset(
        train_images, batch_size=tc.batch_size, augment_flip=True, seed=seed, device=dev,
    ).stream()

    fid_best = mse_best = float("inf")
    timer = StepTimer()
    last_print = None
    cd_monitor = CDGapMonitor(gap_ceiling=cd_gap_ceiling(tc.e_energy_reg))
    if start_iter > 0:
        cd_monitor.seed_from_history(cd_history_path(logger.path, resume_path), start_iter)
    # FID batches of 500 (the reference's protocol), capped by the sample
    # budget for small runs.
    fid_bs = min(tc.fid_batch_size, max(tc.n_fid_samples, 1))
    draws = lambda tag, it: make_draws_fn(seed, tag, it, nz, dev)

    def run_eval(it: int) -> None:
        """FID through both priors and recon MSE of the current state, with
        best-FID checkpoint gating."""
        nonlocal fid_best, mse_best
        eval_metrics: Dict[str, float] = {}
        name = fid_metric_name
        if feature_fn is not None and real_mu is not None:
            for prior in ("damc", "ebm"):
                eval_metrics[f"{name}_{prior}"] = evaluate_fid(
                    models, cfg, feature_fn, real_mu, real_sigma, tc.n_fid_samples, fid_bs,
                    prior, draws(f"fid_{prior}", it),
                    grid_path=f"{img_dir}/{it}_fid_{prior}.png" if img_dir else None,
                )
        if mse_images is not None:
            eval_metrics["recon_mse"] = evaluate_mse(models, cfg, mse_images, tc.batch_size, draws("mse", it))
            mse_best = min(mse_best, eval_metrics["recon_mse"])
            eval_metrics["recon_mse_best"] = mse_best
        if eval_metrics.get(f"{name}_damc", float("inf")) < fid_best:
            fid_best = eval_metrics[f"{name}_damc"]
            if ckpt_dir:
                save_checkpoint(ckpt_dir, "best", state)
        if f"{name}_damc" in eval_metrics:
            eval_metrics[f"{name}_best"] = fid_best
        if eval_metrics:
            logger.log(it, eval_metrics, prefix="eval")

    def plot(it: int, x: torch.Tensor) -> None:
        """The four grids of iteration `it` (observations, posterior recon,
        Q_ema alone, DAMC prior samples)."""
        n_show = min(64, tc.batch_size)
        xs = x[:n_show]
        one = lambda tag: sampling.eval_draws(seed, tag, it, 0, n_show, nz, dev)
        save_image_grid(xs.cpu().numpy(), f"{img_dir}/{it}_obs.png")
        x_hat, _ = sampling.reconstruct(models, cfg, xs, one("plot_post"), cfg.mcmc.g_l_steps)
        save_image_grid(x_hat.cpu().numpy(), f"{img_dir}/{it}_post.png")
        d = one("plot_q")
        with torch.no_grad():
            x_hat_q = models.generator(sample_q(state.amortizer_ema, xs, d.z0, d.sweep_seed))
        save_image_grid(x_hat_q.cpu().numpy(), f"{img_dir}/{it}_post_Q.png")
        x_prior, _ = sampling.gen_samples_damc_prior(models, cfg, one("plot_prior"))
        save_image_grid(x_prior.cpu().numpy(), f"{img_dir}/{it}_prior.png")

    preempted = False
    with graceful_shutdown() as shutdown:
        for it in range(start_iter, iterations):
            if shutdown:
                preemption_checkpoint(shutdown, ckpt_dir, it, state)
                preempted = True
                break
            with timer.phase("data"):
                x, _ = next(stream)
            with timer.phase("train_step"):
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
                extra = cd_monitor.update(it, host)
                now = time.perf_counter()
                if last_print is not None and it > last_print[0]:
                    extra["iters_per_s_wall"] = (it - last_print[0]) / (now - last_print[1])
                last_print = (it, now)
                logger.log(it, {**host, **timer.report(), **extra})
            if img_dir and tc.plot_every > 0 and it % tc.plot_every == 0:
                plot(it, x)
            if ckpt_dir and tc.ckpt_every > 0 and it > 0 and it % tc.ckpt_every == 0:
                save_checkpoint(ckpt_dir, str(it), state)
            if tc.eval_every > 0 and it % tc.eval_every == 0:
                run_eval(it)

        if not preempted and iterations > start_iter:
            # The reference's loop is inclusive of the last iteration; this
            # one keeps step == iterations, so the tail is saved and scored
            # here unless the intervals just did it.
            last_it = iterations - 1
            if ckpt_dir and tc.ckpt_every > 0 and not (last_it > 0 and last_it % tc.ckpt_every == 0):
                save_checkpoint(ckpt_dir, str(last_it), state)
            if tc.eval_every > 0 and last_it % tc.eval_every != 0:
                run_eval(last_it)
    return state
