"""Image generation + reconstruction training driver (counterpart of
`damc_tpu/train/gen_recon.py:44-394`).

Batches (flips on) come from `driver_utils.make_batch_source`: the whole
store on the device (`DeviceDataset`), or the host feed for stores over
the device budget, lazy stores and `data_placement="host"`; each iteration
is one call of `make_train_step`'s function. Around it, as in the JAX
loop:
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
    seed, as the JAX feed restarts its epoch stream. However the loop ends,
    the host feed's threads are stopped.

Every eval draw comes from the run seed (`sampling.eval_draws`), so an
eval is a pure function of the weights and the seed.

`use_mesh` with a started process group of more than one rank
(`parallel.distributed.initialize_distributed`) trains data-parallel, one
rank a process, as the JAX loop does across hosts
(`damc_tpu/train/gen_recon.py:195-394`): each rank its shard of the
training set and B / world rows a step, gradients averaged before every
update (`train/step.py`); the FID batches (rounded down to a multiple of
the world; the batch count to the nearest) generated with their rows split
over the ranks (K4a, K4b) and their statistics all-reduced
(`compute_stats_sharded`); the recon MSE on every rank's replica; logs,
grids and checkpoints from rank 0 alone (`driver_utils`). A world of 1 is
the single-device run.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..metrics.fid import (
    compute_stats, compute_stats_sharded, fid_from_samples, frechet_distance, images_to_unit,
)
from ..models import sample_q
from ..parallel.distributed import global_mesh, world_size
from ..utils.logging import save_image_grid
from ..utils.profiling import StepTimer
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


def make_fid_batch_fn(models, cfg: Config, prior: str, mesh=None) -> Callable[[sampling.Draws], torch.Tensor]:
    """fn(draws) -> one batch of generated images (B, H, W, C) in [0, 1],
    through the DAMC prior (K2) or the EBM prior (K1); with a mesh, this
    rank's rows of the global batch (K4b, K4a)."""
    if prior == "damc":
        return lambda d: sampling.to_unit_range(sampling.gen_samples_damc_prior(models, cfg, d, mesh)[0])
    if prior == "ebm":
        return lambda d: sampling.to_unit_range(sampling.gen_samples_ebm_prior(models, cfg, d, mesh))
    raise ValueError(f"prior must be damc or ebm, got {prior!r}")


def fid_batch_size(tc, mesh=None) -> int:
    """The FID generation batch: `fid_batch_size` (the reference's 500)
    capped by the sample budget; with a mesh, rounded down to a multiple of
    the world (at least the world), as JAX rounds it to its data axis."""
    fid_bs = min(tc.fid_batch_size, max(tc.n_fid_samples, 1))
    if mesh is not None:
        fid_bs = max(fid_bs - fid_bs % mesh.world, mesh.world)
    return fid_bs


def evaluate_fid(
    models, cfg: Config, feature_fn, real_mu, real_sigma, n_samples: int, batch: int,
    prior: str, draws_fn: DrawsFn, grid_path: Optional[str] = None, mesh=None,
) -> float:
    """Frechet distance of round(n_samples / batch) batches (at least one)
    generated through `prior` against the real statistics; batch i takes
    `draws_fn(i, batch)`. With `grid_path`, an 8x8 grid of the first
    batch is saved there. With a mesh, every rank generates its rows of
    each batch and the statistics are all-reduced; the grid is then of
    the first rows this rank holds."""
    one_batch = make_fid_batch_fn(models, cfg, prior, mesh)
    n_batches = max(int(round(n_samples / batch)), 1)

    def batches():
        for i in range(n_batches):
            b = one_batch(draws_fn(i, batch))
            if i == 0 and grid_path:
                save_image_grid(b[:64].float().cpu().numpy() * 2.0 - 1.0, grid_path)
            yield b

    if mesh is not None:
        mu, sigma = compute_stats_sharded(feature_fn, batches(), dim=int(np.shape(real_mu)[0]))
        return frechet_distance(mu, sigma, real_mu, real_sigma)
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
    use_mesh: bool = False,
) -> TrainState:
    """Train from `seed` (default `cfg.train.seed`) for `iterations`
    (default `cfg.train.iterations`) on `train_images` (N, H, W, C) uint8 or
    float32; returns the final state. `fid_images` (uint8, or float in
    [-1, 1]) and `feature_fn` enable the FID evals, `mse_images` (float in
    [-1, 1]) the recon MSE, `log_dir` the metrics file, grids and
    checkpoints; `resume_path` (default `cfg.train.resume_path`) is a
    checkpoint directory or 'auto'. Runs on CUDA unless `device` says
    otherwise. `use_mesh` trains data-parallel over the started process
    group (each rank on its device, `parallel.distributed.rank_device`)
    when it has more than one rank; `log_dir` must then be the same
    directory on every rank."""
    tc, nz = cfg.train, cfg.model.nz
    seed = tc.seed if seed is None else int(seed)
    iterations = tc.iterations if iterations is None else int(iterations)
    resume_path = tc.resume_path if resume_path is None else resume_path
    dev = resolve_device(device)
    mesh = global_mesh(dev) if use_mesh and world_size() > 1 else None
    if mesh is not None:
        dev = mesh.device
    logger, ckpt_dir = init_driver_logging(log_dir, mesh)
    img_dir = os.path.join(log_dir, "imgs") if log_dir and is_primary(mesh) else None

    state = create_state(cfg, seed, dev)
    state, start_iter = restore_for_resume(state, resume_path, ckpt_dir, mesh)
    replicate_state(mesh, state, tc.batch_size)
    step = make_train_step(state.models, state.opts, cfg, mesh=mesh)
    models = state.models

    real_mu = real_sigma = None
    if feature_fn is not None and fid_images is not None:
        real_mu, real_sigma = real_stats(feature_fn, fid_images, dev)

    next_batch, close_data, placement = make_batch_source(train_images, tc, seed, dev, mesh=mesh)
    if is_primary(mesh):
        print(f"[damc] training-batch placement: {placement}", flush=True)

    fid_best = mse_best = float("inf")
    timer = StepTimer()
    cd_monitor = CDGapMonitor(gap_ceiling=cd_gap_ceiling(tc.e_energy_reg))
    if start_iter > 0:
        cd_monitor.seed_from_history(cd_history_path(logger.path, resume_path), start_iter)
    report = MetricsReport(logger, cd_monitor)
    fid_bs = fid_batch_size(tc, mesh)
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
                    grid_path=f"{img_dir}/{it}_fid_{prior}.png" if img_dir else None, mesh=mesh,
                )
            # The best-checkpoint branch below is a save every rank takes
            # part in: gate it on rank 0's score.
            eval_metrics[f"{name}_damc"] = broadcast_metric(eval_metrics[f"{name}_damc"], mesh)
        if mse_images is not None:  # on every rank's replica, as JAX's multi-host loop
            eval_metrics["recon_mse"] = evaluate_mse(models, cfg, mse_images, tc.batch_size, draws("mse", it))
            mse_best = min(mse_best, eval_metrics["recon_mse"])
            eval_metrics["recon_mse_best"] = mse_best
        if eval_metrics.get(f"{name}_damc", float("inf")) < fid_best:
            fid_best = eval_metrics[f"{name}_damc"]
            if ckpt_dir:
                save_state(ckpt_dir, "best", state, mesh)
        if f"{name}_damc" in eval_metrics:
            eval_metrics[f"{name}_best"] = fid_best
        if eval_metrics:
            logger.log(it, eval_metrics, prefix="eval")

    def plot(it: int, x: torch.Tensor) -> None:
        """The four grids of iteration `it` (observations, posterior recon,
        Q_ema alone, DAMC prior samples)."""
        n_show = min(64, x.shape[0])
        xs = x[:n_show]
        one = lambda tag: sampling.eval_draws(seed, tag, it, 0, n_show, nz, dev)
        save_image_grid(xs.cpu().numpy(), f"{img_dir}/{it}_obs.png")
        x_hat, _ = sampling.reconstruct(models, cfg, xs, one("plot_post"), cfg.mcmc.g_l_steps)
        save_image_grid(x_hat.float().cpu().numpy(), f"{img_dir}/{it}_post.png")
        d = one("plot_q")
        with torch.no_grad():
            x_hat_q = models.generator(sample_q(state.amortizer_ema, xs, d.z0, d.sweep_seed))
        save_image_grid(x_hat_q.float().cpu().numpy(), f"{img_dir}/{it}_post_Q.png")
        x_prior, _ = sampling.gen_samples_damc_prior(models, cfg, one("plot_prior"))
        save_image_grid(x_prior.float().cpu().numpy(), f"{img_dir}/{it}_prior.png")

    def iterate(it: int) -> None:
        nonlocal state
        with timer.phase("data"):
            x = next_batch()
        with timer.phase("train_step"):
            state, metrics = step(state, x)
        if on_step is not None:
            on_step(it, state, metrics)
        if tc.print_every > 0 and it % tc.print_every == 0:
            report(it, metrics, timer.report())
        if img_dir and tc.plot_every > 0 and it % tc.plot_every == 0:
            plot(it, x)

    try:
        run_loop(tc, state, start_iter, iterations, ckpt_dir, iterate, run_eval, mesh)
    finally:
        close_data()
    return state
