"""Toy 2-D posterior workload: DAMC against long-run Langevin (counterpart
of `damc_tpu/train/toy.py`).

A frozen random MLP likelihood G (`ToyGenerator`), pinwheel latents z,
observations x = G(z) + 0.25 N(0, I), and Q trained on 50-step posterior
Langevin chains under a N(0, I) prior (the step's toy variant: no EBM, no
prior chains, Q-only updates). The parity eval draws Q samples of fresh
observations (kernel K2 at nz = 2) and `gt_steps` noisy Langevin steps from
N(0, I) through G by autograd, then the reconstruction losses of both and
the MMD^2 between the two sample clouds.

Kept from the reference: every training iteration sees the SAME pinwheel
batch (`sample_pinwheel(bs, seed)`), only the observation noise is fresh.
That noise is a draw of the iteration, taken from the state's device
generator just before the step's own draws. Every draw of the parity eval
comes from the run seed (`sampling.eval_bits`, tag `toy`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..config import Config, preset
from ..data.pinwheel import sample_pinwheel
from ..device import resolve_device
from ..metrics.mmd import mmd2_rbf
from ..models import sample_q
from ..ops.langevin import frozen, gaussian_posterior_energy, langevin_sample
from ..ops.noise import int32_seed
from . import sampling
from .gen_recon import StepCallback
from .state import TrainState, create_state
from .step import make_train_step

OBS_NOISE_STD = 0.25  # `toy_example.py:185`


def make_observations(generator, z: torch.Tensor, noise: torch.Tensor, noise_std: float = OBS_NOISE_STD):
    """x = G(z) + noise_std * noise, `noise` normals of G's output shape."""
    with torch.no_grad():
        return generator(z) + noise_std * noise


def train_toy(
    cfg: Optional[Config] = None,
    iterations: int = 300,
    seed: int = 1,
    device: Optional[Union[str, torch.device]] = None,
    callback: Optional[StepCallback] = None,
) -> TrainState:
    """The toy training loop from `seed`; `callback(it, state, metrics)`
    after every iteration. Runs on CUDA unless `device` says otherwise."""
    cfg = cfg or preset("toy")
    dev = resolve_device(device)
    state = create_state(cfg, seed, dev)
    step = make_train_step(state.models, state.opts, cfg)
    z = torch.from_numpy(sample_pinwheel(cfg.train.batch_size, seed)).to(dev)  # fixed batch
    for it in range(iterations):
        noise = torch.randn(z.shape, generator=state.rng, device=dev)
        x = make_observations(state.models.generator, z, noise)
        state, metrics = step(state, x)
        if callback is not None:
            callback(it, state, metrics)
    return state


@dataclass
class ToyDraws:
    """The random numbers of one batch of the parity eval."""

    obs_noise: torch.Tensor  # (B, 2) normals of the observations
    z0: torch.Tensor  # (B, nz) normals: the start of Q's sweep
    sweep_seed: int  # int32 stream seed of K2
    gt_init: torch.Tensor  # (B, nz) normals: the start of the ground-truth chain
    gt_noise: torch.Tensor  # (gt_steps, B, nz) normals of its steps


ToyDrawsFn = Callable[[int, int], ToyDraws]


def toy_draws_fn(seed: int, it: int, nz: int, gt_steps: int, device) -> ToyDrawsFn:
    """The parity eval's draws at iteration `it` of a run seeded `seed`,
    batch by batch: the counter bits of (seed, 'toy', it, batch) give K2's
    stream seed and the seed of a device generator for the normals."""

    def draws(i: int, b: int) -> ToyDraws:
        bits = sampling.eval_bits(seed, "toy", it, i)[0]
        gen = torch.Generator(device=device).manual_seed(sampling.generator_seed(bits))
        normal = lambda *shape: torch.randn(shape, generator=gen, device=device)
        return ToyDraws(normal(b, 2), normal(b, nz), int32_seed(bits[0]), normal(b, nz), normal(gt_steps, b, nz))

    return draws


def eval_toy_parity(
    state: TrainState,
    cfg: Config,
    draws_fn: ToyDrawsFn,
    seed: int = 1,
    n_batches: int = 10,
    batch: int = 500,
    gt_steps: int = 1000,
) -> Dict[str, object]:
    """The amortized posterior against long-run Langevin
    (`toy_example.py:251-302`): for each of `n_batches` batches of fresh
    pinwheel latents (`sample_pinwheel(batch, seed + 7919 + i)`) and
    observations, Q's samples (K2) and `gt_steps` noisy posterior Langevin
    steps from N(0, I). Returns the per-sample reconstruction losses
    (`g_loss_q`, `g_loss_l`), the MMD^2 between the two clouds (`mmd2`) and
    the clouds themselves (`zq`, `zl`, numpy)."""
    models, mc = state.models, cfg.mcmc
    gen = models.generator
    dev = next(gen.parameters()).device
    zq_all, zl_all = [], []
    loss_q = loss_l = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(n_batches):
        d = draws_fn(i, batch)
        z_data = torch.from_numpy(sample_pinwheel(batch, seed + 7919 + i)).to(dev)
        x = make_observations(gen, z_data, d.obs_noise)
        zq = sample_q(models.amortizer, x, d.z0, d.sweep_seed)
        with frozen(gen):
            energy = gaussian_posterior_energy(gen, x, mc.g_llhd_sigma)
            zl, _ = langevin_sample(d.gt_init, energy, gt_steps, mc.g_l_step_size, with_noise=True,
                                    noise=d.gt_noise)
        with torch.no_grad():
            loss_q = loss_q + torch.sum((gen(zq) - x) ** 2).double()
            loss_l = loss_l + torch.sum((gen(zl) - x) ** 2).double()
        zq_all.append(zq)
        zl_all.append(zl)
    zq, zl = torch.cat(zq_all), torch.cat(zl_all)
    n_total = n_batches * batch
    return {
        "g_loss_q": float(loss_q) / n_total,
        "g_loss_l": float(loss_l) / n_total,
        "mmd2": float(mmd2_rbf(zq, zl)),
        "zq": zq.cpu().numpy(),
        "zl": zl.cpu().numpy(),
    }
