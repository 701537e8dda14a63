"""Training state, optimizers and learning-rate schedule.

Counterpart of `damc_tpu/train/state.py`. The JAX package keeps one pytree
(params, optax states, EMA params, PRNG key); here the parameters live in
the modules, updated in place, and `TrainState` holds those modules, a copy
of Q for the EMA, the three optimizers and the device generator.

Each optimizer is optax's `chain(clip_by_global_norm(max_norm),
adam | adamw(schedule))` on one network:
  * the clip scales every gradient by max_norm / ||g|| only when the global
    norm ||g|| over all of the network's parameters (never its buffers) is
    >= max_norm, as optax does (`clip_grad_norm_` adds 1e-6 and is not used);
  * Adam is `torch.optim.Adam`, which folds the bias correction into the
    step size where optax divides the moments: equal up to rounding;
  * AdamW is `torch.optim.AdamW`, which scales p by (1 - lr wd) before the
    Adam step where optax adds wd p to the update: equal in exact
    arithmetic;
  * the learning rate is the schedule at the optimizer's update count
    before the update, as optax evaluates it.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

import torch

from ..config import Config
from ..device import resolve_device
from ..models import DAMCAmortizer, ModelBundle, build_models


def lr_schedule(lr0: float, cfg: Config, updates_per_iter: int = 1) -> Callable[[int], float]:
    """max(lr0 decay^(count // (every u)), floor): the reference's x0.99 per
    1000 iterations with a 1e-5 floor, where u is the optimizer's updates
    per iteration (Q takes `q_updates` = 6), so the decay falls on the same
    iteration for every network."""
    o = cfg.optim
    every = o.lr_decay_every * updates_per_iter

    def schedule(count: int) -> float:
        return max(lr0 * o.lr_decay ** (count // every), o.lr_floor)

    return schedule


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax `clip_by_global_norm` in place: g <- g / ||g|| * max_norm for
    every g when the global norm ||g|| >= max_norm. Returns ||g||. Decided
    on the device, without a host sync."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class ClippedAdam:
    """Global-norm clip, then Adam (or AdamW with `weight_decay`) at the
    scheduled learning rate, on a fixed list of parameters."""

    def __init__(
        self,
        params: Sequence[torch.nn.Parameter],
        lr0: float,
        cfg: Config,
        max_norm: float,
        weight_decay: Optional[float] = None,
        updates_per_iter: int = 1,
    ):
        self.params: List[torch.nn.Parameter] = list(params)
        self.max_norm = max_norm
        self.schedule = lr_schedule(lr0, cfg, updates_per_iter)
        betas = tuple(cfg.optim.betas)
        if weight_decay is None:
            self.opt = torch.optim.Adam(self.params, lr=lr0, betas=betas, eps=1e-8)
        else:
            self.opt = torch.optim.AdamW(
                self.params, lr=lr0, betas=betas, eps=1e-8, weight_decay=weight_decay
            )
        self.count = 0  # updates taken: optax's ScaleByAdamState.count

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update from `grads`, one per parameter (clipped in place)."""
        clip_by_global_norm_(grads, self.max_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        for p in self.params:
            p.grad = None
        self.count += 1


@dataclass
class Optimizers:
    g: Optional[ClippedAdam]  # None when G is not trained (the toy)
    e: Optional[ClippedAdam]  # None without an EBM update (the toy)
    q: ClippedAdam


def make_optimizers(models: ModelBundle, cfg: Config) -> Optimizers:
    """Adam(betas) for G and E, AdamW(q_weight_decay) for Q, each after a
    global-norm clip (`damc_tpu/train/state.py:75-99`); G's and E's only
    where the workload updates them, as the JAX state has opt_g and opt_e."""
    o, tc = cfg.optim, cfg.train
    train_e = tc.update_e and models.ebm is not None
    return Optimizers(
        g=ClippedAdam(models.generator.parameters(), o.g_lr, cfg, o.g_max_norm) if tc.update_g else None,
        e=ClippedAdam(models.ebm.parameters(), o.e_lr, cfg, o.e_max_norm) if train_e else None,
        q=ClippedAdam(
            models.amortizer.parameters(), o.q_lr, cfg, o.q_max_norm,
            weight_decay=o.q_weight_decay, updates_per_iter=cfg.train.q_updates,
        ),
    )


@dataclass
class TrainState:
    """Everything a training iteration reads and updates. `step` counts the
    iterations taken; `seed` and `step` also give the kernels' stream seeds
    (`train/step.py::draw_step`); `rng` draws every other random number of a
    step on the device."""

    step: int
    models: ModelBundle
    amortizer_ema: DAMCAmortizer
    opts: Optimizers
    rng: torch.Generator
    seed: int


def create_state(
    cfg: Config, seed: int = 0, device: Optional[Union[str, torch.device]] = None
) -> TrainState:
    """Seeded trainable models on `device` (default CUDA), Q_ema an exact
    copy of Q (`damc_tpu/train/state.py:183`), fresh optimizers and a
    device generator seeded with `seed`. A G that the workload does not
    update (the toy's) stays frozen."""
    dev = resolve_device(device)
    models = build_models(cfg, seed=seed, device=dev, trainable=True)
    models.generator.requires_grad_(cfg.train.update_g)
    ema = copy.deepcopy(models.amortizer).requires_grad_(False)
    return TrainState(
        step=0,
        models=models,
        amortizer_ema=ema,
        opts=make_optimizers(models, cfg),
        rng=torch.Generator(device=dev).manual_seed(int(seed)),
        seed=int(seed),
    )
