"""The DAMC training iteration (counterpart of `damc_tpu/train/step.py:69-231`).

One call of the function `make_train_step` returns runs the seven phases of
the JAX step, in order, each under a `torch.profiler.record_function` label
`train/<phase>`:

  1. q_ema_init          z0 ~ Q_ema(. | x): the 100-step sweep, kernel K2 in
                         stream mode;
  2. posterior_langevin  g_l_steps of Langevin on the posterior energy
                         through G and E, by autograd (cuDNN, cuBLAS); the
                         toy's G alone under a N(0, I) prior. With
                         `remat_generator` G's forward runs under
                         `torch.utils.checkpoint` and is recomputed in the
                         backward pass (JAX's `jax.checkpoint`): the same
                         arithmetic, less activation memory;
  3. prior_langevin      e_l_steps over 2B chains [z0, N(0, I)] ("double")
                         or B chains z0 ("single"), kernel K1 in stream mode,
                         or with `use_pallas` off the autograd chain of
                         `langevin_sample`; none for the toy ("none");
  4. q_updates           `q_updates` denoising score-matching updates of Q
                         (both mask branches with `q_loss_both_branches`);
  5. g_update            ||G(z+) - x||^2, summed per sample, mean over B; a
                         monitor only where G is not trained (the toy);
  6. e_update            contrastive divergence E(z+) - E(z-), plus
                         `e_energy_reg` (E+^2 + E-^2) when it is set; none
                         without prior chains;
  7. ema                 Q_ema <- rho Q + (1 - rho) Q_ema every `ema_every`
                         iterations.

Neither kernel is differentiated: the JAX step puts both behind
`stop_gradient`, so every gradient here is autograd through the networks.
Parameters are updated in place. Every random number of an iteration comes
from one `StepDraws`: production draws it from the state's device
generator (`draw_step`), the parity tests build it from the JAX key tree.
The toy's observations x = G(z) + 0.25 N are made before the step, as in
the JAX package (`train/toy.py::make_observations`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import Config
from ..models import ModelBundle, sample_q
from ..ops.langevin import (
    frozen, gaussian_posterior_energy, langevin_sample, posterior_energy, prior_langevin_auto,
)
from ..ops.noise import counter_bits, int32_seed
from .state import Optimizers, TrainState

Metrics = Dict[str, torch.Tensor]

PHASES = (
    "q_ema_init", "posterior_langevin", "prior_langevin", "q_updates", "g_update",
    "e_update", "ema",
)


@dataclass
class QDraws:
    """The draws of one DSM loss evaluation (`DAMCAmortizer.loss`)."""

    prior_noise: torch.Tensor  # (B, nz)
    u: torch.Tensor  # (B,)
    eps: torch.Tensor  # (B, nz)


@dataclass
class StepDraws:
    """Every random number of one iteration (the JAX step's key split,
    `damc_tpu/train/step.py:70-72`)."""

    mask_u: torch.Tensor  # (B,) uniforms; row i is conditional iff >= p_mask
    z0_init: torch.Tensor  # (B, nz) normals: the start of Q_ema's sweep
    neg_init: Optional[torch.Tensor]  # (B, nz) normals: the fresh half of 2B prior chains
    post_noise: torch.Tensor  # (g_l_steps, B, nz) normals of the posterior chain
    q: List[Tuple[QDraws, Optional[QDraws]]]  # per Q update: branch 1, branch 2 or None
    sweep_seed: int  # int32 stream seed of K2
    chain_seed: int  # int32 stream seed of K1 (unused without prior chains)
    # (e_l_steps, chains, nz) normals of the autograd prior chain; only with use_pallas off
    chain_noise: Optional[torch.Tensor] = None


def stream_seeds(seed: int, step: int) -> Tuple[int, int]:
    """(K2 seed, K1 seed) of iteration `step` of a run seeded with `seed`:
    the counter hash of (seed, step), computed on the host so that no
    device value has to be read back."""
    bits = counter_bits(torch.tensor([int(seed) & 0xFFFFFFFF]), int(step), 2)[0]
    return int32_seed(bits[0]), int32_seed(bits[1])


def draw_step(cfg: Config, b: int, state: TrainState) -> StepDraws:
    """One iteration's draws from the state's device generator. The
    autograd prior chain's normals come last, so the draws of the K1 path
    do not depend on `use_pallas`."""
    tc, nz = cfg.train, cfg.model.nz
    gen = state.rng
    dev = gen.device
    normal = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    uniform = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    mask_u = uniform(b)
    z0_init = normal(b, nz)
    neg_init = normal(b, nz) if tc.prior_chains == "double" else None
    post_noise = normal(cfg.mcmc.g_l_steps, b, nz)
    q_draw = lambda: QDraws(normal(b, nz), uniform(b), normal(b, nz))
    q = [(q_draw(), q_draw() if tc.q_loss_both_branches else None) for _ in range(tc.q_updates)]
    sweep_seed, chain_seed = stream_seeds(state.seed, state.step)
    chain_noise = None
    if not tc.use_pallas and tc.prior_chains != "none":
        chains = 2 * b if tc.prior_chains == "double" else b
        chain_noise = normal(cfg.mcmc.e_l_steps, chains, nz)
    return StepDraws(mask_u, z0_init, neg_init, post_noise, q, sweep_seed, chain_seed, chain_noise)


def _phase(name: str):
    return torch.profiler.record_function(f"train/{name}")


def _grads(loss: torch.Tensor, params: Sequence[torch.nn.Parameter]) -> List[torch.Tensor]:
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def make_train_step(
    models: ModelBundle, opts: Optimizers, cfg: Config
) -> Callable[..., Tuple[TrainState, Metrics]]:
    """`train_step(state, x, draws=None) -> (state, metrics)` for this
    workload's config: x (B, H, W, C) in [-1, 1] (the toy: (B, 2)) on the
    models' device, `draws` from `draw_step` when not given. Metrics stay
    on the device; without prior chains there is no `e_pos`, `e_neg` or
    `prior_energy_final`, as in the JAX step."""
    tc, mc, dc = cfg.train, cfg.mcmc, cfg.diffusion
    gen, ebm, amort = models.generator, models.ebm, models.amortizer
    chains = tc.prior_chains != "none" and ebm is not None
    # The JAX step's dtype switches; the port runs float32.
    unported = {
        "compute_dtype": cfg.model.compute_dtype != "float32",
        "pallas_dots_dtype": tc.pallas_dots_dtype != "float32",
    }
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(
            f"{asked}: bfloat16 is not ported (ROADMAP.md, queue 1, item 2b); the port trains "
            "in float32"
        )

    def train_step(state: TrainState, x: torch.Tensor, draws: Optional[StepDraws] = None):
        b = x.shape[0]
        d = draws if draws is not None else draw_step(cfg, b, state)
        if tc.random_mask:
            z_mask = (d.mask_u >= dc.p_mask).to(x.dtype)[:, None]
        else:
            z_mask = torch.ones((b, 1), dtype=x.dtype, device=x.device)

        with _phase("q_ema_init"):
            z0 = sample_q(state.amortizer_ema, x, d.z0_init, d.sweep_seed)

        with _phase("posterior_langevin"), frozen(gen, ebm):
            if tc.remat_generator:
                gen_fn = lambda z: checkpoint(gen, z, use_reentrant=False)
            else:
                gen_fn = gen
            if ebm is not None:
                energy = posterior_energy(gen_fn, ebm, x, mc.g_llhd_sigma)
            else:
                energy = gaussian_posterior_energy(gen_fn, x, mc.g_llhd_sigma)
            zk_pos, post_diag = langevin_sample(
                z0, energy, mc.g_l_steps, mc.g_l_step_size, mc.g_l_with_noise,
                noise=d.post_noise,
            )

        if chains:
            with _phase("prior_langevin"):
                z_neg_init = torch.cat([z0, d.neg_init]) if tc.prior_chains == "double" else z0
                zk_neg, prior_final_energy = prior_langevin_auto(
                    z_neg_init, ebm, mc.e_l_steps, mc.e_l_step_size, mc.e_l_with_noise,
                    seed=d.chain_seed if tc.use_pallas else None, use_pallas=tc.use_pallas,
                    noise=d.chain_noise, generator=state.rng,
                )

        with _phase("q_updates"):
            q_params = opts.q.params
            q_loss = torch.zeros((), device=x.device)
            for qd1, qd2 in d.q:
                loss = amort.loss(
                    zk_pos, x, z_mask, prior_noise=qd1.prior_noise, u=qd1.u, eps=qd1.eps
                ).mean()
                if tc.q_loss_both_branches:
                    loss = loss + amort.loss(
                        zk_pos, x, 1.0 - z_mask, prior_noise=qd2.prior_noise, u=qd2.u, eps=qd2.eps
                    ).mean()
                opts.q.step(_grads(loss, q_params))
                q_loss = loss.detach()

        with _phase("g_update"):
            if tc.update_g:
                g_loss = torch.sum((gen(zk_pos) - x).reshape(b, -1) ** 2, dim=-1).mean()
                opts.g.step(_grads(g_loss, opts.g.params))
            else:  # the reconstruction monitor alone
                with torch.no_grad():
                    g_loss = torch.sum((gen(zk_pos) - x).reshape(b, -1) ** 2, dim=-1).mean()

        if tc.update_e and chains:
            with _phase("e_update"):
                e_p, e_n = ebm(zk_pos), ebm(zk_neg)
                e_pos, e_neg = e_p.mean(), e_n.mean()
                e_loss = e_pos - e_neg
                if tc.e_energy_reg > 0.0:
                    e_loss = e_loss + tc.e_energy_reg * (torch.mean(e_p**2) + torch.mean(e_n**2))
                opts.e.step(_grads(e_loss, opts.e.params))
        else:
            e_pos = e_neg = torch.zeros((), device=x.device)

        with _phase("ema"):
            if (state.step + 1) % tc.ema_every == 0:
                # rho and 1 - rho in float32, as the JAX step forms them.
                rho = np.float32(tc.ema_rho)
                keep = float(np.float32(1.0) - rho)
                with torch.no_grad():
                    for q, e in zip(amort.parameters(), state.amortizer_ema.parameters()):
                        e.copy_(float(rho) * q + keep * e)

        metrics: Metrics = {
            "g_loss": g_loss.detach(),
            "q_loss": q_loss,
            "post_energy_final": post_diag.energy_sum[-1] / b,
            "zk_pos_abs_max": zk_pos.abs().max(),
        }
        if chains:
            metrics.update(
                e_pos=e_pos.detach(), e_neg=e_neg.detach(),
                prior_energy_final=prior_final_energy.mean(),
            )
        state.step += 1
        return state, metrics

    return train_step
