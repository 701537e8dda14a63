"""Generation, reconstruction and scoring pipelines (counterpart of
`damc_tpu/train/sampling.py:26-143`), and the draws of the evals.

Each pipeline takes its random numbers as one `Draws`: the chain or sweep
start z0, the prior-embedding noise and the kernels' int32 stream seeds.
`eval_draws` makes them for the training loop's evals and plots and for
the eval CLI; the parity tests build them from the JAX key tree instead.

Eval draws. The JAX loop splits its key into disjoint streams (init, plot,
FID-damc, FID-ebm, MSE; `damc_tpu/train/gen_recon.py:187-191`) and folds in
the iteration, then the batch. Here every draw of an eval comes from the
run seed through the counter hash of `ops/noise.py`, so an eval is a pure
function of (weights, seed): `counter_bits(seed, c, 4)` at the counter

    c = 2^31 | tag << 28 | iteration << 8 | batch

(a consumer's tag in `EVAL_TAGS`, iteration < 2^20, batch < 2^8) gives K2's
stream seed (column 0), K1's (column 1) and a 64-bit seed of the device
generator that draws z0 and the embedding noise (columns 2 and 3, with the
top bit set). For one run seed and one column the hash is a bijection of
the counter, and the training step's stream seeds (`train/step.py::
stream_seeds`) sit at counters below 2^31 in the same columns, so no two
consumers, evals or training, ever share a kernel seed; the generator seeds
are at least 2^63, apart from every run seed and `data_seed` (< 2^32).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple, Union

import torch

from ..config import Config
from ..data.device_data import DATA_COUNTER
from ..models import ModelBundle, sample_q
from ..ops.langevin import frozen, langevin_sample, posterior_energy, prior_langevin_auto
from ..ops.noise import counter_bits, int32_seed

# The consumers of eval draws: the gen_recon evals and plots, the anomaly
# workload's AUPRC eval and the toy workload's parity eval. Tag 7 at the
# last iteration and batch reaches DATA_COUNTER, the data seed's counter:
# `eval_counter` refuses it.
EVAL_TAGS = {
    "fid_damc": 0, "fid_ebm": 1, "mse": 2, "plot_post": 3, "plot_q": 4, "plot_prior": 5,
    "auprc": 6, "toy": 7,
}
IT_BITS, BATCH_BITS = 20, 8


@dataclass
class Draws:
    """The random numbers of one batch of a pipeline."""

    z0: torch.Tensor  # (B, nz) normals: the start of the sweep or chain
    emb_noise: torch.Tensor  # (B, nz) normals: the DAMC prior's embedding input
    sweep_seed: int  # int32 stream seed of K2
    chain_seed: int  # int32 stream seed of K1


def eval_counter(tag: str, it, batch) -> torch.Tensor:
    """The hash counter of (consumer, iteration, batch); ints or int64
    tensors that broadcast. Raises outside the ranges that keep it
    injective, and at the one counter that is the data seed's."""
    it = torch.as_tensor(it, dtype=torch.int64)
    batch = torch.as_tensor(batch, dtype=torch.int64)
    if bool(((it < 0) | (it >= 1 << IT_BITS)).any()):
        raise ValueError(f"eval draws need an iteration below 2^{IT_BITS}")
    if bool(((batch < 0) | (batch >= 1 << BATCH_BITS)).any()):
        raise ValueError(f"eval draws need fewer than 2^{BATCH_BITS} batches an eval")
    counter = (1 << 31) | (EVAL_TAGS[tag] << (IT_BITS + BATCH_BITS)) | (it << BATCH_BITS) | batch
    if bool((counter == DATA_COUNTER).any()):
        raise ValueError(f"eval draws of {tag!r} at iteration {(1 << IT_BITS) - 1}, batch "
                         f"{(1 << BATCH_BITS) - 1} would share the data seed's counter")
    return counter


def eval_bits(seed: int, tag: str, it, batch) -> torch.Tensor:
    """(N, 4) counter bits (uint32 in int64) of the draws of (tag, it,
    batch) in a run seeded `seed`; N is the broadcast size of it and batch."""
    counter = eval_counter(tag, it, batch).reshape(-1)
    return counter_bits(torch.tensor([int(seed)]), counter, 4)


def generator_seed(bits: torch.Tensor) -> int:
    """64-bit seed, at least 2^63, of the device generator from columns 2
    and 3 of one row of `eval_bits`."""
    return (1 << 63) | (int(bits[2]) << 31) | (int(bits[3]) >> 1)


def eval_draws(
    seed: int, tag: str, it: int, batch: int, b: int, nz: int, device: Union[str, torch.device]
) -> Draws:
    """The draws of batch `batch` of consumer `tag` at iteration `it`:
    z0 then the embedding noise, both (b, nz), from a generator on
    `device`."""
    bits = eval_bits(seed, tag, it, batch)[0]
    gen = torch.Generator(device=device).manual_seed(generator_seed(bits))
    z0 = torch.randn((b, nz), generator=gen, device=device)
    emb_noise = torch.randn((b, nz), generator=gen, device=device)
    return Draws(z0, emb_noise, int32_seed(bits[0]), int32_seed(bits[1]))


@torch.no_grad()
def gen_samples_ebm_prior(models: ModelBundle, cfg: Config, d: Draws) -> torch.Tensor:
    """x = G(z), z after e_l_steps of prior Langevin on the EBM from d.z0
    (kernel K1, stream seed d.chain_seed; with `use_pallas` off the
    autograd chain, its normals from a device generator seeded with
    d.chain_seed). Images in [-1, 1]."""
    mc = cfg.mcmc
    chain = dict(seed=d.chain_seed)
    if not cfg.train.use_pallas:
        gen = torch.Generator(device=d.z0.device).manual_seed(d.chain_seed & 0xFFFFFFFF)
        chain = dict(use_pallas=False, generator=gen)
    z, _ = prior_langevin_auto(
        d.z0, models.ebm, mc.e_l_steps, mc.e_l_step_size, mc.e_l_with_noise, **chain
    )
    return models.generator(z)


@torch.no_grad()
def gen_samples_damc_prior(models: ModelBundle, cfg: Config, d: Draws) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x = G(z), z), z ~ Q(.): one prior reverse sweep of the trained Q
    (not Q_ema) under the embedding of d.emb_noise, kernel K2."""
    z = sample_q(models.amortizer, None, d.z0, d.sweep_seed, emb_noise=d.emb_noise)
    return models.generator(z), z


def reconstruct(
    models: ModelBundle, cfg: Config, x: torch.Tensor, d: Draws, langevin_steps: int = 10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_hat, z): z0 ~ Q(. | x) (kernel K2), then `langevin_steps` of
    noiseless posterior Langevin through G and E by autograd, then
    decode."""
    mc = cfg.mcmc
    gen, ebm = models.generator, models.ebm
    z0 = sample_q(models.amortizer, x, d.z0, d.sweep_seed)
    if ebm is None:
        raise ValueError("reconstruct needs an EBM; the toy workload's posterior is train/toy.py's")
    with frozen(gen, ebm):
        energy = posterior_energy(gen, ebm, x, mc.g_llhd_sigma)
        z, _ = langevin_sample(z0, energy, langevin_steps, mc.g_l_step_size, with_noise=False)
        with torch.no_grad():
            x_hat = gen(z)
    return x_hat, z


def recon_mse_per_image(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-image mean-square error, (B,)."""
    b = x.shape[0]
    return torch.mean((x_hat - x).reshape(b, -1) ** 2, dim=-1)


def anomaly_scores(
    models: ModelBundle, cfg: Config, x: torch.Tensor, d: Draws, langevin_steps: int = 10
) -> torch.Tensor:
    """||x_hat - x||^2 + E(z) + 0.5 ||z||^2 after `reconstruct`, (B,);
    higher is more anomalous."""
    x_hat, z = reconstruct(models, cfg, x, d, langevin_steps)
    b = x.shape[0]
    with torch.no_grad():
        recon = torch.sum((x_hat - x).reshape(b, -1) ** 2, dim=-1)
        return recon + models.ebm(z) + 0.5 * torch.sum(z * z, dim=-1)


def to_unit_range(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> [0, 1] with clamping, the FID input convention."""
    return (1.0 + torch.clamp(x, -1.0, 1.0)) / 2.0
