"""StyleGAN inversion (FFHQ, LSUN-tower): DAMC init, NaN rescue, Adam refine.

Counterpart of `damc_tpu/train/stylegan_inv.py`. The frozen inversion
encoder turns x into a W+ code that conditions Q; Q proposes W+ latents in
one reverse sweep over nz = L*512 (7168 at 256^2) with its 1024-wide
denoiser, which K2 does not take, so the sweep is the torch loop of
`ops/reverse_diffusion.py` (`sweep_route` "tables"); rows whose
reconstruction is NaN take fresh truncated W codes; Adam then refines the
latents under 1.5 pixel MSE + 5e-5 VGG16 feature MSE.

Images are NHWC in [-1, 1], as in the JAX package; the networks run NCHW
inside. Random numbers come in as `InversionDraws` (tensors), or are drawn
from a device generator (`inversion_draws`), so the CPU tests can feed
JAX's own draws. `make_inversion_train_step` trains Q with the refined
inversion as the posterior target; `evaluate_inversion` sweeps a test set
for the recon MSE and the Frechet distance of the reconstructions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..device import resolve_device
from ..models import ModelBundle, sample_q
from ..models.amortizer import DAMCAmortizer
from ..models.common import torch_default_init_
from ..models.stylegan import StyleGANNets, W_DIM, num_synthesis_layers, sample_w_codes
from ..ops.langevin import adam_latent_descent
from ..ops.noise import counter_bits
from .sampling import to_unit_range
from .state import ClippedAdam, Optimizers, TrainState
from .step import QDraws


def make_stylegan_amortizer(
    cfg: Config, resolution: int = 256, seed: int = 0,
    device: Optional[Union[str, torch.device]] = None, trainable: bool = False,
) -> DAMCAmortizer:
    """Q of the inversion workload, nz = nxemb = L*512 (7168 at 256^2), with
    torch-default weights from a CPU generator seeded with `seed`, on
    `device` (default CUDA); frozen unless `trainable`."""
    d = cfg.diffusion
    nz = num_synthesis_layers(resolution) * W_DIM
    dev = resolve_device(device)
    with torch.device("meta"):
        q = DAMCAmortizer(
            nz=nz, nxemb=nz, ntemb=cfg.model.ntemb, dataset="stylegan", n_interval=d.n_interval,
            logsnr_min=d.logsnr_min, logsnr_max=d.logsnr_max, var_type=d.var_type,
            with_noise=d.with_noise, residual=d.residual,
        )
    q.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(int(seed))
    torch_default_init_(q, gen)
    with torch.no_grad():
        q.p.B.normal_(generator=gen)
        q.xemb.zero_()
    return q.to(dev).train(trainable).requires_grad_(trainable)


def create_inversion_state(
    cfg: Config, resolution: int = 256, seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> TrainState:
    """A trainable Q and its optimizer (clip, then AdamW at the preset's Q
    settings, as the JAX package's `make_optimizers(cfg).q`) in a
    `TrainState` without G, E or Q_ema, so `utils/checkpoint.py` saves and
    restores it; the device generator is seeded with `seed`."""
    dev = resolve_device(device)
    q = make_stylegan_amortizer(cfg, resolution, seed, dev, trainable=True)
    o = cfg.optim
    opt = ClippedAdam(q.parameters(), o.q_lr, cfg, o.q_max_norm, weight_decay=o.q_weight_decay,
                      updates_per_iter=cfg.train.q_updates)
    return TrainState(
        step=0, models=ModelBundle(generator=None, ebm=None, amortizer=q), amortizer_ema=None,
        opts=Optimizers(g=None, e=None, q=opt), rng=torch.Generator(device=dev).manual_seed(int(seed)),
        seed=int(seed),
    )


@dataclass
class InversionDraws:
    """The random numbers of one `invert_batch`."""

    z_init: torch.Tensor  # (B, nz) normals: the start of Q's sweep
    sweep_noise: Optional[torch.Tensor]  # (n, B, nz) ancestral normals; None for a noiseless Q
    rescue: torch.Tensor  # (B, 512) normals: the mapping-net inputs of the NaN rescue


def inversion_draws(gen: torch.Generator, b: int, nz: int, n: int, with_noise: bool = True) -> InversionDraws:
    dev = gen.device
    normal = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    z_init = normal(b, nz)
    sweep = normal(n, b, nz) if with_noise else None
    return InversionDraws(z_init, sweep, normal(b, W_DIM))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def inversion_loss_fn(nets: StyleGANNets, x: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-image loss of latents z (B, L*512) against images x (B, H, W, 3):
    1.5 pixel MSE + 5e-5 VGG16 feature MSE, the features of x computed once
    (`damc_tpu/train/stylegan_inv.py:47-92`)."""
    x_c = _nchw(x)
    with torch.no_grad():
        feat_x = nets.vgg(x_c)
    b = x.shape[0]

    def loss(z):
        x_hat = nets.generator(z)
        mse = torch.mean((x_hat - x_c).reshape(b, -1) ** 2, dim=-1)
        f_mse = torch.mean((feat_x - nets.vgg(x_hat)).reshape(b, -1) ** 2, dim=-1)
        return 1.5 * mse + 5e-5 * f_mse

    return loss


@torch.no_grad()
def nan_rescue(nets: StyleGANNets, z: torch.Tensor, x: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Rows of z whose reconstruction MSE against x is NaN take the
    truncated W codes of `normals` (B, 512) (`damc_tpu/train/stylegan_inv.py:
    95-105`)."""
    b = z.shape[0]
    recon = torch.mean((nets.generator(z) - _nchw(x)).reshape(b, -1) ** 2, dim=-1)
    bad = torch.isnan(recon)[:, None]
    return torch.where(bad, sample_w_codes(nets.generator, normals), z)


def _phase(name: str):
    return torch.profiler.record_function(f"inversion/{name}")


def invert_batch(
    q: DAMCAmortizer,
    nets: StyleGANNets,
    x: torch.Tensor,
    draws: InversionDraws,
    steps: int = 100,
    lr: float = 0.01,
    xemb: Optional[torch.Tensor] = None,
):
    """Q(x) -> NaN rescue -> Adam refine, for images x (B, H, W, 3) in
    [-1, 1] (`damc_tpu/train/stylegan_inv.py:108-140`). A caller that holds
    the frozen encoder's code of x passes it as `xemb`. Returns (x_hat
    (B, H, W, 3), z, per-step loss sums)."""
    if xemb is None:
        with _phase("encoder"), torch.no_grad():
            xemb = nets.encoder(_nchw(x))
    with _phase("q_sweep"):
        z0 = sample_q(q, None, draws.z_init, 0, xemb=xemb, noise=draws.sweep_noise)
    with _phase("rescue"):
        z0 = nan_rescue(nets, z0, x, draws.rescue)
    with _phase("refine"):
        z, losses = adam_latent_descent(z0, inversion_loss_fn(nets, x), steps=steps, lr=lr)
    with _phase("decode"), torch.no_grad():
        x_hat = _nhwc(nets.generator(z))
    return x_hat, z, losses


@dataclass
class InversionStepDraws:
    """Every random number of one inversion training iteration."""

    inv: InversionDraws
    mask_u: torch.Tensor  # (B,) uniforms; row i is conditional iff >= p_mask
    q: List[QDraws]  # one per Q update


def make_inversion_train_step(
    q: DAMCAmortizer,
    nets: StyleGANNets,
    q_opt: ClippedAdam,
    refine_steps: int = 100,
    refine_lr: float = 0.01,
    q_updates: int = 6,
    p_mask: float = 0.2,
):
    """`step(x, draws) -> metrics` (`damc_tpu/train/stylegan_inv.py:143-200`):
    the refined inversion of x (B, H, W, 3) is the posterior target, then
    `q_updates` masked DSM updates of Q (rows with mask 0 take the prior
    embedding). `draws` come from `inversion_step_draws` when not given
    (then `gen`, a device generator, is required). Metrics stay on the
    device: q_loss (the last update's), recon_mse, refine_loss_final."""

    def step(x: torch.Tensor, draws: Optional[InversionStepDraws] = None, gen: Optional[torch.Generator] = None):
        b = x.shape[0]
        if draws is None:
            draws = inversion_step_draws(gen, b, q.nz, q.n_interval, q_updates, q.with_noise)
        with torch.no_grad():
            xemb = nets.encoder(_nchw(x))
        x_hat, zk, losses = invert_batch(q, nets, x, draws.inv, refine_steps, refine_lr, xemb=xemb)
        mask = (draws.mask_u >= p_mask).to(x.dtype)[:, None]
        q_loss = torch.zeros((), device=x.device)
        with _phase("q_updates"):
            for qd in draws.q:
                loss = q.loss(zk, None, mask, xemb, prior_noise=qd.prior_noise, u=qd.u, eps=qd.eps).mean()
                grads = torch.autograd.grad(loss, q_opt.params, allow_unused=True)
                q_opt.step([torch.zeros_like(p) if g is None else g for p, g in zip(q_opt.params, grads)])
                q_loss = loss.detach()
        return {
            "q_loss": q_loss,
            "recon_mse": torch.mean((x_hat - x).reshape(b, -1) ** 2),
            "refine_loss_final": losses[-1],
        }

    return step


def inversion_step_draws(gen: torch.Generator, b: int, nz: int, n: int, q_updates: int,
                         with_noise: bool = True) -> InversionStepDraws:
    """One training iteration's draws from the device generator `gen`."""
    dev = gen.device
    inv = inversion_draws(gen, b, nz, n, with_noise)
    mask_u = torch.rand((b,), generator=gen, device=dev)
    normal = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    qd = [QDraws(normal(b, nz), torch.rand((b,), generator=gen, device=dev), normal(b, nz))
          for _ in range(q_updates)]
    return InversionStepDraws(inv, mask_u, qd)


def batch_generator(seed: int, batch: int, device) -> torch.Generator:
    """The device generator of eval batch `batch` of a run seeded `seed`:
    its 64-bit seed is the counter hash of (seed, batch), so an eval is a
    pure function of (weights, images, seed)."""
    bits = counter_bits(torch.tensor([int(seed) & 0xFFFFFFFF]), int(batch), 2)[0]
    return torch.Generator(device=device).manual_seed((int(bits[0]) << 32) | int(bits[1]))


def evaluate_inversion(
    q: DAMCAmortizer,
    nets: StyleGANNets,
    images: np.ndarray,
    batch: int = 8,
    steps: int = 100,
    lr: float = 0.01,
    seed: int = 1,
    feature_fn=None,
    real_mu=None,
    real_sigma=None,
    fid_metric_name: str = "fid",
) -> Dict[str, float]:
    """Recon MSE (the sum of per-image means over N) and, with a feature
    extractor and real statistics, the Frechet distance of the
    reconstructions, over every image of `images` (N, H, W, 3) in [-1, 1]
    (`damc_tpu/train/stylegan_inv.py:203-307`): a tail batch is padded by
    repeating its last image, then sliced back; features stream into
    `RunningStats`."""
    from ..metrics.fid import RunningStats, frechet_distance

    n_total = len(images)
    if n_total == 0:
        raise ValueError("evaluate_inversion: empty image set")
    dev = q.p.B.device
    total_mse, n, stats = 0.0, 0, None
    for bi, i in enumerate(range(0, n_total, batch)):
        xb = torch.from_numpy(np.asarray(images[i : i + batch], np.float32)).to(dev)
        n_real = xb.shape[0]
        if n_real < batch:
            xb = torch.cat([xb, xb[-1:].expand(batch - n_real, -1, -1, -1)])
        draws = inversion_draws(batch_generator(seed, bi, dev), batch, q.nz, q.n_interval, q.with_noise)
        x_hat, _, _ = invert_batch(q, nets, xb, draws, steps, lr)
        x_hat = x_hat[:n_real]
        total_mse += float(torch.sum(torch.mean((x_hat - xb[:n_real]).reshape(n_real, -1) ** 2, dim=-1)))
        n += n_real
        if feature_fn is not None:
            with torch.no_grad():
                feats = feature_fn(to_unit_range(x_hat))
            if stats is None:
                stats = RunningStats(feats.shape[-1], feats.device)
            stats.update(feats)
    out = {"recon_mse": total_mse / n}
    if stats is not None and real_mu is not None:
        mu, sigma = stats.finalize()
        out[fid_metric_name] = frechet_distance(mu, sigma, real_mu, real_sigma)
    return out
