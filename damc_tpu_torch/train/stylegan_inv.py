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
for the recon MSE and the Frechet distance of the reconstructions, on one
device or data-parallel over the ranks of a process group (`mesh`).

`compute_dtype` (torch.float32 or torch.bfloat16) runs the Adam
refine's synthesis and VGG16 forwards and their input-backwards in that
dtype: the two networks' parameters and buffers are cast for the call
(`models/common.py::cast_float_leaves`) and x and z are cast as they
enter, while z, the loss reductions (each cast to float32 first) and Adam
stay float32. The Q sweep, the NaN rescue and the returned x_hat stay
float32 (`damc_tpu/train/stylegan_inv.py:48-145`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch.func import functional_call

from ..config import Config
from ..device import resolve_device
from ..models import ModelBundle, sample_q
from ..models.amortizer import DAMCAmortizer
from ..models.common import cast_float_leaves, torch_default_init_
from ..models.stylegan import StyleGANNets, W_DIM, num_synthesis_layers, sample_w_codes
from ..ops.langevin import adam_latent_descent
from ..ops.noise import counter_bits
from ..parallel.mesh import all_max, batch_sharding
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


def shard_inversion_draws(d: InversionDraws, rows: slice) -> InversionDraws:
    """A rank's rows of the global batch's draws."""
    return InversionDraws(d.z_init[rows], None if d.sweep_noise is None else d.sweep_noise[:, rows], d.rescue[rows])


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


def _in_dtype(module: torch.nn.Module, dtype: torch.dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """module's forward with its floating parameters and buffers and its
    input in `dtype`; the (float32) module itself when dtype is float32."""
    if dtype == torch.float32:
        return module
    leaves = cast_float_leaves(module, dtype)
    return lambda t: functional_call(module, leaves, (t.to(dtype),))


def inversion_loss_fn(
    nets: StyleGANNets, x: torch.Tensor, compute_dtype: torch.dtype = torch.float32
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Per-image loss of latents z (B, L*512) against images x (B, H, W, 3):
    1.5 pixel MSE + 5e-5 VGG16 feature MSE, the features of x computed once
    (`damc_tpu/train/stylegan_inv.py:48-92`). The synthesis and VGG16 run in
    `compute_dtype`; their outputs are cast to float32
    before the reductions."""
    gen, vgg = _in_dtype(nets.generator, compute_dtype), _in_dtype(nets.vgg, compute_dtype)
    x_c = _nchw(x)
    with torch.no_grad():
        feat_x = vgg(x_c).float()
    b = x.shape[0]

    def loss(z):
        x_hat = gen(z).float()
        mse = torch.mean((x_hat - x_c).reshape(b, -1) ** 2, dim=-1)
        f_mse = torch.mean((feat_x - vgg(x_hat).float()).reshape(b, -1) ** 2, dim=-1)
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
    compute_dtype: torch.dtype = torch.float32,
):
    """Q(x) -> NaN rescue -> Adam refine, for images x (B, H, W, 3) in
    [-1, 1] (`damc_tpu/train/stylegan_inv.py:108-140`). A caller that holds
    the frozen encoder's code of x passes it as `xemb`. `compute_dtype`
    applies to the Adam refine alone. Returns (x_hat (B, H, W, 3) in
    float32, z, per-step loss sums)."""
    if xemb is None:
        with _phase("encoder"), torch.no_grad():
            xemb = nets.encoder(_nchw(x))
    with _phase("q_sweep"):
        z0 = sample_q(q, None, draws.z_init, 0, xemb=xemb, noise=draws.sweep_noise)
    with _phase("rescue"):
        z0 = nan_rescue(nets, z0, x, draws.rescue)
    with _phase("refine"):
        z, losses = adam_latent_descent(z0, inversion_loss_fn(nets, x, compute_dtype), steps=steps, lr=lr)
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
    compute_dtype: torch.dtype = torch.float32,
    mesh=None,
) -> Dict[str, float]:
    """Recon MSE (the sum of per-image means over N) and, with a feature
    extractor and real statistics, the Frechet distance of the
    reconstructions, over every image of `images` (N, H, W, 3) in [-1, 1]
    (`damc_tpu/train/stylegan_inv.py:203-307`): a tail batch is padded by
    repeating its last image, then sliced back; features stream into
    `RunningStats`. `compute_dtype` is the Adam refine's (`invert_batch`).

    With a `mesh` (the ranks of a process group, each holding Q and the
    networks), `batch` must divide over the ranks, and each rank inverts
    its rows of every batch, the padded tail's too (:240-283). Its draws
    are its rows of the global batch's, so a row is inverted as in one
    process: the refine's loss is a sum of per-image losses and Adam is
    elementwise. The MSE sums and the feature statistics of the real rows
    are all-reduced; every rank returns the same numbers."""
    from ..metrics.fid import RunningStats, all_reduce_stats, frechet_distance

    n_total = len(images)
    if n_total == 0:
        raise ValueError("evaluate_inversion: empty image set")
    if mesh is not None and batch % mesh.world:
        raise ValueError(f"evaluate_inversion: batch {batch} must divide by the mesh's {mesh.world} ranks")
    rows = slice(0, batch) if mesh is None else batch_sharding(mesh, batch)
    dev = q.p.B.device
    total_mse = torch.zeros((), dtype=torch.float64, device=dev)
    stats = None
    for bi, i in enumerate(range(0, n_total, batch)):
        xb = torch.from_numpy(np.asarray(images[i : i + batch], np.float32)).to(dev)
        n_real = xb.shape[0]
        if n_real < batch:
            xb = torch.cat([xb, xb[-1:].expand(batch - n_real, -1, -1, -1)])
        draws = inversion_draws(batch_generator(seed, bi, dev), batch, q.nz, q.n_interval, q.with_noise)
        xl = xb[rows]
        x_hat, _, _ = invert_batch(q, nets, xl, shard_inversion_draws(draws, rows), steps, lr,
                                   compute_dtype=compute_dtype)
        kept = min(max(n_real - rows.start, 0), xl.shape[0])  # this rank's rows that are not padding
        total_mse += torch.sum(torch.mean((x_hat[:kept] - xl[:kept]).flatten(1) ** 2, dim=-1)).double()
        if feature_fn is not None and kept:
            with torch.no_grad():
                feats = feature_fn(to_unit_range(x_hat[:kept]))
            if stats is None:
                stats = RunningStats(feats.shape[-1], feats.device)
            stats.update(feats)
    if mesh is not None:
        torch.distributed.all_reduce(total_mse)
        if feature_fn is not None:  # a rank that held only padding learns the width from its peers
            width = all_max(mesh, torch.tensor(0.0 if stats is None else float(stats.sum.shape[0]), device=dev))
            stats = all_reduce_stats(stats if stats is not None else RunningStats(int(width), dev))
    out = {"recon_mse": float(total_mse) / n_total}
    if stats is not None and real_mu is not None:
        mu, sigma = stats.finalize()
        out[fid_metric_name] = frechet_distance(mu, sigma, real_mu, real_sigma)
    return out
