"""DAMC amortizer Q (counterpart of `damc_tpu/models/amortizer.py`).

Bundles the encoder (conv, or the toy's MLP; none for the StyleGAN
inversion Q, whose conditioning is the frozen inversion encoder's W+ code),
the prior embedder and the latent denoiser, holds the denoising
score-matching loss that trains Q (`DAMCAmortizer.loss`), and draws Q
samples. `sample_q` takes one of three routes, fixed by `sweep_route`
before anything is launched, as JAX's `sample_q` chooses (:226-347):

  * "k2"      the hoisted sweep in the fused kernel K2 (stream noise from
              an int32 seed), when no guidance is active and K2's fit rule
              `fits_smem` takes the denoiser;
  * "tables"  the same hoisted sweep as a torch loop over
              `denoise_from_tables` (`ops/reverse_diffusion.py`), for a
              denoiser K2 cannot take (the StyleGAN Q);
  * "guided"  the unhoisted loop with classifier-free guidance
              (`cond_w` > 0 on a conditional draw).

Under data parallelism (a `parallel.Mesh`), `sample_q(..., mesh=)` takes
the global batch on every rank and splits K2's rows over the ranks (K4b,
`fused_reverse_sweep_sharded`); `sample_q(..., row_base=)` runs K2 on a
rank's own rows of a global batch (the training step's, already local),
drawing what the unsharded launch draws for them.

`sample_q_per_item` (serving: per-row counter noise) runs K2 ("k2"), or,
for a denoiser K2 cannot take or with `fused=False`, the "tables" loop
drawing the same per-row counter normals K2 draws (JAX's
`sample_q_per_item(fused=False)`, :417-432, runs a vmap of single-item
scans there instead: the same per-row contract from another stream).
Random draws come in as tensors, so
a caller can feed the JAX package's. Keys keep the reference `_netQ_U`
layout: `encoder.net.*`, `prior_emb.0`, `prior_emb.2`, `p.*`, and the
reference's unused `xemb` (1, nxemb), held here as a buffer so a
reference-format state dict loads strictly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.cuda.fused_qsweep import (
    denoiser_layer_params, fits_smem, fused_reverse_sweep, fused_reverse_sweep_sharded,
)
from ..ops.diffusion import diffusion_forward, logsnr_schedule, step_coefficients, sweep_logsnr_grid
from ..ops.noise import counter_normals
from ..ops.reverse_diffusion import reverse_diffusion_sample
from .denoiser import LatentDenoiser
from .encoders import MLPEncoder, make_encoder


class PriorEmbedder(nn.Sequential):
    """Noise -> prior embedding: nz -> 128 -> LeakyReLU(0.01) -> nxemb."""

    def __init__(self, nz: int, nxemb: int, width: int = 128):
        super().__init__(nn.Linear(nz, width), nn.LeakyReLU(0.01), nn.Linear(width, nxemb))


STYLEGAN_WIDTHS = (1024, 1024)  # the inversion Q's hidden widths (`damc_tpu/models/amortizer.py:80-87`)


class DAMCAmortizer(nn.Module):
    """Q: amortized sampler of p(z | x), and of p(z) when unconditioned.
    dataset='toy' selects the MLP encoder, 'stylegan' none (the caller
    passes the embedding as `xemb`) and 1024-wide hidden layers, the others
    the conv encoders, which compute in `encoder_dtype`; the denoiser stays
    float32."""

    def __init__(
        self,
        nz: int,
        nxemb: int = 1024,
        ntemb: int = 128,
        nf: int = 4,
        nif: int = 64,
        nc: int = 3,
        dataset: str = "cifar10",
        n_interval: int = 100,
        logsnr_min: float = -5.1,
        logsnr_max: float = 9.8,
        var_type: str = "large",
        with_noise: bool = True,
        residual: bool = True,
        encoder_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.nz, self.nxemb = nz, nxemb
        self.n_interval = n_interval
        self.logsnr_min, self.logsnr_max = logsnr_min, logsnr_max
        self.var_type = var_type
        self.with_noise = with_noise
        widths = None
        if dataset == "toy":  # x is a 2-D observation: nc is its width
            self.encoder = MLPEncoder(nemb=nxemb, in_dim=nc)
        elif dataset == "stylegan":
            self.encoder = None
            widths = STYLEGAN_WIDTHS
        else:
            self.encoder = make_encoder(dataset, nemb=nxemb, nif=nif, nc=nc, dtype=encoder_dtype)
        self.prior_emb = PriorEmbedder(nz, nxemb)
        self.p = LatentDenoiser(nz, nxemb, ntemb, nf=nf, residual=residual, widths=widths)
        self.register_buffer("xemb", torch.zeros(1, nxemb))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        if self.encoder is None:
            raise ValueError("the StyleGAN Q has no encoder: pass the inversion encoder's code as xemb")
        # A bfloat16 embedding enters Q's float32 layers, where JAX promotes
        # it to float32 (`damc_tpu/models/amortizer.py:81-95`): the cast is
        # exact, and its gradient is cast back to the encoder's dtype.
        return self.encoder(x).float()

    def prior_embed(self, noise: torch.Tensor) -> torch.Tensor:
        return self.prior_emb(noise)

    def denoise(self, z, logsnr, xemb):
        return self.p(z, logsnr, xemb)

    def loss(
        self,
        z: torch.Tensor,
        x: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        xemb: Optional[torch.Tensor] = None,
        *,
        prior_noise: Optional[torch.Tensor],
        u: torch.Tensor,
        eps: torch.Tensor,
    ) -> torch.Tensor:
        """Masked denoising score-matching loss per sample, (B,), as
        `damc_tpu/models/amortizer.py:128-164`: embed x (rows with mask 0
        take the prior embedding of `prior_noise` (B, nz)), map u (B,) in
        [0, 1] to a logsnr, diffuse z with the normals `eps` (B, nz) and
        regress them: 0.5 ||eps - eps_hat||^2. Without x or xemb every row
        takes the prior embedding."""
        if x is not None or xemb is not None:
            if xemb is None:
                xemb = self.encode(x)
            if mask is not None:
                prior_emb = self.prior_embed(prior_noise)
                xemb = xemb * mask + prior_emb * (1.0 - mask)
        else:
            if mask is not None:
                raise ValueError("a mask needs x or xemb")
            xemb = self.prior_embed(prior_noise)
        logsnr = logsnr_schedule(u, self.logsnr_min, self.logsnr_max)
        zt_dist = diffusion_forward(z, logsnr[:, None])
        zt = zt_dist.mean + zt_dist.std.to(z.dtype) * eps
        eps_pred = self.p(zt, logsnr, xemb)
        return 0.5 * torch.sum((eps - eps_pred) ** 2, dim=-1)

    def terminal_reg(self, z: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """0.5 ||z_T||^2 of z diffused to logsnr_min with the normals `eps`,
        per sample (`damc_tpu/models/amortizer.py:166-178`)."""
        logsnr_t = logsnr_schedule(
            torch.ones(z.shape[0], device=z.device), self.logsnr_min, self.logsnr_max
        )
        dist = diffusion_forward(z, logsnr_t[:, None])
        z_t = dist.mean + dist.std.to(z.dtype) * eps
        return 0.5 * torch.sum(z_t**2, dim=-1)

    def step_tables(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logsnr grid (n,), step coefficients (n, 6)) on `device`, both
        computed on the CPU."""
        n = self.n_interval
        grid, _ = sweep_logsnr_grid(n, self.logsnr_min, self.logsnr_max)
        coeffs = step_coefficients(n, self.logsnr_min, self.logsnr_max, self.var_type)
        return grid.to(device), coeffs.to(device)


def sweep_route(amortizer: DAMCAmortizer, cond_w: float = 0.0, conditional: bool = True) -> str:
    """The path `sample_q` takes, from static facts alone (JAX's rule,
    `damc_tpu/models/amortizer.py:236-326`): "guided" when guidance is on
    (a conditional draw with cond_w > 0), else "k2" when K2's fit rule
    takes the denoiser, else "tables"."""
    if conditional and cond_w > 0:
        return "guided"
    layers = amortizer.p.all_layers
    dins, douts = [l.dim_in for l in layers], [l.dim_out for l in layers]
    return "k2" if fits_smem(amortizer.nz, dins, douts) else "tables"


@torch.no_grad()
def sample_q_per_item(
    amortizer: DAMCAmortizer,
    z_init: torch.Tensor,
    row_seeds: torch.Tensor,
    x: Optional[torch.Tensor] = None,
    emb_noise: Optional[torch.Tensor] = None,
    layers: Optional[Tuple[torch.Tensor, Sequence[Tuple[torch.Tensor, ...]]]] = None,
    step_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    fused: Optional[bool] = None,
) -> torch.Tensor:
    """Q samples whose row i is a pure function of (z_init[i], row_seeds[i])
    and x[i] (posterior) or emb_noise[i] (prior).

    The n-step reverse sweep draws per-row counter noise from `row_seeds`.
    `fused` (JAX's meaning): None runs the fused kernel K2 when its fit rule
    takes the denoiser (`sweep_route` "k2") and the tables loop otherwise;
    False runs the tables loop; True runs K2 and raises for a denoiser K2
    cannot take. The loop draws each step's noise as K2 does
    (`noise.counter_normals`), so both give a row the same normals.
    `layers` is `denoiser_layer_params(amortizer.p)` and `step_tables` is
    `amortizer.step_tables(device)`, which a caller that samples often
    computes once (serving: a traced serving program then holds them as
    constants instead of recomputing the CPU-side tables on its device)."""
    fits = sweep_route(amortizer) == "k2"
    if fused is None:
        fused = fits
    elif fused and not fits:
        raise ValueError(
            "sample_q_per_item(fused=True): the fused sweep K2 does not take this denoiser "
            "(fits_smem: at most 256 columns a layer and 227 KB of shared memory a block)"
        )
    if x is not None:
        xemb = amortizer.encode(x)
    elif emb_noise is not None:
        xemb = amortizer.prior_embed(emb_noise)
    else:
        raise ValueError("sample_q_per_item needs x (posterior) or emb_noise (prior)")
    if fused:
        return _sweep(amortizer, xemb, z_init, layers, step_tables, row_seeds=row_seeds)
    grid, _ = step_tables if step_tables is not None else amortizer.step_tables(z_init.device)
    noise = None
    if amortizer.with_noise:
        noise = counter_normals(row_seeds, amortizer.n_interval - 1, amortizer.nz).to(z_init.device)
    return _table_sweep(amortizer, xemb, z_init, grid, noise=noise)


@torch.no_grad()
def sample_q(
    amortizer: DAMCAmortizer,
    x: Optional[torch.Tensor],
    z_init: torch.Tensor,
    seed: int,
    layers: Optional[Tuple[torch.Tensor, Sequence[Tuple[torch.Tensor, ...]]]] = None,
    emb_noise: Optional[torch.Tensor] = None,
    *,
    xemb: Optional[torch.Tensor] = None,
    cond_w: float = 0.0,
    noise: Optional[torch.Tensor] = None,
    guide_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    mesh=None,
    row_base: int = 0,
) -> torch.Tensor:
    """z ~ Q(. | x), or z ~ Q(.) when x is None, detached, from the normals
    `z_init` (B, nz) (`damc_tpu/models/amortizer.py:181-347`).

    The conditioning is `xemb` (B, nxemb) when given (the StyleGAN Q's
    inversion-encoder code; guidance applies to it as to x), else the
    encoding of x, else the prior embedding of the normals `emb_noise`
    (B, nz). `sweep_route` picks the path: K2 in stream mode from the int32
    `seed`, or the torch loop of `ops/reverse_diffusion.py`, hoisted
    ("tables") or guided with weight `cond_w`. The loop's ancestral normals
    are `noise` (n, B, nz) and the guided branch's `guide_noise` (n, B, nz);
    what is not given is drawn from `generator`, a generator on z_init's
    device. The training step draws its chain inits with it, the evals
    their samples and reconstructions, the inversion its Q codes.

    On the "k2" route, `mesh` (JAX's `mesh=`, :295-297) takes the inputs
    as the global batch on every rank and splits the sweep's rows over the
    ranks (K4b); every rank gets the whole result. `row_base` says instead
    that the inputs are a rank's rows from global row `row_base` on, and
    seeds their stream noise as the global rows'. The other routes run
    what they are given as it is."""
    conditional = xemb is not None or x is not None
    if xemb is None:
        if x is not None:
            xemb = amortizer.encode(x)
        elif emb_noise is not None:
            xemb = amortizer.prior_embed(emb_noise)
        else:
            raise ValueError("sample_q needs xemb or x (posterior) or emb_noise (prior)")
    route = sweep_route(amortizer, cond_w, conditional)
    if route == "k2":
        if mesh is None:
            return _sweep(amortizer, xemb, z_init, layers, None, seed=seed, row_base=row_base)
        if row_base:
            raise ValueError("sample_q: row_base names a rank's rows, mesh takes the global batch; not both")
        return _sweep(amortizer, xemb, z_init, layers, None, mesh=mesh, seed=seed)
    if route == "tables":
        grid, _ = sweep_logsnr_grid(amortizer.n_interval, amortizer.logsnr_min, amortizer.logsnr_max)
        return _table_sweep(amortizer, xemb, z_init, grid.to(z_init.device), noise, generator)
    p = amortizer.p
    return reverse_diffusion_sample(
        lambda z, logsnr: p(z, logsnr, xemb), z_init, amortizer.n_interval, amortizer.logsnr_min,
        amortizer.logsnr_max, amortizer.var_type, amortizer.with_noise, noise=noise,
        guided_denoise_fn=lambda normals, z, logsnr: p(z, logsnr, amortizer.prior_embed(normals)),
        cond_w=cond_w, guide_noise=guide_noise, generator=generator,
    )


def _table_sweep(amortizer: DAMCAmortizer, xemb, z_init, grid, noise=None, generator=None) -> torch.Tensor:
    """The hoisted n-step sweep as the torch loop over `denoise_from_tables`
    (`ops/reverse_diffusion.py`), the tables built from `grid`, the
    sweep's logSNR grid on z_init's device."""
    p = amortizer.p
    tables = p.sample_tables(grid, xemb)
    pre_x = tables["pre_x"]
    return reverse_diffusion_sample(
        lambda z, logsnr, pre_t_step: p.denoise_from_tables(z, pre_t_step, pre_x), z_init,
        amortizer.n_interval, amortizer.logsnr_min, amortizer.logsnr_max, amortizer.var_type,
        amortizer.with_noise, noise=noise, step_xs=tables["pre_t"], generator=generator,
    )


def _sweep(amortizer: DAMCAmortizer, xemb, z_init, layers, step_tables, mesh=None, **noise) -> torch.Tensor:
    """The hoisted n-step sweep from z_init under the embedding xemb, in
    the fused kernel (K4b over `mesh`'s ranks when given); `noise` is its
    seed (and row_base) or row_seeds."""
    grid, coeffs = step_tables if step_tables is not None else amortizer.step_tables(z_init.device)
    tables = amortizer.p.sample_tables(grid, xemb)
    fourier, layer_tuples = layers if layers is not None else denoiser_layer_params(amortizer.p)
    kw = dict(steps=amortizer.n_interval, with_noise=amortizer.with_noise, residual=amortizer.p.residual)
    args = (z_init, fourier, layer_tuples, tables["pre_x"], tables["pre_t"], coeffs)
    if mesh is not None:
        return fused_reverse_sweep_sharded(mesh, *args, **kw, **noise)
    return fused_reverse_sweep(*args, **kw, **noise)
