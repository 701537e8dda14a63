"""Typed configuration tree with per-workload presets.

The PyTorch port's own copy of `damc_tpu/utils/config.py`: the same
dataclasses and the same `preset()` values field for field (held by
tests/test_torch_port_config.py), kept here so the port imports nothing of
the JAX package. Some fields only matter to parts of the JAX package that
the port has not reached yet (training, data placement, Pallas dtypes);
they are kept so a preset compares equal.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    dataset: str = "cifar10"
    nz: int = 128  # latent dim
    ngf: int = 128  # generator base width
    nif: int = 64  # encoder base width
    ndf: int = 200  # EBM hidden width
    nxemb: int = 1024  # x-embedding dim in Q
    ntemb: int = 128  # t-embedding dim in Q
    nf: int = 4  # denoiser width factor
    nc: int = 3  # image channels
    image_size: int = 32
    # Compute dtype for the conv nets (generator/encoder). 'bfloat16' halves
    # activation HBM traffic; params and the diffusion/Langevin math stay
    # fp32 (SURVEY.md §7: schedule math is bf16-unsafe at the endpoints).
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class DiffusionConfig:
    n_interval: int = 100  # reverse-diffusion steps (posterior & prior)
    logsnr_min: float = -5.1
    logsnr_max: float = 9.8
    residual: bool = True  # denoiser predicts a residual on z
    var_type: str = "large"
    with_noise: bool = True  # stochastic ancestral steps in Q.sample
    p_mask: float = 0.2  # joint cond/uncond training mask prob
    # Classifier-free guidance weight. NOTE: inert during training/eval for
    # PARITY with the reference, whose --cond_w flag is itself dead code
    # (`_netQ_U.forward(x, ..., cond_w=-1)` defaults guidance OFF at every
    # call site and `self.cond_w` is never read, `diffusion_net.py:585-606`).
    # Guided sampling is available explicitly via `sample_q(..., cond_w=w)`.
    cond_w: float = 0.0


@dataclass(frozen=True)
class MCMCConfig:
    g_l_steps: int = 30  # posterior Langevin steps (training)
    g_l_step_size: float = 0.1
    g_l_with_noise: bool = True
    g_llhd_sigma: float = 0.1
    e_l_steps: int = 60  # prior Langevin steps (training)
    e_l_step_size: float = 0.4
    e_l_with_noise: bool = True


@dataclass(frozen=True)
class OptimConfig:
    g_lr: float = 2e-4
    e_lr: float = 1e-4
    q_lr: float = 2e-4
    betas: Tuple[float, float] = (0.5, 0.999)
    q_weight_decay: float = 1e-4  # 0 for anomaly, 1e-2 for toy
    g_max_norm: float = 100.0
    e_max_norm: float = 100.0
    q_max_norm: float = 100.0
    # multiplicative decay every `lr_decay_every` steps, floored at lr_floor
    lr_decay: float = 0.99
    lr_decay_every: int = 1000
    lr_floor: float = 1e-5


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 1
    batch_size: int = 128
    iterations: int = 1_000_000
    n_fid_samples: int = 50_000
    # FID sample-generation batch (reference `MCMC.py:130,152`: bs=500; the
    # mse eval loader also uses 500, `eval_gen_recon.py:110`).
    fid_batch_size: int = 500
    q_updates: int = 6  # inner Q updates per iteration
    ema_rho: float = 0.005  # Q -> Q_ema mixing (0.75 for toy)
    ema_every: int = 10
    # 'double' = 2B prior chains (gen_recon, train_gen_recon.py:206-209),
    # 'single' = B chains (anomaly), 'none' = no prior sampling (toy)
    prior_chains: str = "double"
    q_loss_both_branches: bool = False  # anomaly trains both mask branches
    # gen_recon/toy draw a Bernoulli(p_mask) mask; anomaly uses a fixed
    # all-ones mask and trains cond + uncond branches explicitly
    # (`train_anomaly_det.py:134-140`).
    random_mask: bool = True
    # The JAX package's kernel switches: its fused Pallas prior chain, and
    # that kernel's dot operand dtype ('float32' | 'bfloat16').
    use_pallas: bool = True
    pallas_dots_dtype: str = "float32"
    # Rematerialize the generator inside the posterior-Langevin gradient
    # (trades FLOPs for activation memory; for very large image configs).
    remat_generator: bool = False
    update_g: bool = True
    update_e: bool = True
    # Optional EBM energy-magnitude regularizer: adds
    # alpha * (mean E(z+)^2 + mean E(z-)^2) to the CD loss (the standard
    # EBM stabilizer, Du & Mordatch 2019). DEFAULT 0.0 = exact reference
    # parity — the reference has NO stabilizer and its own torch loop
    # exhibits iteration-driven CD runaway after ~5k iterations
    # (artifacts/CD_DIVERGENCE.md). A small alpha bounds the energy scale
    # so e_pos/e_neg cannot grow without bound on long horizons.
    e_energy_reg: float = 0.0
    # Training-batch placement ('auto' | 'host' | 'device') and the
    # device-resident store's budget in GB (None: the data module's default).
    data_placement: str = "auto"
    data_device_budget_gb: Optional[float] = None
    print_every: int = 100
    plot_every: int = 1000
    ckpt_every: int = 50_000
    eval_every: int = 100
    log_path: str = "logs"
    data_path: str = "data"
    resume_path: Optional[str] = None
    heldout_digit: int = 1  # anomaly detection held-out class


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    mcmc: MCMCConfig = field(default_factory=MCMCConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)


def _r(cfg, section: str, **kw):
    return dataclasses.replace(cfg, **{section: dataclasses.replace(getattr(cfg, section), **kw)})


def preset(name: str) -> Config:
    """Workload presets mirroring the reference CLI defaults + README recipes."""
    cfg = Config()
    if name == "cifar10":
        cfg = _r(cfg, "model", dataset="cifar10", nz=128, ngf=128, image_size=32)
        return cfg
    if name == "cifar10-stable":
        # Reference-exact cifar10 plus an EBM energy-magnitude regularizer
        # (alpha=2e-4) against the reference's contrastive-divergence runaway
        # (artifacts/CD_DIVERGENCE.md).
        cfg = preset("cifar10")
        return _r(cfg, "train", e_energy_reg=2e-4)
    if name == "svhn":
        cfg = _r(cfg, "model", dataset="svhn", nz=100, ngf=64, image_size=32)
        return cfg
    if name == "celeba64":
        cfg = _r(cfg, "model", dataset="celeba64", nz=100, ngf=128, image_size=64)
        return cfg
    if name == "celebaHQ":
        cfg = _r(cfg, "model", dataset="celebaHQ", nz=128, ngf=128, image_size=256)
        cfg = _r(cfg, "mcmc", g_llhd_sigma=1.0)
        return cfg
    if name == "mnist_anomaly":
        # train_anomaly_det.py defaults: nz=8, ngf=128, nif=128, nxemb=1024,
        # g_llhd_sigma=1.0, g_lr=q_lr=1e-4, e_lr=5e-5, Q weight_decay=0,
        # single prior chains, dual-branch Q loss on a FIXED all-ones mask,
        # eval every 500, ckpt every 1000, held-out digit default 9.
        cfg = _r(
            cfg, "model", dataset="mnist", nz=8, ngf=128, nif=128, nxemb=1024,
            nc=1, image_size=28,
        )
        cfg = _r(cfg, "mcmc", g_llhd_sigma=1.0)
        cfg = _r(cfg, "optim", q_weight_decay=0.0, g_lr=1e-4, e_lr=5e-5, q_lr=1e-4)
        cfg = _r(
            cfg,
            "train",
            prior_chains="single",
            q_loss_both_branches=True,
            random_mask=False,
            eval_every=500,
            ckpt_every=1000,
            heldout_digit=9,
        )
        return cfg
    if name == "toy":
        # toy_example.py: nz=2, nxemb=128, wd=1e-2, rho=0.75, p_mask=0.1,
        # 50-step posterior Langevin with sigma=0.25, no EBM, Q-only updates.
        cfg = _r(cfg, "model", dataset="toy", nz=2, nxemb=128, nc=2)
        cfg = _r(cfg, "diffusion", p_mask=0.1)
        cfg = _r(cfg, "mcmc", g_l_steps=50, g_llhd_sigma=0.25)
        cfg = _r(cfg, "optim", q_weight_decay=1e-2)
        cfg = _r(
            cfg,
            "train",
            batch_size=500,
            ema_rho=0.75,
            prior_chains="none",
            update_g=False,
            update_e=False,
        )
        return cfg
    raise ValueError(f"unknown preset {name!r}")
