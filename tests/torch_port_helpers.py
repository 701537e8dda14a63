"""Shared set-up of the port's parity tests: one tiny configuration, a JAX
state made from a seed, and the port's models carrying the same weights
(through `damc_tpu_torch.convert.state_dicts_from_jax`)."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from damc_tpu.train.state import create_state
from damc_tpu.utils.config import preset as jax_preset
from damc_tpu_torch.config import preset as port_preset
from damc_tpu_torch.convert import load_state_dicts, state_dicts_from_jax
from damc_tpu_torch.models import build_models


def tiny(cfg):
    """The svhn family at test widths (as tests/test_serve.py sizes it); the
    toy keeps its nz = 2 (its G maps 2-D latents to 2-D observations)."""
    nz = cfg.model.nz if cfg.model.dataset == "toy" else 8
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, ngf=8, nif=8, nxemb=16, ntemb=16, nz=nz),
        diffusion=dataclasses.replace(cfg.diffusion, n_interval=2),
        mcmc=dataclasses.replace(cfg.mcmc, g_l_steps=2, e_l_steps=2),
    )


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_and_port(seed: int = 0, preset_name: str = "svhn", edit=None):
    """(jax cfg, jax state, jax models, port cfg, port models) of one weight
    set; the port's models run on the CPU. `edit` (cfg -> cfg) is applied
    to both tiny configs before the models are built."""
    edit = edit or (lambda c: c)
    cfg_j = edit(tiny(jax_preset(preset_name)))
    cfg_p = edit(tiny(port_preset(preset_name)))
    state, models_j, _ = create_state(jax.random.PRNGKey(seed), cfg_j)
    models_p = build_models(cfg_p, seed=seed, device="cpu")
    load_state_dicts(
        models_p,
        state_dicts_from_jax(
            {
                "params_g": to_numpy(state.params_g),
                "params_e": to_numpy(state.params_e),
                "params_q": to_numpy(state.params_q),
            }
        ),
    )
    return cfg_j, state, models_j, cfg_p, models_p


def train_cfgs(preset_name: str = "svhn", **train_kw):
    """(jax cfg, port cfg) of a tiny training run: the `tiny` widths, batch
    4, two Q updates, `train_kw` on top of the preset's train section."""
    from damc_tpu.utils.config import preset as jp

    def one(cfg):
        cfg = tiny(cfg)
        return dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, batch_size=4, q_updates=2, **train_kw)
        )

    return one(jp(preset_name)), one(port_preset(preset_name))


def loss_draws(key, b: int, nz: int):
    """The (prior noise, u, eps) that `DAMCAmortizer.loss` draws from `key`."""
    k_prior, k_u, k_eps = jax.random.split(key, 3)
    return (
        np.asarray(jax.random.normal(k_prior, (b, nz))),
        np.asarray(jax.random.uniform(k_u, (b,))),
        np.asarray(jax.random.normal(k_eps, (b, nz))),
    )


def jax_step_draws(rng, cfg, b: int):
    """The port's `StepDraws` holding exactly the numbers the JAX train step
    draws from the state key `rng` (`damc_tpu/train/step.py:70-72`). The
    kernels' stream seeds are left at 0: the parity runs are noiseless
    there. With `use_pallas` off, the autograd prior chain's normals are
    those JAX's scan chain draws from the prior key."""
    import torch

    from damc_tpu_torch.train.step import QDraws, StepDraws

    tc, nz = cfg.train, cfg.model.nz
    _, k_mask, k_q0, k_post, k_neg, k_prior, k_qloss = jax.random.split(rng, 7)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    post = jax.vmap(lambda k: jax.random.normal(k, (b, nz)))(
        jax.random.split(k_post, cfg.mcmc.g_l_steps)
    )
    chains = 2 * b if tc.prior_chains == "double" else b
    chain = jax.vmap(lambda k: jax.random.normal(k, (chains, nz)))(
        jax.random.split(k_prior, cfg.mcmc.e_l_steps)
    )
    q = []
    for i in range(tc.q_updates):
        k1, k2 = jax.random.split(jax.random.fold_in(k_qloss, i))
        one = lambda k: QDraws(*map(t, loss_draws(k, b, nz)))
        q.append((one(k1), one(k2) if tc.q_loss_both_branches else None))
    return StepDraws(
        mask_u=t(jax.random.uniform(k_mask, (b,))),
        z0_init=t(jax.random.normal(jax.random.split(k_q0, 3)[0], (b, nz))),
        neg_init=t(jax.random.normal(k_neg, (b, nz))) if tc.prior_chains == "double" else None,
        post_noise=t(post),
        q=q,
        sweep_seed=0,
        chain_seed=0,
        chain_noise=None if tc.use_pallas or tc.prior_chains == "none" else t(chain),
    )


def adam_cap(lr: float, updates: int, betas) -> float:
    """The most two runs of `updates` Adam steps from one start can differ
    in one element: 2 lr sum_t c_t, where c_t = sqrt(sum_i w_i^2 / u_i)
    bounds |m_hat / sqrt(v_hat)| at update t (Cauchy-Schwarz), with w_i and
    u_i the bias-corrected weights of gradient i in m_hat and v_hat."""
    b1, b2 = betas
    total = 0.0
    for t in range(1, updates + 1):
        w = [(1 - b1) * b1 ** (t - i) / (1 - b1**t) for i in range(1, t + 1)]
        u = [(1 - b2) * b2 ** (t - i) / (1 - b2**t) for i in range(1, t + 1)]
        total += sum(wi * wi / ui for wi, ui in zip(w, u)) ** 0.5
    return 2 * lr * total


def one_torch_thread():
    """Generator for a module-scoped fixture: torch's intra-op pool at one
    thread for the module, then back. The suite runs several workers on
    one machine, and their full-width thread pools oversubscribe it many
    times over (a file measured 7x slower)."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)



def lsun_jpeg_db(root: str, cls: str, n: int, seed: int, max_size=(120, 90), quality: int = 85, **fixture_kw):
    """Write `<root>/<cls>_lmdb`, an LSUN-style LMDB (tests/lmdb_fixture.py)
    of `n` seeded JPEGs, PIL-written, of random sizes up to `max_size`
    (width, height), 4:2:0 or 4:4:4 by turns; returns {key: bytes}."""
    import io
    import os

    from PIL import Image

    from lmdb_fixture import build_lmdb

    rng = np.random.default_rng(seed)
    items = {}
    for i in range(n):
        w, h = int(rng.integers(9, max_size[0] + 1)), int(rng.integers(9, max_size[1] + 1))
        low = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3), dtype=np.uint8)
        pix = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR)).astype(np.int16)
        pix = np.clip(pix + rng.integers(-8, 9, pix.shape), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(pix).save(buf, "JPEG", quality=quality, subsampling=2 * (i % 2 == 0))
        items[f"{i:08d}".encode()] = buf.getvalue()
    build_lmdb(os.path.join(root, f"{cls}_lmdb"), items, **fixture_kw)
    return items
