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
    """The svhn family at test widths (as tests/test_serve.py sizes it)."""
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, ngf=8, nif=8, nxemb=16, ntemb=16, nz=8),
        diffusion=dataclasses.replace(cfg.diffusion, n_interval=2),
        mcmc=dataclasses.replace(cfg.mcmc, g_l_steps=2, e_l_steps=2),
    )


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_and_port(seed: int = 0, preset_name: str = "svhn"):
    """(jax cfg, jax state, jax models, port cfg, port models) of one weight
    set; the port's models run on the CPU."""
    cfg_j = tiny(jax_preset(preset_name))
    cfg_p = tiny(port_preset(preset_name))
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
