"""Weights in: JAX param trees and reference `.pth.tar` files -> port modules.

The port's modules keep the reference torch key layout, so
`load_state_dict(strict=True)` takes both:

  * `state_dicts_from_jax(params)`: the JAX package's Flax param trees, as
    numpy arrays, mapped the way `damc_tpu/utils/torch_compat.py:183-302`
    exports them (the port keeps its own copy of those maps);
  * `load_reference_checkpoint(models, path)`: a reference-format checkpoint
    (`G_state_dict`, `E_state_dict`, `Q_state_dict`), such as the one
    `damc_tpu.cli.export_checkpoint` writes;
  * `train_state_from_jax(state, cfg)`: a whole JAX training state (weights,
    Q_ema, step and the optax Adam moments) as a port `TrainState`, so a
    port step can continue a JAX run.

Maps: Dense kernel (in, out) -> Linear weight (out, in) (the toy's MLPs
too); Conv HWIO -> OIHW;
ConvTranspose (kh, kw, in, out) -> (in, out, kh, kw) with a spatial flip;
GroupNorm(group_size=1) scale/bias -> InstanceNorm2d weight/bias.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from .config import Config

StateDict = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _dense(p, sd: StateDict, prefix: str) -> None:
    sd[f"{prefix}.weight"] = _a(p["kernel"]).T
    if "bias" in p:
        sd[f"{prefix}.bias"] = _a(p["bias"])


def generator_state(params) -> StateDict:
    """A `DeconvGenerator`'s, or the toy's `ToyGenerator` (Dense layers at
    `net.{2i}`)."""
    p = params["params"]
    sd: StateDict = {}
    if "Dense_0" in p:
        for i in range(len(p)):
            _dense(p[f"Dense_{i}"], sd, f"net.{2 * i}")
        return sd
    for i in range(len(p)):
        q = p[f"ConvTranspose_{i}"]
        sd[f"gen.{2 * i}.weight"] = _a(q["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        sd[f"gen.{2 * i}.bias"] = _a(q["bias"])
    return sd


def ebm_state(params) -> StateDict:
    p = params["params"]
    sd: StateDict = {}
    for i in range(len(p)):
        _dense(p[f"Dense_{i}"], sd, f"ebm.{2 * i}")
    return sd


def _encoder_state(p, sd: StateDict, prefix: str) -> None:
    n_conv = sum(1 for k in p if k.startswith("Conv_"))
    n_norm = sum(1 for k in p if k.startswith("GroupNorm_"))
    for i in range(n_conv):
        q = p[f"Conv_{i}"]
        sd[f"{prefix}.{3 * i}.weight"] = _a(q["kernel"]).transpose(3, 2, 0, 1)
        sd[f"{prefix}.{3 * i}.bias"] = _a(q["bias"])
    for i in range(n_norm):
        sd[f"{prefix}.{3 * i + 1}.weight"] = _a(p[f"GroupNorm_{i}"]["scale"])
        sd[f"{prefix}.{3 * i + 1}.bias"] = _a(p[f"GroupNorm_{i}"]["bias"])


def _denoiser_state(p, sd: StateDict, prefix: str) -> None:
    sd[f"{prefix}.B"] = _a(p["fourier_b"])
    _dense(p["time_d1"], sd, f"{prefix}.time_mlp.1")
    _dense(p["time_d2"], sd, f"{prefix}.time_mlp.3")
    for group, count in (("in_layers", 3), ("mid_layers", 1), ("out_layers", 3)):
        for i in range(count):
            q = p[f"{group}_{i}"]
            pre = f"{prefix}.{group}.{i}"
            sd[f"{pre}._layer_ctx.1.weight"] = _a(q["ctx_kernel"]).T
            sd[f"{pre}._layer_ctx.1.bias"] = _a(q["ctx_bias"])
            _dense(q["_gate"], sd, f"{pre}._hyper_gate")
            _dense(q["_hyper_bias"], sd, f"{pre}._hyper_bias")
            _dense(q["_lin"], sd, f"{pre}._layer.0")
            _dense(q["_skip"], sd, f"{pre}._skip")


def amortizer_state(params, nxemb: int) -> StateDict:
    p = params["params"]
    sd: StateDict = {"xemb": np.zeros((1, nxemb), np.float32)}  # the reference's unused key
    _denoiser_state(p["p"], sd, "p")
    _dense(p["prior_emb"]["Dense_0"], sd, "prior_emb.0")
    _dense(p["prior_emb"]["Dense_1"], sd, "prior_emb.2")
    enc = p["encoder"]
    if "Dense_0" in enc:  # the toy's MLPEncoder, Linears at encoder.{2i}
        for i in range(len(enc)):
            _dense(enc[f"Dense_{i}"], sd, f"encoder.{2 * i}")
    else:
        _encoder_state(enc, sd, "encoder.net")
    return sd


def _torch(sd: StateDict) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32, order="C")) for k, v in sd.items()}


def state_dicts_from_jax(params: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'params_g', 'params_e', 'params_q'} Flax trees (numpy leaves) ->
    {'generator', 'ebm', 'amortizer'} torch state dicts."""
    p_q = params["params_q"]
    nxemb = int(np.shape(p_q["params"]["prior_emb"]["Dense_1"]["kernel"])[1])
    out = {
        "generator": _torch(generator_state(params["params_g"])),
        "amortizer": _torch(amortizer_state(p_q, nxemb)),
    }
    if params.get("params_e") is not None:
        out["ebm"] = _torch(ebm_state(params["params_e"]))
    return out


def load_state_dicts(models, sds: Mapping[str, Mapping[str, torch.Tensor]]) -> None:
    """Strictly load {'generator', 'ebm', 'amortizer'} state dicts."""
    models.generator.load_state_dict(sds["generator"], strict=True)
    models.amortizer.load_state_dict(sds["amortizer"], strict=True)
    if models.ebm is not None:
        models.ebm.load_state_dict(sds["ebm"], strict=True)


def load_reference_checkpoint(models, path: str) -> int:
    """Load a reference-format `.pth.tar` (G/E/Q state dicts) strictly into
    `models`; returns its `iter`."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    load_state_dicts(
        models,
        {"generator": ckpt["G_state_dict"], "amortizer": ckpt["Q_state_dict"],
         "ebm": ckpt.get("E_state_dict")},
    )
    return int(ckpt.get("iter", 0))


def _adam_state(opt_state):
    """The optax `ScaleByAdamState` (count, mu, nu) inside a chained state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def _load_adam(opt, module: torch.nn.Module, sd_fn, opt_state) -> None:
    """Moments of one optax Adam state into `opt` (a `ClippedAdam` over
    `module.parameters()`), through the weights' own key map and layouts."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no optax Adam state (mu, nu, count) found")
    mu, nu = _torch(sd_fn(adam.mu)), _torch(sd_fn(adam.nu))
    count = int(np.asarray(adam.count))
    for name, p in module.named_parameters():
        opt.opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name].to(p.device),
            "exp_avg_sq": nu[name].to(p.device),
        }
    opt.count = count


def train_state_from_jax(
    state, cfg: Config, seed: int = 0, device: Optional[Union[str, torch.device]] = None
):
    """A JAX `DAMCState` with numpy leaves (params_g/e/q, params_q_ema,
    step, opt_g/e/q) -> a port `TrainState` on `device` (default CUDA)
    that continues it: the weights, Q_ema, the iteration count and each
    optimizer's Adam moments and update count. A toy state has no E and
    trains only Q. The JAX PRNG key has no torch counterpart: the port's
    generator is seeded with `seed`."""
    from .train.state import create_state

    port = create_state(cfg, seed, device)
    m = port.models
    params_q = state.params_q
    nxemb = int(np.shape(params_q["params"]["prior_emb"]["Dense_1"]["kernel"])[1])
    load_state_dicts(m, state_dicts_from_jax(
        {"params_g": state.params_g, "params_e": state.params_e, "params_q": params_q}
    ))
    ema = _torch(amortizer_state(state.params_q_ema, nxemb))
    port.amortizer_ema.load_state_dict(ema, strict=True)
    amort_sd = lambda tree: {k: v for k, v in amortizer_state(tree, nxemb).items() if k != "xemb"}
    if port.opts.g is not None:
        _load_adam(port.opts.g, m.generator, generator_state, state.opt_g)
    if port.opts.e is not None:
        _load_adam(port.opts.e, m.ebm, ebm_state, state.opt_e)
    _load_adam(port.opts.q, m.amortizer, amort_sd, state.opt_q)
    port.step = int(np.asarray(state.step))
    return port
