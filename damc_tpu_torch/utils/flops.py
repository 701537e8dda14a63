"""Analytic FLOPs of the port's workloads (the port's copy of
`damc_tpu/utils/flops.py`, with JAX's function names and signatures).

The gen_recon half (`train_step_flops`, `sampling_phase_flops` and the
per-network counts under them) counts one training iteration from the same
layer specs the port's models are built from (`models/generators.py::
generator_spec`, `models/encoders.py::encoder_spec`, the denoiser's
widths); the StyleGAN half counts one `invert_batch`. A profiler's FLOP
count cannot stand in for it: the sweep and the chains are Python loops
of many small products, and the kernels K1 and K2 are custom ops that no
counter sees. `counted_flops` (torch's `FlopCounterMode`) cross-checks the
counts on single, unlooped applies, as JAX's `xla_cost_flops` does.
`peak_flops` is the table of the card's peak rates, the one source of
every share of peak the port reports.

Conventions: 1 MAC = 2 FLOPs; elementwise and activation work is left out
(under 2% of the conv and matmul work at these shapes); the backward pass
through a conv or matmul to its input costs its forward's MACs (the
sampling phase takes gradients in z only), and a parameter update costs a
full backward (fwd + bwd = 3x the forward's MACs). Convs count dense k x k
taps; a ConvTranspose counts its exact taps (edge clipping included), and
the StyleGAN's fused stride-2 up-convolution its 4 unique taps an output
pixel.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

from ..models.amortizer import STYLEGAN_WIDTHS
from ..models.encoders import encoder_spec
from ..models.generators import generator_spec
from ..models.stylegan import (
    AUTO_FUSED_MIN_RES, ENCODER_BASE, ENCODER_MAX, INIT_RES, VGG_CONVS, VGG_POOLS, W_DIM, nf,
    num_synthesis_layers,
)

# Dense peak FLOP/s of one card by a substring of its name, by dtype (NVIDIA's
# data sheet, H100 SXM at its 700 W limit: float32 outside the tensor cores;
# bfloat16 on the tensor cores, without sparsity).
PEAK_FLOPS_BY_DEVICE = {
    "H100": {"float32": 67e12, "bfloat16": 989e12},
}


def peak_flops(device_name: str, dtype: str = "float32") -> Optional[float]:
    """The card's dense peak FLOP/s in `dtype` ("float32" or "bfloat16"),
    from `torch.cuda.get_device_name()`; None for a card not in the table."""
    for key, peaks in PEAK_FLOPS_BY_DEVICE.items():
        if key.lower() in device_name.lower():
            return peaks[dtype]
    return None


def counted_flops(fn: Callable, *args) -> float:
    """The FLOPs torch's `FlopCounterMode` counts for one call fn(*args).
    It counts the matmuls and convolutions dispatched, each once: valid as
    a cross-check on single, unlooped applies only."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def _out_hw(size: int, kernel: int, stride: int, padding) -> int:
    """Output spatial size of a conv layer as encoder_spec encodes it."""
    if padding == "SAME":
        return -(-size // stride)
    if padding == "VALID":
        return (size - kernel) // stride + 1
    p = padding if isinstance(padding, int) else padding[0]  # the explicit k=4, s=2, p=1 case
    return (size + 2 * p - kernel) // stride + 1


def conv_fwd_flops(h: int, w: int, cin: int, cout: int, k: int, stride: int, padding) -> Tuple[float, int]:
    """(FLOPs for one image, out_size) of a dense conv layer."""
    oh = _out_hw(h, k, stride, padding)
    return 2.0 * oh * oh * k * k * cin * cout, oh


def _convt_taps_1d(h: int, k: int, stride: int, pad: int, out: int) -> int:
    """Exact per-dimension tap count of a ConvTranspose: for each output o,
    the kernel taps ki with (o + pad - ki) % stride == 0 and
    0 <= (o + pad - ki) // stride < h (edge clipping is 23% of the interior
    MACs at h=4, k=4, s=2)."""
    total = 0
    for o in range(out):
        for ki in range(k):
            j = o + pad - ki
            if j % stride == 0 and 0 <= j // stride < h:
                total += 1
    return total


def convt_fwd_flops(h: int, cin: int, cout: int, k: int, stride: int, padding: str = "SAME") -> Tuple[float, int]:
    """(FLOPs for one image, out_size) of a ConvTranspose layer, exact.
    'VALID' stride 1 is torch's pad 0 (out = h + k - 1, the 1x1 -> k first
    layer); 'SAME' stride 2, k=4 pad 1 (out = 2h); 'SAME' stride 1, k=3
    pad 1 (out = h)."""
    if padding == "VALID":
        out, pad = h + k - 1, 0
    else:
        out = stride * h
        pad = (k - stride) // 2 if stride > 1 else (k - 1) // 2
    taps = _convt_taps_1d(h, k, stride, pad, out)
    return 2.0 * taps * taps * cin * cout, out


def _mlp_flops(dims) -> float:
    return 2.0 * sum(di * do for di, do in zip(dims[:-1], dims[1:]))


def generator_fwd_flops(dataset: str, ngf: int, nc: int, nz: int) -> float:
    """One G(z) forward, per image (the toy's: its 2 -> 128^3 -> 2 MLP)."""
    if dataset == "toy":
        return _mlp_flops((nz, 128, 128, 128, nc))
    total, size, cin = 0.0, 1, nz
    for features, kernel, stride, pad in generator_spec(dataset, ngf, nc):
        f, size = convt_fwd_flops(size, cin, features, kernel, stride, pad)
        total += f
        cin = features
    return total


def encoder_fwd_flops(dataset: str, nemb: int, nif: int, image_size: int, nc: Optional[int] = None) -> float:
    """One encoder forward, per image; `nc` is the image channel count
    (cfg.model.nc), by default 1 for mnist and 3 otherwise."""
    if nc is None:
        nc = 3 if dataset != "mnist" else 1
    if dataset == "toy":  # MLPEncoder: 2 -> 128^3 -> nemb
        return _mlp_flops((nc, 128, 128, 128, nemb))
    total, size, cin = 0.0, image_size, nc
    for features, kernel, stride, padding, _norm in encoder_spec(dataset, nemb, nif):
        f, size = conv_fwd_flops(size, size, cin, features, kernel, stride, padding)
        total += f
        cin = features
    return total


def _csl_dims(nz: int, nf: int, widths=None):
    """(dim_in, dim_out) of every ConcatSquashLinear of the denoiser U-Net:
    3 in, 1 mid, 3 out."""
    narrow, wide = widths or (32 * nf, 64 * nf)
    return [(2 * nz, narrow), (narrow, wide), (wide, wide), (wide, wide),
            (2 * wide, wide), (2 * wide, narrow), (2 * narrow, nz)]


def denoiser_fwd_flops(nz: int, nxemb: int, ntemb: int, nf: int, widths=None) -> float:
    """One eps-prediction on the hoisted path (`denoise_from_tables`), per
    sample: each layer's FiLM gate and bias products (dout^2 each, on the
    step's combined context) and x products (din dout each), and the
    Fourier projection. The tables are `denoiser_sweep_setup_flops`'."""
    mac = sum(2 * di * do + 2 * do * do for di, do in _csl_dims(nz, nf, widths))
    return 2.0 * (mac + nz * (nz // 2))


def denoiser_sweep_setup_flops(nz: int, nxemb: int, ntemb: int, nf: int, n_steps: int,
                               widths=None) -> Tuple[float, float]:
    """(per sample, per sweep) FLOPs of `sample_tables`: SiLU(xemb) Kx once
    a sample; the temb MLP and SiLU(temb) Kt over the step grid, whatever
    the batch."""
    outs = [do for _, do in _csl_dims(nz, nf, widths)]
    return 2.0 * nxemb * sum(outs), 2.0 * n_steps * (ntemb * sum(outs) + 2 * ntemb * ntemb)


def ebm_fwd_flops(nz: int, ndf: int, n_hidden: int = 2) -> float:
    dims, d = [], nz
    for _ in range(n_hidden):
        dims.append((d, ndf))
        d = ndf
    dims.append((d, 1))
    return 2.0 * sum(di * do for di, do in dims)


def _prior_chain_mult(cfg) -> int:
    """Prior chains as a multiple of B: 2B gen_recon, B anomaly, 0 toy."""
    return {"double": 2, "single": 1, "none": 0}[cfg.train.prior_chains]


def sampling_phase_flops(cfg, batch: int) -> Dict[str, float]:
    """FLOPs of one iteration's sampling phase at batch B: Q_ema's sweep
    (the encoder once, n_interval denoiser evals, the tables); the
    posterior chain, g_l_steps of fwd + input-bwd of G and E (a G forward
    more a step with `remat_generator`); the prior chains, e_l_steps of
    fwd + input-bwd of E over 2B, B or no chains."""
    m, d, mc = cfg.model, cfg.diffusion, cfg.mcmc
    g_fwd = generator_fwd_flops(m.dataset, m.ngf, m.nc, m.nz)
    enc_fwd = encoder_fwd_flops(m.dataset, m.nxemb, m.nif, m.image_size, m.nc)
    den_fwd = denoiser_fwd_flops(m.nz, m.nxemb, m.ntemb, m.nf)
    setup_per_sample, setup_grid = denoiser_sweep_setup_flops(m.nz, m.nxemb, m.ntemb, m.nf, d.n_interval)
    e_fwd = ebm_fwd_flops(m.nz, m.ndf)
    g_per_step = 3.0 if cfg.train.remat_generator else 2.0
    has_ebm = cfg.train.prior_chains != "none"
    sweep = batch * (enc_fwd + d.n_interval * den_fwd + setup_per_sample) + setup_grid
    posterior = batch * mc.g_l_steps * (g_per_step * g_fwd + (2.0 * e_fwd if has_ebm else 0.0))
    prior = _prior_chain_mult(cfg) * batch * mc.e_l_steps * (2.0 * e_fwd)
    return {
        "generator_fwd_per_image": g_fwd,
        "encoder_fwd_per_image": enc_fwd,
        "denoiser_eval_per_sample": den_fwd,
        "ebm_fwd_per_sample": e_fwd,
        "sweep": sweep,
        "posterior": posterior,
        "prior": prior,
        "total": sweep + posterior + prior,
    }


def denoiser_train_fwd_flops(nz: int, nxemb: int, ntemb: int, nf: int, widths=None) -> float:
    """One full (unhoisted) denoiser eval, the Q loss's: per layer the whole
    context product ((ntemb + nxemb) x dout), the gate and bias products
    and the x products; the Fourier projection and the temb MLP."""
    nctx = nxemb + ntemb
    mac = sum(2 * di * do + 2 * do * do + nctx * do for di, do in _csl_dims(nz, nf, widths))
    mac += nz * (nz // 2) + 2 * ntemb * ntemb
    return 2.0 * mac


def prior_embed_fwd_flops(nz: int, nxemb: int, width: int = 128) -> float:
    """One PriorEmbedder forward (nz -> 128 -> nxemb)."""
    return 2.0 * (nz * width + width * nxemb)


def train_step_flops(cfg, batch: int) -> Dict[str, float]:
    """FLOPs of one training iteration (`train/step.py`) at batch B: the
    sampling phase; q_updates x the Q loss's fwd + bwd (encoder, prior
    embedder, one unhoisted denoiser eval; both mask branches with
    `q_loss_both_branches`); the G update's fwd + bwd over B (a forward
    alone where G is not trained); the E update's fwd + bwd over B and the
    prior chains."""
    m, tc = cfg.model, cfg.train
    phase = sampling_phase_flops(cfg, batch)
    enc_fwd, g_fwd, e_fwd = (phase[k] for k in (
        "encoder_fwd_per_image", "generator_fwd_per_image", "ebm_fwd_per_sample"))
    den_train = denoiser_train_fwd_flops(m.nz, m.nxemb, m.ntemb, m.nf)
    pe_fwd = prior_embed_fwd_flops(m.nz, m.nxemb)
    branches = 2 if tc.q_loss_both_branches else 1
    q_total = tc.q_updates * branches * 3.0 * batch * (enc_fwd + pe_fwd + den_train)
    g_total = (3.0 if tc.update_g else 1.0) * batch * g_fwd
    mult = _prior_chain_mult(cfg)
    e_total = 3.0 * (1 + mult) * batch * e_fwd if tc.update_e and mult > 0 else 0.0
    return {
        **{k: phase[k] for k in (
            "generator_fwd_per_image", "encoder_fwd_per_image", "denoiser_eval_per_sample",
            "ebm_fwd_per_sample")},
        "denoiser_train_eval_per_sample": den_train,
        "sampling_phase": phase["total"],
        "q_updates": q_total,
        "g_update": g_total,
        "e_update": e_total,
        "total": phase["total"] + q_total + g_total + e_total,
    }


# The StyleGAN inversion batch (`train/stylegan_inv.py::invert_batch`).


def _epilogue_flops(c: int) -> float:
    return 2.0 * W_DIM * 2 * c  # the style dense (W_DIM -> 2C)


def stylegan_synthesis_fwd_flops(resolution: int = 256) -> float:
    """One synthesis forward (W+ -> image) per image, the final toRGB only."""
    c0 = nf(INIT_RES)
    total = _epilogue_flops(c0) + 2.0 * INIT_RES**2 * 9 * c0 * c0 + _epilogue_flops(c0)
    cin = c0
    for res_log2 in range(3, int(math.log2(resolution)) + 1):
        res, cout = 2**res_log2, nf(2**res_log2)
        taps = 4 if res >= AUTO_FUSED_MIN_RES else 9
        total += 2.0 * res * res * taps * cin * cout  # up-convolution
        total += 2.0 * res * res * 9 * cout  # blur, depthwise 3x3
        total += _epilogue_flops(cout) + 2.0 * res * res * 9 * cout * cout + _epilogue_flops(cout)
        cin = cout
    return total + 2.0 * resolution * resolution * cin * 3


def stylegan_encoder_fwd_flops(resolution: int = 256) -> float:
    """One inversion-encoder forward (image -> W+) per image."""
    n_blocks = int(math.log2(resolution))
    total = 2.0 * resolution * resolution * 9 * 3 * ENCODER_BASE
    size, cin = resolution, ENCODER_BASE
    for _ in range(1, n_blocks - 1):
        size //= 2
        cout = min(cin * 2, ENCODER_MAX)
        if cout != cin:
            total += 2.0 * size * size * cin * cout
        total += 2.0 * size * size * 9 * cin * cin + 2.0 * size * size * 9 * cin * cout
        cin = cout
    return total + 2.0 * (cin * INIT_RES**2) * (num_synthesis_layers(resolution) * W_DIM)


def vgg16_fwd_flops(image_size: int = 256) -> float:
    """One VGG16 forward through block4_conv3 per image."""
    total, size = 0.0, image_size
    for idx in range(max(VGG_CONVS) + 1):
        if idx in VGG_POOLS:
            size //= 2
        elif idx in VGG_CONVS:
            cin, cout = VGG_CONVS[idx]
            total += 2.0 * size * size * 9 * cin * cout
    return total


def inversion_phase_flops(
    batch: int, resolution: int = 256, q_steps: int = 100, adam_steps: int = 100, ntemb: int = 128
) -> Dict[str, float]:
    """FLOPs of one `invert_batch`: the encoder and the q_steps sweep of the
    1024-wide Q, VGG(x) once, adam_steps of forward and input-backward of
    synthesis and VGG, the rescue probe and the final synthesis."""
    nz = num_synthesis_layers(resolution) * W_DIM
    g_fwd = stylegan_synthesis_fwd_flops(resolution)
    v_fwd, enc_fwd = vgg16_fwd_flops(resolution), stylegan_encoder_fwd_flops(resolution)
    den_fwd = denoiser_fwd_flops(nz, nz, ntemb, nf=4, widths=STYLEGAN_WIDTHS)
    per_sample, per_grid = denoiser_sweep_setup_flops(nz, nz, ntemb, nf=4, n_steps=q_steps, widths=STYLEGAN_WIDTHS)
    parts = {
        "encoder": batch * enc_fwd,
        "sweep": batch * (q_steps * den_fwd + per_sample) + per_grid,
        "feat_x": batch * v_fwd,
        "adam": batch * adam_steps * 2.0 * (g_fwd + v_fwd),
        "rescue_final": batch * 2.0 * g_fwd,
    }
    parts["total"] = sum(parts.values())
    return parts
