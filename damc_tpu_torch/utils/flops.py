"""Analytic FLOPs of the StyleGAN inversion batch (the port's copy of
`damc_tpu/utils/flops.py:153-190, 343-462`).

1 MAC = 2 FLOPs; elementwise work is left out; the backward pass through a
conv or matmul to its input costs its forward's MACs (only the latents
take a gradient). Convs count dense k x k taps. The fused stride-2
up-convolution counts its 4 unique taps an output pixel.
"""

from __future__ import annotations

import math
from typing import Dict

from ..models.stylegan import (
    AUTO_FUSED_MIN_RES, ENCODER_BASE, ENCODER_MAX, INIT_RES, VGG_CONVS, VGG_POOLS, W_DIM, nf,
    num_synthesis_layers,
)
from ..models.amortizer import STYLEGAN_WIDTHS


def _csl_dims(nz: int, widths):
    narrow, wide = widths
    return [(2 * nz, narrow), (narrow, wide), (wide, wide), (wide, wide),
            (2 * wide, wide), (2 * wide, narrow), (2 * narrow, nz)]


def denoiser_fwd_flops(nz: int, widths) -> float:
    """One eps-prediction on the hoisted path, per sample: the FiLM gate and
    bias products (dout^2 each), the x products (din dout each) of every
    layer, and the Fourier projection."""
    mac = sum(2 * di * do + 2 * do * do for di, do in _csl_dims(nz, widths))
    return 2.0 * (mac + nz * (nz // 2))


def denoiser_sweep_setup_flops(nz: int, nxemb: int, ntemb: int, n_steps: int, widths):
    """(per sample, per sweep) FLOPs of `sample_tables`: SiLU(xemb) Kx once
    a sample; the temb MLP and SiLU(temb) Kt over the step grid."""
    outs = [do for _, do in _csl_dims(nz, widths)]
    return 2.0 * nxemb * sum(outs), 2.0 * n_steps * (ntemb * sum(outs) + 2 * ntemb * ntemb)


def _epilogue_flops(c: int) -> float:
    return 2.0 * W_DIM * 2 * c  # the style dense (W_DIM -> 2C)


def synthesis_fwd_flops(resolution: int = 256) -> float:
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


def encoder_fwd_flops(resolution: int = 256) -> float:
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
    g_fwd, v_fwd, enc_fwd = synthesis_fwd_flops(resolution), vgg16_fwd_flops(resolution), encoder_fwd_flops(resolution)
    den_fwd = denoiser_fwd_flops(nz, STYLEGAN_WIDTHS)
    per_sample, per_grid = denoiser_sweep_setup_flops(nz, nz, ntemb, q_steps, STYLEGAN_WIDTHS)
    parts = {
        "encoder": batch * enc_fwd,
        "sweep": batch * (q_steps * den_fwd + per_sample) + per_grid,
        "feat_x": batch * v_fwd,
        "adam": batch * adam_steps * 2.0 * (g_fwd + v_fwd),
        "rescue_final": batch * 2.0 * g_fwd,
    }
    parts["total"] = sum(parts.values())
    return parts
