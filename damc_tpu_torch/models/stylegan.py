"""StyleGAN-1 stack of the inversion workload, as `nn.Module`s in NCHW.

Counterpart of `damc_tpu/models/stylegan.py`:

  * `StyleGANGenerator`: mapping (8 equalized-lr dense layers at lr_mul
    0.01, pixel norm on the input), truncation (psi 0.7 over the first 8
    of the W+ layers, `w_avg` buffer) and synthesis (4 -> resolution: AdaIN
    epilogues, fixed noise buffers, blur, the fused up-convolution at
    res >= 128, toRGB and the final tanh);
  * `StyleGANEncoder`: the inversion encoder, image -> flat W+ code
    (B, L*512), a residual pyramid with BatchNorm in inference mode;
  * `VGG16Features`: VGG16 with Keras preprocessing, cut at block4_conv3.

State-dict keys are exactly the ones the JAX converters read from the
published `.pth` files (`damc_tpu/models/stylegan.py:350-445`), so
`load_stylegan` takes those files and the JAX converters take these
modules' state dicts. The equalized-lr constants (gain / sqrt(fan_in) and
lr_mul) are applied in the forward passes, as the checkpoints store the
unscaled weights. Every module is built frozen (eval mode, no parameter
requires grad): the inversion differentiates the latents only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

W_DIM = 512
INIT_RES = 4
FMAPS_BASE = 16 << 10
FMAPS_MAX = 512
AUTO_FUSED_MIN_RES = 128
TRUNCATION_PSI = 0.7
TRUNCATION_LAYERS = 8
MAPPING_LAYERS = 8
MAPPING_LR_MUL = 0.01
GAIN = math.sqrt(2.0)
ENCODER_BASE, ENCODER_MAX = 64, 1024  # the inversion encoder's channels: 64, doubling to 1024
VGG_CONVS = {  # block1_conv1 .. block4_conv3 at their reference layer indices: (cin, cout)
    0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128), 10: (128, 256), 12: (256, 256),
    14: (256, 256), 17: (256, 512), 19: (512, 512), 21: (512, 512),
}
VGG_POOLS = (4, 9, 16)  # max-pool layer indices before layer 21
VGG_MEAN_BGR = (103.939, 116.779, 123.68)
_BLUR = np.outer([1.0, 2.0, 1.0], [1.0, 2.0, 1.0]) / 16.0


def nf(res: int) -> int:
    return min(FMAPS_BASE // res, FMAPS_MAX)


def num_synthesis_layers(resolution: int) -> int:
    return int(np.log2(resolution // INIT_RES * 2)) * 2


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class _Bias(nn.Module):
    """A bias vector under the reference's `wscale.bias` key."""

    def __init__(self, c: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(c))


class _Weight(nn.Module):
    """A bias-free layer's weight under the reference's `conv.weight` or
    `fc.weight` key."""

    def __init__(self, *shape: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(shape))


class EqualizedDense(nn.Module):
    """y = x W^T gain / sqrt(fan_in) lr_mul + b lr_mul, LeakyReLU(0.2) when
    `act` (the reference's DenseBlock + WScaleLayer)."""

    def __init__(self, din: int, dout: int, gain: float = GAIN, lr_mul: float = MAPPING_LR_MUL,
                 act: bool = True):
        super().__init__()
        self.fc = _Weight(dout, din)
        self.wscale = _Bias(dout)
        self.scale = gain / math.sqrt(din) * lr_mul
        self.lr_mul, self.act = lr_mul, act

    def forward(self, x):
        y = (x @ self.fc.weight.t()) * self.scale + self.wscale.bias * self.lr_mul
        return _lrelu(y) if self.act else y


class MappingNet(nn.Module):
    """z (B, 512) -> w (B, L*512): pixel norm, then 8 dense layers."""

    def __init__(self, n_layers: int):
        super().__init__()
        for i in range(MAPPING_LAYERS):
            dout = W_DIM * n_layers if i == MAPPING_LAYERS - 1 else W_DIM
            self.add_module(f"dense{i}", EqualizedDense(W_DIM, dout))

    def forward(self, z):
        w = z * torch.rsqrt(torch.mean(z * z, dim=-1, keepdim=True) + 1e-8)
        for i in range(MAPPING_LAYERS):
            w = getattr(self, f"dense{i}")(w)
        return w


class Truncation(nn.Module):
    """w (B, L*512) -> W+ (B, L, 512): w_avg + (w - w_avg) psi on the first
    8 layers."""

    def __init__(self, n_layers: int):
        super().__init__()
        self.n_layers = n_layers
        self.register_buffer("w_avg", torch.zeros(W_DIM))
        coefs = torch.ones(1, n_layers, 1)
        coefs[:, :TRUNCATION_LAYERS] *= TRUNCATION_PSI
        self.register_buffer("coefs", coefs, persistent=False)

    def forward(self, w):
        w = w.reshape(-1, self.n_layers, W_DIM)
        w_avg = self.w_avg.reshape(1, 1, W_DIM)
        return w_avg + (w - w_avg) * self.coefs


class _NoiseInput(nn.Module):
    """The fixed noise map (1, 1, res, res) and its per-channel weight."""

    def __init__(self, res: int, c: int):
        super().__init__()
        self.register_buffer("noise", torch.zeros(1, 1, res, res))
        self.weight = nn.Parameter(torch.zeros(c))


class _StyleMod(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.dense = EqualizedDense(W_DIM, 2 * c, gain=1.0, lr_mul=1.0, act=False)


class Epilogue(nn.Module):
    """noise -> bias -> LeakyReLU(0.2) -> instance norm (eps 1e-8, biased
    variance over H x W) -> AdaIN x (s0 + 1) + s1, s = dense(w)."""

    def __init__(self, res: int, c: int):
        super().__init__()
        self.apply_noise = _NoiseInput(res, c)
        self.bias = nn.Parameter(torch.zeros(c))
        self.style_mod = _StyleMod(c)

    def forward(self, x, w):
        c = x.shape[1]
        x = x + self.apply_noise.noise * self.apply_noise.weight.view(1, c, 1, 1)
        x = _lrelu(x + self.bias.view(1, c, 1, 1))
        x = x - torch.mean(x, dim=(2, 3), keepdim=True)
        x = x * torch.rsqrt(torch.mean(x * x, dim=(2, 3), keepdim=True) + 1e-8)
        s = self.style_mod.dense(w).view(-1, 2, c, 1, 1)
        return x * (s[:, 0] + 1.0) + s[:, 1]


class _ConstBlock(nn.Module):
    """layer0: the learned 4x4 constant and its epilogue."""

    def __init__(self, c: int):
        super().__init__()
        self.const = nn.Parameter(torch.zeros(1, c, INIT_RES, INIT_RES))
        self.epilogue = Epilogue(INIT_RES, c)

    def forward(self, b: int, w):
        return self.epilogue(self.const.expand(b, -1, -1, -1), w)


class _ConvBlock(nn.Module):
    """3x3 conv at sqrt(2) / sqrt(9 cin), then the epilogue."""

    def __init__(self, res: int, cin: int, cout: int):
        super().__init__()
        self.conv = _Weight(cout, cin, 3, 3)
        self.scale = GAIN / math.sqrt(9 * cin)
        self.epilogue = Epilogue(res, cout)

    def forward(self, x, w):
        return self.epilogue(F.conv2d(x, self.conv.weight, padding=1) * self.scale, w)


class _UpConvBlock(nn.Module):
    """Upsample by 2 and 3x3 conv, then blur and the epilogue. Below 128:
    nearest upsampling, then the conv. From 128 on (fused): the weight,
    stored (3, 3, cin, cout), scaled, padded and folded to a 4x4 kernel for
    a stride-2 transposed convolution."""

    def __init__(self, res: int, cin: int, cout: int):
        super().__init__()
        self.fused = res >= AUTO_FUSED_MIN_RES
        if self.fused:
            self.weight = nn.Parameter(torch.zeros(3, 3, cin, cout))
        else:
            self.conv = _Weight(cout, cin, 3, 3)
        self.scale = GAIN / math.sqrt(9 * cin)
        self.epilogue = Epilogue(res, cout)
        blur = torch.tensor(_BLUR, dtype=torch.float32).expand(cout, 1, 3, 3).contiguous()
        self.register_buffer("blur", blur, persistent=False)  # [1 2 1]^2 / 16, depthwise

    def forward(self, x, w):
        if self.fused:
            k = F.pad(self.weight * self.scale, (0, 0, 0, 0, 1, 1, 1, 1))
            k = k[1:, 1:] + k[:-1, 1:] + k[1:, :-1] + k[:-1, :-1]  # (4, 4, cin, cout)
            x = F.conv_transpose2d(x, k.permute(2, 3, 0, 1), stride=2, padding=1)
        else:
            n, c, h, wd = x.shape  # nearest upsampling; its backward is a plain sum, deterministic on CUDA
            x = x[:, :, :, None, :, None].expand(n, c, h, 2, wd, 2).reshape(n, c, 2 * h, 2 * wd)
            x = F.conv2d(x, self.conv.weight, padding=1) * self.scale
        x = F.conv2d(x, self.blur, padding=1, groups=x.shape[1])
        return self.epilogue(x, w)


class _ToRGB(nn.Module):
    """1x1 conv at 1 / sqrt(cin), plus the bias."""

    def __init__(self, cin: int):
        super().__init__()
        self.conv = _Weight(3, cin, 1, 1)
        self.bias = nn.Parameter(torch.zeros(3))
        self.scale = 1.0 / math.sqrt(cin)

    def forward(self, x):
        return F.conv2d(x, self.conv.weight) * self.scale + self.bias.view(1, 3, 1, 1)


class SynthesisNet(nn.Module):
    """W+ (B, L, 512) -> image (B, 3, res, res) in [-1, 1] (the full-
    resolution path: only the last toRGB runs)."""

    def __init__(self, resolution: int):
        super().__init__()
        self.final_log2 = int(np.log2(resolution))
        for res_log2 in range(2, self.final_log2 + 1):
            res, b = 2**res_log2, res_log2 - 2
            if res == INIT_RES:
                self.add_module("layer0", _ConstBlock(nf(res)))
            else:
                self.add_module(f"layer{2 * b}", _UpConvBlock(res, nf(res // 2), nf(res)))
            self.add_module(f"layer{2 * b + 1}", _ConvBlock(res, nf(res), nf(res)))
            self.add_module(f"output{b}", _ToRGB(nf(res)))

    def forward(self, wp):
        x = self.layer0(wp.shape[0], wp[:, 0])
        x = self.layer1(x, wp[:, 1])
        for b in range(1, self.final_log2 - 1):
            x = getattr(self, f"layer{2 * b}")(x, wp[:, 2 * b])
            x = getattr(self, f"layer{2 * b + 1}")(x, wp[:, 2 * b + 1])
        return torch.tanh(getattr(self, f"output{self.final_log2 - 2}")(x))


class StyleGANGenerator(nn.Module):
    def __init__(self, resolution: int = 256):
        super().__init__()
        self.resolution = resolution
        self.n_layers = num_synthesis_layers(resolution)
        self.mapping = MappingNet(self.n_layers)
        self.truncation = Truncation(self.n_layers)
        self.synthesis = SynthesisNet(resolution)

    def forward(self, z_flat):
        """The DAMC G: flat W+ codes (B, L*512) -> synthesis only."""
        return self.synthesis(z_flat.reshape(-1, self.n_layers, W_DIM))


def generator_apply(generator: StyleGANGenerator, z_flat: torch.Tensor) -> torch.Tensor:
    """Flat W+ codes (B, L*512) -> images (B, 3, res, res), mapping and
    truncation bypassed (`damc_tpu/models/stylegan.py:220-225`)."""
    return generator(z_flat)


def sample_w_codes(generator: StyleGANGenerator, normals: torch.Tensor) -> torch.Tensor:
    """Truncated W+ codes of the normals (B, 512) through mapping and
    truncation, flat (B, L*512) (`damc_tpu/models/stylegan.py:228-238`)."""
    wp = generator.truncation(generator.mapping(normals))
    return wp.reshape(normals.shape[0], -1)


class _BatchNorm(nn.Module):
    """Inference-mode batch norm from running statistics (eps 1e-5), in
    every mode: x (weight / sqrt(var + eps)) + (bias - mean scale)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * scale
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return x * scale.view(shape) + shift.view(shape)


class _BNLayer(nn.Module):
    """The reference's BatchNormLayer wrapper (keys `<name>.bn.*`)."""

    def __init__(self, c: int):
        super().__init__()
        self.bn = _BatchNorm(c)

    def forward(self, x):
        return self.bn(x)


class _FirstBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _Weight(cout, cin, 3, 3)
        self.bn = _BNLayer(cout)

    def forward(self, x):
        return _lrelu(self.bn(F.conv2d(x, self.conv.weight, padding=1)))


class _ResBlock(nn.Module):
    """[1x1 conv + BN shortcut when the width changes] + two 3x3 conv +
    bias + BN + LeakyReLU; the conv biases are the reference's `wscale`
    biases, taken verbatim."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        hidden = min(cin, cout)
        self.shortcut = cin != cout
        if self.shortcut:
            self.conv = _Weight(cout, cin, 1, 1)
            self.bn = _BNLayer(cout)
        self.conv1, self.wscale1, self.bn1 = _Weight(hidden, cin, 3, 3), _Bias(hidden), _BNLayer(hidden)
        self.conv2, self.wscale2, self.bn2 = _Weight(cout, hidden, 3, 3), _Bias(cout), _BNLayer(cout)

    def forward(self, x):
        y = _lrelu(self.bn(F.conv2d(x, self.conv.weight))) if self.shortcut else x
        h = F.conv2d(x, self.conv1.weight, padding=1) + self.wscale1.bias.view(1, -1, 1, 1)
        h = _lrelu(self.bn1(h))
        h = F.conv2d(h, self.conv2.weight, padding=1) + self.wscale2.bias.view(1, -1, 1, 1)
        return _lrelu(self.bn2(h)) + y


class _LastBlock(nn.Module):
    """Flatten (NCHW order) -> dense at 1 / sqrt(fan_in), no bias -> BN."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.fc = _Weight(cout, cin)
        self.bn = _BNLayer(cout)
        self.scale = 1.0 / math.sqrt(cin)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        return self.bn((x @ self.fc.weight.t()) * self.scale)


class StyleGANEncoder(nn.Module):
    """Image (B, 3, res, res) in [-1, 1] -> flat W+ code (B, L*512)."""

    def __init__(self, resolution: int = 256):
        super().__init__()
        self.num_blocks = int(np.log2(resolution))
        cin, cout = 3, ENCODER_BASE
        for i in range(self.num_blocks):
            if i == 0:
                self.add_module("block0", _FirstBlock(cin, cout))
            elif i == self.num_blocks - 1:
                cin, cout = cin * INIT_RES * INIT_RES, W_DIM * 2 * i
                self.add_module(f"block{i}", _LastBlock(cin, cout))
            else:
                self.add_module(f"block{i}", _ResBlock(cin, cout))
            cin, cout = cout, min(cout * 2, ENCODER_MAX)

    def forward(self, x):
        for i in range(self.num_blocks):
            if 0 < i < self.num_blocks - 1:
                x = F.avg_pool2d(x, 2)
            x = getattr(self, f"block{i}")(x)
        return x


class VGG16Features(nn.Module):
    """Images (B, 3, H, W) RGB in [-1, 1] -> block4_conv3 ReLU features
    (B, 512, H/8, W/8): [0, 255], BGR, minus the BGR mean, then 10 ReLU
    convs and 3 max-pools."""

    def __init__(self):
        super().__init__()
        for idx, (cin, cout) in VGG_CONVS.items():
            self.add_module(f"layer{idx}", nn.Conv2d(cin, cout, 3, padding=1))
        self.register_buffer("mean_bgr", torch.tensor(VGG_MEAN_BGR).view(1, 3, 1, 1), persistent=False)

    def forward(self, x):
        x = (x + 1.0) * (255.0 / 2.0)
        x = x.flip(1) - self.mean_bgr
        for idx in range(max(VGG_CONVS) + 1):
            if idx in VGG_POOLS:
                x = F.max_pool2d(x, 2)
            elif idx in VGG_CONVS:
                x = F.relu(getattr(self, f"layer{idx}")(x))
        return x


@dataclass
class StyleGANNets:
    """The frozen networks of the inversion workload; a part not loaded is
    None."""

    generator: Optional[StyleGANGenerator] = None
    encoder: Optional[StyleGANEncoder] = None
    vgg: Optional[VGG16Features] = None


def _freeze(module: nn.Module, device) -> nn.Module:
    return module.to(device).eval().requires_grad_(False)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from `generator`, scaled so that activations stay of
    order one: standard normals for the equalized-lr weights (over lr_mul
    for the mapping's), He normals for the encoder's and VGG's convs, a
    tenth of a normal for biases, noise weights and w_avg, unit normals
    for the noise maps and the constant, BN statistics near the identity."""
    for name, t in module.state_dict(keep_vars=True).items():
        leaf = name.rsplit(".", 1)[-1]
        normal = lambda: torch.randn(t.shape, generator=generator)
        if leaf in ("running_var",):
            t.copy_(0.5 + torch.rand(t.shape, generator=generator))
        elif leaf in ("running_mean", "bias", "w_avg") or name.endswith("apply_noise.weight"):
            t.copy_(0.1 * normal())
        elif name.endswith("bn.weight"):
            t.copy_(1.0 + 0.1 * normal())
        elif isinstance(module, (StyleGANEncoder, VGG16Features)) and t.ndim == 4:
            t.copy_(normal() * math.sqrt(2.0 / (t.shape[1] * t.shape[2] * t.shape[3])))
        elif name.startswith("mapping."):
            t.copy_(normal() / MAPPING_LR_MUL)
        elif t.is_floating_point() and t.ndim > 0:
            t.copy_(normal())
    return module


def build_stylegan(
    resolution: int = 256, seed: int = 0, device: Optional[Union[str, torch.device]] = None
) -> StyleGANNets:
    """The three networks with random weights drawn on the CPU from a
    generator seeded with `seed` (`init_random_`), frozen on `device`
    (default CUDA)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    nets = [init_random_(m, gen) for m in (StyleGANGenerator(resolution), StyleGANEncoder(resolution),
                                           VGG16Features())]
    return StyleGANNets(*(_freeze(m, dev) for m in nets))


def _take(module: nn.Module, sd, what: str, path: str) -> nn.Module:
    """Load from `sd` exactly the keys `module` holds (the JAX converter's
    keys); a missing one raises, and the names of the keys not taken are
    printed on one line."""
    want = module.state_dict()
    missing = [k for k in want if k not in sd]
    if missing:
        raise KeyError(f"{path}: the {what} checkpoint lacks {len(missing)} keys, e.g. {missing[:5]}")
    extra = sorted(k for k in sd if k not in want)
    if extra:
        print(f"[damc] {what} ({path}): {len(extra)} keys not taken: {' '.join(extra)}")
    module.load_state_dict({k: sd[k] for k in want}, strict=True)
    return module


def load_stylegan(
    generator_path: Optional[str] = None,
    encoder_path: Optional[str] = None,
    vgg_path: Optional[str] = None,
    resolution: int = 256,
    device: Optional[Union[str, torch.device]] = None,
) -> StyleGANNets:
    """The published `.pth` state dicts (`styleganinv_ffhq256_generator.pth`,
    `styleganinv_ffhq256_encoder.pth`, `vgg16.pth`) loaded into frozen
    modules on `device` (default CUDA); each path left out gives None."""
    from ..device import resolve_device

    dev = resolve_device(device)
    out = StyleGANNets()
    for field, path, make in (
        ("generator", generator_path, lambda: StyleGANGenerator(resolution)),
        ("encoder", encoder_path, lambda: StyleGANEncoder(resolution)),
        ("vgg", vgg_path, VGG16Features),
    ):
        if path:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            setattr(out, field, _freeze(_take(make(), sd, field, path), dev))
    return out
