"""InceptionV3 pool3 feature extractor for FID (counterpart of
`damc_tpu/models/inception.py`).

torchvision's inception_v3 graph with pytorch-fid's three deviations:
(a) the InceptionA/C/E average-pool branches exclude the padding from the
count, (b) Mixed_7c's pool branch is a 3x3 stride-1 max pool, (c) no
classifier: the features are the 2048-d global average ("pool3"). Each
BasicConv2d is a bias-free conv, then BatchNorm folded into a per-channel
scale and offset (scale = gamma / sqrt(var + 1e-3), offset = beta - mean
scale), then ReLU, as `convert_torch_state_dict` folds pytorch-fid's
checkpoint.

The module computes NCHW; `forward` takes images NHWC (B, H, W, C) in
[0, 1] (gray is repeated to RGB), resizes them to 299x299 by
`F.interpolate(bilinear, align_corners=False, antialias=False)`, which is
pytorch-fid's resize and equals JAX's `jax.image.resize(bilinear)` when
upsampling (both sample at pixel centres and clamp at the edges), and maps
them to [-1, 1].

Parameters are held as a dict {block: {branch: {kernel (HWIO), scale,
offset}}} in numpy, the JAX package's layout, so `init_random_params`
draws the same numbers from the same numpy stream and a converted
checkpoint loads into both packages.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 0.001

WEIGHTS_ENV_VAR = "DAMC_INCEPTION_WEIGHTS"
DEFAULT_WEIGHTS_PATHS = (
    os.path.expanduser("~/.cache/damc/pt_inception-2015-12-05-6726825d.pth"),
    os.path.expanduser("~/.cache/torch/hub/checkpoints/pt_inception-2015-12-05-6726825d.pth"),
)


def _a_spec(cin, pool):
    return {
        "branch1x1": (cin, 64, 1, 1),
        "branch5x5_1": (cin, 48, 1, 1),
        "branch5x5_2": (48, 64, 5, 5),
        "branch3x3dbl_1": (cin, 64, 1, 1),
        "branch3x3dbl_2": (64, 96, 3, 3),
        "branch3x3dbl_3": (96, 96, 3, 3),
        "branch_pool": (cin, pool, 1, 1),
    }


def _b_spec(cin):
    return {
        "branch3x3": (cin, 384, 3, 3),
        "branch3x3dbl_1": (cin, 64, 1, 1),
        "branch3x3dbl_2": (64, 96, 3, 3),
        "branch3x3dbl_3": (96, 96, 3, 3),
    }


def _c_spec(cin, c7):
    return {
        "branch1x1": (cin, 192, 1, 1),
        "branch7x7_1": (cin, c7, 1, 1),
        "branch7x7_2": (c7, c7, 1, 7),
        "branch7x7_3": (c7, 192, 7, 1),
        "branch7x7dbl_1": (cin, c7, 1, 1),
        "branch7x7dbl_2": (c7, c7, 7, 1),
        "branch7x7dbl_3": (c7, c7, 1, 7),
        "branch7x7dbl_4": (c7, c7, 7, 1),
        "branch7x7dbl_5": (c7, 192, 1, 7),
        "branch_pool": (cin, 192, 1, 1),
    }


def _d_spec(cin):
    return {
        "branch3x3_1": (cin, 192, 1, 1),
        "branch3x3_2": (192, 320, 3, 3),
        "branch7x7x3_1": (cin, 192, 1, 1),
        "branch7x7x3_2": (192, 192, 1, 7),
        "branch7x7x3_3": (192, 192, 7, 1),
        "branch7x7x3_4": (192, 192, 3, 3),
    }


def _e_spec(cin):
    return {
        "branch1x1": (cin, 320, 1, 1),
        "branch3x3_1": (cin, 384, 1, 1),
        "branch3x3_2a": (384, 384, 1, 3),
        "branch3x3_2b": (384, 384, 3, 1),
        "branch3x3dbl_1": (cin, 448, 1, 1),
        "branch3x3dbl_2": (448, 384, 3, 3),
        "branch3x3dbl_3a": (384, 384, 1, 3),
        "branch3x3dbl_3b": (384, 384, 3, 1),
        "branch_pool": (cin, 192, 1, 1),
    }


# (cin, cout, kh, kw) of every BasicConv2d, in pytorch-fid's module order.
ARCH_SPEC = {
    "Conv2d_1a_3x3": (3, 32, 3, 3),
    "Conv2d_2a_3x3": (32, 32, 3, 3),
    "Conv2d_2b_3x3": (32, 64, 3, 3),
    "Conv2d_3b_1x1": (64, 80, 1, 1),
    "Conv2d_4a_3x3": (80, 192, 3, 3),
    "Mixed_5b": _a_spec(192, 32),
    "Mixed_5c": _a_spec(256, 64),
    "Mixed_5d": _a_spec(288, 64),
    "Mixed_6a": _b_spec(288),
    "Mixed_6b": _c_spec(768, 128),
    "Mixed_6c": _c_spec(768, 160),
    "Mixed_6d": _c_spec(768, 160),
    "Mixed_6e": _c_spec(768, 192),
    "Mixed_7a": _d_spec(768),
    "Mixed_7b": _e_spec(1280),
    "Mixed_7c": _e_spec(2048),
}


class BasicConv(nn.Module):
    """Bias-free conv, folded BN, ReLU. `padding` is 'valid' or 'same'
    (stride 1, odd kernels: (k - 1) / 2 on each side)."""

    def __init__(self, spec, stride: int = 1, padding: str = "valid"):
        super().__init__()
        cin, cout, kh, kw = spec
        self.stride = stride
        self.pad = (0, 0) if padding == "valid" else ((kh - 1) // 2, (kw - 1) // 2)
        self.register_buffer("weight", torch.zeros(cout, cin, kh, kw))
        self.register_buffer("scale", torch.ones(cout))
        self.register_buffer("offset", torch.zeros(cout))

    def load(self, leaf: Dict[str, np.ndarray]) -> None:
        with torch.no_grad():
            kernel = torch.from_numpy(np.array(leaf["kernel"], np.float32))  # HWIO
            self.weight.copy_(kernel.permute(3, 2, 0, 1))
            self.scale.copy_(torch.from_numpy(np.array(leaf["scale"], np.float32)))
            self.offset.copy_(torch.from_numpy(np.array(leaf["offset"], np.float32)))

    def forward(self, x):
        y = F.conv2d(x, self.weight, stride=self.stride, padding=self.pad)
        return torch.relu(y * self.scale[:, None, None] + self.offset[:, None, None])


def _avg_pool_excl_pad(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


class _Block(nn.Module):
    def __init__(self, spec, same=(), stride2=()):
        super().__init__()
        for name, s in spec.items():
            self.add_module(
                name, BasicConv(s, 2 if name in stride2 else 1, "same" if name in same else "valid")
            )


class InceptionA(_Block):
    def __init__(self, spec):
        super().__init__(spec, same=("branch5x5_2", "branch3x3dbl_2", "branch3x3dbl_3"))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_excl_pad(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(_Block):
    def __init__(self, spec):
        super().__init__(spec, same=("branch3x3dbl_2",), stride2=("branch3x3", "branch3x3dbl_3"))

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(_Block):
    def __init__(self, spec):
        super().__init__(spec, same=(
            "branch7x7_2", "branch7x7_3", "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4",
            "branch7x7dbl_5",
        ))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for name in ("branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5"):
            bd = getattr(self, name)(bd)
        bp = self.branch_pool(_avg_pool_excl_pad(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(_Block):
    def __init__(self, spec):
        super().__init__(spec, same=("branch7x7x3_2", "branch7x7x3_3"),
                         stride2=("branch3x3_2", "branch7x7x3_4"))

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for name in ("branch7x7x3_2", "branch7x7x3_3", "branch7x7x3_4"):
            b7 = getattr(self, name)(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(_Block):
    def __init__(self, spec, pool: str):
        super().__init__(spec, same=(
            "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_2", "branch3x3dbl_3a", "branch3x3dbl_3b",
        ))
        self.pool = pool

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        if self.pool == "max":  # FIDInceptionE_2 (Mixed_7c)
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool_excl_pad(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


def resize_299(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NCHW at 299x299, bilinear at pixel centres, edges clamped."""
    return F.interpolate(x, size=(299, 299), mode="bilinear", align_corners=False, antialias=False)


class InceptionPool3(nn.Module):
    """images (B, H, W, C) in [0, 1] -> pool3 features (B, 2048)."""

    def __init__(self, params: Optional[Dict] = None):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(ARCH_SPEC["Conv2d_1a_3x3"], stride=2)
        self.Conv2d_2a_3x3 = BasicConv(ARCH_SPEC["Conv2d_2a_3x3"])
        self.Conv2d_2b_3x3 = BasicConv(ARCH_SPEC["Conv2d_2b_3x3"], padding="same")
        self.Conv2d_3b_1x1 = BasicConv(ARCH_SPEC["Conv2d_3b_1x1"])
        self.Conv2d_4a_3x3 = BasicConv(ARCH_SPEC["Conv2d_4a_3x3"])
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            self.add_module(name, InceptionA(ARCH_SPEC[name]))
        self.Mixed_6a = InceptionB(ARCH_SPEC["Mixed_6a"])
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            self.add_module(name, InceptionC(ARCH_SPEC[name]))
        self.Mixed_7a = InceptionD(ARCH_SPEC["Mixed_7a"])
        self.Mixed_7b = InceptionE(ARCH_SPEC["Mixed_7b"], pool="avg")
        self.Mixed_7c = InceptionE(ARCH_SPEC["Mixed_7c"], pool="max")
        if params is not None:
            self.load_params(params)

    def load_params(self, params: Dict) -> None:
        """Load a params dict of the JAX package's layout (HWIO kernels)."""
        for name, spec in ARCH_SPEC.items():
            module = getattr(self, name)
            if isinstance(spec, tuple):
                module.load(params[name])
            else:
                for sub in spec:
                    getattr(module, sub).load(params[name][sub])

    def forward(self, x: torch.Tensor, resize: bool = True) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.Conv2d_1a_3x3.weight.dtype)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)  # grayscale -> RGB
        if resize:
            x = resize_299(x)
        x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))


def init_random_params(seed: int = 0) -> Dict:
    """Shape-correct random params from `np.random.RandomState(seed)`:
    kernels N(0, 0.05^2) HWIO, scale 1, offset 0, drawn in ARCH_SPEC order,
    the same numbers as the JAX package's `init_random_params(key, seed)`."""
    rng = np.random.RandomState(seed)

    def leaf(spec):
        cin, cout, kh, kw = spec
        return {
            "kernel": rng.randn(kh, kw, cin, cout).astype(np.float32) * 0.05,
            "scale": np.ones((cout,), np.float32),
            "offset": np.zeros((cout,), np.float32),
        }

    params: Dict = {}
    for name, spec in ARCH_SPEC.items():
        if isinstance(spec, tuple):
            params[name] = leaf(spec)
        else:
            params[name] = {sub: leaf(s) for sub, s in spec.items()}
    return params


def convert_torch_state_dict(state_dict) -> Dict:
    """pytorch-fid / torchvision inception state_dict -> params dict, with
    BatchNorm folded: conv OIHW -> HWIO, scale = gamma / sqrt(var + eps),
    offset = beta - mean * scale."""
    params: Dict = {}
    convs = sorted({k[: -len(".conv.weight")] for k in state_dict if k.endswith(".conv.weight")})
    for name in convs:
        w = np.asarray(state_dict[f"{name}.conv.weight"], np.float32)
        gamma = np.asarray(state_dict[f"{name}.bn.weight"], np.float32)
        beta = np.asarray(state_dict[f"{name}.bn.bias"], np.float32)
        mean = np.asarray(state_dict[f"{name}.bn.running_mean"], np.float32)
        var = np.asarray(state_dict[f"{name}.bn.running_var"], np.float32)
        scale = gamma / np.sqrt(var + BN_EPS)
        offset = beta - mean * scale
        node = params
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = {
            "kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "scale": scale,
            "offset": offset,
        }
    return params


def load_inception_params(path: Optional[str] = None) -> Dict:
    """Load and convert the pytorch-fid InceptionV3 checkpoint from `path`,
    else `$DAMC_INCEPTION_WEIGHTS`, else the default paths."""
    candidates = [path] if path else [os.environ.get(WEIGHTS_ENV_VAR), *DEFAULT_WEIGHTS_PATHS]
    for cand in candidates:
        if cand and os.path.exists(cand):
            sd = torch.load(cand, map_location="cpu", weights_only=True)
            sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
            return convert_torch_state_dict(sd)
    raise FileNotFoundError(
        f"InceptionV3 weights not found; set ${WEIGHTS_ENV_VAR} or place the "
        f"pytorch-fid checkpoint at one of {DEFAULT_WEIGHTS_PATHS}"
    )


def inception_feature_fn(params: Dict, device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """fn(images (B, H, W, C) in [0, 1]) -> pool3 features (B, 2048), with
    the network on `device`."""
    net = InceptionPool3(params).to(device).eval()

    def feature_fn(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return net(x.to(net.Conv2d_1a_3x3.weight.device))

    return feature_fn


def try_load_inception_feature_fn(
    path: Optional[str] = None, device=None
) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The pool3 feature fn on `device`, or None when no weights are on disk."""
    try:
        params = load_inception_params(path)
    except FileNotFoundError:
        return None
    return inception_feature_fn(params, device)
