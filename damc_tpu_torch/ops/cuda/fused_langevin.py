"""K1: the K-step prior-Langevin chain — wrapper, plain version, fit rule.

Counterpart of `damc_tpu/ops/pallas/fused_langevin.py`
(`fused_prior_langevin`, `ebm_params_to_dense_weights`). The kernel is
`damc_tpu_torch/csrc/fused_langevin.cu`; its source note gives the design.

`fused_prior_langevin` runs the plain PyTorch version for tensors on the CPU
and launches the kernel for tensors on a CUDA device; anything else, or a
failed build or launch, raises. `fused_prior_langevin.launches` counts the
kernel launches.

Only counter-mode noise (`row_seeds`) and noiseless chains are ported; the
TPU kernel's stream mode and its bf16 dot option come with the training
slice.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from ..noise import counter_normal
from . import build

ROWS = 4  # chains per block, kRows in the kernel
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use
_SLOPE = 0.2
_lock = threading.Lock()


def ebm_params_to_dense_weights(ebm) -> Tuple[torch.Tensor, ...]:
    """(k1 (nz, ndf), b1, k2 (ndf, ndf), b2, k3 (ndf,)) of a 2-hidden
    `LatentEBM`, kernels as contiguous x @ K float32."""
    lin = [m for m in ebm.ebm if isinstance(m, torch.nn.Linear)]
    if len(lin) != 3 or lin[2].out_features != 1:
        raise ValueError("the fused chain hand-codes the 2-hidden, 1-output EBM")
    k = lambda l: l.weight.detach().t().contiguous().float()
    b = lambda l: l.bias.detach().contiguous().float()
    return k(lin[0]), b(lin[0]), k(lin[1]), b(lin[1]), lin[2].weight.detach()[0].contiguous().float()


def smem_bytes(nz: int, ndf: int, rows: int = ROWS) -> int:
    """K2 of the EBM plus z, dU/dz, h1p, h1, d2 and d1 for each chain."""
    return 4 * (ndf * ndf + rows * (2 * nz + 4 * ndf))


def fits_smem(nz: int, ndf: int) -> bool:
    return smem_bytes(nz, ndf) <= SMEM_LIMIT


def _lrelu(x):
    return torch.where(x >= 0.0, x, _SLOPE * x)


def _dlrelu(x):
    return torch.where(x >= 0.0, 1.0, _SLOPE)


def prior_langevin_plain(
    z, k1, b1, k2, b2, k3, row_seeds=None, steps: int = 1, step_size: float = 0.1,
    with_noise: bool = True,
) -> torch.Tensor:
    """The kernel's function as a Python loop over steps (torch.matmul)."""
    coeff = 0.5 * step_size * step_size
    k3 = k3.reshape(1, -1)
    z = z.float()
    for step in range(steps):
        h1p = z @ k1 + b1
        h2p = _lrelu(h1p) @ k2 + b2
        d2 = _dlrelu(h2p) * k3
        d1 = _dlrelu(h1p) * (d2 @ k2.t())
        grad = d1 @ k1.t() + z
        z = z - coeff * grad
        if with_noise:
            z = z + step_size * counter_normal(row_seeds, step, z.shape[1])
    return z


def fused_prior_langevin(
    z, k1, b1, k2, b2, k3, row_seeds=None, steps: int = 1, step_size: float = 0.1,
    with_noise: bool = True,
) -> torch.Tensor:
    """Run the whole K-step chain z (B, nz) -> z_K on the EBM weights
    (k1, b1, k2, b2, k3) of `ebm_params_to_dense_weights`. `row_seeds` (B,)
    int32 switches on the per-row counter noise: chain i depends only on
    (row_seeds[i], z[i])."""
    if with_noise and row_seeds is None:
        raise ValueError("only counter-mode noise (row_seeds) is ported")
    if z.device.type == "cpu":
        return prior_langevin_plain(
            z, k1, b1, k2, b2, k3, row_seeds=row_seeds, steps=steps,
            step_size=step_size, with_noise=with_noise,
        )
    if z.device.type != "cuda":
        raise ValueError(f"no prior-Langevin kernel for device {z.device}")
    b, nz = z.shape
    ndf = k1.shape[1]
    if k1.shape != (nz, ndf) or k2.shape != (ndf, ndf) or b1.numel() != ndf or b2.numel() != ndf or k3.numel() != ndf:
        raise ValueError("EBM weights do not match z's width")
    if not fits_smem(nz, ndf):
        raise ValueError(f"EBM width ndf={ndf} does not fit the chain kernel's shared memory")
    dev = z.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    z32, w = f32(z), [f32(t) for t in (k1, b1, k2, b2, k3)]
    seeds = None
    if with_noise:
        seeds = torch.as_tensor(row_seeds).to(device=dev, dtype=torch.int32).contiguous()
        if seeds.shape != (b,):
            raise ValueError(f"row_seeds must be ({b},), got {tuple(seeds.shape)}")
    out = torch.empty_like(z32)
    lib = _library()
    rc = lib.damc_fused_langevin(
        z32.data_ptr(), *[t.data_ptr() for t in w],
        None if seeds is None else seeds.data_ptr(), out.data_ptr(),
        b, nz, ndf, steps, float(step_size), 0.5 * step_size * step_size,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, rc, "fused_prior_langevin")
    with _lock:
        fused_prior_langevin.launches += 1
    return out


fused_prior_langevin.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("fused_langevin")
    fn = lib.damc_fused_langevin
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
        if lib.damc_fused_langevin_rows() != ROWS:
            raise RuntimeError("fused_langevin.cu and fused_langevin.py disagree on the row tile")
        if lib.damc_fused_langevin_smem_bytes(128, 200) != smem_bytes(128, 200):
            raise RuntimeError("fused_langevin.cu and fused_langevin.py disagree on shared memory")
    return lib
