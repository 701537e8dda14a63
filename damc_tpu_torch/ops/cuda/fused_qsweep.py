"""K2: the n-step reverse-diffusion sweep — wrapper, plain version, fit rule.

Counterpart of `damc_tpu/ops/pallas/fused_qsweep.py` (`fused_reverse_sweep`,
`denoiser_layer_params`, `fits_vmem`). The kernel is
`damc_tpu_torch/csrc/fused_qsweep.cu`; its source note gives the design.

`fused_reverse_sweep` runs the plain PyTorch version for tensors on the CPU
and launches the kernel for tensors on a CUDA device; anything else, or a
failed build or launch, raises. `fused_reverse_sweep.launches` counts the
kernel launches.

Only counter-mode noise (`row_seeds`) and noiseless sweeps are ported; the
TPU kernel's stream mode (one scalar seed, on-core PRNG) comes with the
training slice.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..noise import counter_normal
from . import build

N_COEF = 6  # c1, c2, m_z, m_x, std, is_last
ROWS = 8  # rows per block, kRows in the kernel
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use
_LRELU = 0.01
_TWO_PI = 2.0 * math.pi
_lock = threading.Lock()

LayerTuple = Tuple[torch.Tensor, ...]  # lin_k, lin_b, skip_k, skip_b, gate_k, gate_b, hyper_k


def denoiser_layer_params(denoiser) -> Tuple[torch.Tensor, List[LayerTuple]]:
    """(fourier (nz, nz/2), per-layer weight tuples) of a `LatentDenoiser`,
    in/mid/out order, kernels as contiguous (din, dout) float32 — the
    x @ K layout the kernel reads row by row."""
    k = lambda lin: lin.weight.detach().t().contiguous().float()
    b = lambda lin: lin.bias.detach().contiguous().float()
    layers = []
    for l in denoiser.all_layers:
        lin = l._layer[0]
        layers.append(
            (k(lin), b(lin), k(l._skip), b(l._skip), k(l._hyper_gate), b(l._hyper_gate),
             k(l._hyper_bias))
        )
    return denoiser.B.detach().contiguous().float(), layers


def smem_bytes(nz: int, dins: Sequence[int], douts: Sequence[int], rows: int = ROWS) -> int:
    """Shared memory of one block: per row z, the layer input, the context,
    the output and the three in-layer skips (the kernel's layout)."""
    per_row = nz + max(dins) + 2 * max(douts) + sum(douts[:3])
    return 4 * rows * per_row


def fits_smem(nz: int, dins: Sequence[int], douts: Sequence[int], rows: int = ROWS) -> bool:
    """The Hopper fit rule in place of the TPU's `fits_vmem`: a block's rows
    of activations must fit in 227 KB of shared memory, and every width must
    be a multiple of 4 (float4 reads). The CIFAR-10 family fits (57 KB at
    8 rows); the StyleGAN width (1024, nz=7168) does not."""
    widths = [nz, *dins, *douts]
    return all(w % 4 == 0 for w in widths) and smem_bytes(nz, dins, douts, rows) <= SMEM_LIMIT


def _dims(fourier, layers) -> Tuple[int, int, List[int], List[int]]:
    nz, nfour = fourier.shape
    dins = [int(lt[0].shape[0]) for lt in layers]
    douts = [int(lt[0].shape[1]) for lt in layers]
    return nz, nfour, dins, douts


def _check_unet(nz, nfour, dins, douts) -> None:
    """The 3-in/1-mid/3-out topology the kernel hard-codes."""
    ok = (
        len(dins) == 7
        and dins[0] == 2 * nfour + nz
        and dins[1] == douts[0] and dins[2] == douts[1] and dins[3] == douts[2]
        and dins[4] == douts[3] + douts[2]
        and dins[5] == douts[4] + douts[1]
        and dins[6] == douts[5] + douts[0]
        and douts[6] == nz
    )
    if not ok:
        raise ValueError(f"not the 7-layer denoiser U-Net: din={dins}, dout={douts}")


def reverse_sweep_plain(
    z_init: torch.Tensor,
    fourier: torch.Tensor,
    layers: Sequence[LayerTuple],
    pre_x: Sequence[torch.Tensor],
    pre_t: Sequence[torch.Tensor],
    coeffs: torch.Tensor,
    row_seeds=None,
    steps: int = 1,
    with_noise: bool = True,
    residual: bool = True,
) -> torch.Tensor:
    """The kernel's function as a Python loop over steps (torch.matmul), in
    the dtype of its inputs (float32; float64 gives a reference)."""
    act = lambda h: torch.where(h >= 0.0, h, _LRELU * h)
    z = z_init
    nz = z.shape[1]
    for step in range(steps):
        films = []
        for (_, _, _, _, gate_k, gate_b, hyper_k), px, pt in zip(layers, pre_x, pre_t):
            c = F.silu(pt[step][None, :] + px)
            films.append((torch.sigmoid(c @ gate_k + gate_b), c @ hyper_k))

        def apply(li, h):
            lin_k, lin_b, skip_k, skip_b = layers[li][:4]
            gate, bias = films[li]
            return (h @ lin_k + lin_b) * gate + bias + h @ skip_k + skip_b

        t = z @ fourier
        t = t - torch.round(t)  # half to even, as the kernel's rintf
        proj = _TWO_PI * t
        h = torch.cat([torch.sin(proj), torch.cos(proj), z], dim=-1)
        hs = []
        li = 0
        for _ in range(3):
            h = apply(li, h)
            li += 1
            hs.append(h)
            h = act(h)
        h = apply(li, h)
        li += 1
        for _ in range(3):
            h = act(torch.cat([h, hs.pop()], dim=-1))
            h = apply(li, h)
            li += 1
        eps = z + h if residual else h
        c1, c2, m_z, m_x, std, is_last = coeffs[step]
        x_pred = c1 * z - c2 * eps
        z_next = m_z * z + m_x * x_pred
        if with_noise:
            z_next = z_next + std * counter_normal(row_seeds, step, nz)
        z = torch.where(is_last > 0.5, x_pred, z_next)
    return z


def fused_reverse_sweep(
    z_init: torch.Tensor,
    fourier: torch.Tensor,
    layers: Sequence[LayerTuple],
    pre_x: Sequence[torch.Tensor],
    pre_t: Sequence[torch.Tensor],
    coeffs: torch.Tensor,
    row_seeds=None,
    steps: int = 1,
    with_noise: bool = True,
    residual: bool = True,
) -> torch.Tensor:
    """Run the whole n-step reverse sweep: z_init (B, nz) -> x_hat (B, nz).

    `pre_x[l]` (B, dout_l) and `pre_t[l]` (n, dout_l) are the denoiser's
    sample tables, `coeffs` (n, 6) the `step_coefficients` table and
    `row_seeds` (B,) int32 the per-row counter seeds: row i depends only on
    (row_seeds[i], z_init[i], pre_x[*][i])."""
    if with_noise and row_seeds is None:
        raise ValueError("only counter-mode noise (row_seeds) is ported")
    args = (z_init, fourier, layers, pre_x, pre_t, coeffs)
    if z_init.device.type == "cpu":
        return reverse_sweep_plain(
            *args, row_seeds=row_seeds, steps=steps, with_noise=with_noise, residual=residual
        )
    if z_init.device.type != "cuda":
        raise ValueError(f"no reverse-sweep kernel for device {z_init.device}")
    nz, nfour, dins, douts = _dims(fourier, layers)
    _check_unet(nz, nfour, dins, douts)
    if not fits_smem(nz, dins, douts):
        raise ValueError(
            f"denoiser widths din={dins}, dout={douts} do not fit the sweep "
            f"kernel's {SMEM_LIMIT} B of shared memory at {ROWS} rows"
        )
    b = z_init.shape[0]
    if z_init.shape != (b, nz) or coeffs.shape[0] < steps or coeffs.shape[1] != N_COEF:
        raise ValueError(f"bad shapes: z {tuple(z_init.shape)}, coeffs {tuple(coeffs.shape)}")
    dev = z_init.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    z = f32(z_init)
    px = f32(torch.cat(list(pre_x), dim=1))
    pt = f32(torch.cat(list(pre_t), dim=1))
    if px.shape != (b, sum(douts)) or pt.shape[0] < steps:
        raise ValueError(f"bad tables: pre_x {tuple(px.shape)}, pre_t {tuple(pt.shape)}")
    cf = f32(coeffs)
    four = f32(fourier)
    flat = [f32(t) for lt in layers for t in lt]
    seeds = None
    if with_noise:
        seeds = torch.as_tensor(row_seeds).to(device=dev, dtype=torch.int32).contiguous()
        if seeds.shape != (b,):
            raise ValueError(f"row_seeds must be ({b},), got {tuple(seeds.shape)}")
    out = torch.empty_like(z)
    lib = _library()
    ptrs = (ctypes.c_void_p * len(flat))(*[t.data_ptr() for t in flat])
    dims = (ctypes.c_int * 14)(*dins, *douts)
    rc = lib.damc_fused_qsweep(
        z.data_ptr(), four.data_ptr(), ptrs, dims, px.data_ptr(), pt.data_ptr(),
        cf.data_ptr(), None if seeds is None else seeds.data_ptr(), out.data_ptr(),
        b, nz, nfour, steps, int(residual), smem_bytes(nz, dins, douts),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, rc, "fused_reverse_sweep")
    with _lock:
        fused_reverse_sweep.launches += 1
    return out


fused_reverse_sweep.launches = 0


def _library() -> ctypes.CDLL:
    lib = build.load("fused_qsweep")
    fn = lib.damc_fused_qsweep
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        if lib.damc_fused_qsweep_rows() != ROWS:
            raise RuntimeError("fused_qsweep.cu and fused_qsweep.py disagree on the row tile")
    return lib
