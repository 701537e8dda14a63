"""K1: the K-step prior-Langevin chain — wrapper, plain version, fit rule.

Counterpart of `damc_tpu/ops/pallas/fused_langevin.py`
(`fused_prior_langevin`, `ebm_params_to_dense_weights`). The kernel is
`damc_tpu_torch/csrc/fused_langevin.cu`; its source note gives the design.

`fused_prior_langevin` calls the custom op `torch.ops.damc.fused_prior_langevin`,
which runs the plain PyTorch version for tensors on the CPU and launches
the kernel for tensors on a CUDA device; anything else, or a failed build
or launch, raises. A fake implementation gives the output's shape, so
`make_fx` and `torch.export` record the whole chain as one node. `fused_prior_langevin.launches` counts the
launches of the fp32-dot variant; the bf16-dot variant has a count object
of its own, `fused_prior_langevin.bf16`, whose `launches` counts its.

Noise modes, as the TPU kernel's: counter (`row_seeds`, per-chain int32
seeds; serving), stream (`seed`, one int32 for the launch; training) and
noiseless. Stream mode draws row i's noise from
`ops/noise.py::stream_row_seeds(seed, B, row_base=row_base)[i]`, not from
the TPU's on-core PRNG (see `ops/noise.py`).

K4a, `fused_prior_langevin_sharded` (counterpart of the TPU's
`fused_prior_langevin_sharded`, `damc_tpu/ops/pallas/fused_langevin.py:335`,
K1 inside `jax.shard_map`): the chains of a global batch split over the
ranks of a `parallel.Mesh`, the weights replicated. Each rank launches K1 on
its rows with `row_base` its first global row, and the rows are gathered:
in every noise mode the result equals one unsharded launch bit for bit,
since a chain's arithmetic and its stream seed depend on its global row
alone. The TPU kernel offsets each shard's seed instead, so its sharded
stream draws are not its unsharded ones.

Dot precision, as the TPU kernel's `dots_dtype`: "float32", or "bfloat16":
the four products take operands rounded to bfloat16 (the weights, z,
lrelu(h1p), d2 and d1) and accumulate in float32, while the biases, k3,
the + z term, the chain state and the noise stay float32.
"""

from __future__ import annotations

import ctypes
import threading
import types
from typing import List, Optional, Tuple

import torch

from ...parallel.mesh import gather_rows, pad_rows
from ..noise import counter_normal, int32_seed, stream_row_seeds
from . import build

# The kernel's geometry (csrc/fused_langevin.cu; `_library` checks it):
ROWS = 8  # chains per cluster
CLUSTER = 4  # blocks per cluster; each holds ndf / CLUSTER hidden columns of K1 and K2
THREADS = 256
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use
_SLOPE = 0.2
DOTS_DTYPES = ("float32", "bfloat16")
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


def column_ranges(ndf: int) -> List[Tuple[int, int]]:
    """[start, stop) of the hidden columns each block of a cluster holds
    (its slices of K1 and K2). The transposed products sum over these
    slices, and the cluster adds the partial sums in this order: the
    summation order of every element, fixed by ndf alone."""
    j = ndf // CLUSTER
    return [(r * j, (r + 1) * j) for r in range(CLUSTER)]


def slice_ld(j: int) -> int:
    """Row stride of a block's weight slices with j columns: j padded to a
    multiple of 4 whose quarter is odd (conflict-free 128-bit row reads)."""
    j4 = -(-j // 4) * 4
    return j4 if (j4 // 4) % 2 else j4 + 4


def smem_bytes(nz: int, ndf: int) -> int:
    """Shared memory of one block (the kernel's layout): its column slices
    of K1 and K2; per chain the whole z, the gathered h1, its partial sums
    of d2 K2^T (ndf) and d1 K1^T (nz), its own columns of d2 and d1 (padded
    to a multiple of 4) and of h1p and lrelu(h1p)."""
    j = ndf // CLUSTER
    j4 = -(-j // 4) * 4
    return 4 * ((nz + ndf) * slice_ld(j) + ROWS * (2 * nz + 2 * ndf + 2 * j4 + 2 * j))


def fits_smem(nz: int, ndf: int) -> bool:
    """The Hopper fit rule: nz a multiple of 4 (float4 reads), ndf a
    multiple of CLUSTER (each block holds ndf / CLUSTER hidden columns,
    zero-padded to a multiple of 4), and a block's share of the weights and
    activations within 227 KB of shared memory. ndf=200 fits (94 KB a
    block); ndf=512 does not."""
    return nz % 4 == 0 and ndf % CLUSTER == 0 and smem_bytes(nz, ndf) <= SMEM_LIMIT


def _lrelu(x):
    return torch.where(x >= 0.0, x, _SLOPE * x)


def _dlrelu(x):
    return torch.where(x >= 0.0, 1.0, _SLOPE)


def _check_args(with_noise, seed, row_seeds, dots_dtype) -> None:
    if with_noise and seed is None and row_seeds is None:
        raise ValueError("a noisy chain needs seed (stream mode) or row_seeds (counter mode)")
    if dots_dtype not in DOTS_DTYPES:
        raise ValueError(f"dots_dtype must be one of {DOTS_DTYPES}, got {dots_dtype!r}")


def _bf16_operand(t: torch.Tensor) -> torch.Tensor:
    """t rounded to the nearest bfloat16 (ties to even), held in float32."""
    return t.to(torch.bfloat16).float()


def prior_langevin_plain(
    z, k1, b1, k2, b2, k3, seed=None, steps: int = 1, step_size: float = 0.1,
    with_noise: bool = True, row_seeds=None, dots_dtype: str = "float32", row_base: int = 0,
) -> torch.Tensor:
    """The kernel's function as a Python loop over steps (torch.matmul).
    `row_seeds` wins over `seed`. With dots_dtype "bfloat16" the operands
    of the four products are rounded where the kernel rounds them; the
    product of two bfloat16 values is exact in float32, so the products
    then differ from the kernel's in summation order alone."""
    _check_args(with_noise, seed, row_seeds, dots_dtype)
    op = _bf16_operand if dots_dtype == "bfloat16" else (lambda t: t)
    coeff = 0.5 * step_size * step_size
    k3 = k3.reshape(1, -1)
    k1, k2 = op(k1), op(k2)
    z = z.float()
    if with_noise and row_seeds is None:
        row_seeds = stream_row_seeds(seed, z.shape[0], z.device, row_base)
    for step in range(steps):
        h1p = op(z) @ k1 + b1
        h2p = op(_lrelu(h1p)) @ k2 + b2
        d2 = _dlrelu(h2p) * k3
        d1 = _dlrelu(h1p) * (op(d2) @ k2.t())
        grad = op(d1) @ k1.t() + z
        z = z - coeff * grad
        if with_noise:
            z = z + step_size * counter_normal(row_seeds, step, z.shape[1])
    return z


def fused_prior_langevin(
    z, k1, b1, k2, b2, k3, seed=None, steps: int = 1, step_size: float = 0.1,
    with_noise: bool = True, row_seeds=None, dots_dtype: str = "float32", row_base: int = 0,
) -> torch.Tensor:
    """Run the whole K-step chain z (B, nz) -> z_K on the EBM weights
    (k1, b1, k2, b2, k3) of `ebm_params_to_dense_weights`.

    Noise: `row_seeds` (B,) int32 selects counter mode, chain i a function
    of (row_seeds[i], z[i]) only; otherwise `seed` (int32) selects stream
    mode, chain i a function of (seed, row_base + i, z[i]): z holds rows
    row_base .. row_base + B - 1 of a global batch (a rank's rows; 0 for a
    whole batch). `row_seeds` wins when both are given. `dots_dtype`
    ("float32" or "bfloat16") selects the variant.

    The chain runs as the custom op `torch.ops.damc.fused_prior_langevin`:
    its CPU implementation is the plain version, its CUDA implementation
    the kernel launch, and a trace (`torch.export`) keeps it as one node."""
    _check_args(with_noise, seed, row_seeds, dots_dtype)
    if z.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no prior-Langevin kernel for device {z.device}")
    if row_seeds is not None and not isinstance(row_seeds, torch.Tensor):
        row_seeds = torch.as_tensor(row_seeds, device=z.device)
    return torch.ops.damc.fused_prior_langevin(
        z, k1, b1, k2, b2, k3, row_seeds if with_noise else None,
        None if seed is None else int32_seed(seed), int(steps), float(step_size),
        bool(with_noise), dots_dtype, int(row_base),
    )


fused_prior_langevin.launches = 0
fused_prior_langevin.bf16 = types.SimpleNamespace(launches=0)


@torch.library.custom_op("damc::fused_prior_langevin", mutates_args=(), device_types="cpu")
def _chain_op(
    z: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor, b2: torch.Tensor,
    k3: torch.Tensor, row_seeds: Optional[torch.Tensor], seed: Optional[int], steps: int,
    step_size: float, with_noise: bool, dots_dtype: str, row_base: int = 0,
) -> torch.Tensor:
    out = prior_langevin_plain(
        z, k1, b1, k2, b2, k3, seed=seed, steps=steps, step_size=step_size,
        with_noise=with_noise, row_seeds=row_seeds, dots_dtype=dots_dtype, row_base=row_base,
    )
    return out.clone() if out is z else out  # an op's output may not alias its input


@_chain_op.register_fake
def _chain_fake(z, k1, b1, k2, b2, k3, row_seeds, seed, steps, step_size, with_noise, dots_dtype,
                row_base=0):
    return z.new_empty(z.shape, dtype=torch.float32)


@_chain_op.register_kernel("cuda")
def _chain_launch(z, k1, b1, k2, b2, k3, row_seeds, seed, steps, step_size, with_noise, dots_dtype,
                  row_base=0):
    b, nz = z.shape
    ndf = k1.shape[1]
    if k1.shape != (nz, ndf) or k2.shape != (ndf, ndf) or b1.numel() != ndf or b2.numel() != ndf or k3.numel() != ndf:
        raise ValueError("EBM weights do not match z's width")
    if not fits_smem(nz, ndf):
        raise ValueError(
            f"EBM width ndf={ndf} does not fit the chain kernel: ndf must be a multiple of "
            f"{CLUSTER} and {smem_bytes(nz, ndf)} B of shared memory a block within {SMEM_LIMIT}"
        )
    dev = z.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    z32, w = f32(z), [f32(t) for t in (k1, b1, k2, b2, k3)]
    seeds = None
    if with_noise and row_seeds is not None:
        seeds = row_seeds.to(device=dev, dtype=torch.int32).contiguous()
        if seeds.shape != (b,):
            raise ValueError(f"row_seeds must be ({b},), got {tuple(seeds.shape)}")
    stream = with_noise and seeds is None
    bf16 = dots_dtype == "bfloat16"
    out = torch.empty_like(z32)
    lib = _library()
    rc = lib.damc_fused_langevin(
        z32.data_ptr(), *[t.data_ptr() for t in w],
        None if seeds is None else seeds.data_ptr(), int32_seed(seed) if stream else 0,
        int(stream), int(row_base), int(bf16), out.data_ptr(),
        b, nz, ndf, steps, float(step_size), 0.5 * step_size * step_size,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, rc, "fused_prior_langevin")
    with _lock:
        if bf16:
            fused_prior_langevin.bf16.launches += 1
        else:
            fused_prior_langevin.launches += 1
    return out


def _library() -> ctypes.CDLL:
    lib = build.load("fused_langevin")
    fn = lib.damc_fused_langevin
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # z, k1, b1, k2, b2, k3, seeds, seed, stream_noise, row_base, bf16_dots,
        # out, B, nz, ndf, steps, step_size, coeff, stream
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
        geometry = (ctypes.c_int * 3)()
        lib.damc_fused_langevin_geometry(geometry)
        if tuple(geometry) != (ROWS, CLUSTER, THREADS):
            raise RuntimeError("fused_langevin.cu and fused_langevin.py disagree on the geometry")
        if any(lib.damc_fused_langevin_smem_bytes(nz, 200) != smem_bytes(nz, 200) for nz in (128, 100, 8)):
            raise RuntimeError("fused_langevin.cu and fused_langevin.py disagree on shared memory")
    return lib


def fused_prior_langevin_sharded(
    mesh, z, k1, b1, k2, b2, k3, seed=None, steps: int = 1, step_size: float = 0.1,
    with_noise: bool = True, row_seeds=None, dots_dtype: str = "float32",
) -> torch.Tensor:
    """K4a: `fused_prior_langevin` on the global batch z (B, nz), which
    every rank of `mesh` holds, with its chains split over the ranks. The
    batch is padded to a multiple of the world with zero rows (dropped
    again); each rank runs its local_b rows with row_base = rank * local_b
    (counter-mode `row_seeds` split with the rows, the weights replicated),
    and the rows are gathered onto every rank. Equal to the unsharded
    launch bit for bit in every mode. A world of 1 (or no mesh) launches
    K1 on the whole batch."""
    kw = dict(seed=seed, steps=steps, step_size=step_size, with_noise=with_noise, dots_dtype=dots_dtype)
    if mesh is None or mesh.world == 1:
        return fused_prior_langevin(z, k1, b1, k2, b2, k3, row_seeds=row_seeds, **kw)
    b = z.shape[0]
    local_b = -(-b // mesh.world)
    rows = slice(mesh.rank * local_b, (mesh.rank + 1) * local_b)
    z_l = pad_rows(z, local_b * mesh.world)[rows]
    if with_noise and row_seeds is not None:
        row_seeds = pad_rows(torch.as_tensor(row_seeds, device=z.device), local_b * mesh.world)[rows]
    out = fused_prior_langevin(z_l, k1, b1, k2, b2, k3, row_seeds=row_seeds, row_base=rows.start, **kw)
    return gather_rows(mesh, out)[:b]
