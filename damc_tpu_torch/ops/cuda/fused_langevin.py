"""K1: the K-step prior-Langevin chain — wrapper, plain version, fit rule.

Counterpart of `damc_tpu/ops/pallas/fused_langevin.py`
(`fused_prior_langevin`, `ebm_params_to_dense_weights`). The kernels are
in `damc_tpu_torch/csrc/fused_langevin.cu`; its source notes give the
designs.

`fused_prior_langevin` calls the custom op `torch.ops.damc.fused_prior_langevin`,
which runs the plain PyTorch version for tensors on the CPU and launches
the kernel for tensors on a CUDA device; anything else, or a failed build
or launch, raises. A fake implementation gives the output's shape, so
`make_fx` and `torch.export` record the whole chain as one node. Each
variant counts its launches in a count object of its own (`launch_count`):
`fused_prior_langevin.launches` the fp32-dot variant over a cluster of 4,
`fused_prior_langevin.c8.launches` over a cluster of 8,
`fused_prior_langevin.tc.launches` the bf16-dot tensor-core variant,
`fused_prior_langevin.l2.launches` and `fused_prior_langevin.l2.bf16.launches`
the streamed variant, which reads the weights from global memory (L2).

Widths, as the TPU kernel's: every 2-hidden, 1-output EBM (`fits_ebm`).
The variant is a function of (nz, ndf, dots dtype) alone (`launch_widths`),
so a chain's result does not depend on its batch. fp32 dots: nz and ndf
zero-padded by the wrapper (`pad_widths`), the weights held in shared
memory split over the smallest cluster (`CLUSTERS`: 4 or 8 blocks) whose
blocks' shares fit (`fits_smem`): at nz=128 a cluster of 4 up to ndf=368
(the presets' 200), of 8 up to 536 (ndf=512). bf16 dots: the tensor-core
variant (`mma.sync`, the 8 chains of a block as the N dimension), its
bf16 weights over the smallest of `MMA_CLUSTERS` (1, 4 or 8 blocks) whose
blocks fit (`mma_smem_bytes`), nz padded to a multiple of 16 and ndf to
one of 16 x the cluster by the kernel itself in shared memory (six pads on
the host would cost more card time than a third of the chain: PERF.md,
PR 18): at nz=128 one block up to ndf=256 (the presets' 200, padded to
208), 4 up to 512, 8 up to 640. Each output tile belongs to one warp, which sums over k in
order; a cluster adds its blocks' partials in rank order. Past those
widths, in either precision, the streamed variant: a cluster of 8 blocks
(`L2_CLUSTER`) owns 16, 32 or 48 chains (`L2_CHAINS`, taken from the batch
by `l2_chains`; 8 where 32 fit no block) and streams tiles of the weights
from global memory (L2) through a ring in shared memory (`l2_tiling`,
`l2_smem_bytes`), nz padded to a multiple of the tile's depth and ndf to
one of 8 x it; each output element is one thread's sum over k in order,
whatever the chains. The launch raises only for widths whose block
overflows even then (ndf past 24,064 at nz=128).

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
import functools
import threading
import types
from typing import List, NamedTuple, Optional, Tuple

import torch

from ...parallel.mesh import gather_rows, pad_rows
from ..noise import counter_normal, int32_seed, stream_row_seeds
from . import build

# The kernel's geometry (csrc/fused_langevin.cu; `_library` checks it):
ROWS = 8  # chains per cluster of the variants that hold the weights in shared memory
THREADS = 256
# Blocks per cluster of the fp32 variant that holds the weights in shared
# memory, smallest first; each block holds ndf / cluster hidden columns of
# K1 and K2.
CLUSTERS = (4, 8)
# The streamed variant: blocks per cluster (each owns ndf / 8 hidden
# columns), slots of its weight ring, the chains a cluster it takes from
# the batch, the chains a tiling must fit (32) and those where 32 fit no
# block (8), the output columns and the k depth of a weight tile.
L2_CLUSTER = 8
L2_STAGES = 4
L2_CHAINS = (16, 32, 48)
L2_BASE = 32
L2_NARROW = 8
L2_COLS = (128, 32)
L2_KTILES = (32, 16, 8)
# Blocks per cluster of the bf16-dot tensor-core variant, smallest first.
MMA_CLUSTERS = (1, 4, 8)
MMA_TILE = 16  # rows of an mma tile and its k: the widths' multiple
MMA_THREADS = 512  # threads per block of the tensor-core variant
MMA_MAX_COLUMNS = MMA_THREADS // 32 * MMA_TILE  # own hidden columns a block holds: a tile a warp
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


def column_ranges(ndf: int, cluster: int) -> List[Tuple[int, int]]:
    """[start, stop) of the hidden columns each block of a cluster holds
    (its slices of K1 and K2). The transposed products sum over these
    slices, and the cluster adds the partial sums in this order: the
    summation order of every element, fixed by ndf and the cluster, which
    `launch_widths` takes from the widths."""
    j = ndf // cluster
    return [(r * j, (r + 1) * j) for r in range(cluster)]


def slice_ld(j: int) -> int:
    """Row stride of a block's weight slices with j columns: j padded to a
    multiple of 4 whose quarter is odd (conflict-free 128-bit row reads)."""
    j4 = -(-j // 4) * 4
    return j4 if (j4 // 4) % 2 else j4 + 4


def smem_bytes(nz: int, ndf: int, smem_weights: bool, cluster: int) -> int:
    """Shared memory of one block. With `smem_weights`, of the fp32 variant
    over a cluster of `cluster` (the kernel's layout): its column slices of
    K1 and K2; per chain the whole z, the gathered h1, its partial sums of
    d2 K2^T (ndf) and d1 K1^T (nz), its own columns of d2 and d1 (padded to
    a multiple of 4) and of h1p and lrelu(h1p). At nz=128: 95,744 B at
    ndf=200 over 4; 395,264 B at ndf=512 over 4 and 223,232 B over 8.
    Without, of the streamed variant (`cluster` L2_CLUSTER) at the tiling
    of (nz, ndf) with the chains it was fitted to (`l2_tiling`); where none
    fits, at the last one tried (8 chains, 32 columns, k-tiles of 8)."""
    if smem_weights:
        j = ndf // cluster
        j4 = -(-j // 4) * 4
        return 4 * ((nz + ndf) * slice_ld(j) + ROWS * (2 * nz + 2 * ndf + 2 * j4 + 2 * j))
    if cluster != L2_CLUSTER:
        raise ValueError(f"the streamed variant runs over clusters of {L2_CLUSTER}, not {cluster}")
    t = l2_tiling(nz, ndf)
    if t is None:
        kt = L2_KTILES[-1]
        return l2_smem_bytes(_round_up(nz, kt), _round_up(ndf, L2_CLUSTER * kt), L2_NARROW, L2_COLS[-1], kt)
    return l2_smem_bytes(t.nz, t.ndf, L2_NARROW if t.chains == (L2_NARROW,) else L2_BASE, t.cols, t.ktile)


def l2_smem_bytes(nz: int, ndf: int, chains: int, cols: int, ktile: int) -> int:
    """Shared memory of one block of the streamed variant (the kernel's
    layout) with `chains` chains a cluster and weight tiles of `cols`
    output columns x `ktile` k, at padded widths (nz a multiple of ktile,
    ndf of 8 ktile; J = ndf / 8 own columns): 4 bytes x (z and the partial
    sums of d1 K1^T, nz x chains each; the own columns of lrelu(h1p), later
    d1, and of d2, chains x (J + 4) each; L2_STAGES ring slots of cols x
    (ktile + 4); two activation tiles of chains x (ktile + 4)), plus the
    signs of h1p, chains x J bytes. At nz=128, ndf=1024 with 32 chains and
    tiles of 128 x 32: 153,600 B."""
    j = ndf // L2_CLUSTER
    floats = 2 * nz * chains + 2 * chains * (j + 4) + L2_STAGES * cols * (ktile + 4) + 2 * chains * (ktile + 4)
    return 4 * floats + chains * j


class L2Tiling(NamedTuple):
    """The streamed variant's tiling of an EBM's widths."""

    nz: int  # padded to a multiple of ktile
    ndf: int  # padded to a multiple of L2_CLUSTER x ktile
    cols: int  # output columns of a weight tile
    ktile: int  # k depth of a weight tile
    chains: Tuple[int, ...]  # the chains a cluster it takes


@functools.lru_cache(maxsize=None)
def l2_tiling(nz: int, ndf: int) -> Optional[L2Tiling]:
    """The streamed variant's tiling of widths (nz, ndf), from these alone
    (the kernel's `l2_tiling`): the first of (32 chains, 128 columns), (8,
    128), (8, 32), each at the deepest k-tile of L2_KTILES, whose block fits
    SMEM_LIMIT at widths padded to it (nz to a multiple of the k-tile, ndf
    to one of 8 x it). Fitted to 32 chains it takes every one of L2_CHAINS
    whose block fits (16 always), else 8 alone. Padded widths give
    themselves back. None where nothing fits. At nz=128: ndf=1024 as it is
    with tiles of 128 x 32 and 16, 32 or 48 chains; ndf=540 to 768."""
    for base, cols in ((L2_BASE, L2_COLS[0]), (L2_NARROW, L2_COLS[0]), (L2_NARROW, L2_COLS[1])):
        for kt in L2_KTILES:
            nz_p, ndf_p = _round_up(nz, kt), _round_up(ndf, L2_CLUSTER * kt)
            if l2_smem_bytes(nz_p, ndf_p, base, cols, kt) <= SMEM_LIMIT:
                chains = (tuple(c for c in L2_CHAINS if l2_smem_bytes(nz_p, ndf_p, c, cols, kt) <= SMEM_LIMIT)
                          if base == L2_BASE else (base,))
                return L2Tiling(nz_p, ndf_p, cols, kt, chains)
    return None


def l2_packed_floats(nz: int, ndf: int) -> int:
    """Floats of the streamed variant's scratch at the tiling of (nz, ndf):
    the weights packed, once a launch, in the order its 8 blocks stream
    them, each tile as it lies in a ring slot. Per block (J = ndf / 8 own
    columns at the padded widths, tiles of cols x kt): the two forward
    products' tiles, kt rows at stride cols over ceil(J / cols) column
    chunks, chunks x cols x (nz + ndf) floats; the two transposed ones',
    rows at stride kt + 4, (J ndf + nz J) (kt + 4) / kt."""
    t = l2_tiling(nz, ndf)
    j = t.ndf // L2_CLUSTER
    chunks = -(-j // t.cols)
    return L2_CLUSTER * (chunks * t.cols * (t.nz + t.ndf) + (j * t.ndf + t.nz * j) * (t.ktile + 4) // t.ktile)


def l2_chains(chains: Tuple[int, ...], b: int, max_clusters) -> int:
    """The chains a cluster of a streamed launch of b chains: of `chains`,
    the one whose ceil(b / c) clusters take the fewest waves of the
    `max_clusters(c)` the card runs at once, then the fewest chains. Each
    output element's sum does not depend on it."""
    return min(chains, key=lambda c: (-(-(-(-b // c)) // max(1, max_clusters(c))), c))


def mma_widths(nz: int, ndf: int, cluster: int) -> Tuple[int, int]:
    """The widths the tensor-core variant pads (nz, ndf) to in shared
    memory over `cluster` blocks: nz to a multiple of MMA_TILE, ndf to one
    of MMA_TILE x cluster (each block's own columns a multiple of the tile)."""
    return _round_up(nz, MMA_TILE), _round_up(ndf, MMA_TILE * cluster)


def mma_smem_bytes(nz: int, ndf: int, cluster: int) -> int:
    """Shared memory of one block of the tensor-core variant over
    `cluster` blocks (the kernel's layout, at `mma_widths`; J = ndf /
    cluster own columns): 2 bytes x ((nz + ndf) (J + 8) bf16 weight slices,
    plus per chain the bf16 operands z (nz + 8), h1 (ndf + 8), d2 and d1
    (J + 8 each)), plus 4 bytes x 8 chains x (2 nz: the fp32 chain and the
    step's normals; and over more than one block nz + ndf, the partial
    sums of d1 K1^T and d2 K2^T). At nz=128, ndf=200 (208) in one block
    165,888 B; ndf=512 over 4 217,600 B."""
    nz_p, ndf_p = mma_widths(nz, ndf, cluster)
    j = ndf_p // cluster
    halves = (nz_p + ndf_p) * (j + 8) + ROWS * ((nz_p + 8) + (ndf_p + 8) + 2 * (j + 8))
    floats = ROWS * (2 * nz_p + (nz_p + ndf_p if cluster > 1 else 0))
    return 2 * halves + 4 * floats


def fits_mma(nz: int, ndf: int, cluster: int) -> bool:
    """Whether the tensor-core variant over `cluster` blocks holds an EBM
    of widths (nz, ndf): a block's own columns at most MMA_MAX_COLUMNS and
    its shared memory within SMEM_LIMIT."""
    ndf_p = mma_widths(nz, ndf, cluster)[1]
    return ndf_p // cluster <= MMA_MAX_COLUMNS and mma_smem_bytes(nz, ndf, cluster) <= SMEM_LIMIT


def fits_smem(nz: int, ndf: int, cluster: int) -> bool:
    """Whether the variant over `cluster` blocks that holds the weights in
    shared memory takes the widths as they are: nz a multiple of 4 (float4
    reads), ndf a multiple of the cluster (each block holds ndf / cluster
    hidden columns, zero-padded to a multiple of 4), and a block's share of
    the weights and activations within 227 KB. At nz=128 ndf=200 fits over
    4 (94 KB a block); ndf=512 does not (386 KB), but fits over 8 (218 KB)."""
    return nz % 4 == 0 and ndf % cluster == 0 and smem_bytes(nz, ndf, True, cluster) <= SMEM_LIMIT


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class Launch(NamedTuple):
    """The widths and the variant of a K1 launch."""

    nz: int
    ndf: int
    smem_weights: bool  # the weight slices in shared memory, else streamed from global memory
    cluster: int  # blocks per cluster
    bf16: bool = False  # bf16 dots: with smem_weights the tensor-core variant
    chains: Tuple[int, ...] = (ROWS,)  # chains a cluster it may take (the streamed variant: by the batch)

    @property
    def mma(self) -> bool:
        """The bf16-dot tensor-core variant, which pads the widths itself."""
        return self.bf16 and self.smem_weights


@functools.lru_cache(maxsize=None)  # read on every launch
def launch_widths(nz: int, ndf: int, dots_dtype: str = "float32") -> Optional[Launch]:
    """The launch for an EBM of widths (nz, ndf) with `dots_dtype` dots,
    from these alone. float32: nz padded to a multiple of 4, and the
    smallest cluster of CLUSTERS whose blocks' shares fit (`fits_smem`)
    with ndf padded to a multiple of it, the weights in shared memory.
    bfloat16: the tensor-core variant over the smallest cluster of
    MMA_CLUSTERS that holds the widths (`fits_mma`), at `mma_widths`. Else,
    in either precision, the streamed variant over L2_CLUSTER at its tiling
    (`l2_tiling`). None where that fits no block either (ndf past 24,064 at
    nz=128). At nz=128, fp32: ndf=200 over 4, 512 over 8, 1024 streamed;
    bf16: ndf=200 (208) in one block, 512 over 4, 1024 streamed. Widths
    that fit as they are launch as they are."""
    if dots_dtype not in DOTS_DTYPES:
        raise ValueError(f"dots_dtype must be one of {DOTS_DTYPES}, got {dots_dtype!r}")
    bf16 = dots_dtype == "bfloat16"
    if bf16:
        for cluster in MMA_CLUSTERS:
            if fits_mma(nz, ndf, cluster):
                return Launch(*mma_widths(nz, ndf, cluster), True, cluster, True)
    else:
        nz_p = _round_up(nz, 4)
        for cluster in CLUSTERS:
            ndf_p = _round_up(ndf, cluster)
            if fits_smem(nz_p, ndf_p, cluster):
                return Launch(nz_p, ndf_p, True, cluster)
    t = l2_tiling(nz, ndf)
    if t is None:
        return None
    return Launch(t.nz, t.ndf, False, L2_CLUSTER, bf16, t.chains)


def pad_widths(z, k1, b1, k2, b2, k3, nz_p: int, ndf_p: int) -> Tuple[torch.Tensor, ...]:
    """z and the EBM's weights zero-padded to widths (nz_p, ndf_p): extra z
    columns and K1 rows, extra hidden units with zero weights, bias and
    head. A padded unit's pre-activation is 0 and feeds nothing, and a
    padded z column enters no product, so the chain's first nz columns are
    the unpadded chain's; each column's noise depends on its index alone."""
    pad = torch.nn.functional.pad
    dz, dh = nz_p - z.shape[1], ndf_p - k1.shape[1]
    if dz == 0 and dh == 0:
        return z, k1, b1, k2, b2, k3
    return (pad(z, (0, dz)), pad(k1, (0, dh, 0, dz)), pad(b1, (0, dh)), pad(k2, (0, dh, 0, dh)),
            pad(b2, (0, dh)), pad(k3, (0, dh)))


def fits_ebm(ebm) -> bool:
    """Whether K1 takes a `LatentEBM`, from static facts alone: the 2-hidden,
    1-output layout the kernel hand-codes (JAX's `is_standard_mlp`), at any
    width: the launch pads it (`launch_widths`) and raises only for widths
    whose streamed block overflows."""
    lin = [m for m in ebm.ebm if isinstance(m, torch.nn.Linear)]
    return len(lin) == 3 and lin[2].out_features == 1


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
    """t rounded to the nearest bfloat16 (ties to even), held in t's float
    type (float32, or float64 for a float64 reference chain)."""
    return t.to(torch.bfloat16).to(t.dtype)


def prior_langevin_plain(
    z, k1, b1, k2, b2, k3, seed=None, steps: int = 1, step_size: float = 0.1,
    with_noise: bool = True, row_seeds=None, dots_dtype: str = "float32", row_base: int = 0,
) -> torch.Tensor:
    """The kernel's function as a Python loop over steps (torch.matmul).
    `row_seeds` wins over `seed`. With dots_dtype "bfloat16" the operands
    of the four products are rounded where the kernel rounds them; the
    product of two bfloat16 values is exact in float32, so the products
    then differ from the kernel's in summation order alone. A float64 z
    (with float64 weights) runs in float64, a reference for the float32
    runs."""
    _check_args(with_noise, seed, row_seeds, dots_dtype)
    op = _bf16_operand if dots_dtype == "bfloat16" else (lambda t: t)
    coeff = 0.5 * step_size * step_size
    k3 = k3.reshape(1, -1)
    k1, k2 = op(k1), op(k2)
    z = z if z.dtype == torch.float64 else z.float()
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
fused_prior_langevin.c8 = types.SimpleNamespace(launches=0)
fused_prior_langevin.tc = types.SimpleNamespace(launches=0)
fused_prior_langevin.l2 = types.SimpleNamespace(launches=0, bf16=types.SimpleNamespace(launches=0))


def launch_count(launch: Launch):
    """The count object (its `launches`) of the variant `launch` names."""
    if launch.mma:
        return fused_prior_langevin.tc
    if not launch.smem_weights:
        return fused_prior_langevin.l2.bf16 if launch.bf16 else fused_prior_langevin.l2
    return {4: fused_prior_langevin, 8: fused_prior_langevin.c8}[launch.cluster]


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
    widths = launch_widths(nz, ndf, dots_dtype)
    if widths is None:
        raise ValueError(
            f"EBM widths nz={nz}, ndf={ndf} overflow the chain kernel: the streamed variant's block takes "
            f"{smem_bytes(nz, ndf, False, L2_CLUSTER)} B of shared memory, past {SMEM_LIMIT}"
        )
    dev = z.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()
    z32, *w = [f32(t) for t in (z, k1, b1, k2, b2, k3)]
    if widths.mma:  # the kernel pads the widths in shared memory
        nz_p, ndf_p = nz, ndf
    else:
        nz_p, ndf_p = widths.nz, widths.ndf
        z32, *w = pad_widths(z32, *w, nz_p, ndf_p)
    seeds = None
    if with_noise and row_seeds is not None:
        seeds = row_seeds.to(device=dev, dtype=torch.int32).contiguous()
        if seeds.shape != (b,):
            raise ValueError(f"row_seeds must be ({b},), got {tuple(seeds.shape)}")
    stream = with_noise and seeds is None
    out = torch.empty_like(z32)
    lib = _library()
    chains, packed = ROWS, None
    if not widths.smem_weights:
        chains = l2_chains(widths.chains, b, lambda c: max_active_clusters(nz_p, ndf_p, c, widths.bf16))
        packed = torch.empty(l2_packed_floats(nz_p, ndf_p), dtype=torch.float32, device=dev)
    rc = lib.damc_fused_langevin(
        z32.data_ptr(), *[t.data_ptr() for t in w],
        None if seeds is None else seeds.data_ptr(), int32_seed(seed) if stream else 0,
        int(stream), int(row_base), int(widths.bf16), int(widths.smem_weights), widths.cluster, chains,
        None if packed is None else packed.data_ptr(), out.data_ptr(), b, nz_p, ndf_p, steps, float(step_size),
        0.5 * step_size * step_size,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, rc, "fused_prior_langevin")
    count = launch_count(widths)
    with _lock:
        count.launches += 1
    return out if nz_p == nz else out[:, :nz].contiguous()


def _library() -> ctypes.CDLL:
    lib = build.load("fused_langevin")
    fn = lib.damc_fused_langevin
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # z, k1, b1, k2, b2, k3, seeds, seed, stream_noise, row_base, bf16_dots, smem_weights,
        # cluster, chains, packed, out, B, nz, ndf, steps, step_size, coeff, stream
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, p, p, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
        geometry = (ctypes.c_int * 32)()
        lib.damc_fused_langevin_geometry(geometry)
        want = (ROWS, THREADS, len(CLUSTERS), *CLUSTERS, len(MMA_CLUSTERS), *MMA_CLUSTERS, MMA_TILE, MMA_THREADS,
                L2_CLUSTER, L2_STAGES, len(L2_CHAINS), *L2_CHAINS, L2_NARROW, *L2_COLS, *L2_KTILES)
        if tuple(geometry[:len(want)]) != want:
            raise RuntimeError("fused_langevin.cu and fused_langevin.py disagree on the geometry")
        smem, l2_smem = lib.damc_fused_langevin_smem_bytes, lib.damc_fused_langevin_l2_smem_bytes
        widths = ((128, 200), (100, 200), (8, 200), (10, 200), (128, 512), (128, 640), (128, 1024))
        if any(smem(nz, ndf, c, 0) != smem_bytes(nz, ndf, True, c) for nz, ndf in widths for c in CLUSTERS) or any(
               smem(nz, ndf, c, 1) != mma_smem_bytes(nz, ndf, c) for nz, ndf in widths for c in MMA_CLUSTERS) or any(
               l2_smem(nz, ndf, m, c, k) != l2_smem_bytes(nz, ndf, m, c, k) for nz, ndf in ((128, 1024), (96, 3072))
               for m in (*L2_CHAINS, L2_NARROW) for c in L2_COLS for k in L2_KTILES):
            raise RuntimeError("fused_langevin.cu and fused_langevin.py disagree on shared memory")
        tiling = (ctypes.c_int * 5)()
        lib.damc_fused_langevin_l2_packed_floats.restype = ctypes.c_longlong
        for nz, ndf in ((128, 540), (128, 1024), (100, 1020), (128, 2336), (128, 3072), (700, 600), (3000, 200),
                        (128, 3100), (3400, 100), (128, 24065)):
            t = l2_tiling(nz, ndf)
            got = tuple(tiling) if lib.damc_fused_langevin_l2_tiling(nz, ndf, tiling) else None
            base = None if t is None else L2_NARROW if t.chains == (L2_NARROW,) else L2_BASE
            packed = lib.damc_fused_langevin_l2_packed_floats(nz, ndf)
            if got != (None if t is None else (t.nz, t.ndf, t.cols, t.ktile, base)) or packed != (
                    -1 if t is None else l2_packed_floats(nz, ndf)):
                raise RuntimeError("fused_langevin.cu and fused_langevin.py disagree on the streamed tiling")
    return lib


@functools.lru_cache(maxsize=None)
def _max_active_clusters(device: int, nz: int, ndf: int, chains: int, bf16: bool) -> int:
    lib = _library()
    out = ctypes.c_int(0)
    build.check(lib, lib.damc_fused_langevin_l2_max_clusters(nz, ndf, chains, int(bf16), ctypes.byref(out)),
                "max_active_clusters")
    return out.value


def max_active_clusters(nz: int, ndf: int, chains: int, bf16: bool = False) -> int:
    """How many clusters of the streamed variant with `chains` chains the
    current card runs at once, at the tiling of widths (nz, ndf)."""
    return _max_active_clusters(torch.cuda.current_device(), nz, ndf, chains, bool(bf16))


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
