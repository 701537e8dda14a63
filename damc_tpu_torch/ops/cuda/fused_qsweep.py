"""K2: the n-step reverse-diffusion sweep — wrapper, plain version, fit rule.

Counterpart of `damc_tpu/ops/pallas/fused_qsweep.py` (`fused_reverse_sweep`,
`denoiser_layer_params`, `fits_vmem`). The kernel is
`damc_tpu_torch/csrc/fused_qsweep.cu`; its source note gives the design.

`fused_reverse_sweep` calls the custom op `torch.ops.damc.fused_reverse_sweep`,
which runs the plain PyTorch version for tensors on the CPU and launches
the kernel for tensors on a CUDA device; anything else, or a failed build
or launch, raises. A fake implementation gives the output's shape, so
`make_fx` and `torch.export` record the whole sweep as one node. `fused_reverse_sweep.launches` counts the
kernel launches.

Noise modes, as the TPU kernel's: counter (`row_seeds`, per-row int32
seeds; serving), stream (`seed`, one int32 for the launch; the training
step's Q_ema draw) and noiseless. Stream mode draws row i's noise from
`ops/noise.py::stream_row_seeds(seed, B)[i]`, not from the TPU's on-core
PRNG (see `ops/noise.py`).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
import weakref
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..noise import counter_normal, int32_seed, stream_row_seeds
from . import build

N_COEF = 6  # c1, c2, m_z, m_x, std, is_last
# The kernel's geometry (csrc/fused_qsweep.cu; `_library` checks it):
TILE_ROWS = (4, 8, 12, 16)  # the row tiles (rows per cluster) a launch may take
CLUSTER = 8  # blocks per cluster; each owns 1/CLUSTER of every layer's columns
THREADS = 544  # 16 compute warps and the producer warp
K_SPLIT = 8  # chunks of every weight stage's rows, one per warp of each half
MAX_TILE = 32  # most columns a block may own in one layer
STAGE_ROWS = 64  # input rows of a weight stage
LAYERS = 7
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


def col_tile(dout: int) -> int:
    """Columns a block owns in a layer of width `dout`: ceil(dout / CLUSTER)
    rounded up to a multiple of 16 (the kernel's thread layouts)."""
    t = -(-dout // CLUSTER)
    return -(-t // 16) * 16


def column_ranges(dout: int) -> List[Tuple[int, int]]:
    """[start, stop) of the output columns of each block of a cluster; the
    last blocks of a ragged layer own fewer columns or none."""
    t = col_tile(dout)
    return [(min(r * t, dout), min((r + 1) * t, dout)) for r in range(CLUSTER)]


def chunk_rows(n: int) -> List[List[Tuple[int, int]]]:
    """For each of the K_SPLIT chunks, the [start, stop) runs of an input
    dimension of width n that it sums, in order: the weights stream through
    shared memory in stages of STAGE_ROWS rows, and chunk q takes rows
    [q * STAGE_ROWS // K_SPLIT, (q + 1) * STAGE_ROWS // K_SPLIT) of every
    stage. The chunks' partial sums are then added in chunk order. This is
    the summation order of every output element, fixed by n alone."""
    per = STAGE_ROWS // K_SPLIT
    return [
        [(s + q * per, min(s + (q + 1) * per, n)) for s in range(0, n, STAGE_ROWS) if s + q * per < n]
        for q in range(K_SPLIT)
    ]


def pack_weights(layers: Sequence[LayerTuple]) -> torch.Tensor:
    """The layers' weights as the kernel streams them: layer by layer, the
    (lin, skip) pair, then the (gate, hyper) pair, each pair of (n, dout)
    matrices padded with zero columns to CLUSTER * col_tile(dout) and laid
    out [rank][row][matrix][col_tile]: the rows of a block's column tile of
    both matrices are contiguous, so a weight stage is one bulk copy."""
    parts = []
    for lt in layers:
        dout = int(lt[0].shape[1])
        t = col_tile(dout)
        for m0, m1 in ((lt[0], lt[2]), (lt[4], lt[6])):
            pair = torch.stack([F.pad(m, (0, CLUSTER * t - dout)) for m in (m0, m1)], dim=1)
            parts.append(pair.reshape(pair.shape[0], 2, CLUSTER, t).permute(2, 0, 1, 3).reshape(-1))
    return torch.cat(parts)


# The last packings, newest last: (weak references to the source tensors,
# their version counters, the packed tensor). Serving passes one set of
# layer tuples for its lifetime, and a loaded serving artifact one set a
# program (its damc and recon programs hold their own copies), so each packs
# once; a caller that builds new tuples (the training step) packs every call.
_PACK_CACHE = 4
_packs: List[Tuple[tuple, tuple, torch.Tensor]] = []


def _packed(flat: Sequence[torch.Tensor]) -> torch.Tensor:
    """pack_weights of the flat layer tensors, reused while the very same
    tensors, unmodified, come again."""
    versions = tuple(t._version for t in flat)
    with _lock:
        for i, (refs, seen, packed) in enumerate(_packs):
            if seen == versions and len(refs) == len(flat) and all(r() is t for r, t in zip(refs, flat)):
                _packs.append(_packs.pop(i))
                return packed
    packed = pack_weights([flat[7 * l:7 * l + 7] for l in range(LAYERS)])
    with _lock:
        _packs[:] = [e for e in _packs if all(r() is not None for r in e[0])]  # sources gone
        _packs.append((tuple(weakref.ref(t) for t in flat), versions, packed))
        del _packs[:-_PACK_CACHE]
    return packed


def ring_stages(rows: int) -> int:
    """Weight stages in a block's shared-memory ring at a row tile, all but
    one in flight: as many as the tile's other buffers leave room for."""
    return 11 if rows <= 4 else 8 if rows <= 8 else 6 if rows <= 12 else 4


def stages_per_step(dins: Sequence[int], douts: Sequence[int]) -> int:
    """Weight stages one step streams: each layer's din rows, then its dout
    rows, in stages of STAGE_ROWS."""
    return sum(-(-n // STAGE_ROWS) for n in (*dins, *douts))


def row_tile(b: int, max_clusters: int) -> int:
    """The row tile of a launch of b rows: the smallest that puts every
    cluster on the card at once (at most `max_clusters`), else the
    largest. A small batch so spreads over more SMs, a large one reuses
    each weight stage for more rows. The tile never changes a row's
    arithmetic (`chunk_rows`), so a row's result does not depend on it."""
    for rows in TILE_ROWS:
        if -(-b // rows) <= max_clusters:
            return rows
    return TILE_ROWS[-1]


def smem_bytes(nz: int, dins: Sequence[int], douts: Sequence[int], rows: int = TILE_ROWS[-1]) -> int:
    """Shared memory of one block (the kernel's layout) at a row tile: the
    ring of weight stages, the chunks' partial sums, per row the whole z,
    the layer input and context, the block's output and context tiles of
    every layer and its Fourier features, and the table of one step's
    weight stages."""
    ring = ring_stages(rows) * STAGE_ROWS * 2 * MAX_TILE
    nfour = (dins[0] - nz) // 2
    in_max, d_max = (-(-max(w) // 4) * 4 for w in (dins, douts))  # row strides, float4-aligned
    per_row = nz + in_max + d_max + 2 * LAYERS * MAX_TILE + 2 * -(-nfour // CLUSTER)
    floats = ring + K_SPLIT * 4 * rows * MAX_TILE + rows * per_row
    return 4 * floats + 8 * stages_per_step(dins, douts)


def fits_smem(nz: int, dins: Sequence[int], douts: Sequence[int]) -> bool:
    """The Hopper fit rule in place of the TPU's `fits_vmem`: no block
    owning more than MAX_TILE columns of a layer (at most 256 columns a
    layer on a cluster of 8), and a block's shared memory within 227 KB at
    every row tile. Widths need not be multiples of 4 (the toy's nz = 2).
    The CIFAR-10 family and the toy fit (at most 214 KB a block); the
    StyleGAN width (1024, nz=7168) does not."""
    return (
        all(col_tile(d) <= MAX_TILE for d in douts)
        and max(smem_bytes(nz, dins, douts, r) for r in TILE_ROWS) <= SMEM_LIMIT
    )


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
    seed=None,
    steps: int = 1,
    with_noise: bool = True,
    residual: bool = True,
    row_seeds=None,
) -> torch.Tensor:
    """The kernel's function as a Python loop over steps (torch.matmul), in
    the dtype of its inputs (float32; float64 gives a reference).
    `row_seeds` wins over `seed`."""
    act = lambda h: torch.where(h >= 0.0, h, _LRELU * h)
    z = z_init
    nz = z.shape[1]
    if with_noise and row_seeds is None:
        row_seeds = stream_row_seeds(seed, z.shape[0], z.device)
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
    seed=None,
    steps: int = 1,
    with_noise: bool = True,
    residual: bool = True,
    row_seeds=None,
) -> torch.Tensor:
    """Run the whole n-step reverse sweep: z_init (B, nz) -> x_hat (B, nz).

    `pre_x[l]` (B, dout_l) and `pre_t[l]` (n, dout_l) are the denoiser's
    sample tables and `coeffs` (n, 6) the `step_coefficients` table.
    Noise: `row_seeds` (B,) int32 selects counter mode, row i a function of
    (row_seeds[i], z_init[i], pre_x[*][i]) only; otherwise `seed` (int32)
    selects stream mode, row i a function of (seed, i, z_init[i],
    pre_x[*][i]). `row_seeds` wins when both are given.

    The sweep runs as the custom op `torch.ops.damc.fused_reverse_sweep`,
    `layers` flattened into one list of 7 tensors a layer (the widths come
    from their shapes): its CPU implementation is the plain version, its
    CUDA implementation the kernel launch."""
    if with_noise and seed is None and row_seeds is None:
        raise ValueError("a noisy sweep needs seed (stream mode) or row_seeds (counter mode)")
    if z_init.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no reverse-sweep kernel for device {z_init.device}")
    if row_seeds is not None and not isinstance(row_seeds, torch.Tensor):
        row_seeds = torch.as_tensor(row_seeds, device=z_init.device)
    return torch.ops.damc.fused_reverse_sweep(
        z_init, fourier, [t for lt in layers for t in lt], list(pre_x), list(pre_t), coeffs,
        row_seeds if with_noise else None, None if seed is None else int32_seed(seed),
        int(steps), bool(with_noise), bool(residual),
    )


fused_reverse_sweep.launches = 0


def _layer_tuples(flat: Sequence[torch.Tensor]) -> List[LayerTuple]:
    return [tuple(flat[i:i + 7]) for i in range(0, len(flat), 7)]


@torch.library.custom_op("damc::fused_reverse_sweep", mutates_args=(), device_types="cpu")
def _sweep_op(
    z_init: torch.Tensor, fourier: torch.Tensor, layers: List[torch.Tensor],
    pre_x: List[torch.Tensor], pre_t: List[torch.Tensor], coeffs: torch.Tensor,
    row_seeds: Optional[torch.Tensor], seed: Optional[int], steps: int, with_noise: bool,
    residual: bool,
) -> torch.Tensor:
    out = reverse_sweep_plain(
        z_init, fourier, _layer_tuples(layers), pre_x, pre_t, coeffs, seed=seed, steps=steps,
        with_noise=with_noise, residual=residual, row_seeds=row_seeds,
    )
    return out.clone() if out is z_init else out  # an op's output may not alias its input


@_sweep_op.register_fake
def _sweep_fake(z_init, fourier, layers, pre_x, pre_t, coeffs, row_seeds, seed, steps, with_noise, residual):
    dtype = torch.float32 if z_init.device.type == "cuda" else z_init.dtype
    return z_init.new_empty(z_init.shape, dtype=dtype)


@_sweep_op.register_kernel("cuda")
def _sweep_launch(z_init, fourier, layers, pre_x, pre_t, coeffs, row_seeds, seed, steps, with_noise, residual):
    layers = _layer_tuples(layers)
    nz, nfour, dins, douts = _dims(fourier, layers)
    _check_unet(nz, nfour, dins, douts)
    if not fits_smem(nz, dins, douts):
        raise ValueError(
            f"denoiser widths din={dins}, dout={douts} do not fit the sweep kernel: "
            f"at most {CLUSTER * MAX_TILE} columns a layer, "
            f"and {max(smem_bytes(nz, dins, douts, r) for r in TILE_ROWS)} B of shared memory "
            f"a block within {SMEM_LIMIT}"
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
    if with_noise and row_seeds is not None:
        seeds = row_seeds.to(device=dev, dtype=torch.int32).contiguous()
        if seeds.shape != (b,):
            raise ValueError(f"row_seeds must be ({b},), got {tuple(seeds.shape)}")
    stream = with_noise and seeds is None
    out = torch.empty_like(z)
    lib = _library()
    packed = _packed(flat)
    ptrs = (ctypes.c_void_p * len(flat))(*[t.data_ptr() for t in flat])
    dims = (ctypes.c_int * 14)(*dins, *douts)
    # The row tile is a host decision at each launch, from B and the card.
    rows = row_tile(b, max_active_clusters(nz, dins, douts))
    rc = lib.damc_fused_qsweep(
        z.data_ptr(), four.data_ptr(), packed.data_ptr(), ptrs, dims, px.data_ptr(), pt.data_ptr(),
        cf.data_ptr(), None if seeds is None else seeds.data_ptr(),
        int32_seed(seed) if stream else 0, int(stream), out.data_ptr(),
        b, nz, nfour, steps, int(residual), rows, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(lib, rc, "fused_reverse_sweep")
    with _lock:
        fused_reverse_sweep.launches += 1
    return out


def _library() -> ctypes.CDLL:
    lib = build.load("fused_qsweep")
    fn = lib.damc_fused_qsweep
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # z, fourier, packed, layer_ptrs, dims, pre_x, pre_t, coeffs, seeds,
        # seed, stream_noise, out, B, nz, nfour, steps, residual, rows, stream
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        geometry = (ctypes.c_int * 9)()
        lib.damc_fused_qsweep_geometry(geometry)
        if tuple(geometry) != (CLUSTER, THREADS, K_SPLIT, MAX_TILE, STAGE_ROWS, *TILE_ROWS):
            raise RuntimeError("fused_qsweep.cu and fused_qsweep.py disagree on the geometry")
        agree = True
        for nz, widths in ((128, (256, 128, 256, 256, 512, 512, 256, 128, 256, 256, 256, 256, 128, 128)),
                           (100, (200, 128, 256, 256, 512, 512, 256, 128, 256, 256, 256, 256, 128, 100)),
                           (2, (4, 128, 256, 256, 512, 512, 256, 128, 256, 256, 256, 256, 128, 2)),
                           (2, (6, 10, 10, 10, 21, 21, 21, 10, 10, 10, 11, 11, 11, 2))):
            dims = (ctypes.c_int * 14)(*widths)
            agree &= all(lib.damc_fused_qsweep_smem_bytes(dims, nz, r) == smem_bytes(nz, widths[:7], widths[7:], r)
                         for r in TILE_ROWS)
            agree &= lib.damc_fused_qsweep_packed_floats(dims) == sum(
                2 * (n + d) * CLUSTER * col_tile(d) for n, d in zip(widths[:7], widths[7:]))
        for n in (4, 100, 128, 256, 512):
            agree &= lib.damc_fused_qsweep_col_tile(n) == col_tile(n)
        if not agree:
            raise RuntimeError("fused_qsweep.cu and fused_qsweep.py disagree on the plan")
    return lib


def max_active_clusters(nz: int, dins: Sequence[int], douts: Sequence[int]) -> int:
    """How many clusters of the sweep kernel the current card runs at once,
    at the largest row tile (the smaller tiles use less shared memory, and
    a block of theirs still fills an SM's registers)."""
    return _max_active_clusters(torch.cuda.current_device(), nz, tuple(dins), tuple(douts))


@functools.lru_cache(maxsize=None)
def _max_active_clusters(device: int, nz: int, dins: Tuple[int, ...], douts: Tuple[int, ...]) -> int:
    lib = _library()
    out = ctypes.c_int(0)
    dims = (ctypes.c_int * 14)(*dins, *douts)
    build.check(lib, lib.damc_fused_qsweep_max_active_clusters(
        dims, nz, TILE_ROWS[-1], ctypes.byref(out)), "max_active_clusters")
    return out.value
