"""The prior chain at every EBM width, on the CPU against the JAX package:
the train step, the anomaly step, the two-rank step and the EBM-prior eval
batch at widths K1 pads.

The JAX package sends every 2-hidden EBM to its TPU kernel, at any width
(`damc_tpu/ops/langevin.py:157-250`, padding only the batch). So does the
port: `fits_ebm` takes the layout alone, and the launch pads the widths
with zero weights (`ops/cuda/fused_langevin.py::launch_widths`): with fp32
dots nz to a multiple of 4 and ndf to one of the cluster (`pad_widths`),
holding the weights in shared memory over the smallest cluster whose
blocks' shares fit (4 blocks at ndf=200, 8 at ndf=512, nz=128); with bf16
dots the tensor-core variant, nz to a multiple of 16 and ndf to one of 16
x the cluster (1 block at ndf=200, 4 at ndf=512), padded by the kernel in
shared memory; where none fits (ndf=1024) the streamed variant, over a
cluster of 8 with 16, 32 or 48 chains, streams tiles of the weights from L2
(nz to a multiple of its k-tile, ndf to one of 8 x it).
On the CPU the op runs the plain version at the widths as given; the
padding tests below show that the padded chain's first nz columns are the
unpadded chain's.

The step tests run JAX's step on its CPU paths (its scan chain), every draw
from the JAX key tree (`torch_port_helpers.jax_step_draws`), the chains
noiseless (the port's K1 stream noise is not the TPU's), and hold the
metrics at rtol 1e-5 and the parameters as tests/test_torch_port_train.py
does (its docstring gives the limits)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_gloo as gloo
from damc_tpu.train import sampling as jax_sampling
from damc_tpu.train.state import create_state as jax_create_state
from damc_tpu.train.step import make_train_step as jax_make_train_step
from damc_tpu_torch.config import preset
from damc_tpu_torch.convert import train_state_from_jax
from damc_tpu_torch.models import LatentEBM
from damc_tpu_torch.ops.cuda import fused_langevin as k1
from damc_tpu_torch.ops.langevin import prior_langevin_auto
from damc_tpu_torch.ops.noise import stream_row_seeds
from damc_tpu_torch.train import sampling
from damc_tpu_torch.train.sampling import Draws, eval_draws, gen_samples_ebm_prior
from damc_tpu_torch.train.state import create_state
from damc_tpu_torch.train.step import draw_step, make_train_step
from damc_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint
from test_torch_port_data_parallel import _assert_close_params
from test_torch_port_train import _assert_metrics, _assert_state, _noiseless, _x
from torch_port_helpers import jax_and_port, jax_step_draws, one_torch_thread, to_numpy, train_cfgs

PRESETS = ("cifar10", "cifar10-stable", "svhn", "celeba64", "celebaHQ", "mnist_anomaly")
# Widths the kernel pads or spreads: nz not a multiple of 4 (float4 reads),
# and ndf=512 at nz=128 (a block's slices take 386 KB of shared memory over
# a cluster of 4, 218 KB over 8).
PADDED = {"nz10": dict(nz=10), "ndf512": dict(nz=128, ndf=512)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def group():
    yield from gloo.groups()


def _widths(cfg, **model):
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model))


def _k1_calls(monkeypatch):
    """Record the batch of every call of K1's plain version (what the op
    runs on the CPU)."""
    calls, plain = [], k1.prior_langevin_plain

    def counting(z, *a, **kw):
        calls.append(int(z.shape[0]))
        return plain(z, *a, **kw)

    monkeypatch.setattr(k1, "prior_langevin_plain", counting)
    return calls


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("widths", [None, *PADDED], ids=["preset", *PADDED])
def test_k1_takes_every_two_hidden_ebm(name, widths):
    """`fits_ebm` takes the EBM `build_models` makes at every image preset's
    widths and at nz=10 and ndf=512; each preset launches at its own widths
    with the weights in shared memory over a cluster of 4, nz=10 padded to
    12, ndf=512 with the weights in shared memory over a cluster of 8."""
    cfg = preset(name)
    if widths is not None:
        cfg = _widths(cfg, **PADDED[widths])
    m = cfg.model
    with torch.device("meta"):
        ebm = LatentEBM(m.nz, ndf=m.ndf)
    assert k1.fits_ebm(ebm)
    want = {None: (m.nz, m.ndf, True, 4), "nz10": (12, m.ndf, True, 4), "ndf512": (128, 512, True, 8)}[widths]
    assert k1.launch_widths(m.nz, m.ndf) == k1.Launch(*want)


@pytest.mark.parametrize("nz, ndf, want", [
    (128, 200, (128, 200, True, 4)),
    (128, 368, (128, 368, True, 4)),  # the widest ndf a cluster of 4 holds at nz=128
    (128, 372, (128, 376, True, 8)),
    (128, 500, (128, 504, True, 8)),
    (128, 512, (128, 512, True, 8)),
    (128, 536, (128, 536, True, 8)),  # the widest ndf a cluster of 8 holds at nz=128
    (128, 540, (128, 768, False, 8, False, (16, 32, 48))),  # streamed: ndf to a multiple of 8 x 32
    (128, 1024, (128, 1024, False, 8, False, (16, 32, 48))),
    (128, 2336, (128, 2560, False, 8, False, (16, 32))),  # 48 chains no longer fit a block
    (128, 2400, (128, 2560, False, 8, False, (16, 32))),
    (128, 3073, (128, 3200, False, 8, False, (16, 32))),  # past 32-deep tiles: 16 deep
    (100, 1020, (128, 1024, False, 8, False, (16, 32, 48))),
    (3000, 200, (3000, 256, False, 8, False, (8,))),  # 32 chains fit no block: 8
    (128, 24064, (128, 24064, False, 8, False, (8,))),  # the widest ndf the streamed variant takes
    (128, 24065, None),  # the first that raises
    (7, 10, (8, 12, True, 4)),
    (100, 510, (100, 512, True, 8)),
    (10, 512, (12, 512, True, 8)),
])
def test_launch_widths_rule(nz, ndf, want):
    """Widths that fit launch as they are; others are padded, nz to a
    multiple of 4 and ndf to one of the smallest cluster (4, then 8) whose
    blocks' shares of the weights and activations fit 227 KB, the weights
    in shared memory; past a cluster of 8 (ndf above 536 at nz=128) the
    streamed variant at its tiling (`l2_tiling`): over a cluster of 8, nz
    padded to a multiple of the k-tile and ndf to one of 8 x it, with the
    chains a cluster it may take; past its widest block (ndf=24,065 at
    nz=128, 8 chains and 32 x 8 tiles) the kernel takes no width and the
    launch raises. The route is a function of the widths alone. A 3-hidden
    EBM is not the layout K1 hand-codes."""
    assert k1.launch_widths(nz, ndf) == (None if want is None else k1.Launch(*want))
    assert k1.launch_widths(nz, ndf, "float32") == k1.launch_widths(nz, ndf)
    assert not k1.fits_ebm(LatentEBM(8, ndf=16, n_hidden=3))


@pytest.mark.parametrize("nz, ndf, want", [
    (128, 200, (128, 208, True, 1)),  # cifar10, celebaHQ: one block
    (100, 200, (112, 208, True, 1)),  # svhn, celeba64
    (8, 200, (16, 208, True, 1)),  # mnist_anomaly
    (10, 200, (16, 208, True, 1)),
    (128, 256, (128, 256, True, 1)),  # the widest ndf one block holds at nz=128
    (128, 257, (128, 320, True, 4)),
    (128, 512, (128, 512, True, 4)),  # ndf=512 on chip over a cluster of 4
    (128, 513, (128, 640, True, 8)),
    (128, 640, (128, 640, True, 8)),  # the widest ndf a cluster of 8 holds at nz=128
    (128, 641, (128, 768, False, 8)),  # streamed, padded as the fp32 streamed variant
    (128, 1024, (128, 1024, False, 8)),
    (16, 256, (16, 256, True, 1)),  # the most own columns a block's 16 warps hold, a tile each
    (16, 272, (16, 320, True, 4)),
    (128, 2400, (128, 2560, False, 8)),
    (128, 24065, None),
])
def test_launch_widths_rule_bf16(nz, ndf, want):
    """With bf16 dots the route takes the tensor-core variant over the
    smallest cluster of MMA_CLUSTERS (1, 4, 8) whose block holds the bf16
    weight slices and the activations in 227 KB (`fits_mma`), nz padded to
    a multiple of 16 and ndf to one of 16 x the cluster; past a cluster of
    8 the streamed variant with bf16 dots at the fp32 one's tiling. At nz=128 one
    block holds ndf up to 256, so the presets run in one block, and ndf=512
    runs on chip over 4. A function of (nz, ndf, dots dtype) alone."""
    got = k1.launch_widths(nz, ndf, "bfloat16")
    if want is None:
        assert got is None
        return
    assert got[:5] == (*want, True)
    assert got.mma == want[2] and got.bf16
    if got.mma:
        assert got == k1.Launch(*want, True)
        assert (got.nz, got.ndf) == k1.mma_widths(nz, ndf, got.cluster)
        smaller = [c for c in k1.MMA_CLUSTERS if c < got.cluster]
        assert k1.fits_mma(nz, ndf, got.cluster) and not any(k1.fits_mma(nz, ndf, c) for c in smaller)
    else:
        assert got._replace(bf16=False) == k1.launch_widths(nz, ndf)
    with pytest.raises(ValueError, match="dots_dtype"):
        k1.launch_widths(nz, ndf, "float16")


@pytest.mark.parametrize("nz, ndf, cluster, want", [
    (128, 200, 1, 165_888),  # cifar10: the weights 145,152 B, one block
    (100, 200, 1, 157_696),
    (8, 200, 1, 108_544),
    (128, 256, 1, 225_792),
    (128, 272, 1, 247_808),  # past the 232,448 B a block may use
    (128, 512, 1, 700_928),  # past it
    (128, 512, 4, 217_600),
    (128, 640, 8, 183_296),
    (128, 768, 8, 241_152),  # past it: from L2
])
def test_mma_smem_bytes(nz, ndf, cluster, want):
    """The tensor-core variant's shared memory, reckoned by hand from its
    layout at the padded widths (nz_p, ndf_p, J = ndf_p / cluster): bf16
    weight slices (nz_p + ndf_p) x (J + 8), 8 chains' bf16 operands z
    (nz_p + 8), h1 (ndf_p + 8), d2 and d1 (J + 8 each) at 2 bytes; 8
    chains' fp32 z and step normals (nz_p each) and, over more than one
    block, the partial sums of d1 K1^T and d2 K2^T (nz_p + ndf_p) at 4
    bytes. cifar10 in one block: 2 x ((128 + 208) x 216 + 8 x (136 + 216 +
    2 x 216)) + 4 x 8 x 2 x 128 = 165,888."""
    nz_p, ndf_p = k1.mma_widths(nz, ndf, cluster)
    j = ndf_p // cluster
    halves = (nz_p + ndf_p) * (j + 8) + 8 * ((nz_p + 8) + (ndf_p + 8) + 2 * (j + 8))
    floats = 8 * (2 * nz_p + (nz_p + ndf_p if cluster > 1 else 0))
    assert 2 * halves + 4 * floats == want
    assert k1.mma_smem_bytes(nz, ndf, cluster) == want
    assert k1.fits_mma(nz, ndf, cluster) == (want <= k1.SMEM_LIMIT)


@pytest.mark.parametrize("nz, ndf, smem_weights, cluster, want", [
    (128, 200, True, 4, 95_744),
    (100, 200, True, 4, 88_128),
    (128, 512, True, 4, 395_264),  # past the 232,448 B a block may use
    (128, 512, True, 8, 223_232),
    (128, 1024, True, 8, 698_368),  # past it again: streamed
    (128, 512, False, 8, 135_168),
    (128, 1024, False, 8, 153_600),
    (128, 2400, False, 8, 208_896),  # padded to 2560, fitted to 32 chains
    (128, 24065, False, 8, 232_512),  # 8 chains, 32 x 8 tiles: past a block
])
def test_smem_bytes_of_each_variant(nz, ndf, smem_weights, cluster, want):
    """A block's shared memory, reckoned by hand from the kernel's layout.
    On chip: 4 x ((nz + ndf) slice_ld(ndf / cluster) + 8 chains x (2 nz +
    2 ndf + 2 pad4(J) + 2 J)); the on-chip variants fit where it is within
    SMEM_LIMIT. Streamed (over a cluster of 8, at the widths its tiling pads
    to, J = ndf_p / 8, with the M chains it was fitted to and tiles of
    cols x kt): 4 x (2 nz_p M + 2 M (J + 4) + 4 cols (kt + 4) + 2 M (kt +
    4)) + M J. ndf=1024: M=32, 128 x 32 tiles, J=128: 4 x (8,192 + 8,448 +
    18,432 + 2,304) + 4,096 = 153,600. ndf=512: J=64: 4 x (8,192 + 4,352 +
    18,432 + 2,304) + 2,048 = 135,168. ndf=2400 padded to 2560, J=320: 4 x
    (8,192 + 20,736 + 18,432 + 2,304) + 10,240 = 208,896. ndf=24,065, where
    no tiling fits, at the last one tried: padded to 24,128 (8 x 8), J=3,016,
    M=8 and 32 x 8 tiles: 4 x (2,048 + 48,320 + 1,536 + 192) + 24,128 =
    232,512, past the limit."""
    assert k1.smem_bytes(nz, ndf, smem_weights, cluster) == want
    if smem_weights:
        assert k1.fits_smem(nz, ndf, cluster) == (want <= k1.SMEM_LIMIT)
    else:
        assert (k1.launch_widths(nz, ndf) is not None) == (want <= k1.SMEM_LIMIT)
        with pytest.raises(ValueError, match="clusters of 8"):
            k1.smem_bytes(nz, ndf, smem_weights, 4)


@pytest.mark.parametrize("nz, ndf, chains, cols, kt, want", [
    (128, 1024, 32, 128, 32, 153_600),  # the ndf=1024 FID batch's tiling at 32 chains
    (128, 1024, 16, 128, 32, 113_664),
    (128, 1024, 48, 128, 32, 193_536),
    (128, 3072, 32, 128, 32, 227_328),  # the widest ndf at 32 x 32 tiles that fits
    (128, 3072, 48, 128, 32, 304_128),  # past the 232,448 B a block may use
    (3000, 256, 8, 128, 8, 219_904),
    (3408, 128, 8, 32, 16, 231_040),
])
def test_l2_smem_bytes(nz, ndf, chains, cols, kt, want):
    """The streamed variant's shared memory, reckoned by hand from its
    layout at padded widths (J = ndf / 8 own columns, M chains, tiles of
    cols x kt): in floats z and the partial sums of d1 K1^T (nz x M each),
    the own columns of lrelu(h1p) (later d1) and of d2 (M x (J + 4) each),
    4 ring slots of cols x (kt + 4) and 2 activation tiles of M x (kt + 4);
    then the signs of h1p, M x J bytes. ndf=1024, M=32: 4 x (2 x 4,096 + 2
    x 4,224 + 4 x 4,608 + 2 x 1,152) + 4,096 = 153,600."""
    j = ndf // 8
    floats = 2 * nz * chains + 2 * chains * (j + 4) + 4 * cols * (kt + 4) + 2 * chains * (kt + 4)
    assert 4 * floats + chains * j == want
    assert k1.l2_smem_bytes(nz, ndf, chains, cols, kt) == want


@pytest.mark.parametrize("nz, ndf, want", [
    (128, 1024, (128, 1024, 128, 32, (16, 32, 48))),
    (128, 540, (128, 768, 128, 32, (16, 32, 48))),  # ndf to a multiple of 8 x 32
    (100, 1020, (128, 1024, 128, 32, (16, 32, 48))),  # nz to a multiple of 32
    (8, 1024, (32, 1024, 128, 32, (16, 32, 48))),
    (128, 2336, (128, 2560, 128, 32, (16, 32))),  # 48 chains past a block
    (128, 3073, (128, 3200, 128, 16, (16, 32))),  # 32-deep tiles past a block: 16 deep, ndf to 8 x 16
    (700, 600, (704, 640, 128, 8, (16, 32))),
    (3000, 200, (3000, 256, 128, 8, (8,))),  # 32 chains fit no block: 8 chains
    (3400, 100, (3408, 128, 32, 16, (8,))),  # nor tiles of 128 columns: 32
    (128, 24065, None),
])
def test_l2_tiling(nz, ndf, want):
    """The streamed variant's tiling, from the widths alone: the first of
    (32 chains, 128-column tiles), (8, 128), (8, 32), each at the deepest
    k-tile (32, 16, 8) whose block fits, nz padded to a multiple of the
    k-tile and ndf to one of 8 x it; fitted to 32 chains it takes 16 and,
    where they fit, 48. Padded widths give the same tiling back (the C
    entry checks the widths it is given so), and its chains all fit."""
    t = k1.l2_tiling(nz, ndf)
    assert (None if t is None else tuple(t)) == want
    if t is not None:
        assert k1.l2_tiling(t.nz, t.ndf) == t
        assert t.nz % t.ktile == 0 and t.ndf % (8 * t.ktile) == 0
        assert all(k1.l2_smem_bytes(t.nz, t.ndf, c, t.cols, t.ktile) <= k1.SMEM_LIMIT for c in t.chains)


@pytest.mark.parametrize("nz, ndf, want", [
    (128, 1024, 2_506_752),  # 10.0 MB: the ndf=1024 FID batch's scratch
    (128, 540, 1_691_648),
    (3000, 200, 4_584_448),  # J=32 < 128 columns: the forward tiles keep their stride
])
def test_l2_packed_floats(nz, ndf, want):
    """The streamed variant's scratch, reckoned by hand: per block of the 8
    (J = ndf_p / 8 own columns, tiles of cols x kt at the tiling's padded
    widths) the forward products' tiles, kt rows at stride cols over
    ceil(J / cols) chunks, chunks x cols x (nz_p + ndf_p) floats, and the
    transposed ones', rows at stride kt + 4, (J ndf_p + nz_p J) (kt + 4) /
    kt. ndf=1024: 8 x (128 x 1,152 + (131,072 + 16,384) x 36 / 32) =
    2,506,752; ndf=540 (768, J=96): 8 x (128 x 896 + (73,728 + 12,288) x
    36 / 32) = 1,691,648; (3000, 200) at (3000, 256), 8 chains, tiles of
    128 x 8, J=32: 8 x (128 x 3,256 + (8,192 + 96,000) x 12 / 8) =
    4,584,448."""
    t = k1.l2_tiling(nz, ndf)
    j = t.ndf // 8
    per_block = -(-j // t.cols) * t.cols * (t.nz + t.ndf) + (j * t.ndf + t.nz * j) * (t.ktile + 4) // t.ktile
    assert 8 * per_block == want
    assert k1.l2_packed_floats(nz, ndf) == want


@pytest.mark.parametrize("b, clusters, want", [
    (500, {16: 14, 32: 14, 48: 14}, 48),  # 11 clusters of 48 in one wave; 16 of 32 would take two
    (500, {16: 16, 32: 16, 48: 16}, 32),  # 16 clusters of 32 in one wave: fewer chains a cluster
    (256, {16: 16, 32: 16, 48: 16}, 16),
    (256, {16: 14, 32: 14, 48: 14}, 32),
    (16, {16: 14, 32: 14, 48: 14}, 16),
    (1, {16: 0, 32: 0, 48: 0}, 16),  # a card that reports none: the fewest chains
])
def test_l2_chains(b, clusters, want):
    """A streamed launch takes, of the chains its tiling allows, the one
    whose clusters take the fewest waves of those the card holds at once,
    then the fewest chains; every chain's sums are the same whichever."""
    assert k1.l2_chains((16, 32, 48), b, clusters.__getitem__) == want
    assert k1.l2_chains((8,), b, lambda c: 1) == 8


def _old_l2_takes(nz, ndf):
    """Whether the variant this one replaced took the widths: a cluster of 4
    blocks of 8 chains, nz padded to a multiple of 4 and ndf to one of 16,
    a block's activations 4 x 8 x (2 nz + 2 ndf + 2 pad4(J) + 2 J) bytes
    within the limit, J = ndf / 4."""
    nz4, ndf16 = -(-nz // 4) * 4, -(-ndf // 16) * 16
    j = ndf16 // 4
    return 4 * 8 * (2 * nz4 + 2 * ndf16 + 2 * j + 2 * j) <= k1.SMEM_LIMIT


@pytest.mark.parametrize("nz", [8, 10, 100, 128, 256, 1000, 2000])
def test_streamed_variant_takes_every_width_the_old_one_took(nz):
    """Every width the route sent to the variant this one replaced (where
    no on-chip variant holds the weights, in either dot precision) the
    streamed variant takes, at nz=128 ndf 537 to 2,336 and beyond (to
    24,064), at any ndf up to 3,000 at the other latent widths. (From nz=3,497
    with ndf of 80 or less, latents no EBM here has, it takes fewer: its
    ring and padding overflow a block where the old variant's did not.)"""
    for ndf in range(1, 3001):
        for dots in k1.DOTS_DTYPES:
            launch = k1.launch_widths(nz, ndf, dots)
            if launch is not None and launch.smem_weights:
                continue
            if _old_l2_takes(nz, ndf):
                assert launch is not None and launch.cluster == 8, (nz, ndf, dots)


@pytest.mark.parametrize("ndf", [376, 504, 512, 536])
def test_cluster_of_8_holds_every_hidden_column_once(ndf):
    """Over a cluster of 8 the blocks hold every hidden column exactly
    once, ndf / 8 each, a split fixed by ndf and the cluster, which the
    widths fix; the slices' row stride is a multiple of 4 with an odd
    quarter and holds the slice."""
    ranges = k1.column_ranges(ndf, 8)
    assert len(ranges) == 8 and [j for a, e in ranges for j in range(a, e)] == list(range(ndf))
    ld = k1.slice_ld(ndf // 8)
    assert ld >= ndf // 8 and ld % 4 == 0 and (ld // 4) % 2 == 1


@pytest.mark.parametrize("nz, ndf, count", [
    (128, 200, ""), (128, 512, "c8"), (128, 1024, "l2"),
    (128, 200, "tc"), (8, 200, "tc"), (128, 512, "tc"), (128, 640, "tc"), (128, 1024, "l2.bf16"),
])
def test_each_variant_counts_its_launches(nz, ndf, count):
    """Each variant the route takes has its own count object (its
    `launches`): with fp32 dots the presets' cluster of 4 counts in
    `fused_prior_langevin`, a cluster of 8 in `.c8`, the L2 variant in
    `.l2`; with bf16 dots the tensor-core variant, over any cluster, in
    `.tc` and the L2 variant in `.l2.bf16`. No two variants share one."""
    dots = "bfloat16" if count in ("tc", "l2.bf16") else "float32"
    want = k1.fused_prior_langevin
    for part in filter(None, count.split(".")):
        want = getattr(want, part)
    got = k1.launch_count(k1.launch_widths(nz, ndf, dots))
    assert got is want and isinstance(got.launches, int)
    f = k1.fused_prior_langevin
    counts = [f, f.c8, f.tc, f.l2, f.l2.bf16]
    assert len({id(c) for c in counts}) == len(counts)


def _weights(nz, ndf, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(nz, ndf, generator=g) / nz**0.5, torch.randn(ndf, generator=g) * 0.1,
            torch.randn(ndf, ndf, generator=g) / ndf**0.5, torch.randn(ndf, generator=g) * 0.1,
            torch.randn(ndf, generator=g) / ndf**0.5], torch.randn(6, nz, generator=g)


NOISE = {"stream": dict(seed=-987), "counter": dict(row_seeds=torch.tensor([3, -7, 11, 2**31 - 1, 0, 5])),
         "noiseless": dict(with_noise=False)}


@pytest.mark.parametrize("dots", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(NOISE))
@pytest.mark.parametrize("nz, ndf", [(10, 200), (7, 10), (128, 510), (10, 512), (128, 500), (128, 1020),
                                     (100, 1020), (128, 540)])
def test_padded_chain_is_the_unpadded_chain(nz, ndf, mode, dots):
    """The chain on `pad_widths`' inputs, at the widths `launch_widths`
    gives (ndf to a multiple of 4 or, over a cluster of 8, of 8: (128, 500)
    to 504; the streamed variant's nz to a multiple of its k-tile and ndf
    to one of 8 x it: (128, 1020) to 1024, (100, 1020) to (128, 1024),
    (128, 540) to 768), is the
    unpadded chain in its first nz columns, in every noise mode and dot
    precision: a zero weight adds exact zeros, a padded
    hidden unit's pre-activation is 0 and feeds nothing, and a column's
    noise depends on its index alone. Where only nz is padded the products
    are the same sums, so the two agree bit for bit; where ndf is padded
    the plain version's matmuls block the sums otherwise, so they agree to
    float32 rounding over 6 steps (1e-6; bf16 operands 1e-5, where a
    one-ulp sum can flip an operand's rounding)."""
    w, z = _weights(nz, ndf, nz + ndf)
    nz_p, ndf_p = k1.launch_widths(nz, ndf)[:2]
    kw = dict(steps=6, step_size=0.4, dots_dtype=dots, **NOISE[mode])
    want = k1.prior_langevin_plain(z, *w, **kw)
    padded = k1.pad_widths(z, *w, nz_p, ndf_p)
    assert padded[0].shape == (6, nz_p) and padded[3].shape == (ndf_p, ndf_p)
    got = k1.prior_langevin_plain(*padded, **kw)[:, :nz]
    if ndf_p == ndf:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 if dots == "bfloat16" else 1e-6)


@pytest.mark.parametrize("mode", list(NOISE))
@pytest.mark.parametrize("nz, ndf", [(8, 200), (100, 200), (128, 200), (10, 512), (128, 500), (128, 600)])
def test_padded_chain_is_the_unpadded_chain_at_the_tensor_core_widths(nz, ndf, mode):
    """With bf16 dots, the chain zero-padded to the tensor-core variant's
    widths (`launch_widths(nz, ndf, "bfloat16")`, which the kernel pads in
    shared memory: nz 8 -> 16 and 100 -> 112, ndf 200 -> 208 in one block,
    500 -> 512 over 4, 600 -> 640 over 8) is the unpadded chain in its
    first nz columns, in every noise mode: a zero weight adds exact zeros,
    a padded hidden unit feeds nothing, and a column's noise depends on its
    index alone. Where only nz is padded the sums are the same, bit for
    bit; where ndf is, the plain version's matmuls block them otherwise, so
    they agree to 1e-5 over 6 steps, as the fp32 widths' test holds bf16."""
    w, z = _weights(nz, ndf, nz + ndf)
    launch = k1.launch_widths(nz, ndf, "bfloat16")
    assert launch.mma
    kw = dict(steps=6, step_size=0.4, dots_dtype="bfloat16", **NOISE[mode])
    want = k1.prior_langevin_plain(z, *w, **kw)
    padded = k1.pad_widths(z, *w, launch.nz, launch.ndf)
    assert padded[0].shape == (6, launch.nz) and padded[3].shape == (launch.ndf, launch.ndf)
    got = k1.prior_langevin_plain(*padded, **kw)
    if mode == "noiseless":  # a padded z column stays 0
        assert torch.equal(got[:, nz:], torch.zeros_like(got[:, nz:]))
    if launch.ndf == ndf:
        assert torch.equal(got[:, :nz], want)
    else:
        torch.testing.assert_close(got[:, :nz], want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", list(NOISE))
def test_plain_bf16_chain_runs_in_float64(mode):
    """With bf16 dots a float64 z and float64 weights run the plain chain in
    float64, operands rounded to bf16 where the kernel rounds them (the
    reference chip_smoke holds K1's bf16-dot variants to); a float32 chain
    is what it was, operands rounded and held in float32."""
    w, z = _weights(12, 64, 7)
    kw = dict(steps=6, step_size=0.4, dots_dtype="bfloat16", **NOISE[mode])
    ref = k1.prior_langevin_plain(z.double(), *[t.double() for t in w], **kw)
    got = k1.prior_langevin_plain(z, *w, **kw)
    assert ref.dtype == torch.float64 and got.dtype == torch.float32
    assert k1._bf16_operand(z).dtype == torch.float32
    assert torch.equal(k1._bf16_operand(z), z.to(torch.bfloat16).float())
    torch.testing.assert_close(got.double(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name, widths", [("cifar10", "nz10"), ("cifar10", "ndf512"), ("mnist_anomaly", "nz10")],
                         ids=["cifar10-nz10", "cifar10-ndf512", "anomaly-nz10"])
def test_train_step_at_padded_widths_matches_jax(name, widths, monkeypatch):
    """One iteration with `use_pallas` on at widths K1 pads against JAX's
    step: the port's chains run on K1 (its plain version here, once a step
    over the 2B chains, or the B chains of the anomaly step), JAX's on its
    scan chain. The anomaly step runs its single chains, fixed mask and
    both Q loss branches."""
    cfg_j, cfg_p = (_noiseless(_widths(c, **PADDED[widths])) for c in train_cfgs(name))
    assert cfg_p.train.use_pallas and cfg_j.train.use_pallas
    state, models_j, opts_j = jax_create_state(jax.random.PRNGKey(0), cfg_j)
    port = train_state_from_jax(to_numpy(state), cfg_p, device="cpu")
    x = _x(cfg_j, np.random.default_rng(5))
    draws = jax_step_draws(state.rng, cfg_j, len(x))
    assert draws.chain_noise is None
    calls = _k1_calls(monkeypatch)
    state, mj = jax.jit(jax_make_train_step(models_j, opts_j, cfg_j))(state, jnp.asarray(x))
    port, mp = make_train_step(port.models, port.opts, cfg_p)(port, torch.from_numpy(x), draws)
    assert calls == [2 * len(x) if cfg_p.train.prior_chains == "double" else len(x)]
    _assert_metrics(mp, mj)
    _assert_state(port, state, cfg_j, 1)


def _nz10(cfg):
    return dataclasses.replace(
        _widths(cfg, nz=10),
        mcmc=dataclasses.replace(cfg.mcmc, e_l_with_noise=False, e_l_steps=4),
        diffusion=dataclasses.replace(cfg.diffusion, with_noise=False),
    )


def test_ebm_prior_batch_at_nz10_matches_jax(monkeypatch):
    """The EBM-prior eval batch at nz=10 with `use_pallas` on against JAX's
    `gen_samples_ebm_prior` on the same z0, the chain's noise off on both
    sides, as tests/test_torch_port_sampling.py holds it at nz=8 (atol
    1e-5): K1 runs the chain once."""
    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=3, edit=_nz10)
    assert cfg_p.train.use_pallas and cfg_p.model.nz == 10
    key, b = jax.random.PRNGKey(11), 5
    want = np.asarray(jax_sampling.gen_samples_ebm_prior(key, state, models_j, cfg_j, b))
    z0 = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[0], (b, 10)), np.float32))
    calls = _k1_calls(monkeypatch)
    got = sampling.gen_samples_ebm_prior(models_p, cfg_p, Draws(z0, torch.zeros_like(z0), 0, 0))
    assert calls == [b] and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_ebm_prior_batch_at_nz10_is_a_function_of_its_draws(monkeypatch):
    """With the chain's noise on, an EBM-prior batch at nz=10 is K1 on the
    draws' stream seed: two calls agree bit for bit and equal that chain,
    run through `prior_langevin_auto`, decoded by G."""
    _, cfg = train_cfgs("cifar10")
    cfg = _widths(cfg, nz=10)
    assert cfg.train.use_pallas and cfg.mcmc.e_l_with_noise
    models = create_state(cfg, seed=2, device="cpu").models
    d = eval_draws(3, "fid_ebm", 0, 0, 6, 10, "cpu")
    calls = _k1_calls(monkeypatch)
    a, b = gen_samples_ebm_prior(models, cfg, d), gen_samples_ebm_prior(models, cfg, d)
    assert calls == [6, 6] and torch.equal(a, b) and bool(torch.isfinite(a).all())
    mc = cfg.mcmc
    z, _ = prior_langevin_auto(d.z0, models.ebm, mc.e_l_steps, mc.e_l_step_size, mc.e_l_with_noise,
                               seed=d.chain_seed)
    w = k1.ebm_params_to_dense_weights(models.ebm)
    plain = k1.prior_langevin_plain(d.z0, *w, steps=mc.e_l_steps, step_size=mc.e_l_step_size,
                                    row_seeds=stream_row_seeds(d.chain_seed, 6))
    assert torch.equal(z, plain)
    with torch.no_grad():
        assert torch.equal(a, models.generator(z))


def _draws_by_hand(cfg, b, seed, chains=None):
    """The draws of `draw_step` in its order (mask uniforms, the sweep's
    start, the fresh chain starts, the posterior normals, each Q update's
    (prior noise, u, eps) per branch), then, when `chains` is given, the
    (e_l_steps, chains, nz) normals of the autograd chain."""
    tc, nz = cfg.train, cfg.model.nz
    gen = torch.Generator().manual_seed(seed)
    normal = lambda *shape: torch.randn(shape, generator=gen)
    out = [torch.rand((b,), generator=gen), normal(b, nz)]
    if tc.prior_chains == "double":
        out.append(normal(b, nz))
    out.append(normal(cfg.mcmc.g_l_steps, b, nz))
    for _ in range(tc.q_updates):
        for _ in range(2 if tc.q_loss_both_branches else 1):
            out += [normal(b, nz), torch.rand((b,), generator=gen), normal(b, nz)]
    if chains is not None:
        out.append(normal(cfg.mcmc.e_l_steps, chains, nz))
    return out


def _flat(d):
    out = [d.mask_u, d.z0_init] + ([d.neg_init] if d.neg_init is not None else []) + [d.post_noise]
    for pair in d.q:
        for qd in pair:
            if qd is not None:
                out += [qd.prior_noise, qd.u, qd.eps]
    return out + ([d.chain_noise] if d.chain_noise is not None else [])


@pytest.mark.parametrize("name", ["cifar10", "mnist_anomaly"])
@pytest.mark.parametrize("widths", list(PADDED))
def test_draw_step_does_not_depend_on_the_ebm_widths(widths, name):
    """At nz=10 and ndf=512 `draw_step` draws what it draws at any width:
    with `use_pallas` on no chain normals (K1 draws its own from the
    stream seed), every draw the generator's sequence in its order; with
    `use_pallas` off the autograd chain's (e_l_steps, chains, nz) normals
    after every other draw."""
    _, cfg = train_cfgs(name)
    cfg = _widths(cfg, **PADDED[widths])
    b = cfg.train.batch_size
    chains = 2 * b if cfg.train.prior_chains == "double" else b
    off = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_pallas=False))
    for c, on_k1 in ((cfg, True), (off, False)):
        d = draw_step(c, b, create_state(c, seed=1, device="cpu"))
        want = _draws_by_hand(c, b, 1, None if on_k1 else chains)
        got = _flat(d)
        assert (d.chain_noise is None) == on_k1 and len(got) == len(want)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        if not on_k1:
            assert d.chain_noise.shape == (c.mcmc.e_l_steps, chains, c.model.nz)


def test_two_rank_step_at_nz10_equals_world_one(group, tmp_path):
    """Two steps at nz=10 with the chains' noise on, on 2 gloo ranks, each
    rank drawing the global batch's draws from its own generator as a run
    does: K4a splits the 2B chains (each rank K1 on B of them from its
    first global row), K4b the Q rows; the replicas are equal, and the
    metrics and parameters are the world-1 steps' within
    tests/test_torch_port_data_parallel.py's limits (the order of the
    reductions alone differs; a chain's noise is its global row's)."""
    _, cfg = train_cfgs("cifar10", ema_every=2)
    cfg = _widths(_noiseless(cfg), nz=10)
    cfg = dataclasses.replace(cfg, mcmc=dataclasses.replace(cfg.mcmc, e_l_with_noise=True))
    save_checkpoint(str(tmp_path), "0", create_state(cfg, 0, "cpu"))
    r = np.random.default_rng(0)
    xs = [_x(cfg, r) for _ in range(2)]
    (m0, a0, n0, c0), (m1, a1, n1, c1) = group(2).run(gloo.drawn_train_steps, cfg, str(tmp_path), xs)

    one = restore_checkpoint(str(tmp_path), "0", create_state(cfg, 0, "cpu"))
    step = make_train_step(one.models, one.opts, cfg)
    metrics_1 = []
    for x in xs:
        one, m = step(one, torch.from_numpy(x), draw_step(cfg, len(x), one))
        metrics_1.append(m)

    b = cfg.train.batch_size
    assert n0 == n1 == [None, None]
    for rank, calls in enumerate((c0, c1)):
        assert sorted(calls) == sorted([("K1", b, rank * b), ("K2", b // 2, rank * b // 2)] * 2)
    assert m0 == m1 and all(np.array_equal(a0[k], a1[k]) for k in a0)
    for got, want in zip(m0, metrics_1):
        _assert_metrics(got, want)
    _assert_close_params(a0, gloo.state_arrays(one), cfg)


def test_k1_phases_instruments_the_tensor_core_kernel():
    """`tools/k1_phases.py` times the phases of the tensor-core kernel by
    text replacement in `csrc/fused_langevin.cu`: every pattern it needs
    is found once in the source as it stands, and each of its phase
    timers is placed."""
    from damc_tpu_torch.ops.cuda import build
    from damc_tpu_torch.tools import k1_phases

    src = k1_phases.instrument((build.SRC_DIR / "fused_langevin.cu").read_text())
    assert all(f"PT({i});" in src for i in range(len(k1_phases.PHASES)))
    assert "damc_phase_cycles" in src


def test_k1_l2_phases_instruments_the_streamed_kernel():
    """`tools/k1_l2_phases.py` times the phases of the streamed kernel by
    text replacement in `csrc/fused_langevin.cu`: every pattern it needs is
    found in the streamed kernel as often as it expects, and each of its
    phase timers is placed."""
    from damc_tpu_torch.ops.cuda import build
    from damc_tpu_torch.tools import k1_l2_phases

    src = k1_l2_phases.instrument((build.SRC_DIR / "fused_langevin.cu").read_text())
    assert all(f"PH({i});" in src for i in range(len(k1_l2_phases.PHASES)))
    assert "g_l2_cycles" in src and "damc_l2_cycles" in src
