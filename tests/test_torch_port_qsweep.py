"""K2, the reverse sweep: the plain version of the port's sweep kernel
against the JAX Pallas kernel (plain interpreter) at the CIFAR-10 denoiser
widths, the weight extraction from the port's denoiser, the Hopper fit
rule and the wrapper's dispatch rules."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damc_tpu.ops.pallas.fused_qsweep import fused_reverse_sweep as jax_sweep
from damc_tpu.ops.pallas.fused_qsweep import step_coefficients as jax_coeffs
from damc_tpu_torch.models import LatentDenoiser
from damc_tpu_torch.ops.cuda import fused_qsweep as k2

NZ, NARROW, WIDE = 128, 128, 256
DINS = [2 * NZ, NARROW, WIDE, WIDE, 2 * WIDE, 2 * WIDE, 2 * NARROW]
DOUTS = [NARROW, WIDE, WIDE, WIDE, WIDE, NARROW, NZ]


def _inputs(b, n, seed, scale=1.0):
    """Random weights (torch-default scale; `scale` damps the layers), step
    and sample tables at the cifar10 widths."""
    r = np.random.default_rng(seed)
    u = lambda shape, fan: (scale * r.uniform(-1, 1, shape) / np.sqrt(fan)).astype(np.float32)
    fourier = r.normal(size=(NZ, NZ // 2)).astype(np.float32)
    layers = [
        (u((i, o), i), u((o,), i), u((i, o), i), u((o,), i), u((o, o), o), u((o,), o), u((o, o), o))
        for i, o in zip(DINS, DOUTS)
    ]
    pre_x = [r.normal(size=(b, o)).astype(np.float32) for o in DOUTS]
    pre_t = [r.normal(size=(n, o)).astype(np.float32) for o in DOUTS]
    z = r.normal(size=(b, NZ)).astype(np.float32)
    seeds = r.integers(0, 2**31 - 1, b).astype(np.int32)
    coeffs = np.array(jax_coeffs(n, -5.1, 9.8, "large"))
    return z, fourier, layers, pre_x, pre_t, coeffs, seeds


def _jax(z, fourier, layers, pre_x, pre_t, coeffs, seeds, n, noisy):
    j = jnp.asarray
    return np.asarray(
        jax_sweep(
            j(z), j(fourier), [tuple(map(j, lt)) for lt in layers], [j(t) for t in pre_x],
            [j(t) for t in pre_t], j(coeffs), steps=n, with_noise=noisy, residual=True,
            interpret="plain", row_seeds=j(seeds) if noisy else None,
        )
    )


def _port(z, fourier, layers, pre_x, pre_t, coeffs, seeds, n, noisy):
    t = torch.from_numpy
    return k2.reverse_sweep_plain(
        t(z), t(fourier), [tuple(map(t, lt)) for lt in layers], [t(a) for a in pre_x],
        [t(a) for a in pre_t], t(coeffs), row_seeds=t(seeds) if noisy else None, steps=n,
        with_noise=noisy, residual=True,
    ).numpy()


@pytest.mark.parametrize("noisy", [False, True], ids=["noiseless", "counter_noise"])
def test_plain_sweep_matches_jax_n6(noisy):
    """Six steps, atol 2e-4 / rtol 1e-4 (the JAX suite's bound for the fused
    sweep against its scan at n=6). The layers are damped to half the
    torch-default scale: at full scale random weights amplify float32
    rounding ~1e4-fold in six steps (1.4e-2 between fp32 and fp64 of the
    same plain version), beyond any fp32 pair's reach. Counter noise
    enters with the same bits on both sides."""
    args = _inputs(10, 6, seed=11, scale=0.5)
    got, want = _port(*args, 6, noisy), _jax(*args, 6, noisy)
    assert np.isfinite(got).all() and got.shape == (10, NZ)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_plain_sweep_matches_jax_full_scale_two_steps():
    """Full-scale random weights over two noisy steps, atol 2e-4 / rtol 1e-4."""
    args = _inputs(8, 2, seed=12)
    np.testing.assert_allclose(_port(*args, 2, True), _jax(*args, 2, True), atol=2e-4, rtol=1e-4)


def test_denoiser_layer_params_follow_the_module():
    torch.manual_seed(0)
    den = LatentDenoiser(NZ, nxemb=32, ntemb=16, nf=4, residual=True)
    fourier, layers = k2.denoiser_layer_params(den)
    assert fourier.shape == (NZ, NZ // 2) and len(layers) == 7
    assert [tuple(lt[0].shape) for lt in layers] == list(zip(DINS, DOUTS))
    lin = den.out_layers[1]._layer[0]
    assert torch.equal(layers[5][0], lin.weight.t()) and layers[5][0].is_contiguous()
    assert layers[0][6].shape == (NARROW, NARROW)  # hyper_k, no bias
    h = torch.randn(3, DINS[2])
    assert torch.allclose(h @ layers[2][2] + layers[2][3], den.in_layers[2]._skip(h), atol=1e-6)


TOY_DINS = [4, 128, 256, 256, 512, 512, 256]  # nz = 2: one Fourier pair, then [sin, cos, z]
TOY_DOUTS = [128, 256, 256, 256, 256, 128, 2]


def test_fit_rule():
    """The CIFAR-10 widths and the toy's (nz = 2, whose last layer is 2
    wide: widths need not be multiples of 4) fit the cluster kernel at
    every row tile; the StyleGAN width (1024 hidden, nz=7168) does not and
    waits for its own slice, nor do layers wider than a cluster's 8 x 32
    columns. The row strides round up to a float4."""
    assert k2.fits_smem(NZ, DINS, DOUTS)
    assert max(k2.smem_bytes(NZ, DINS, DOUTS, r) for r in k2.TILE_ROWS) <= k2.SMEM_LIMIT
    assert k2.fits_smem(2, TOY_DINS, TOY_DOUTS)
    assert k2.fits_smem(NZ + 2, [d + 2 * (i == 0) for i, d in enumerate(DINS)], DOUTS)
    odd = [d + (i == 4) for i, d in enumerate(DINS)]  # the widest input 513: a stride of 516
    # 4 more floats a row, and one more 64-row weight stage (8 bytes) in the table.
    assert k2.smem_bytes(NZ, odd, DOUTS) == k2.smem_bytes(NZ, DINS, DOUTS) + 4 * 4 * k2.TILE_ROWS[-1] + 8
    nz, w = 7168, 1024
    s_dins = [2 * nz, w, w, w, 2 * w, 2 * w, 2 * w]
    s_douts = [w, w, w, w, w, w, nz]
    assert not k2.fits_smem(nz, s_dins, s_douts)
    wide = [DOUTS[0], 264, *DOUTS[2:]]  # 264 columns: 8 tiles of 48
    assert not k2.fits_smem(NZ, [DINS[0], DINS[1], 264, *DINS[3:]], wide)


NZ100_DINS = [200, 128, 256, 256, 512, 512, 256]  # svhn, celeba64: nz = 100, 50 Fourier pairs
NZ100_DOUTS = [128, 256, 256, 256, 256, 128, 100]


def test_plan_at_nz100():
    """nz = 100 (svhn, celeba64), the first width that is a multiple of 4
    but not of 8 or 16: the denoiser's widths; a block's shared memory at
    each row tile, pinned; the 100-wide last layer over blocks of 16
    columns, the seventh holding 4 and the eighth none; the 200-wide first
    input in four 64-row stages, whose last 8 rows chunk 0 sums alone; the
    100-row gate and hyper stages, whose last 4 rows chunk 4 sums; and the
    row tiles of the batches the presets launch."""
    den = LatentDenoiser(100, nxemb=32, ntemb=16, nf=4, residual=True)
    fourier, layers = k2.denoiser_layer_params(den)
    assert fourier.shape == (100, 50)
    assert [tuple(lt[0].shape) for lt in layers] == list(zip(NZ100_DINS, NZ100_DOUTS))
    assert k2.fits_smem(100, NZ100_DINS, NZ100_DOUTS)
    assert [k2.smem_bytes(100, NZ100_DINS, NZ100_DOUTS, r) for r in k2.TILE_ROWS] == [218336, 206848, 211744, 216640]
    assert k2.col_tile(100) == 16 and k2.column_ranges(100)[5:] == [(80, 96), (96, 100), (100, 100)]
    assert k2.chunk_rows(200)[0] == [(0, 8), (64, 72), (128, 136), (192, 200)]
    assert all(len(chunk) == 3 for chunk in k2.chunk_rows(200)[1:])
    assert k2.chunk_rows(100)[4] == [(32, 40), (96, 100)] and k2.chunk_rows(100)[5] == [(40, 48)]
    assert k2.stages_per_step(NZ100_DINS, NZ100_DOUTS) == 56
    tiles = {b: k2.row_tile(b, max_clusters=15) for b in (16, 64, 80, 128, 500)}
    assert tiles == {16: 4, 64: 8, 80: 8, 128: 12, 500: 16}


@pytest.mark.parametrize("b", [1, 16, 128, 500])
def test_row_tile_fills_the_card_in_one_wave(b):
    """Row i of a launch goes to cluster i // rows, slot i % rows. The row
    tile is the smallest that puts every cluster on the card at once (15
    clusters of 8 blocks on an H100), else the largest; it changes where a
    row sits, never how it is summed (`chunk_rows`)."""
    rows = k2.row_tile(b, max_clusters=15)
    assert rows == {1: 4, 16: 4, 128: 12, 500: 16}[b]
    clusters = -(-b // rows)
    assert clusters <= 15 or rows == k2.TILE_ROWS[-1]
    assert all(-(-b // r) > 15 for r in k2.TILE_ROWS if r < rows)
    assert len({divmod(i, rows) for i in range(b)}) == b


@pytest.mark.parametrize("n", sorted({*DINS, *DOUTS, 200, 100, 16, 8}))
def test_columns_and_summation_chunks_cover_each_index_once(n):
    """The blocks of a cluster own every output column of a layer exactly
    once, and the chunks of the fixed summation order take every input row
    exactly once; both depend on the width alone, so a row is summed in
    the same order whatever B, the row tile or its slot."""
    cols = [j for a, b in k2.column_ranges(n) for j in range(a, b)]
    assert sorted(cols) == list(range(n)) and len(k2.column_ranges(n)) == k2.CLUSTER
    assert all(b - a <= k2.col_tile(n) for a, b in k2.column_ranges(n))
    runs = k2.chunk_rows(n)
    assert len(runs) == k2.K_SPLIT
    rows = sorted(k for chunk in runs for a, b in chunk for k in range(a, b))
    assert rows == list(range(n))
    for chunk in runs:  # each chunk walks its rows upward
        starts = [a for a, _ in chunk]
        assert starts == sorted(starts)


def test_pack_weights_puts_each_block_rows_together():
    """pack_weights lays each (lin, skip) and (gate, hyper) pair out as
    [rank][row][matrix][col_tile], zero past dout: checked element by
    element against the layers, for the cifar10 widths and a ragged last
    layer (dout=100, tiles of 16 over 8 blocks)."""
    r = np.random.default_rng(5)
    dins, douts = DINS[:-1] + [DINS[-1]], DOUTS[:-1] + [100]
    layers = [
        tuple(torch.from_numpy(r.normal(size=s).astype(np.float32))
              for s in ((i, o), (o,), (i, o), (o,), (o, o), (o,), (o, o)))
        for i, o in zip(dins, douts)
    ]
    packed = k2.pack_weights(layers).numpy()
    off = 0
    for (lin, _, skip, _, gate, _, hyper), din, dout in zip(layers, dins, douts):
        t = k2.col_tile(dout)
        for m0, m1, n in ((lin, skip, din), (gate, hyper, dout)):
            block = packed[off:off + n * k2.CLUSTER * 2 * t].reshape(k2.CLUSTER, n, 2, t)
            full = np.zeros((2, n, k2.CLUSTER * t), np.float32)
            full[0, :, :dout], full[1, :, :dout] = m0.numpy(), m1.numpy()
            want = full.reshape(2, n, k2.CLUSTER, t).transpose(2, 1, 0, 3)
            np.testing.assert_array_equal(block, want)
            off += n * k2.CLUSTER * 2 * t
    assert off == packed.size


def test_packing_is_reused_only_for_the_same_unchanged_tensors():
    """The wrapper packs the weights once for a caller that passes the same
    layer tensors again (serving), and packs anew for new tensors or after
    an in-place change, so no stale packing is ever launched."""
    _, _, layers, *_ = _inputs(2, 2, seed=14)
    flat = [torch.from_numpy(t) for lt in layers for t in lt]
    first = k2._packed(flat)
    np.testing.assert_array_equal(first.numpy(), k2.pack_weights([flat[7 * l:7 * l + 7] for l in range(7)]).numpy())
    assert k2._packed(flat) is first
    flat[0].add_(1.0)  # the lin kernel of layer 0, in place
    changed = k2._packed(flat)
    assert changed is not first and changed[0] == first[0] + 1.0
    copies = [t.clone() for t in flat]
    assert k2._packed(copies) is not changed
    assert torch.equal(k2._packed(copies), changed)


def test_wrapper_dispatch_rules():
    z, fourier, layers, pre_x, pre_t, coeffs, seeds = _inputs(3, 2, seed=13)
    t = torch.from_numpy
    args = (t(z), t(fourier), [tuple(map(t, lt)) for lt in layers], [t(a) for a in pre_x],
            [t(a) for a in pre_t], t(coeffs))
    before = k2.fused_reverse_sweep.launches
    out = k2.fused_reverse_sweep(*args, row_seeds=t(seeds), steps=2)
    assert k2.fused_reverse_sweep.launches == before  # CPU tensors: the plain version
    assert torch.equal(out, k2.reverse_sweep_plain(*args, row_seeds=t(seeds), steps=2))
    with pytest.raises(ValueError, match="row_seeds"):
        k2.fused_reverse_sweep(*args, steps=2)
    meta = (args[0].to("meta"),) + args[1:]
    with pytest.raises(ValueError, match="device"):
        k2.fused_reverse_sweep(*meta, steps=2, with_noise=False)


def test_stream_mode_sweep_matches_jax_scan_in_distribution():
    """The port's stream-mode sweep (plain version) against the JAX scan
    sweep (hoisted tables, threefry noise) over 4096 rows at the tiny svhn
    widths (nz=8), 10 steps, the same starts and embeddings on both sides:
    per-dimension mean within 5 sigma sqrt(2 / n) and std within
    5 sigma sqrt(1 / n) of the JAX output's."""
    import jax

    from damc_tpu.ops.diffusion import sweep_logsnr_grid
    from damc_tpu.ops.reverse_diffusion import reverse_diffusion_sample
    from damc_tpu_torch.ops.diffusion import step_coefficients
    from torch_port_helpers import jax_and_port

    cfg_j, state, models_j, cfg_p, models_p = jax_and_port(seed=4)
    n, steps, nz, nxemb = 4096, 10, cfg_p.model.nz, cfg_p.model.nxemb
    r = np.random.default_rng(21)
    z = r.normal(size=(n, nz)).astype(np.float32)
    xemb = r.normal(size=(n, nxemb)).astype(np.float32)
    grid, _ = sweep_logsnr_grid(steps, -5.1, 9.8)
    tab_j = models_j.amortizer.apply(
        state.params_q, grid, jnp.asarray(xemb), method=lambda m, g, e: m.p.sample_tables(g, e)
    )
    denoise = lambda zz, _, t: models_j.amortizer.apply(
        state.params_q, zz, t, tab_j["pre_x"], method=lambda m, a, b, c: m.p.denoise_from_tables(a, b, c)
    )
    want = np.asarray(reverse_diffusion_sample(
        jax.random.PRNGKey(2), denoise, jnp.asarray(z), steps, -5.1, 9.8, "large",
        step_xs=tab_j["pre_t"],
    ))
    p = models_p.amortizer.p
    with torch.no_grad():
        tab_p = p.sample_tables(torch.from_numpy(np.array(grid)), torch.from_numpy(xemb))
        fourier, layers = k2.denoiser_layer_params(p)
        got = k2.fused_reverse_sweep(
            torch.from_numpy(z), fourier, layers, tab_p["pre_x"], tab_p["pre_t"],
            step_coefficients(steps, -5.1, 9.8, "large"), seed=-42, steps=steps,
        ).numpy()
    sigma = want.std(0)
    assert (np.abs(got.mean(0) - want.mean(0)) <= 5 * sigma * np.sqrt(2 / n)).all()
    assert (np.abs(got.std(0) - sigma) <= 5 * sigma * np.sqrt(1 / n)).all()
    assert np.abs(got - want).max() > 0.1  # other noise, pointwise apart


def test_stream_mode_of_the_plain_sweep():
    """Stream mode equals counter mode fed `stream_row_seeds(seed, B)`;
    `row_seeds` wins when both are given."""
    from damc_tpu_torch.ops.noise import stream_row_seeds

    args = _inputs(5, 3, seed=14, scale=0.5)
    t = torch.from_numpy
    targs = (t(args[0]), t(args[1]), [tuple(map(t, lt)) for lt in args[2]], [t(a) for a in args[3]],
             [t(a) for a in args[4]], t(args[5]))
    stream = k2.fused_reverse_sweep(*targs, seed=9, steps=3)
    assert torch.equal(stream, k2.reverse_sweep_plain(*targs, row_seeds=stream_row_seeds(9, 5), steps=3))
    counter = k2.reverse_sweep_plain(*targs, row_seeds=t(args[6]), steps=3)
    assert torch.equal(k2.fused_reverse_sweep(*targs, seed=9, row_seeds=t(args[6]), steps=3), counter)
    assert not torch.equal(stream, counter)
