#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`damc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. prints the card's name and power limit (nvidia-smi); needs CUDA;
  2. builds every CUDA kernel from `damc_tpu_torch/csrc`, one nvcc each, all
     at once;
  3. holds each kernel against its plain PyTorch version on the card, at the
     serving shape B=16 and the FID shape B=500 (ragged row tiles) in
     counter and noiseless mode, and in stream mode at the training shapes
     (K1 over 2B=256 chains, K2 over B=128 rows), and times both beside
     their bounds; then, in counter mode, rows 0, 7, 250 and 499 of a B=500
     launch of each kernel must equal, bit for bit, the same rows launched
     alone and inside batches of 16, 64, 80 and 128 (every K2 row tile the
     main path runs);
  4. serves the full-width `cifar10` preset (random weights from a seed) over
     HTTP: /sample damc and ebm and /reconstruct, some requests concurrent;
     checks shapes, range, that an item served alone equals the same item
     served coalesced, that the EBM path agrees with the CPU plain versions,
     and that each path launched its kernels;
  5. profiles one B=16 dispatch of each serving path (device busy and idle
     time, top kernels);
  6. trains the full-width `cifar10` preset at B=128 for 10 iterations
     through `train_gen_recon` on images made from a seed, timed by CUDA
     events without a sync per iteration; checks finite metrics, that every
     network changed, that Q_ema changed only at the 10th iteration and that
     K1 and K2 launched once an iteration; then two fresh 2-iteration runs
     must be bit-identical, and one B=8 iteration on the card must agree
     with the CPU plain path on the same draws and z0, in metrics,
     gradients and parameters;
  7. profiles one training iteration (device busy and idle time, the seven
     phases, top kernels);
  8. holds each kernel against its plain version at the eval shapes in
     stream mode: K1 at B=500 with the eval CLI's 100 steps at 1.6 and the
     loop's 60 at 0.4; K2 at B=500 under the prior embedding (the FID
     batch) and the encoder (the recon-MSE batch), and at B=64 (the plot
     grids) and B=80 (the loop's recon-MSE tail), whose 100-step rows must
     equal those of the B=500 launch bit for bit;
  9. drives the gen_recon workload through its CLIs at full cifar10 width
     in a temporary directory, on a CIFAR-10 pickle tree made from the seed
     (50,000 train images; 2,000 test images, cut from 10,000): trains 6
     iterations at B=128 with evals, grids and checkpoints every 3 and 1,000
     FID samples (`frechet_rand`: no Inception weights here) and checks the
     metrics rows, the checkpoints, the PNG grids and that K1 and K2
     launched exactly as the protocol implies; resumes to 8 iterations with
     --resume_path auto in the same run directory; restores ckpt/5 into a
     fresh state, equal to the state in memory, and steps both, bit for
     bit; scores ckpt/best twice through the eval CLI (K1 100 steps at 1.6,
     K2 at B=500) and checks that both print the same numbers;
 10. runs pool3 InceptionV3 (random weights) on the card against the CPU on
     2 images, then times it at B=500 with its peak memory;
 11. times the eval's parts (a FID batch of each prior: sampling, features,
     stats; a recon-MSE batch at B=128 and B=500; sqrtm) and sets the eval
     beside 100 training iterations, with a projection of the 50,000-sample
     protocol, labelled as such;
 12. anomaly workload (`mnist_anomaly`, nz=8, full width): K1 over the
     B=128 single prior chains and K2 at B=128 and at the AUPRC batch B=500,
     stream mode, against their plain versions; then, on an MNIST-shaped
     mnist.npz made from the seed (70,000 images; held-out digit 9; the
     test split cut to 4,000 images through its cache file), trains 20
     iterations through `cli.train_anomaly_det` with an AUPRC eval and
     checkpoints every 10, resumes to 22 in the same directory, and scores
     ckpt/best twice through `cli.eval_anomaly_det` (identical AUPRCs);
     checks rows, checkpoints, K1 and K2 once an iteration and K2 once an
     eval batch; profiles one iteration as phase 7 does;
 13. toy workload (`toy`, nz=2, B=500): K2 at the toy's widths in stream,
     counter and noiseless mode against the plain version (6 steps held to
     fp64; stream rows of B=500 equal to the same rows at B=16, bit for
     bit); then 40 iterations through `cli.toy` with a parity eval (1,000
     ground-truth steps, 2 batches of 500) every 20 and at the end; checks
     finite g_loss_q, g_loss_l and mmd2, a 600x600 KDE PNG per cloud and
     eval, K2 once an iteration and once an eval batch, K1 never; profiles
     one iteration;
 14. prints which image decoders the machine has (jpeglib.h, PIL);
 15. svhn (nz=100, ngf=64, 32x32, full width): K1 over 2B=256 (60 steps at
     0.4) and at B=500 (100 steps at the eval CLI's 0.4; 60 at 0.4), K2 at
     B=500 under the encoder and the prior embedding in stream
     mode, whose rows 0-15, 0-63, 0-79 and 0-127 launched alone must equal
     the B=500 launch's bit for bit, and both kernels at B=16 in counter
     mode; K1 at cifar10's eval step size 1.6, which no svhn path runs,
     traced step by step against its plain version and printed, not held;
     then, on SVHN .mat files made from the seed (73,257 train images;
     2,000 test images), 6 iterations through `cli.train_gen_recon` with
     evals, grids and checkpoints every 3 and 1,000 FID samples, the eval
     CLI once on ckpt/best, and ckpt/best served through the serve CLI's
     loading path (--ckpt_dir): /sample damc and ebm and /reconstruct must
     equal the restored state's serving core run in process, bit for bit;
     profiles one iteration as phase 7 does;
 16. celeba64 (nz=100, ngf=128, 64x64): K1 and K2 at the training shapes;
     a PNG tree made from the seed at CelebA's 178x218 (2,048 train, 512
     test images; row filters cycling None to Paeth), written by worker
     processes; 4 iterations through the train CLI, which decodes the tree
     and writes the train split's .npy cache, then a resume to 5 with an
     eval, which must read the cache memory-mapped, equal to the decode;
     prints the walls of the tree, the decode and the cache; profiles one
     iteration;
 17. celebaHQ (nz=128, ngf=128, 256x256): K1 and K2 at the training shapes;
     a 1024x1024 PNG tree (160 train, 64 test images); 3 iterations at B=128
     through the train CLI with evals at 0 and at the end (500 FID samples,
     the 64 test images); one iteration from the last checkpoint with
     remat_generator off and on, bit-identical in metrics and parameters,
     with the peak memory of each; one iteration profiled as in phase 7;
 18. unfused sweep (item 2a) on the full-width cifar10 Q: B=128, 6 noiseless
     steps held to K2's fp64 plain version at sweep_check's limit; B=500,
     100 steps on K2's own stream normals, moments held to K2's; a guided
     sweep (cond_w 0.5) finite and apart from the unguided one; the route
     rule; the 100-step unfused sweep's ms beside K2's at B=16, 128, 500;
 19. StyleGAN inversion (item 6) at full size (256x256, nz 7168, the 313M-
     weight Q, random weights saved as .pth files, 16 seeded 1024x1024
     PNGs): 2 training iterations at B=8 (every Q update changes Q), a Q
     checkpoint, the eval CLI twice from it with identical output, K1 and
     K2 launched 0 times and the unfused sweep once a batch; nan_rescue;
     invert_batch's ms split by part, images/s, peak memory, the device's
     idle share and top kernels, the FLOP count beside its fp32 bound;
 20. prints one JSON line {"kernels": [...]} with launches, errors and times
     of each kernel on each path (serve, train, eval, anomaly, anomaly_eval:
     the train CLI's AUPRC evals, anomaly_eval_cli: the eval CLI's two
     runs, toy, svhn: the train CLI run, svhn_eval: the eval CLI run,
     svhn_serve: the served checkpoint, celeba64: both train CLI runs,
     celebaHQ: the train CLI run);
 21. prints {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of fn() over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def langevin_cost(b, nz, ndf, steps):
    flops = 2.0 * b * steps * (2 * nz * ndf + 2 * ndf * ndf)
    nbytes = 4.0 * (2 * b * nz + nz * ndf + ndf * ndf + 3 * ndf + b)
    return flops, nbytes


def sweep_cost(b, fourier, layers, steps):
    nz, nfour = fourier.shape
    macs = nz * nfour + sum(2 * lt[0].numel() + 2 * lt[4].numel() for lt in layers)
    n_weights = fourier.numel() + sum(t.numel() for lt in layers for t in lt)
    ctx = sum(lt[0].shape[1] for lt in layers)
    flops = 2.0 * b * steps * macs
    nbytes = 4.0 * (2 * b * nz + n_weights + b * ctx + steps * ctx + steps * 6 + b)
    return flops, nbytes


def check_close(name, got, want, atol, rtol=0.0):
    err = float((got - want).abs().max())
    ok = bool(((got - want).abs() <= atol + rtol * want.abs()).all())
    print(f"  {name}: max_abs_err={err:.3e} (atol={atol:g}, rtol={rtol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree (max abs err {err})")
    return err


def _int32(u):
    """uint32 values held in int64 -> int32 with the same bits."""
    import torch

    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def _stream_as_counter(noise, b, dev):
    """In stream mode, the counter-mode keywords that must give the same
    bits (stream mode is counter mode fed stream_row_seeds); else None."""
    from damc_tpu_torch.ops.noise import stream_row_seeds

    return dict(row_seeds=_int32(stream_row_seeds(noise["seed"], b, dev))) if "seed" in noise else None


def report(name, r):
    b_ms, by = bound(r["flops"], r["bytes"])
    print(f"  {name} B={r['b']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"bound {b_ms:.5g} ms ({by}), {r['flops']:.4g} FLOP, {r['bytes']:.4g} B")


def chain_check(ebm_w, z, noise, steps, step_size, label):
    """K1 against its plain version on z (B, nz) under `noise` (row_seeds
    or seed), then both timed. The counter bits are exact; logf/cosf may
    differ from torch by an ulp, so atol 1e-4. In stream mode the kernel
    must also equal counter mode on stream_row_seeds, bit for bit."""
    import torch

    from damc_tpu_torch.ops.cuda.fused_langevin import fused_prior_langevin, prior_langevin_plain

    b, nz = z.shape
    kw = dict(steps=steps, step_size=step_size)
    got = fused_prior_langevin(z, *ebm_w, **noise, **kw)
    counter = _stream_as_counter(noise, b, z.device)
    if counter is not None and not torch.equal(got, fused_prior_langevin(z, *ebm_w, **counter, **kw)):
        raise AssertionError(f"{label}: stream mode differs from counter mode on stream_row_seeds")
    want = prior_langevin_plain(z, *ebm_w, **noise, **kw)
    err = check_close(f"{label} B={b}, {steps} steps at {step_size}", got, want, atol=1e-4)
    flops, nbytes = langevin_cost(b, nz, ebm_w[0].shape[1], steps)
    r = dict(b=b, max_abs_err=err, flops=flops, bytes=nbytes,
             ms=time_ms(lambda: fused_prior_langevin(z, *ebm_w, **noise, **kw), 20),
             plain_ms=time_ms(lambda: prior_langevin_plain(z, *ebm_w, **noise, **kw), 5))
    report(label, r)
    return r


def sweep_check(models, cfg, z, xemb, noise, label, subs=(), full=True):
    """K2 against its plain version on z (B, nz) with the tables of the
    embedding `xemb`, under `noise` (with_noise=False, row_seeds or seed).

    6 steps: at full width with random weights six steps amplify fp32
    rounding to ~1e-2 (the plain version in fp32 against fp64), so no fp32
    pair meets 2e-4 here: the kernel is held to the fp64 plain version, at
    most twice as far as the fp32 plain version is, plus 2e-4.
    The preset's 100 noisy steps are chaotic pointwise: the output must be
    finite and, at B >= 128, each dimension's mean and std over the batch
    within 0.1 x the mean std of the plain version's (both see the same
    noise). In stream mode the kernel must equal counter mode on
    stream_row_seeds, bit for bit.
    Each b of `subs` launches the first b rows (the row tile of another
    shape): 6 steps held as above, and 100 steps equal, bit for bit, to
    those rows of the whole launch, since neither a row's noise nor its
    summation order depends on the batch.
    Returns {batch: row} with the 100-step times; `full=False` stops after
    the 6-step check."""
    import torch

    from damc_tpu_torch.ops.cuda.fused_qsweep import denoiser_layer_params, fused_reverse_sweep
    from damc_tpu_torch.ops.cuda.fused_qsweep import reverse_sweep_plain
    from damc_tpu_torch.ops.diffusion import step_coefficients, sweep_logsnr_grid

    dev, d = z.device, cfg.diffusion
    fourier, layers = denoiser_layer_params(models.amortizer.p)
    tables = {}
    for n in (6, d.n_interval) if full else (6,):
        grid, _ = sweep_logsnr_grid(n, d.logsnr_min, d.logsnr_max)
        with torch.no_grad():
            t = models.amortizer.p.sample_tables(grid.to(dev), xemb)
        tables[n] = (t["pre_x"], t["pre_t"], step_coefficients(n, d.logsnr_min, d.logsnr_max, d.var_type).to(dev))

    def args(n, b):
        pre_x, pre_t, coeffs = tables[n]
        return (z[:b], fourier, layers, [t[:b] for t in pre_x], pre_t, coeffs)

    def launch(n, b, kw):
        got = fused_reverse_sweep(*args(n, b), steps=n, residual=d.residual, **kw)
        counter = _stream_as_counter(kw, b, dev)
        if counter is not None and not torch.equal(
                got, fused_reverse_sweep(*args(n, b), steps=n, residual=d.residual, **counter)):
            raise AssertionError(f"{label} B={b}: stream mode differs from counter mode on stream_row_seeds")
        return got

    res, whole = {}, None
    for b in (z.shape[0],) + tuple(subs):
        kw = {k: v[:b] if k == "row_seeds" else v for k, v in noise.items()}
        a6 = args(6, b)
        a64 = (a6[0].double(), a6[1].double(), [tuple(t.double() for t in lt) for lt in a6[2]],
               [t.double() for t in a6[3]], [t.double() for t in a6[4]], a6[5].double())
        got = launch(6, b, kw)
        want = reverse_sweep_plain(*a6, steps=6, residual=d.residual, **kw)
        ref = reverse_sweep_plain(*a64, steps=6, residual=d.residual, **kw)
        err_plain = float((want.double() - ref).abs().max())
        err_k = float((got.double() - ref).abs().max())
        res[b] = r = dict(b=b, max_abs_err=float((got - want).abs().max()))
        print(f"  {label} B={b} 6 steps: kernel-plain {r['max_abs_err']:.3e}; against fp64: kernel "
              f"{err_k:.3e}, plain fp32 {err_plain:.3e} (limit 2 x plain + 2e-4)")
        if err_k > 2 * err_plain + 2e-4:
            raise AssertionError(f"{label} B={b}: kernel further from fp64 than fp32 allows")
        if not full:
            continue
        n = d.n_interval
        a = args(n, b)
        got = launch(n, b, kw)
        want = reverse_sweep_plain(*a, steps=n, residual=d.residual, **kw)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{label} B={b} {n} steps: non-finite output")
        if whole is None:
            whole = got
            if b >= 128:
                scale = float(want.std(0).mean())
                d_mean = float((got.mean(0) - want.mean(0)).abs().max())
                d_std = float((got.std(0) - want.std(0)).abs().max())
                print(f"  {label} B={b} {n} steps: max |d mean|={d_mean:.3e}, max |d std|={d_std:.3e}, "
                      f"mean std={scale:.3e} (limit 0.1 x mean std each)")
                if d_mean > 0.1 * scale or d_std > 0.1 * scale:
                    raise AssertionError(f"{label} B={b} {n} steps: moments disagree with the plain version")
        else:
            same = torch.equal(got, whole[:b])
            print(f"  {label} B={b} {n} steps == rows 0-{b - 1} of the B={whole.shape[0]} launch: {same}")
            if not same:
                raise AssertionError(f"{label} B={b}: rows differ from the same rows of the whole launch")
        flops, nbytes = sweep_cost(b, fourier, layers, n)
        r.update(flops=flops, bytes=nbytes,
                 ms=time_ms(lambda: fused_reverse_sweep(*a, steps=n, residual=d.residual, **kw), 10),
                 plain_ms=time_ms(lambda: reverse_sweep_plain(*a, steps=n, residual=d.residual, **kw), 3,
                                  warmup=1))
        report(label, r)
    return res


def kernel_phase(models, cfg):
    """Each kernel against its plain version at B=16 and B=500, counter mode
    and (6-step K2, 60-step K1) noiseless."""
    import torch

    from damc_tpu_torch.ops.cuda.fused_langevin import (
        ebm_params_to_dense_weights, fused_prior_langevin, prior_langevin_plain,
    )
    from damc_tpu_torch.ops.cuda.fused_qsweep import denoiser_layer_params, max_active_clusters, row_tile

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    m, mc = cfg.model, cfg.mcmc
    ebm_w = ebm_params_to_dense_weights(models.ebm)
    _, layers = denoiser_layer_params(models.amortizer.p)
    res = {"K1": {}, "K2": {}}
    k2_max = max_active_clusters(m.nz, [lt[0].shape[0] for lt in layers], [lt[0].shape[1] for lt in layers])
    print(f"[kernels] K2 clusters the card runs at once: {k2_max}; row tiles: "
          + ", ".join(f"B={b} {row_tile(b, k2_max)} rows" for b in (16, 64, 80, cfg.train.batch_size, 500)))

    for b in (16, 500):
        print(f"[kernels] B={b}")
        z = torch.randn(b, m.nz, generator=gen).to(dev)
        seeds = torch.randint(0, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).to(dev)
        # K1: the 60-step prior chain at step size 0.4.
        kw = dict(steps=mc.e_l_steps, step_size=mc.e_l_step_size)
        got = fused_prior_langevin(z, *ebm_w, with_noise=False, **kw)
        want = prior_langevin_plain(z, *ebm_w, with_noise=False, **kw)
        check_close(f"K1 noiseless {mc.e_l_steps} steps", got, want, atol=1e-5)
        res["K1"][b] = chain_check(ebm_w, z, dict(row_seeds=seeds), mc.e_l_steps, mc.e_l_step_size,
                                   "K1 counter noise")
        # K2: tables from the prior embedding of noise, as the damc path builds them.
        with torch.no_grad():
            xemb = models.amortizer.prior_embed(torch.randn(b, m.nz, generator=gen).to(dev))
        sweep_check(models, cfg, z, xemb, dict(with_noise=False), "K2 noiseless", full=False)
        res["K2"][b] = sweep_check(models, cfg, z, xemb, dict(row_seeds=seeds), "K2 counter noise")[b]
    return res


ROW_PICKS = (0, 7, 250, 499)
ROW_BATCHES = (16, 64, 80, 128)  # the serving, plot, recon-MSE tail and training shapes


def row_independence_phase(models, cfg):
    """Counter mode, each kernel at its serving step count: rows 0, 7, 250
    and 499 of a B=500 launch must equal, bit for bit, the same rows
    launched alone (B=1) and inside batches of 16, 64, 80 and 128, where
    row i sits at slot i % B among other rows. The row tile, the cluster
    and the slot differ between the launches; the row's inputs do not.
    Between them the launches take every K2 row tile the main path runs."""
    import torch

    from damc_tpu_torch.ops.cuda.fused_langevin import ebm_params_to_dense_weights, fused_prior_langevin
    from damc_tpu_torch.ops.cuda.fused_qsweep import (
        denoiser_layer_params, fused_reverse_sweep, max_active_clusters, row_tile,
    )
    from damc_tpu_torch.ops.diffusion import step_coefficients, sweep_logsnr_grid

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
    m, d, mc = cfg.model, cfg.diffusion, cfg.mcmc
    b = 500
    z = torch.randn(b, m.nz, generator=gen).to(dev)
    seeds = torch.randint(0, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).to(dev)
    ebm_w = ebm_params_to_dense_weights(models.ebm)
    fourier, layers = denoiser_layer_params(models.amortizer.p)
    grid, _ = sweep_logsnr_grid(d.n_interval, d.logsnr_min, d.logsnr_max)
    coeffs = step_coefficients(d.n_interval, d.logsnr_min, d.logsnr_max, d.var_type).to(dev)
    with torch.no_grad():
        xemb = models.amortizer.prior_embed(torch.randn(b, m.nz, generator=gen).to(dev))
        tables = models.amortizer.p.sample_tables(grid.to(dev), xemb)
    k2_max = max_active_clusters(m.nz, [lt[0].shape[0] for lt in layers], [lt[0].shape[1] for lt in layers])
    tiles = sorted({row_tile(n, k2_max) for n in (b, 1) + ROW_BATCHES})
    print(f"[rows] K2 row tiles of these launches: {tiles}")
    runs = {
        "K1": lambda idx: fused_prior_langevin(
            z[idx], *ebm_w, row_seeds=seeds[idx], steps=mc.e_l_steps, step_size=mc.e_l_step_size),
        "K2": lambda idx: fused_reverse_sweep(
            z[idx], fourier, layers, [t[idx] for t in tables["pre_x"]], tables["pre_t"], coeffs,
            row_seeds=seeds[idx], steps=d.n_interval, residual=d.residual),
    }
    for name, run in runs.items():
        full = run(torch.arange(b, device=dev))
        for i in ROW_PICKS:
            same = {"alone": torch.equal(full[i], run(torch.tensor([i], device=dev))[0])}
            for n in ROW_BATCHES:
                idx = [(i + 1 + k) % b for k in range(n)]
                idx[i % n] = i
                same[f"slot {i % n} of B={n}"] = torch.equal(full[i], run(torch.tensor(idx, device=dev))[i % n])
            print(f"[rows] {name} row {i} of B={b} equals itself " + ", ".join(f"{k}: {v}" for k, v in same.items()))
            if not all(same.values()):
                raise AssertionError(f"{name}: row {i} depends on the batch it is launched in")


def stream_kernel_phase(models, cfg):
    """Stream mode (one int32 seed a launch) at the training shapes: K1 over
    the 2B=256 prior chains, K2 over the B=128 Q_ema rows."""
    import torch

    from damc_tpu_torch.ops.cuda.fused_langevin import ebm_params_to_dense_weights, fused_prior_langevin
    from damc_tpu_torch.ops.cuda.fused_qsweep import denoiser_layer_params, fused_reverse_sweep
    from damc_tpu_torch.ops.diffusion import step_coefficients
    from damc_tpu_torch.ops.noise import counter_normal, stream_row_seeds

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    m, d, mc = cfg.model, cfg.diffusion, cfg.mcmc
    b1 = 2 * cfg.train.batch_size if cfg.train.prior_chains == "double" else cfg.train.batch_size
    b2 = cfg.train.batch_size
    seed = -1234567891  # any int32
    res = {}

    # K1. With zero weights and z = 0 one step of size 1 returns the step-0
    # noise itself: the kernel's against counter_normal of the plain row
    # seeds (the bits are equal; logf/cosf may differ by an ulp).
    print(f"[kernels] stream mode, K1 B={b1}")
    ebm_w = ebm_params_to_dense_weights(models.ebm)
    zeros = [torch.zeros_like(t) for t in ebm_w]
    noise = fused_prior_langevin(torch.zeros(b1, m.nz, device=dev), *zeros, seed=seed, steps=1, step_size=1.0)
    check_close("K1 stream noise, step 0", noise, counter_normal(stream_row_seeds(seed, b1, dev), 0, m.nz), atol=1e-5)
    z = torch.randn(b1, m.nz, generator=gen).to(dev)
    res["K1"] = chain_check(ebm_w, z, dict(seed=seed), mc.e_l_steps, mc.e_l_step_size, "K1 stream")

    # K2, tables from the Q encoder of random images as the training step
    # builds them.
    print(f"[kernels] stream mode, K2 B={b2}")
    fourier, layers = denoiser_layer_params(models.amortizer.p)
    zl = [tuple(torch.zeros_like(t) for t in lt) for lt in layers]
    coeffs2 = step_coefficients(2, d.logsnr_min, d.logsnr_max, d.var_type).to(dev)
    px = [torch.zeros(b2, lt[0].shape[1], device=dev) for lt in layers]
    pt = [torch.zeros(2, lt[0].shape[1], device=dev) for lt in layers]
    noise = fused_reverse_sweep(torch.zeros(b2, m.nz, device=dev), torch.zeros_like(fourier), zl, px, pt, coeffs2,
                                seed=seed, steps=1)
    want = coeffs2[0, 4] * counter_normal(stream_row_seeds(seed, b2, dev), 0, m.nz)
    check_close("K2 stream noise, step 0", noise, want, atol=1e-5)
    x = torch.rand(b2, 32, 32, 3, generator=gen).to(dev) * 2 - 1
    z = torch.randn(b2, m.nz, generator=gen).to(dev)
    with torch.no_grad():
        xemb = models.amortizer.encode(x)
    res["K2"] = sweep_check(models, cfg, z, xemb, dict(seed=seed), "K2 stream")[b2]
    return res


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return json.loads(r.read())


def _array(obj):
    return np.frombuffer(base64.b64decode(obj["data_b64"]), np.float32).reshape(obj["shape"])


def _concurrent(calls):
    """Run the zero-argument callables together; return their results."""
    out, errors = [None] * len(calls), []

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
        if t.is_alive():
            raise AssertionError("request thread did not finish")
    if errors:
        raise errors[0]
    return out


def _check_images(name, imgs, n):
    if imgs.shape != (n, 32, 32, 3) or not np.isfinite(imgs).all() or np.abs(imgs).max() > 1.0:
        raise AssertionError(f"{name}: bad images, shape {imgs.shape}")


def serving_phase(models, cfg, counters):
    """Full-width cifar10 over HTTP; returns per-path kernel launches and stats."""
    import torch

    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.serve import SamplerService, build_serving_fns, item_draws, make_http_server
    from damc_tpu_torch.serve import stack_draws

    service = SamplerService(models, cfg, max_batch=16, recon_langevin_steps=10, device="cuda")
    service.warmup()
    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    sample = lambda prior, n, seed: _array(
        _post(base + "/sample", {"n": n, "prior": prior, "seed": seed, "encoding": "b64"})["images"]
    )
    rng = np.random.default_rng(SEED)
    x = rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)

    def recon(imgs, seed):
        body = _post(base + "/reconstruct", {
            "image_b64": base64.b64encode(imgs.tobytes()).decode(), "shape": list(imgs.shape),
            "seed": seed, "encoding": "b64",
        })
        return _array(body["x_hat"]), _array(body["z"])

    launches = {}
    served = {}
    try:
        for k in counters.values():
            k.launches = 0
        for path in ("damc", "ebm", "recon"):
            before = {name: k.launches for name, k in counters.items()}
            if path == "recon":
                alone = recon(x[:1], 3)
                for i in range(3):
                    recon(x[i:i + 1], 10 + i)
                both = _concurrent([lambda: recon(x[:4], 3), lambda: recon(x[4:], 4)])
                for xh, z in both:
                    _check_images(path, xh, 4)
                    if z.shape != (4, cfg.model.nz) or not np.isfinite(z).all():
                        raise AssertionError("recon: bad z")
                same = np.array_equal(both[0][0][0], alone[0][0]) and np.array_equal(
                    both[0][1][0], alone[1][0])
            else:
                alone = sample(path, 1, 7)
                for i in range(3):
                    sample(path, 1, 10 + i)
                both = _concurrent([lambda: sample(path, 8, 7), lambda: sample(path, 8, 8)])
                for imgs in both:
                    _check_images(path, imgs, 8)
                same = np.array_equal(both[0][0], alone[0])
                served[path] = both[0][:2]
            if not same:
                raise AssertionError(f"{path}: item (seed, 0) alone differs from it coalesced")
            launches[path] = {name: k.launches - before[name] for name, k in counters.items()}
            print(f"[serve] {path}: alone == coalesced; kernel launches {launches[path]}")
        stats = json.loads(urllib.request.urlopen(base + "/stats", timeout=60).read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
        service.close()
    total = {name: k.launches for name, k in counters.items()}
    if launches["damc"]["K2"] < 1 or launches["recon"]["K2"] < 1 or launches["ebm"]["K1"] < 1:
        raise AssertionError(f"a path did not launch its kernel: {launches}")
    if launches["damc"]["K1"] or launches["ebm"]["K2"]:
        raise AssertionError(f"a path launched a kernel it should not: {launches}")
    for path, s in stats.items():
        print(f"[serve] {path}: p50 {s['latency_p50_ms']:.3f} ms, p99 {s['latency_p99_ms']:.3f} ms, "
              f"{s['requests']} requests, {s['items']} items in {s['batches']} batches")
    print("[serve] /stats " + json.dumps(stats))

    # The EBM path against the plain versions on the CPU, same seed and items:
    # a 60-step contracting chain, then G; 1e-3 covers cuDNN against the CPU.
    cpu = build_models(cfg, seed=SEED, device="cpu")
    want = build_serving_fns(cpu, cfg)["ebm"](stack_draws([item_draws(7, i, cfg.model.nz) for i in range(2)], "cpu"))
    err = float(np.abs(served["ebm"] - want.numpy()).max())
    print(f"[serve] ebm items (7, 0..1) against the CPU plain path: max_abs_err={err:.3e} (atol 1e-3)")
    if err > 1e-3:
        raise AssertionError("ebm path disagrees with the CPU plain path")
    return total, stats


def profile_phase(models, cfg):
    """One B=16 dispatch of each path's serving core under torch.profiler:
    host wall time, device busy time (sum of kernel self times), the
    device's idle share and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from damc_tpu_torch.serve import build_serving_fns, item_draws, stack_draws

    fns = build_serving_fns(models, cfg)
    draws = stack_draws([item_draws(5, i, cfg.model.nz) for i in range(16)], "cuda")
    x = torch.zeros(16, 32, 32, 3, device="cuda")
    run = {
        "damc": lambda: fns["damc"](draws),
        "ebm": lambda: fns["ebm"](draws),
        "recon": lambda: fns["recon"](draws, x),
    }
    for path, fn in run.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Device-side kernel records only: an operator's row repeats the
        # time of the kernels it launched.
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        dev = lambda e: e.self_device_time_total / 1e3
        kernels.sort(key=dev, reverse=True)
        busy_ms = sum(dev(e) for e in kernels)
        top = [{"name": e.key[:60], "ms": dev(e), "calls": e.count} for e in kernels[:6]]
        print("[profile] " + json.dumps({
            "path": path, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None, "top": top,
        }))


def train_images(n: int) -> np.ndarray:
    """CIFAR-shaped uint8 images (n, 32, 32, 3) made from the seed."""
    return np.random.default_rng(SEED).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


def _snapshot(module):
    return [p.detach().clone() for p in module.parameters()]


def _changed(module, snap) -> bool:
    return any(not bool((p == s).all()) for p, s in zip(module.parameters(), snap))


def _state_modules(state):
    m = state.models
    return {"G": m.generator, "E": m.ebm, "Q": m.amortizer, "Q_ema": state.amortizer_ema}


def training_phase(cfg, counters, iterations: int = 10):
    """`iterations` full-width iterations through `train_gen_recon` at the
    preset's `print_every`; returns (final state, launches over the run).

    Nothing in the run waits for the device but the loop's own metric read
    at `print_every` (iteration 1 here): after each iteration the callback
    records a CUDA event, the launch counts (host integers) and device
    copies of the metrics and of Q_ema's parameters, and the checks read
    them after the run. An iteration's time is the device time between the
    events of two iterations, so it counts any wait on the host."""
    import torch

    from damc_tpu_torch.train.gen_recon import train_gen_recon
    from damc_tpu_torch.train.state import create_state

    b = cfg.train.batch_size
    images = train_images(iterations * b)
    start = {k: _snapshot(v) for k, v in _state_modules(create_state(cfg, SEED, "cuda")).items()}
    log = {"events": [], "launches": [], "metrics": [], "ema": []}

    def on_step(it, state, metrics):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        log["events"].append(event)
        log["launches"].append({name: k.launches for name, k in counters.items()})
        log["metrics"].append({k: v.detach().clone() for k, v in metrics.items()})
        log["ema"].append(_snapshot(state.amortizer_ema))

    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    state = train_gen_recon(cfg, images, iterations=iterations, seed=SEED, on_step=on_step)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    total = {name: k.launches for name, k in counters.items()}

    for it, metrics in enumerate(log["metrics"]):
        bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
        if bad:
            raise AssertionError(f"iteration {it + 1}: non-finite metrics {bad}")
    per_iter = [log["launches"][0]] + [
        {n: cur[n] - prev[n] for n in cur} for prev, cur in zip(log["launches"], log["launches"][1:])
    ]
    print(f"[train] launches per iteration {per_iter}")
    if any(l != {"K1": 1, "K2": 1} for l in per_iter):
        raise AssertionError("K1 and K2 must each launch exactly once per iteration")
    for name, module in _state_modules(state).items():
        if not _changed(module, start[name]):
            raise AssertionError(f"{name} did not change in {iterations} iterations")
    ema = [start["Q_ema"]] + log["ema"]
    changed = [any(not bool((p == q).all()) for p, q in zip(a, b_)) for a, b_ in zip(ema, ema[1:])]
    print(f"[train] Q_ema changed at iterations {[i + 1 for i, c in enumerate(changed) if c]}")
    if changed != [i == cfg.train.ema_every - 1 for i in range(iterations)]:
        raise AssertionError(f"Q_ema must change only at iteration {cfg.train.ema_every}")
    ev = log["events"]
    ms = [a.elapsed_time(b_) for a, b_ in zip(ev, ev[1:])]  # iterations 2 .. iterations
    print("[train] " + json.dumps({
        "print_every": cfg.train.print_every, "ms_per_iteration_2_to_10": ms,
        "median_ms_iterations_3_to_10": statistics.median(ms[1:]),
        "mean_ms_iterations_3_to_10": ev[1].elapsed_time(ev[-1]) / (iterations - 2),
        "wall_s_with_set_up": wall_s, "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
    }))
    return state, total, statistics.median(ms[1:])


def rerun_phase(cfg):
    """Two fresh 2-iteration runs from one seed: every metric of every
    iteration and every parameter at the end, bit for bit."""
    import torch

    from damc_tpu_torch.train.gen_recon import train_gen_recon

    images = train_images(2 * cfg.train.batch_size)
    runs = []
    for _ in range(2):
        metrics = []
        state = train_gen_recon(
            cfg, images, iterations=2, seed=SEED,
            on_step=lambda it, st, m: metrics.append({k: v.clone() for k, v in m.items()}),
        )
        runs.append((metrics, _state_modules(state)))
    (m_a, s_a), (m_b, s_b) = runs
    same = all(torch.equal(a[k], b[k]) for a, b in zip(m_a, m_b) for k in a) and all(
        torch.equal(p, q) for name in s_a for p, q in zip(s_a[name].parameters(), s_b[name].parameters())
    )
    print(f"[train] two fresh 2-iteration runs bit-identical: {same}")
    if not same:
        raise AssertionError("two runs from one seed differ")


# Card against CPU after one iteration from one z0. Metrics: the rule of the
# CPU tests against the JAX package (tests/test_torch_port_train.py).
# Gradients: a relative L2 error per network and per leaf.
METRIC_RTOL = METRIC_ATOL = 1e-5
GRAD_RTOL = 1e-4
ZERO_LEAF = 1e-6  # a leaf whose gradient norm is below this share of its network's is zero to rounding


def _recording(opt, log):
    """Make `opt.step` keep a copy of the gradients it is given (before the
    clip) in `log`."""
    step = opt.step

    def record(grads):
        log.append([g.detach().clone() for g in grads])
        step(grads)

    opt.step = record


def gpu_cpu_phase(cfg):
    """One iteration at B=8 with 2 posterior steps, noiseless kernels and
    one Q update, on the card and on the CPU plain path, from the same
    weights, draws and z0.

    Three parts of the iteration amplify float32 rounding at full width
    with random weights, so they are cut: Q_ema's noiseless 100-step sweep
    is chaotic (six steps already take rounding to ~1e-2 against float64,
    kernel phase), so both sides take the CPU's z0 and the kernel phases
    hold the sweep to its plain version; the posterior chain at
    g_llhd_sigma 0.1 multiplies a difference in z at each step, so that a
    few ulps of x reach the gradients at 1e-3 after five steps where they
    stay near 1e-6 after two; and each further Q update starts from
    parameters that Adam's first steps moved apart where a gradient is zero
    to rounding. The rest differs in float32 rounding only (no TF32,
    deterministic cuDNN), and is held to:
      * every metric within rtol 1e-5 / atol 1e-5 of the CPU's;
      * each network's gradient, as its optimizer receives it, within
        relative L2 error GRAD_RTOL, and so is each leaf's unless its
        gradient is zero to rounding (below ZERO_LEAF of the network's
        norm: a conv bias in front of InstanceNorm);
      * each updated parameter element whose CPU gradient g is more than
        10 times the card's difference d from it within lr / 36 + 1e-6 of
        the CPU's. Adam's first step is -lr g / (|g| + eps); where
        |d| < |g| / 10 it moves by at most lr |d| eps / (0.9 |g| + eps)^2
        <= lr / 36. Elements with |g| <= 10 |d| take a step whose direction
        rounding sets, on either side, and are counted, not held;
      * Q_ema, which one iteration does not mix, equal."""
    import torch

    from damc_tpu_torch.models import sample_q
    from damc_tpu_torch.train import step as step_module
    from damc_tpu_torch.train.state import create_state
    from damc_tpu_torch.train.step import draw_step, make_train_step

    b = 8
    small = dataclasses.replace(
        cfg,
        train=dataclasses.replace(cfg.train, batch_size=b, q_updates=1),
        mcmc=dataclasses.replace(cfg.mcmc, g_l_steps=2, e_l_with_noise=False),
        diffusion=dataclasses.replace(cfg.diffusion, with_noise=False),
    )
    x = torch.from_numpy(train_images(b)).float() / 255.0 * 2.0 - 1.0
    state = create_state(small, SEED, "cpu")
    draws = draw_step(small, b, state)
    z0 = sample_q(state.amortizer_ema, x, draws.z0_init, draws.sweep_seed)

    def to(dev, t):
        return None if t is None else t.to(dev)

    nets = ("G", "E", "Q")
    out = {}
    for dev in ("cpu", "cuda"):
        d = dataclasses.replace(
            draws, mask_u=to(dev, draws.mask_u), z0_init=to(dev, draws.z0_init),
            neg_init=to(dev, draws.neg_init), post_noise=to(dev, draws.post_noise),
            q=[tuple(None if qd is None else dataclasses.replace(
                qd, prior_noise=to(dev, qd.prior_noise), u=to(dev, qd.u), eps=to(dev, qd.eps))
                for qd in pair) for pair in draws.q],
        )
        state = create_state(small, SEED, dev)
        grads = {name: [] for name in nets}
        for name, opt in zip(nets, (state.opts.g, state.opts.e, state.opts.q)):
            _recording(opt, grads[name])
        step = make_train_step(state.models, state.opts, small)
        original = step_module.sample_q
        step_module.sample_q = lambda ema, xx, z_init, seed: z0.to(xx.device)
        try:
            state, metrics = step(state, x.to(dev), d)
        finally:
            step_module.sample_q = original
        modules = _state_modules(state)
        out[dev] = (
            {k: float(v) for k, v in metrics.items()},
            {k: [(n, p.detach().cpu()) for n, p in v.named_parameters()] for k, v in modules.items()},
            {k: [g.cpu() for g in v[0]] for k, v in grads.items()},
        )
    (m_c, p_c, g_c), (m_g, p_g, g_g) = out["cpu"], out["cuda"]
    failed = []
    for k in m_c:
        diff = abs(m_g[k] - m_c[k])
        limit = METRIC_ATOL + METRIC_RTOL * abs(m_c[k])
        print(f"[train]   {k}: card {m_g[k]:.9g}, CPU {m_c[k]:.9g}, diff {diff:.3e}, limit {limit:.3e}")
        if diff > limit:
            failed.append(k)
    lrs = {"G": small.optim.g_lr, "E": small.optim.e_lr, "Q": small.optim.q_lr}
    for name in nets:
        names = [n for n, _ in p_c[name]]
        deltas = [gg - gc for gg, gc in zip(g_g[name], g_c[name])]
        norm = lambda ts: float(torch.sqrt(sum((t.double() ** 2).sum() for t in ts)))
        net_norm = norm(g_c[name])
        net_rel = norm(deltas) / net_norm
        leaf_rel = {n: norm([dl]) / norm([gc]) for n, dl, gc in zip(names, deltas, g_c[name])
                    if norm([gc]) >= ZERO_LEAF * net_norm}
        worst = max(leaf_rel, key=leaf_rel.get)
        print(f"[train]   {name} gradient: relative L2 error {net_rel:.3e}; worst leaf {worst} "
              f"{leaf_rel[worst]:.3e}; {len(names) - len(leaf_rel)} of {len(names)} leaves zero to "
              f"rounding (limit {GRAD_RTOL:g} each)")
        if net_rel > GRAD_RTOL or leaf_rel[worst] > GRAD_RTOL:
            failed.append(f"{name} gradient")
        limit = lrs[name] / 36 + 1e-6
        held = exempt = 0
        worst_p = 0.0
        for (n, pc), (_, pg), gc, dl in zip(p_c[name], p_g[name], g_c[name], deltas):
            keep = gc.abs() > 10 * dl.abs()
            held += int(keep.sum())
            exempt += int((~keep).sum())
            if bool(keep.any()):
                worst_p = max(worst_p, float((pg - pc).abs()[keep].max()))
        print(f"[train]   {name} parameters: {held} elements held, max abs diff {worst_p:.3e} "
              f"(limit {limit:.3e}); {exempt} set by rounding (share {exempt / (held + exempt):.3e})")
        if worst_p > limit:
            failed.append(f"{name} parameters")
    same_ema = all(torch.equal(a, c) for (_, a), (_, c) in zip(p_g["Q_ema"], p_c["Q_ema"]))
    print(f"[train]   Q_ema equal: {same_ema}")
    if not same_ema:
        failed.append("Q_ema")
    if failed:
        raise AssertionError(f"card and CPU disagree beyond float32 rounding: {failed}")


def train_profile_phase(cfg, state, x=None, path="train"):
    """One training iteration on the batch x (default: CIFAR-shaped images
    made from the seed) under torch.profiler: host wall time, device
    busy time (sum of kernel times), idle share, and for each of the seven
    labelled phases its host time, its span on the device (first to last
    kernel, from the profiler's GPU-side annotation) and the kernel time
    inside that span; then the top kernels. Kernels are attributed by time
    stamp, since autograd launches the backward from another thread than
    the phase's host range."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from damc_tpu_torch.train.step import PHASES, make_train_step

    step = make_train_step(state.models, state.opts, cfg)
    if x is None:
        x = torch.from_numpy(train_images(cfg.train.batch_size)).cuda().float() / 255.0 * 2.0 - 1.0
    step(state, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    annotation = lambda e: getattr(e, "is_user_annotation", False) or "/" in e.name or "#" in e.name
    kernels = [e for e in events if e.device_type == cuda and not annotation(e)]
    dur = lambda e: (e.time_range.end - e.time_range.start) / 1e3
    busy_ms = sum(dur(k) for k in kernels)
    phases = {}
    for name in PHASES:
        label = f"train/{name}"
        host = [e for e in events if e.name == label and e.device_type != cuda]
        spans = [e for e in events if e.name == label and e.device_type == cuda]
        inside = [k for k in kernels for sp in spans
                  if sp.time_range.start <= k.time_range.start < sp.time_range.end]
        phases[name] = {
            "host_ms": sum(dur(e) for e in host),
            "device_span_ms": sum(dur(e) for e in spans),
            "device_busy_ms": sum(dur(k) for k in inside),
            "kernels": len(inside),
        }
    by_name = {}
    for k in kernels:
        ms, calls = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (ms + dur(k), calls + 1)
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:10]
    print("[profile] " + json.dumps({
        "path": path, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "phases": phases,
        "top": [{"name": n[:60], "ms": ms, "calls": c} for n, (ms, c) in top],
    }))


EVAL_TRAIN_IMAGES = 50_000  # CIFAR-10's train split
EVAL_TEST_IMAGES = 2_000  # the test split holds 10,000: cut so that the MSE eval stays short
EVAL_K1_STEPS, EVAL_K1_STEP_SIZE = 100, 1.6  # the eval CLI's prior chain on cifar10


def eval_kernel_phase(models, cfg):
    """Stream mode at the eval shapes. K1 at B=500 (the EBM-prior FID
    batch) with the eval CLI's 100 steps at 1.6 and the loop's 60 at 0.4.
    K2 at B=500 under the prior embedding (the DAMC-prior FID batch) and
    the encoder (the eval CLI's recon-MSE batch), and, as the first rows of
    those launches, B=64 under both (the plot grids) and B=80 under the
    encoder (the loop's recon-MSE tail, 2,000 % 128)."""
    import torch

    from damc_tpu_torch.ops.cuda.fused_langevin import ebm_params_to_dense_weights

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 3)
    m, mc = cfg.model, cfg.mcmc
    b, seed = 500, 987654321
    ebm_w = ebm_params_to_dense_weights(models.ebm)
    z = torch.randn(b, m.nz, generator=gen).to(dev)
    res = {}
    print(f"[eval-kernels] K1 B={b} stream")
    res["K1"] = chain_check(ebm_w, z, dict(seed=seed), EVAL_K1_STEPS, EVAL_K1_STEP_SIZE, "K1 eval CLI")
    res["K1_loop"] = chain_check(ebm_w, z, dict(seed=seed), mc.e_l_steps, mc.e_l_step_size, "K1 loop eval")

    x = torch.rand(b, 32, 32, 3, generator=gen).to(dev) * 2 - 1
    with torch.no_grad():
        prior = models.amortizer.prior_embed(torch.randn(b, m.nz, generator=gen).to(dev))
        posterior = models.amortizer.encode(x)
    print(f"[eval-kernels] K2 B={b} stream, prior tables")
    r = sweep_check(models, cfg, z, prior, dict(seed=seed), "K2 eval prior", subs=(64,))
    res["K2"], res["K2_plot_prior"] = r[b], r[64]
    print(f"[eval-kernels] K2 B={b} stream, posterior tables")
    r = sweep_check(models, cfg, z, posterior, dict(seed=seed), "K2 eval posterior", subs=(64, 80))
    res["K2_posterior"], res["K2_plot_posterior"], res["K2_mse_tail"] = r[b], r[64], r[80]
    return res


def write_cifar_tree(root: str, n_train: int, n_test: int) -> None:
    """CIFAR-10's python pickle layout (data_batch_1..5, test_batch: uint8
    rows of 3072 in CHW order) with images made from the seed."""
    import os
    import pickle

    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)
    rng = np.random.default_rng(SEED + 4)

    def write(name, n):
        data = rng.integers(0, 256, (n, 3072), dtype=np.uint8)
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({"data": data, "labels": [0] * n}, f, protocol=4)

    for i in range(1, 6):
        write(f"data_batch_{i}", n_train // 5)
    write("test_batch", n_test)


def _instrument(module, name, counters, log, what=None):
    """Wrap `module.name` so that each call records its wall time
    (synchronised), the launches it made and its label, `what(args)` or
    else `name`; returns the undo."""
    import torch

    original = getattr(module, name)

    def call(*args, **kwargs):
        torch.cuda.synchronize()
        before = {k: c.launches for k, c in counters.items()}
        t0 = time.perf_counter()
        out = original(*args, **kwargs)
        torch.cuda.synchronize()
        log.append({"what": name if what is None else what(args), "s": time.perf_counter() - t0, "value": out,
                    "launches": {k: c.launches - before[k] for k, c in counters.items()}})
        return out

    setattr(module, name, call)
    return lambda: setattr(module, name, original)


def _png_size(path):
    """(width, height, color type) from a PNG's IHDR; checks the signature."""
    import struct

    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path}: not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    return w, h, head[25]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def protocol_launches(cfg, iterations, n_evals, n_plots, n_fid, n_test):
    """K1 and K2 launches of a train CLI run: one of each a training step;
    per eval one K2 a DAMC-prior FID batch, one K1 an EBM-prior FID batch
    and one K2 a recon-MSE batch (batches of B); three K2 a plot (post,
    post_Q, prior)."""
    n_fid_b = max(round(n_fid / min(cfg.train.fid_batch_size, n_fid)), 1)
    n_mse_b = -(-n_test // cfg.train.batch_size)
    per_eval = {"fid_damc": {"K1": 0, "K2": n_fid_b}, "fid_ebm": {"K1": n_fid_b, "K2": 0},
                "evaluate_mse": {"K1": 0, "K2": n_mse_b}}
    total = {"K1": iterations + n_evals * n_fid_b, "K2": iterations + n_evals * (n_fid_b + n_mse_b) + 3 * n_plots}
    return per_eval, total, n_mse_b


def train_cli_run(cfg, counters, argv, logs, evals, plots, n_fid, n_test, resumed=False, tag="eval"):
    """`cli.train_gen_recon.main(argv)` (print_every 1), counted and timed:
    checks that the run directory holds a train row for every iteration,
    eval rows at `evals` with finite frechet_rand and recon MSE, the PNG
    grids of the iterations `plots` and `evals` (64 images, 8 a row), and
    that K1 and K2 launched as the protocol implies for the iterations the
    call ran. A `resumed` run appends to the files of the run it resumes,
    and `evals` and `plots` are the ones it adds."""
    import os

    import torch

    from damc_tpu_torch.cli import train_gen_recon
    from damc_tpu_torch.train import gen_recon

    dataset = cfg.model.dataset
    calls, events = [], []
    undo = [_instrument(gen_recon, "evaluate_fid", counters, calls, what=lambda args: f"fid_{args[7]}"),
            _instrument(gen_recon, "evaluate_mse", counters, calls), _timed_steps(gen_recon, events)]
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    try:
        state = train_gen_recon.main(argv)
    finally:
        for u in undo:
            u()
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    total = {k: c.launches for k, c in counters.items()}
    runs = os.listdir(os.path.join(logs, dataset))
    if len(runs) != 1:
        raise AssertionError(f"expected one run directory, found {runs}")
    run = os.path.join(logs, dataset, runs[0])
    rows = _jsonl(os.path.join(run, "metrics.jsonl"))
    train_steps = [r["step"] for r in rows if r["phase"] == "train"]
    eval_rows = [r for r in rows if r["phase"] == "eval"]
    eval_steps = [r["step"] for r in eval_rows]
    print(f"[{tag}] {dataset}: train rows {train_steps}; eval rows {eval_steps}")
    if resumed:
        eval_steps = eval_steps[len(eval_steps) - len(evals):]
    if train_steps != list(range(state.step)) or eval_steps != evals:
        raise AssertionError("metrics.jsonl lacks a train or an eval row")
    for r in eval_rows:
        vals = {k: r.get(k) for k in ("frechet_rand_damc", "frechet_rand_ebm", "recon_mse")}
        print(f"[{tag}] {dataset} iteration {r['step']}: " + json.dumps(vals))
        if not all(v is not None and np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"eval row {r['step']}: a metric is missing or not finite")
    if evals or plots:
        grids = set(os.listdir(os.path.join(run, "imgs")))
        want = {f"{it}_{k}.png" for it in plots for k in ("obs", "post", "post_Q", "prior")} | {
            f"{it}_fid_{p}.png" for it in evals for p in ("damc", "ebm")}
        if not (want <= grids if resumed else want == grids):
            raise AssertionError(f"grids {sorted(grids)}, expected {sorted(want)}")
        # 8 images a row, 2-pixel borders: the batch's first 64 images, the FID batch's first 64.
        shown = {"plot": min(64, cfg.train.batch_size), "fid": min(64, cfg.train.fid_batch_size, n_fid)}
        size = cfg.model.image_size + 2
        for g in sorted(want):
            n = shown["fid" if "_fid_" in g else "plot"]
            if _png_size(os.path.join(run, "imgs", g)) != (8 * size + 2, -(-n // 8) * size + 2, 2):
                raise AssertionError(f"{g}: not an RGB grid of {n} images")
        print(f"[{tag}] {dataset}: {len(want)} PNG grids of this run, 8 images a row, RGB")
    per_eval, want_total, n_mse_b = protocol_launches(cfg, len(events), len(evals), len(plots), n_fid, n_test)
    for c in calls:
        if c["launches"] != per_eval[c["what"]]:
            raise AssertionError(f"{c['what']}: launches {c['launches']}, expected {per_eval[c['what']]}")
    print(f"[{tag}] {dataset}: launches per eval {[(c['what'], c['launches']) for c in calls[:3]]}; "
          f"whole run {total} (expected {want_total})")
    if total != want_total:
        raise AssertionError("the run's launches differ from the protocol's")
    eval_walls = [sum(c["s"] for c in calls[i:i + 3]) for i in range(0, len(calls), 3)]
    skip = {i for i, it in enumerate(range(state.step - len(events), state.step)) if it in evals or it in plots}
    ms = _step_ms(events, skip=skip)
    print(f"[{tag}] " + json.dumps({
        "dataset": dataset, "train_cli_wall_s": train_wall, "eval_walls_s": eval_walls,
        "ms_per_iteration": ms, "median_ms_per_iteration": statistics.median(ms) if ms else None,
        "per_call": [{k: c[k] for k in ("what", "s")} for c in calls],
    }))
    return {"state": state, "run": run, "runs": runs, "calls": calls, "total": total, "train_wall": train_wall,
            "eval_walls": eval_walls, "n_mse_b": n_mse_b, "ms": ms}


def eval_phase(cfg, counters):
    """The gen_recon workload through its CLIs at full cifar10 width, in a
    temporary directory: train 6 iterations with evals, grids and
    checkpoints every 3; resume to 8 with --resume_path auto; restore
    ckpt/5 and step it against the state in memory; score ckpt/best twice
    through the eval CLI. Returns what the timing and JSON lines need."""
    import os
    import shutil
    import tempfile

    import torch

    from damc_tpu_torch.cli import train_gen_recon
    from damc_tpu_torch.train.state import create_state
    from damc_tpu_torch.train.step import make_train_step
    from damc_tpu_torch.utils.checkpoint import restore_checkpoint

    tmp = tempfile.mkdtemp(prefix="damc_eval_smoke_")
    try:
        t0 = time.perf_counter()
        data, logs = os.path.join(tmp, "data"), os.path.join(tmp, "logs")
        write_cifar_tree(data, EVAL_TRAIN_IMAGES, EVAL_TEST_IMAGES)
        print(f"[eval] CIFAR-10 pickle tree made from the seed: {EVAL_TRAIN_IMAGES} train images (the real "
              f"split), {EVAL_TEST_IMAGES} test images (the real split holds 10,000; cut so the MSE eval "
              f"stays short), written in {time.perf_counter() - t0:.2f} s")
        b, n_fid = cfg.train.batch_size, 1000
        common = ["--dataset", "cifar10", "--data_path", data, "--log_path", logs, "--seed", str(SEED)]
        train_args = common + ["--batch_size", str(b), "--eval_every", "3", "--ckpt_every", "3",
                               "--plot_every", "3", "--print_every", "1", "--n_fid_samples", str(n_fid)]

        # 1. Train 6 iterations.
        run_info = train_cli_run(cfg, counters, train_args + ["--iterations", "6"], logs, evals=[0, 3, 5],
                                 plots=[0, 3], n_fid=n_fid, n_test=EVAL_TEST_IMAGES)
        state, run, runs, calls = run_info["state"], run_info["run"], run_info["runs"], run_info["calls"]
        eval_walls, n_mse_b = run_info["eval_walls"], run_info["n_mse_b"]
        ckpts = sorted(os.listdir(os.path.join(run, "ckpt")))
        print(f"[eval] checkpoints {ckpts}")
        if not {"3", "5", "best"} <= set(ckpts):
            raise AssertionError("ckpt/3, ckpt/5 or ckpt/best is missing")

        # 2. Resume to 8 iterations in the same run directory.
        for k in counters.values():
            k.launches = 0
        resumed = train_gen_recon.main(train_args + ["--iterations", "8", "--resume_path", "auto"])
        runs_after = os.listdir(os.path.join(logs, "cifar10"))
        rows = _jsonl(os.path.join(run, "metrics.jsonl"))
        steps_after = [r["step"] for r in rows if r["phase"] == "train"]
        print(f"[eval] resumed run: directories {runs_after}, train rows {steps_after}, step {resumed.step}, "
              f"launches {dict((k, c.launches) for k, c in counters.items())}")
        if runs_after != runs or steps_after != list(range(8)) or resumed.step != 8:
            raise AssertionError("the resumed run did not continue at iteration 6 in the same directory")
        del resumed

        # 3. Restore ckpt/5 into a fresh state: equal to the state in memory,
        # and one more step from each, bit for bit.
        restored = restore_checkpoint(os.path.join(run, "ckpt"), "5", create_state(cfg, 123, "cuda"))
        same = _states_equal(restored, state)
        print(f"[eval] ckpt/5 restored into a fresh state equals the state in memory: {same}")
        if not same:
            raise AssertionError("a restored tensor, optimizer state or generator state differs")
        x = torch.from_numpy(train_images(b)).cuda().float() / 255.0 * 2.0 - 1.0
        s_a, m_a = make_train_step(state.models, state.opts, cfg)(state, x)
        s_b, m_b = make_train_step(restored.models, restored.opts, cfg)(restored, x)
        same = all(torch.equal(m_a[k], m_b[k]) for k in m_a) and _states_equal(s_a, s_b)
        print(f"[eval] one more step from the restored state == from the state in memory: {same}")
        if not same:
            raise AssertionError("the step after a restore differs from the step before the save")
        del state, restored, s_a, s_b

        # 4. The eval CLI on ckpt/best, twice.
        eval_args = common + ["--ckpt_dir", os.path.join(run, "ckpt"), "--n_fid_samples", "2000"]
        _, walls, cli_launches = eval_cli_runs(cfg, counters, eval_args, 2, 2000, EVAL_TEST_IMAGES)
        return {"calls": calls, "eval_walls": eval_walls, "cli_launches": cli_launches, "cli_walls": walls,
                "n_mse_b": n_mse_b}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def eval_cli_runs(cfg, counters, argv, runs, n_fid, n_test, tag="eval"):
    """`cli.eval_gen_recon.main(argv)` `runs` times: every run must print the
    same numbers, and launch, per run, a K2 and a K1 per FID batch of 500
    and a K2 per recon-MSE batch of 500. Returns (outputs, walls,
    launches)."""
    import torch

    from damc_tpu_torch.cli import eval_gen_recon

    for k in counters.values():
        k.launches = 0
    outs, walls = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        outs.append(eval_gen_recon.main(argv))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = {k: c.launches for k, c in counters.items()}
    same = all(o == outs[0] for o in outs)
    print(f"[{tag}] {cfg.model.dataset} eval CLI: {json.dumps(outs[0])}; {runs} runs identical: {same}; "
          f"launches over all {launches}; wall s {walls}")
    if not same:
        raise AssertionError("eval CLI runs on one checkpoint printed different numbers")
    bs = cfg.train.fid_batch_size
    n_b, n_m = n_fid // bs, -(-n_test // bs)
    want = {"K1": runs * n_b, "K2": runs * (n_b + n_m)}
    if launches != want:
        raise AssertionError(f"eval CLI launches {launches}, expected {want}")
    return outs, walls, launches


def _states_equal(a, b) -> bool:
    import torch

    mods = lambda s: [s.models.generator, s.models.ebm, s.models.amortizer, s.amortizer_ema]
    for ma, mb in zip(mods(a), mods(b)):
        sa, sb = ma.state_dict(), mb.state_dict()
        if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k]) for k in sa):
            return False
    for oa, ob in zip((a.opts.g, a.opts.e, a.opts.q), (b.opts.g, b.opts.e, b.opts.q)):
        da, db = oa.opt.state_dict()["state"], ob.opt.state_dict()["state"]
        if oa.count != ob.count or da.keys() != db.keys():
            return False
        if not all(torch.equal(v, db[i][k]) for i, st in da.items() for k, v in st.items()):
            return False
    return (a.step, a.seed) == (b.step, b.seed) and torch.equal(a.rng.get_state(), b.rng.get_state())


def inception_phase():
    """pool3 InceptionV3 with random weights: the card against the CPU on 2
    images (relative L2 1e-4, as the CPU tests hold it to JAX's), then the
    FID batch B=500 (32x32 -> 299x299) timed by CUDA events with its peak
    memory."""
    import torch

    from damc_tpu_torch.models.inception import InceptionPool3, init_random_params

    params = init_random_params(seed=0)
    net = InceptionPool3(params).cuda().eval()
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(SEED + 5))
    with torch.no_grad():
        got = net(x.cuda()).double().cpu()
        want = InceptionPool3(params).eval()(x).double()
    err = float((got - want).norm() / want.norm())
    print(f"[inception] card against CPU, 2 images: relative L2 error {err:.3e} (limit 1e-4)")
    if err > 1e-4:
        raise AssertionError("Inception on the card disagrees with the CPU")
    x500 = torch.rand(500, 32, 32, 3, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        ms = time_ms(lambda: net(x500), 3, warmup=1)
    peak = torch.cuda.max_memory_allocated() - base
    print(f"[inception] B=500: {ms:.3f} ms a batch, peak memory above the inputs {peak / 2**30:.3f} GiB")
    return net, ms, peak


def eval_timing_phase(cfg, inception_ms, eval_info, train_ms_per_iteration):
    """The eval's parts at its shapes, each timed by CUDA events on one
    state (random weights from the seed): a FID batch of 500 for each prior
    split into sampling (kernel + G decode), features and the stats update;
    a recon-MSE batch at B=128 and B=500; the host's sqrtm; and the eval
    next to the preset's eval interval of 100 iterations."""
    import torch

    from damc_tpu_torch.metrics.fid import RunningStats, frechet_distance, make_random_feature_fn
    from damc_tpu_torch.train.gen_recon import make_fid_batch_fn, make_recon_fn
    from damc_tpu_torch.train.sampling import eval_draws
    from damc_tpu_torch.train.state import create_state

    state = create_state(cfg, SEED, "cuda")
    m, nz = state.models, cfg.model.nz
    feat = make_random_feature_fn((32, 32, 3), device="cuda")
    out = {}
    for prior in ("damc", "ebm"):
        d = eval_draws(SEED, f"fid_{prior}", 0, 0, 500, nz, "cuda")
        fn = make_fid_batch_fn(m, cfg, prior)
        imgs = fn(d)
        feats = feat(imgs)
        rs = RunningStats(feats.shape[1], "cuda")
        out[f"fid_{prior}"] = {
            "sampling_ms": time_ms(lambda: fn(d), 5),
            "frechet_rand_features_ms": time_ms(lambda: feat(imgs), 5),
            "stats_update_ms": time_ms(lambda: rs.update(feats), 5),
        }
    recon = make_recon_fn(m, cfg)
    test = np.random.default_rng(SEED + 6).uniform(-1, 1, (500, 32, 32, 3)).astype(np.float32)
    for b in (cfg.train.batch_size, 500):
        x = torch.from_numpy(test[:b]).cuda()
        d = eval_draws(SEED, "mse", 0, 0, b, nz, "cuda")
        out[f"mse_batch_ms_b{b}"] = time_ms(lambda: recon(x, d), 3, warmup=1)
    sq = {}
    rng = np.random.default_rng(SEED + 7)
    for dim in (192, 2048):
        a = rng.normal(size=(dim, 2 * dim))
        s1, s2 = a @ a.T / (2 * dim), np.cov(rng.normal(size=(dim, 2 * dim)))
        t0 = time.perf_counter()
        frechet_distance(np.zeros(dim), s1, np.zeros(dim), s2)
        sq[dim] = (time.perf_counter() - t0) * 1e3
    out["sqrtm_host_ms"] = {"frechet_rand_192": sq[192], "inception_2048": sq[2048]}
    # The loop's eval at iteration 5 of the 6-iteration run (1,000 samples,
    # 2,000 test images at B=128), next to 100 iterations.
    window_ms = 100 * train_ms_per_iteration
    last = eval_info["eval_walls"][-1] * 1e3
    out["loop_eval_ms"] = last
    out["train_100_iterations_ms"] = window_ms
    out["loop_eval_share_of_window"] = last / (last + window_ms)
    # A projection, not a measurement: the preset's 50,000-sample protocol
    # (100 batches of 500 a prior, Inception features) and the full 10,000
    # test images (79 batches of 128), from the parts above.
    per_prior = {p: out[f"fid_{p}"]["sampling_ms"] + inception_ms + out[f"fid_{p}"]["stats_update_ms"]
                 for p in ("damc", "ebm")}
    proj = 100 * sum(per_prior.values()) + 79 * out[f"mse_batch_ms_b{cfg.train.batch_size}"] + 2 * sq[2048]
    out["projection_50k_protocol_ms"] = proj
    out["projection_share_of_window"] = proj / (proj + window_ms)
    print("[eval-timing] " + json.dumps(out))
    return out


ANOMALY_TEST_IMAGES = 4_000  # the digit-9 test split holds 19,567: cut so that each AUPRC eval stays short
ANOMALY_ITERATIONS, ANOMALY_EVAL_EVERY, ANOMALY_RESUME_TO = 20, 10, 22
TOY_ITERATIONS, TOY_VIZ_EVERY, TOY_VIZ_BATCHES, TOY_GT_STEPS = 40, 20, 2, 1000


def anomaly_kernel_phase(cfg):
    """The kernels at the anomaly workload's shapes (nz=8), stream mode: K1
    over the B=128 single prior chains (60 steps at 0.4), K2 over B=128
    rows under the encoder of MNIST-shaped images (the Q_ema draw of a
    step) and over B=500 (the AUPRC eval's batch)."""
    import torch

    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.ops.cuda.fused_langevin import ebm_params_to_dense_weights

    dev = torch.device("cuda")
    models = build_models(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 8)
    m, mc = cfg.model, cfg.mcmc
    b, seed = cfg.train.batch_size, 192837465
    res = {}
    print(f"[anomaly-kernels] K1 B={b} stream, single chains")
    z = torch.randn(500, m.nz, generator=gen).to(dev)
    res["K1"] = chain_check(ebm_params_to_dense_weights(models.ebm), z[:b], dict(seed=seed), mc.e_l_steps,
                            mc.e_l_step_size, "K1 anomaly")
    x = torch.rand(500, m.image_size, m.image_size, m.nc, generator=gen).to(dev) * 2 - 1
    with torch.no_grad():
        xemb = models.amortizer.encode(x)
    print(f"[anomaly-kernels] K2 B={b} stream")
    res["K2"] = sweep_check(models, cfg, z[:b], xemb[:b], dict(seed=seed), "K2 anomaly step")[b]
    print("[anomaly-kernels] K2 B=500 stream, the AUPRC batch")
    res["K2_auprc"] = sweep_check(models, cfg, z, xemb, dict(seed=seed), "K2 anomaly AUPRC")[500]
    return res


def _timed_steps(module, events):
    """Wrap `module.make_train_step` so that every step it builds records a
    CUDA event after it (no sync); returns the undo."""
    import torch

    original = module.make_train_step

    def make(*args, **kwargs):
        step = original(*args, **kwargs)

        def timed(*a, **k):
            out = step(*a, **k)
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            events.append(event)
            return out

        return timed

    module.make_train_step = make
    return lambda: setattr(module, "make_train_step", original)


def _step_ms(events, skip):
    """ms between the events of consecutive iterations, leaving out the
    intervals that follow an iteration in `skip` (an eval or a checkpoint
    ran after its step) and the first (first use)."""
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return [t for i, t in enumerate(ms) if i > 0 and i not in skip]


def anomaly_phase(cfg, counters):
    """The anomaly workload through its CLIs at full mnist_anomaly width, in
    a temporary directory, on an MNIST-shaped mnist.npz made from the seed
    (70,000 images: 50,000/10,000/10,000 in x_train/x_test/x_valid): train
    20 iterations at B=128 with an AUPRC eval and checkpoints every 10 (the
    test split cut to 4,000 images through its cache file), resume to 22
    with --resume_path auto in the same directory, then score ckpt/best
    twice through the eval CLI. Returns the times and launches."""
    import os
    import shutil
    import tempfile

    import torch

    from damc_tpu_torch.cli import eval_anomaly_det, train_anomaly_det
    from damc_tpu_torch.data.datasets import load_mnist_anomaly, synthetic_mnist_npz
    from damc_tpu_torch.train import anomaly

    tmp = tempfile.mkdtemp(prefix="damc_anomaly_smoke_")
    try:
        data, logs = os.path.join(tmp, "data"), os.path.join(tmp, "logs")
        os.makedirs(data)
        t0 = time.perf_counter()
        synthetic_mnist_npz(os.path.join(data, "mnist.npz"), (50_000, 10_000, 10_000), seed=SEED)
        digit = cfg.train.heldout_digit
        train_x, _ = load_mnist_anomaly(data, digit, "train")
        test_x, test_y = load_mnist_anomaly(data, digit, "test")
        n_test = len(test_x)
        # The cut: the first 4,000 images of the split, through its own cache file.
        cache = os.path.join(data, f"heldout_{digit}_test.npy")
        split = np.load(cache, allow_pickle=True).item()
        np.save(cache, {k: v[:ANOMALY_TEST_IMAGES] for k, v in split.items()})
        cut_x, cut_y = load_mnist_anomaly(data, digit, "test")
        if not (np.array_equal(cut_x, test_x[:ANOMALY_TEST_IMAGES]) and np.array_equal(cut_y, test_y[:len(cut_y)])
                and len(cut_x) == ANOMALY_TEST_IMAGES):
            raise AssertionError("the cut test split does not read back")
        print(f"[anomaly] MNIST-shaped mnist.npz made from the seed (70,000 images), held-out digit {digit}: "
              f"{len(train_x)} train images, {n_test} test images cut to {len(cut_x)} ({int(cut_y.sum())} "
              f"anomalous; cut so each AUPRC eval stays short), in {time.perf_counter() - t0:.2f} s")
        b = cfg.train.batch_size
        common = ["--data_path", data, "--log_path", logs, "--seed", str(SEED), "--label", str(digit)]
        train_args = common + ["--eval_every", str(ANOMALY_EVAL_EVERY), "--ckpt_every", str(ANOMALY_EVAL_EVERY),
                               "--print_every", "5"]

        # 1. Train 20 iterations.
        evals, events = [], []
        undo = [_instrument(anomaly, "evaluate_auprc", counters, evals), _timed_steps(anomaly, events)]
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        try:
            state, best = train_anomaly_det.main(train_args + ["--iterations", str(ANOMALY_ITERATIONS)])
        finally:
            for u in undo:
                u()
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        total = {k: c.launches for k, c in counters.items()}
        (run,) = os.listdir(os.path.join(logs, "mnist"))
        run = os.path.join(logs, "mnist", run)
        rows = _jsonl(os.path.join(run, "metrics.jsonl"))
        train_steps = [r["step"] for r in rows if r["phase"] == "train"]
        eval_rows = [r for r in rows if r["phase"] == "eval"]
        print(f"[anomaly] train rows {train_steps}; eval rows "
              + json.dumps([{k: r[k] for k in ("step", "auprc", "auprc_best")} for r in eval_rows]))
        want_evals = [0, 10, ANOMALY_ITERATIONS - 1]
        if train_steps != list(range(0, ANOMALY_ITERATIONS, 5)) or [r["step"] for r in eval_rows] != want_evals:
            raise AssertionError("metrics.jsonl lacks a train or an eval row")
        for r in rows:
            if not all(np.isfinite(v) for k, v in r.items() if k not in ("phase",)):
                raise AssertionError(f"non-finite metric in row {r}")
        if not all(0.0 < r["auprc"] <= 1.0 for r in eval_rows) or best != max(r["auprc"] for r in eval_rows):
            raise AssertionError(f"AUPRC out of (0, 1] or best {best} is not the largest")
        ckpts = sorted(os.listdir(os.path.join(run, "ckpt")))
        print(f"[anomaly] checkpoints {ckpts}; best AUPRC {best}")
        if ckpts != sorted(["10", str(ANOMALY_ITERATIONS - 1), "best"]):
            raise AssertionError("ckpt/10, the terminal checkpoint or ckpt/best is missing")
        n_batches = -(-ANOMALY_TEST_IMAGES // anomaly.EVAL_BATCH)
        for e in evals:
            if e["launches"] != {"K1": 0, "K2": n_batches}:
                raise AssertionError(f"an AUPRC eval launched {e['launches']}, expected K2 {n_batches} times")
        eval_launches = {k: sum(e["launches"][k] for e in evals) for k in counters}
        train_launches = {k: total[k] - eval_launches[k] for k in counters}
        per_iteration = {k: v / ANOMALY_ITERATIONS for k, v in train_launches.items()}
        print(f"[anomaly] launches: whole run {total}, the {len(evals)} evals {eval_launches}, "
              f"per training iteration {per_iteration}")
        if train_launches != {"K1": ANOMALY_ITERATIONS, "K2": ANOMALY_ITERATIONS}:
            raise AssertionError("K1 and K2 must each launch once a training iteration")
        ms = _step_ms(events, skip={0, ANOMALY_EVAL_EVERY})
        del state

        # 2. Resume to 22 in the same directory (no eval on the way).
        resumed, _ = train_anomaly_det.main(
            common + ["--iterations", str(ANOMALY_RESUME_TO), "--resume_path", "auto", "--eval_every", "0",
                      "--ckpt_every", str(ANOMALY_EVAL_EVERY), "--print_every", "1"])
        rows = _jsonl(os.path.join(run, "metrics.jsonl"))
        resumed_rows = [r["step"] for r in rows if r["phase"] == "train"][len(train_steps):]
        print(f"[anomaly] resumed: directories {os.listdir(os.path.join(logs, 'mnist'))}, new train rows "
              f"{resumed_rows}, step {resumed.step}")
        if resumed.step != ANOMALY_RESUME_TO or resumed_rows != list(range(ANOMALY_ITERATIONS, ANOMALY_RESUME_TO)):
            raise AssertionError("the resumed run did not continue at iteration 20 in the same directory")
        del resumed

        # 3. The eval CLI on ckpt/best, twice.
        for k in counters.values():
            k.launches = 0
        scores, walls = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            scores.append(eval_anomaly_det.main(common + ["--ckpt_dir", os.path.join(run, "ckpt")]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        cli_launches = {k: c.launches for k, c in counters.items()}
        print(f"[anomaly] eval CLI AUPRC {scores}; identical: {scores[0] == scores[1]}; launches over both "
              f"{cli_launches}; wall s {walls}")
        if scores[0] != scores[1] or not 0.0 < scores[0] <= 1.0:
            raise AssertionError("two eval CLI runs on one checkpoint printed different AUPRCs")
        if cli_launches != {"K1": 0, "K2": 2 * n_batches}:
            raise AssertionError(f"eval CLI launches {cli_launches}, expected K2 {2 * n_batches}")
        out = {
            "median_ms_per_iteration": statistics.median(ms), "ms_per_iteration": ms,
            "auprc_eval_wall_s": [e["s"] for e in evals], "eval_cli_wall_s": walls,
            "train_cli_wall_s": train_wall, "launches_per_iteration": per_iteration,
        }
        print("[anomaly] " + json.dumps(out))
        return {"train": train_launches, "eval": eval_launches, "cli": cli_launches, **out}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def image_profile_phase(cfg, path):
    """One iteration (B=128) of an image workload under torch.profiler, as
    `train_profile_phase` profiles cifar10's, on images of the preset's
    shape made from the seed."""
    import torch

    from damc_tpu_torch.train.state import create_state

    m = cfg.model
    gen = torch.Generator(device="cpu").manual_seed(SEED + 10)
    x = torch.rand(cfg.train.batch_size, m.image_size, m.image_size, m.nc, generator=gen).cuda() * 2 - 1
    train_profile_phase(cfg, create_state(cfg, SEED, "cuda"), x=x, path=path)


def toy_profile_phase(cfg):
    """One toy iteration (B=500) under torch.profiler, on observations of
    the fixed pinwheel batch as `train_toy` makes them."""
    import torch

    from damc_tpu_torch.data.pinwheel import sample_pinwheel
    from damc_tpu_torch.train.state import create_state
    from damc_tpu_torch.train.toy import make_observations

    state = create_state(cfg, SEED, "cuda")
    z = torch.from_numpy(sample_pinwheel(cfg.train.batch_size, SEED)).cuda()
    x = make_observations(state.models.generator, z, torch.randn(z.shape, generator=state.rng, device="cuda"))
    train_profile_phase(cfg, state, x=x, path="toy")


def toy_kernel_phase(cfg):
    """K2 at the toy's widths (nz = 2: one Fourier pair, the last layer 2
    wide) at B=500 under the MLP encoder of pinwheel observations: stream
    mode (the step's Q_ema draw and the parity eval's Q samples) with its
    first 16 rows launched alone equal bit for bit, counter mode, and
    noiseless; each against the plain version and the fp64 plain version."""
    import torch

    from damc_tpu_torch.data.pinwheel import sample_pinwheel
    from damc_tpu_torch.models import build_models

    dev = torch.device("cuda")
    models = build_models(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 9)
    b, nz = cfg.train.batch_size, cfg.model.nz
    z = torch.randn(b, nz, generator=gen).to(dev)
    seeds = torch.randint(0, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).to(dev)
    with torch.no_grad():
        x = models.generator(torch.from_numpy(sample_pinwheel(b, SEED)).to(dev))
        xemb = models.amortizer.encode(x + 0.25 * torch.randn(b, 2, generator=gen).to(dev))
    res = {}
    print(f"[toy-kernels] K2 nz={nz} B={b}")
    sweep_check(models, cfg, z, xemb, dict(with_noise=False), "K2 toy noiseless", full=False)
    res["K2_counter"] = sweep_check(models, cfg, z, xemb, dict(row_seeds=seeds), "K2 toy counter")[b]
    r = sweep_check(models, cfg, z, xemb, dict(seed=24681357), "K2 toy stream", subs=(16,))
    res["K2"] = r[b]
    return res


def toy_phase(cfg, counters):
    """The toy workload through its CLI at the preset's width (nz=2, B=500)
    in a temporary directory: 40 iterations with a parity eval (1,000
    ground-truth Langevin steps, 2 batches of 500) every 20 and at the end;
    checks the eval rows, the KDE plots and the launches."""
    import os
    import shutil
    import tempfile

    import torch

    from damc_tpu_torch.cli import toy as toy_cli
    from damc_tpu_torch.train import toy
    from damc_tpu_torch.utils.logging import KDE_CELL, KDE_GRID

    tmp = tempfile.mkdtemp(prefix="damc_toy_smoke_")
    try:
        evals, events = [], []
        undo = [_instrument(toy, "eval_toy_parity", counters, evals), _timed_steps(toy, events)]
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        try:
            state, final = toy_cli.main([
                "--iterations", str(TOY_ITERATIONS), "--viz_iter", str(TOY_VIZ_EVERY),
                "--viz_batches", str(TOY_VIZ_BATCHES), "--gt_steps", str(TOY_GT_STEPS), "--log_path", tmp,
            ])
        finally:
            for u in undo:
                u()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = {k: c.launches for k, c in counters.items()}
        (run,) = os.listdir(os.path.join(tmp, "toy"))
        run = os.path.join(tmp, "toy", run)
        rows = _jsonl(os.path.join(run, "metrics.jsonl"))
        eval_rows = [r for r in rows if r["phase"] == "eval"]
        print("[toy] eval rows " + json.dumps(
            [{k: r[k] for k in ("step", "g_loss_q", "g_loss_l", "mmd2")} for r in eval_rows]))
        viz_its = list(range(0, TOY_ITERATIONS, TOY_VIZ_EVERY))
        if [r["step"] for r in eval_rows] != viz_its + [TOY_ITERATIONS]:
            raise AssertionError("metrics.jsonl lacks an eval row")
        if not all(np.isfinite(r[k]) for r in eval_rows for k in ("g_loss_q", "g_loss_l", "mmd2")):
            raise AssertionError("a parity eval gave a non-finite g_loss_q, g_loss_l or mmd2")
        if final["zq"].shape != (TOY_VIZ_BATCHES * 500, 2) or not np.isfinite(final["zq"]).all():
            raise AssertionError("the final Q cloud has the wrong shape or is not finite")
        side = KDE_GRID * KDE_CELL
        plots = sorted(os.listdir(os.path.join(run, "viz")))
        want = sorted(f"{n}_lang_post_{w}.png" for n in [*map(str, viz_its), "final"] for w in ("Q", "gt"))
        if plots != want:
            raise AssertionError(f"KDE plots {plots}, expected {want}")
        for p in plots:
            if _png_size(os.path.join(run, "viz", p)) != (side, side, 2):
                raise AssertionError(f"{p}: not a {side}x{side} RGB plot")
        print(f"[toy] {len(plots)} KDE plots, each {side}x{side} RGB")
        per_eval = {"K1": 0, "K2": TOY_VIZ_BATCHES}
        if any(e["launches"] != per_eval for e in evals):
            raise AssertionError(f"a parity eval launched {[e['launches'] for e in evals]}, expected {per_eval}")
        eval_launches = {k: sum(e["launches"][k] for e in evals) for k in counters}
        train_launches = {k: total[k] - eval_launches[k] for k in counters}
        print(f"[toy] launches: whole run {total}, the {len(evals)} evals {eval_launches}")
        if train_launches != {"K1": 0, "K2": TOY_ITERATIONS}:
            raise AssertionError("the toy step must launch K2 once an iteration and K1 never")
        ms = _step_ms(events, skip=set(viz_its))
        out = {"median_ms_per_iteration": statistics.median(ms), "ms_per_iteration": ms,
               "parity_eval_wall_s": [e["s"] for e in evals], "cli_wall_s": wall,
               "final": {k: final[k] for k in ("g_loss_q", "g_loss_l", "mmd2")}}
        print("[toy] " + json.dumps(out))
        return {"train": train_launches, "eval": eval_launches, **out}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


SVHN_TRAIN_IMAGES = 73_257  # SVHN's train split
SVHN_TEST_IMAGES = 2_000  # the test split holds 26,032: cut so that the MSE eval stays short
CELEBA64_TRAIN, CELEBA64_TEST, CELEBA64_SIZE = 2_048, 512, (178, 218)  # CelebA's aligned images
CELEBAHQ_TRAIN, CELEBAHQ_TEST, CELEBAHQ_SIZE = 160, 64, (1024, 1024)  # CelebA-HQ's images


def write_svhn_mats(root: str, n_train: int, n_test: int) -> None:
    """SVHN's .mat layout (X (32, 32, 3, N) uint8, y (N, 1) labels 1-10),
    images made from the seed."""
    import os

    from scipy import io as sio

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(SEED + 11)
    for split, n in (("train", n_train), ("test", n_test)):
        sio.savemat(os.path.join(root, f"{split}_32x32.mat"), {
            "X": rng.integers(0, 256, (32, 32, 3, n), dtype=np.uint8),
            "y": rng.integers(1, 11, (n, 1), dtype=np.uint8),
        })


def write_png_tree(root: str, n: int, size, seed: int) -> float:
    """`synthetic_image_tree` of n PNGs of `size` (width, height) under
    root, written by up to 8 worker processes at once (each a run of the
    file numbers, with its own seed); returns the wall in seconds."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    from damc_tpu_torch.data.datasets import synthetic_image_tree

    t0 = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1, n))
    per = -(-n // workers)
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(synthetic_image_tree, root, min(per, n - k * per), size, seed + k, k * per)
                for k in range(workers) if k * per < n]
        for job in jobs:
            job.result()
    return time.perf_counter() - t0


def preset_kernel_phase(cfg, tag, seed_offset, eval_k1=(), serve=False, rows=False):
    """K1 and K2 at a gen_recon preset's training shapes in stream mode,
    on its own random weights: K1 over the 2B prior chains (60 steps at
    0.4), K2 over B rows under the encoder of random images (the Q_ema
    draw of a step). `eval_k1` lists (steps, step size) of K1 at B=500;
    `serve` adds both kernels at B=16 in counter mode; `rows` adds K2 at
    B=500 under the prior embedding (the FID batch) and the encoder (the
    eval CLI's recon-MSE batch), whose rows 0-15, 0-63, 0-79 and 0-127
    launched alone must equal those of the B=500 launch bit for bit."""
    import torch

    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.ops.cuda.fused_langevin import ebm_params_to_dense_weights

    dev = torch.device("cuda")
    models = build_models(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(SEED + seed_offset)
    m, mc, b = cfg.model, cfg.mcmc, cfg.train.batch_size
    seed = 135792468 + seed_offset
    ebm_w = ebm_params_to_dense_weights(models.ebm)
    z = torch.randn(500, m.nz, generator=gen).to(dev)
    res = {}
    print(f"[{tag}-kernels] nz={m.nz}: K1 B={2 * b} stream, K2 B={b} stream")
    res["K1"] = chain_check(ebm_w, torch.randn(2 * b, m.nz, generator=gen).to(dev), dict(seed=seed),
                            mc.e_l_steps, mc.e_l_step_size, f"K1 {tag}")
    for steps, size in eval_k1:
        res[f"K1_eval_{steps}_{size}"] = chain_check(ebm_w, z, dict(seed=seed), steps, size, f"K1 {tag} eval")
    x = torch.rand(500 if rows else b, m.image_size, m.image_size, m.nc, generator=gen).to(dev) * 2 - 1
    with torch.no_grad():
        post = torch.cat([models.amortizer.encode(x[i:i + 128]) for i in range(0, len(x), 128)])
        prior = models.amortizer.prior_embed(torch.randn(500, m.nz, generator=gen).to(dev))
    if rows:
        r = sweep_check(models, cfg, z, post, dict(seed=seed), f"K2 {tag} posterior", subs=(64, 80, b))
        res["K2"], res["K2_posterior"] = r[b], r[500]
        r = sweep_check(models, cfg, z, prior, dict(seed=seed), f"K2 {tag} prior", subs=(16, 64))
        res["K2_prior"] = r[500]
    else:
        res["K2"] = sweep_check(models, cfg, z[:b], post[:b], dict(seed=seed), f"K2 {tag}")[b]
    if serve:
        seeds = torch.randint(0, 2**31 - 1, (16,), generator=gen, dtype=torch.int32).to(dev)
        res["K1_serve"] = chain_check(ebm_w, z[:16], dict(row_seeds=seeds), mc.e_l_steps, mc.e_l_step_size,
                                      f"K1 {tag} counter")
        sweep_check(models, cfg, z[:16], prior[:16], dict(with_noise=False), f"K2 {tag} noiseless", full=False)
        res["K2_serve"] = sweep_check(models, cfg, z[:16], prior[:16], dict(row_seeds=seeds),
                                      f"K2 {tag} counter")[16]
    return res


def serve_checkpoint_phase(cfg, counters, ckpt_dir, tag):
    """The serve CLI's loading path on a training checkpoint:
    `cli.serve.build_service` with --ckpt_dir/--ckpt_name best, over HTTP:
    /sample damc and ebm and /reconstruct, each path's launches counted.
    The served items must equal the serving core run in process on the
    same checkpoint restored into a fresh state, bit for bit (each row is
    a function of its own draws, whatever it is batched with)."""
    import torch

    from damc_tpu_torch.cli import serve as serve_cli
    from damc_tpu_torch.serve import build_serving_fns, item_draws, make_http_server, stack_draws
    from damc_tpu_torch.train.state import create_state
    from damc_tpu_torch.utils.checkpoint import restore_checkpoint

    m = cfg.model
    service, _ = serve_cli.build_service([
        "--dataset", m.dataset, "--ckpt_dir", ckpt_dir, "--ckpt_name", "best", "--max_batch", "16"])
    service.warmup()
    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    x = np.random.default_rng(SEED + 12).uniform(-1, 1, (4, m.image_size, m.image_size, m.nc)).astype(np.float32)
    served, launches = {}, {}
    try:
        for path in ("damc", "ebm", "recon"):
            for k in counters.values():
                k.launches = 0
            if path == "recon":
                body = _post(base + "/reconstruct", {
                    "image_b64": base64.b64encode(x.tobytes()).decode(), "shape": list(x.shape),
                    "seed": 3, "encoding": "b64"})
                served[path] = (_array(body["x_hat"]), _array(body["z"]))
            else:
                body = _post(base + "/sample", {"n": 4, "prior": path, "seed": 7, "encoding": "b64"})
                served[path] = (_array(body["images"]),)
            launches[path] = {k: c.launches for k, c in counters.items()}
        stats = json.loads(urllib.request.urlopen(base + "/stats", timeout=60).read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
        service.close()
    print(f"[{tag}] served ckpt/best through the serve CLI's loading path; launches {launches}")
    for path, st in stats.items():
        print(f"[{tag}] {path}: p50 {st['latency_p50_ms']:.3f} ms, p99 {st['latency_p99_ms']:.3f} ms, "
              f"{st['requests']} requests, {st['items']} items in {st['batches']} batches")
    if launches["damc"]["K2"] < 1 or launches["recon"]["K2"] < 1 or launches["ebm"]["K1"] < 1:
        raise AssertionError(f"a path did not launch its kernel: {launches}")
    if launches["damc"]["K1"] or launches["ebm"]["K2"] or launches["recon"]["K1"]:
        raise AssertionError(f"a path launched a kernel it should not: {launches}")
    state = restore_checkpoint(ckpt_dir, "best", create_state(cfg, SEED + 13, "cuda"))
    for module in state.models.modules():
        module.eval().requires_grad_(False)
    fns = build_serving_fns(state.models, cfg, recon_langevin_steps=10)
    pad = lambda seed: stack_draws([item_draws(seed, i, m.nz) for i in (0, 1, 2, 3) + (3,) * 12], "cuda")
    xs = torch.from_numpy(x[[0, 1, 2, 3] + [3] * 12]).cuda()
    with torch.no_grad():
        want = {"damc": (fns["damc"](pad(7)),), "ebm": (fns["ebm"](pad(7)),), "recon": fns["recon"](pad(3), xs)}
    for path, outs in served.items():
        same = all(np.array_equal(o, w[:4].cpu().numpy()) for o, w in zip(outs, want[path]))
        print(f"[{tag}] {path}: the served items == the restored state's, in process: {same}")
        if not same:
            raise AssertionError(f"{path}: the served checkpoint differs from the restored state")
    return launches, stats


def svhn_phase(cfg, counters):
    """svhn (nz=100, ngf=64) through its CLIs at full width in a temporary
    directory, on SVHN .mat files made from the seed (73,257 train images,
    the real split; 2,000 test images): train 6 iterations at B=128 with
    evals, grids and checkpoints every 3 and 1,000 FID samples; score
    ckpt/best once through the eval CLI (K1 100 steps at the CLI's 0.4);
    then serve ckpt/best through the serve CLI's loading path."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="damc_svhn_smoke_")
    try:
        data, logs = os.path.join(tmp, "data"), os.path.join(tmp, "logs")
        t0 = time.perf_counter()
        write_svhn_mats(data, SVHN_TRAIN_IMAGES, SVHN_TEST_IMAGES)
        print(f"[svhn] SVHN .mat files made from the seed: {SVHN_TRAIN_IMAGES} train images (the real split), "
              f"{SVHN_TEST_IMAGES} test images (cut from 26,032), written in {time.perf_counter() - t0:.2f} s")
        n_fid = 1000
        common = ["--dataset", "svhn", "--data_path", data, "--log_path", logs, "--seed", str(SEED)]
        t0 = time.perf_counter()
        info = train_cli_run(cfg, counters, common + [
            "--iterations", "6", "--eval_every", "3", "--ckpt_every", "3", "--plot_every", "3", "--print_every", "1",
            "--n_fid_samples", str(n_fid)], logs, evals=[0, 3, 5], plots=[0, 3], n_fid=n_fid,
            n_test=SVHN_TEST_IMAGES, tag="svhn")
        ckpt = os.path.join(info["run"], "ckpt")
        ckpts = sorted(os.listdir(ckpt))
        print(f"[svhn] checkpoints {ckpts}")
        if not {"3", "5", "best"} <= set(ckpts):
            raise AssertionError("ckpt/3, ckpt/5 or ckpt/best is missing")
        del info["state"]
        _, cli_walls, cli_launches = eval_cli_runs(
            cfg, counters, common + ["--ckpt_dir", ckpt, "--n_fid_samples", str(n_fid)], 1, n_fid,
            SVHN_TEST_IMAGES, tag="svhn")
        serve_launches, stats = serve_checkpoint_phase(cfg, counters, ckpt, "svhn")
        wall = time.perf_counter() - t0
        print(f"[svhn] phase wall without the data {wall:.2f} s")
        return {**info, "cli_launches": cli_launches, "cli_walls": cli_walls, "serve": serve_launches,
                "serve_total": {k: sum(l[k] for l in serve_launches.values()) for k in counters}, "wall": wall}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _record_reads(log):
    """Wrap the folder readers the gen_recon CLIs call (the cache and the
    direct decode, in `cli.common` and in `data.datasets`), recording each
    call's root, wall and result; returns the undo."""
    from damc_tpu_torch.cli import common
    from damc_tpu_torch.data import datasets

    undo = []
    for module, name in ((common, "load_image_folder_cached"), (common, "load_image_folder"),
                         (datasets, "load_image_folder")):
        original = getattr(module, name)

        def call(root, size, *a, _original=original, _name=name, **k):
            t0 = time.perf_counter()
            out = _original(root, size, *a, **k)
            log.append({"what": _name, "root": root, "s": time.perf_counter() - t0, "value": out})
            return out

        setattr(module, name, call)
        undo.append(lambda module=module, name=name, original=original: setattr(module, name, original))
    return lambda: [u() for u in undo]


def decoders_line() -> str:
    """Which image decoders this machine offers: libjpeg's header, and PIL
    as a fresh interpreter imports it (the port itself never does)."""
    import glob

    headers = sorted(glob.glob("/usr/include/jpeglib.h") + glob.glob("/usr/include/*/jpeglib.h")
                     + glob.glob("/usr/local/include/jpeglib.h"))
    pil = subprocess.run([sys.executable, "-c", "import PIL.Image; print(PIL.__version__)"],
                         capture_output=True, text=True, timeout=120)
    found = f"imports, version {pil.stdout.strip()}" if pil.returncode == 0 else "does not import"
    return f"[data] decoders on this machine: jpeglib.h {headers or 'absent'}; PIL {found}"


def chain_trace(cfg, steps, step_size, seed_offset):
    """K1 at B=500 with `steps` at `step_size` on the preset's random EBM,
    against its plain version after every step count k (kernel and plain
    each run k steps from the same z and noise). Where the gap first jumps
    past 1e-4, the two states one step before are compared through the
    EBM: a pre-activation (z K1 + b1, or the next layer's) that the two
    sides put on opposite sides of 0 sends the gradient through lrelu's
    other slope (1 against 0.2), which float32 rounding alone can decide
    near 0. Printed, not held: no path of the preset runs this chain."""
    import torch

    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.ops.cuda.fused_langevin import (
        ebm_params_to_dense_weights, fused_prior_langevin, prior_langevin_plain,
    )

    models = build_models(cfg, seed=SEED, device="cuda")
    k1, b1, k2, b2, _ = ebm_w = ebm_params_to_dense_weights(models.ebm)
    z = torch.randn(500, cfg.model.nz, generator=torch.Generator().manual_seed(SEED + seed_offset)).cuda()
    kw = dict(seed=135792468 + seed_offset, step_size=step_size)
    runs = [(fused_prior_langevin(z, *ebm_w, steps=k, **kw), prior_langevin_plain(z, *ebm_w, steps=k, **kw))
            for k in range(steps + 1)]
    errs = [float((a - b).abs().max()) for a, b in runs]
    label = f"[{cfg.model.dataset}-kernels] K1 B=500, {steps} steps at {step_size} (no path of this preset)"
    jump = next((k for k, e in enumerate(errs) if e > 1e-4), None)
    if jump is None:
        print(f"{label}: kernel-plain at most {max(errs):.3e} over every step count")
        return
    row = int((runs[jump][0] - runs[jump][1]).abs().max(1).values.argmax())
    pre = []
    for zs in runs[jump - 1]:
        h1 = zs[row] @ k1 + b1
        pre.append((h1, torch.where(h1 >= 0, h1, 0.2 * h1) @ k2 + b2))
    flips = [int(((a >= 0) != (b >= 0)).sum()) for a, b in zip(*pre)]
    nearest = [float(h.abs().min()) for h in pre[1]]  # the plain state's
    print(f"{label}: kernel-plain {errs[jump - 1]:.3e} after {jump - 1} steps, {errs[jump]:.3e} after {jump}, "
          f"{errs[-1]:.3e} after {steps}; row {row} before step {jump}: the smallest |pre-activation| "
          f"{nearest[0]:.3e} (first layer), {nearest[1]:.3e} (second); the two states put {flips[0]} and "
          f"{flips[1]} of them on opposite sides of 0")


def celeba64_phase(cfg, counters):
    """celeba64 (nz=100, ngf=128, 64x64) through the train CLI at full width
    in a temporary directory, on a PNG tree made from the seed at CelebA's
    aligned size, 178x218 (2,048 train and 512 test images): train 4
    iterations at B=128 (grids at 0, a checkpoint at the end), which writes
    the train split's cache celeba64_train_64.npy; then resume to 5 with an
    eval (500 FID samples, the 512 test images), which must read the cache
    memory-mapped, equal to the first run's decode."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="damc_celeba64_smoke_")
    reads = []
    undo = _record_reads(reads)
    try:
        data, logs = os.path.join(tmp, "data"), os.path.join(tmp, "logs")
        tree_s = write_png_tree(os.path.join(data, "celeba64_train"), CELEBA64_TRAIN, CELEBA64_SIZE, SEED + 20)
        tree_s += write_png_tree(os.path.join(data, "celeba64_test"), CELEBA64_TEST, CELEBA64_SIZE, SEED + 40)
        n_files = CELEBA64_TRAIN + CELEBA64_TEST
        print(f"[celeba64] PNG tree made from the seed: {n_files} images at {CELEBA64_SIZE[0]}x{CELEBA64_SIZE[1]} "
              f"(filters cycling None to Paeth), written in {tree_s:.2f} s")
        n_fid = 500
        common = ["--dataset", "celeba64", "--data_path", data, "--log_path", logs, "--seed", str(SEED),
                  "--print_every", "1", "--n_fid_samples", str(n_fid)]
        t0 = time.perf_counter()
        first = train_cli_run(cfg, counters, common + ["--iterations", "4", "--eval_every", "0", "--plot_every", "4"],
                              logs, evals=[], plots=[0], n_fid=n_fid, n_test=CELEBA64_TEST, tag="celeba64")
        cache = os.path.join(data, "celeba64_train_64.npy")
        decoded = [r for r in reads if r["what"] == "load_image_folder"]
        train_decode = next(r for r in decoded if r["root"].endswith("celeba64_train"))
        cached = next(r for r in reads if r["what"] == "load_image_folder_cached")
        print(f"[celeba64] first run: decode of {CELEBA64_TRAIN} train images {train_decode['s']:.2f} s, "
              f"the cache written and mapped {cached['s'] - train_decode['s']:.2f} s, decode of {CELEBA64_TEST} "
              f"test images {sum(r['s'] for r in decoded if r is not train_decode):.2f} s; "
              f"{os.path.basename(cache)} written: {os.path.exists(cache)}")
        if not os.path.exists(cache) or not np.array_equal(np.load(cache), train_decode["value"]):
            raise AssertionError("the first run did not write the train split's cache, or it differs from the decode")
        if sorted(os.listdir(os.path.join(first["run"], "ckpt"))) != ["3"]:
            raise AssertionError("the first run's checkpoint ckpt/3 is missing")
        del first["state"]
        reads.clear()
        second = train_cli_run(cfg, counters, common + [
            "--iterations", "5", "--eval_every", "4", "--plot_every", "0", "--resume_path", "auto"],
            logs, evals=[4], plots=[], n_fid=n_fid, n_test=CELEBA64_TEST, resumed=True, tag="celeba64")
        (cached,) = [r for r in reads if r["what"] == "load_image_folder_cached"]
        store = cached["value"]
        redecoded = [r["root"] for r in reads if r["what"] == "load_image_folder" and r["root"].endswith("_train")]
        same = isinstance(store, np.memmap) and store.mode == "r" and np.array_equal(store, train_decode["value"])
        print(f"[celeba64] resumed run: step {second['state'].step}; the train split read from the cache "
              f"memory-mapped in {cached['s']:.4f} s, equal to the first run's decode: {same}; decoded again: "
              f"{redecoded or 'none'}")
        if second["state"].step != 5 or not same or redecoded:
            raise AssertionError("the resumed run did not continue at 4 from the cache")
        del second["state"]
        wall = time.perf_counter() - t0
        print(f"[celeba64] phase wall without the tree {wall:.2f} s")
        launches = {k: first["total"][k] + second["total"][k] for k in counters}
        return {"launches": launches, "tree_s": tree_s, "decode_s": train_decode["s"], "wall": wall,
                "ms": first["ms"] + second["ms"]}
    finally:
        undo()
        shutil.rmtree(tmp, ignore_errors=True)


def celebahq_phase(cfg, counters):
    """celebaHQ (nz=128, ngf=128, 256x256, G up to 2048 channels) through the
    train CLI at full width in a temporary directory, on a PNG tree made
    from the seed at CelebA-HQ's size, 1024x1024 (160 train and 64 test
    images): 3 iterations at B=128 with evals at 0 and at the end (500 FID
    samples, the 64-image recon-MSE set) and a checkpoint at the end; then
    one iteration from that checkpoint with remat_generator off and on,
    from the same state and draws, which must agree bit for bit, with the
    peak memory of each; then one iteration under the profiler. Returns
    the launches, times and the restored state."""
    import dataclasses as dc
    import os
    import shutil
    import tempfile

    import torch

    from damc_tpu_torch.data.images import decode_png, resize_bilinear
    from damc_tpu_torch.train.state import create_state
    from damc_tpu_torch.train.step import draw_step, make_train_step
    from damc_tpu_torch.utils.checkpoint import restore_checkpoint

    tmp = tempfile.mkdtemp(prefix="damc_celebahq_smoke_")
    reads = []
    undo = _record_reads(reads)
    try:
        data, logs = os.path.join(tmp, "data"), os.path.join(tmp, "logs")
        tree_s = write_png_tree(os.path.join(data, "train"), CELEBAHQ_TRAIN, CELEBAHQ_SIZE, SEED + 60)
        tree_s += write_png_tree(os.path.join(data, "test"), CELEBAHQ_TEST, CELEBAHQ_SIZE, SEED + 80)
        one = os.path.join(data, "train", "000000.png")
        with open(one, "rb") as f:
            blob = f.read()
        t0 = time.perf_counter()
        img = decode_png(blob, one)
        decode_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        resize_bilinear(img, (256, 256))
        resize_ms = (time.perf_counter() - t0) * 1e3
        w, h = CELEBAHQ_SIZE
        print(f"[celebaHQ] PNG tree made from the seed: {CELEBAHQ_TRAIN + CELEBAHQ_TEST} images at {w}x{h}, "
              f"{os.path.getsize(one)} bytes the first, written in {tree_s:.2f} s; one {w}x{h} file: decode_png "
              f"{decode_ms:.1f} ms, resize to 256x256 {resize_ms:.1f} ms")
        n_fid = 500
        argv = ["--dataset", "celebaHQ", "--data_path", data, "--log_path", logs, "--seed", str(SEED),
                "--iterations", "3", "--eval_every", "2", "--ckpt_every", "2", "--plot_every", "0",
                "--print_every", "1", "--n_fid_samples", str(n_fid)]
        t0 = time.perf_counter()
        info = train_cli_run(cfg, counters, argv, logs, evals=[0, 2], plots=[], n_fid=n_fid, n_test=CELEBAHQ_TEST,
                             tag="celebaHQ")
        decodes = {os.path.basename(r["root"]): r["s"] for r in reads if r["what"] == "load_image_folder"}
        cached = next(r for r in reads if r["what"] == "load_image_folder_cached")
        print(f"[celebaHQ] decode and resize of the train split ({CELEBAHQ_TRAIN} files) {decodes['train']:.2f} s, "
              f"of the test split ({CELEBAHQ_TEST}) {decodes['test']:.2f} s; the cache written and mapped "
              f"{cached['s'] - decodes['train']:.2f} s")
        ckpt = os.path.join(info["run"], "ckpt")
        if not {"2", "best"} <= set(os.listdir(ckpt)):
            raise AssertionError("ckpt/2 or ckpt/best is missing")
        del info["state"]
        store = cached["value"]
        x = torch.from_numpy(np.asarray(store[:cfg.train.batch_size])).cuda().float() / 255.0 * 2.0 - 1.0

        # One iteration from ckpt/2 with remat_generator off, then on.
        out = {}
        for remat in (False, True):
            c = dc.replace(cfg, train=dc.replace(cfg.train, remat_generator=remat))
            state = restore_checkpoint(ckpt, "2", create_state(c, SEED, "cuda"))
            draws = draw_step(c, len(x), state)
            step = make_train_step(state.models, state.opts, c)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t1 = time.perf_counter()
            state, metrics = step(state, x, draws)
            torch.cuda.synchronize()
            out[remat] = {
                "wall_ms": (time.perf_counter() - t1) * 1e3,
                "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
                "metrics": {k: v.detach().cpu() for k, v in metrics.items()},
                "params": [p.detach().cpu() for mod in state.models.modules() for p in mod.parameters()],
            }
            if remat:
                del state
        same = all(torch.equal(out[False]["metrics"][k], out[True]["metrics"][k]) for k in out[False]["metrics"]) \
            and all(torch.equal(a, b) for a, b in zip(out[False]["params"], out[True]["params"]))
        print("[celebaHQ] " + json.dumps({
            "remat_generator": {str(k): {"iteration_wall_ms": v["wall_ms"], "peak_gib_above_state": v["peak_gib"]}
                                for k, v in out.items()},
            "bit_identical_metrics_and_parameters": same}))
        if not same:
            raise AssertionError("remat_generator changed the iteration's metrics or parameters")
        state = restore_checkpoint(ckpt, "2", create_state(cfg, SEED, "cuda"))
        train_profile_phase(cfg, state, x=x, path="celebaHQ")
        del state
        wall = time.perf_counter() - t0
        print(f"[celebaHQ] phase wall without the tree {wall:.2f} s")
        return {"launches": info["total"], "tree_s": tree_s, "decode_ms": decode_ms, "wall": wall, "ms": info["ms"],
                "remat": {k: {"wall_ms": v["wall_ms"], "peak_gib": v["peak_gib"]} for k, v in out.items()}}
    finally:
        undo()
        shutil.rmtree(tmp, ignore_errors=True)


UNFUSED_BATCHES = (16, 128, 500)  # the serving, training and FID shapes


def unfused_sweep_phase(models, cfg):
    """Item 2a on the card, on the full-width cifar10 Q: the unfused sweep
    (`ops/reverse_diffusion.py`, the torch loop over `denoise_from_tables`
    that `sample_q` runs for a denoiser K2 does not take) at B=128, 6 steps,
    noiseless, held to K2's fp64 plain version at `sweep_check`'s limit
    (twice the fp32 plain version's distance, plus 2e-4); at B=500, 100
    steps, fed K2's own stream normals, its per-dimension mean and std held
    to K2's within 0.1 x K2's mean std; a guided sweep (cond_w 0.5, route
    "guided") finite and apart from the unguided one on the same normals;
    the route rule ("k2" for this Q, "tables" for the StyleGAN Q, "guided"
    under guidance); then the median ms of the 100-step unfused sweep beside
    K2's at B=16, 128 and 500 (stream mode, CUDA events). Returns the
    times and errors."""
    import torch

    from damc_tpu_torch.models import DAMCAmortizer, sample_q, sweep_route
    from damc_tpu_torch.ops.cuda.fused_qsweep import denoiser_layer_params, fused_reverse_sweep, reverse_sweep_plain
    from damc_tpu_torch.ops.diffusion import step_coefficients, sweep_logsnr_grid
    from damc_tpu_torch.ops.noise import counter_normal, stream_row_seeds
    from damc_tpu_torch.ops.reverse_diffusion import reverse_diffusion_sample

    dev, d, nz = torch.device("cuda"), cfg.diffusion, cfg.model.nz
    q = models.amortizer
    gen = torch.Generator(device="cpu").manual_seed(SEED + 90)
    normal = lambda *shape: torch.randn(shape, generator=gen).to(dev)
    fourier, layers = denoiser_layer_params(q.p)
    out = {}

    with torch.no_grad():
        def tables(n, xemb):
            grid, _ = sweep_logsnr_grid(n, d.logsnr_min, d.logsnr_max)
            t = q.p.sample_tables(grid.to(dev), xemb)
            return t["pre_x"], t["pre_t"], step_coefficients(n, d.logsnr_min, d.logsnr_max, d.var_type).to(dev)

        def unfused(z, tabs, n, noise=None):
            pre_x, pre_t, _ = tabs
            return reverse_diffusion_sample(
                lambda zz, logsnr, step: q.p.denoise_from_tables(zz, step, pre_x), z, n, d.logsnr_min,
                d.logsnr_max, d.var_type, noise is not None, noise=noise, step_xs=pre_t)

        def k2_normals(seed, b, n):
            rows = stream_row_seeds(seed, b, dev)
            return torch.stack([counter_normal(rows, k, nz) for k in range(n)])

        # 1. B=128, 6 steps, noiseless, against the fp64 plain version.
        b = 128
        z, xemb = normal(b, nz), q.prior_embed(normal(b, nz))
        tabs = tables(6, xemb)
        got = unfused(z, tabs, 6)
        args = (z, fourier, layers, tabs[0], tabs[1], tabs[2])
        want = reverse_sweep_plain(*args, steps=6, with_noise=False, residual=d.residual)
        dbl = lambda t: t.double()
        args64 = (dbl(z), dbl(fourier), [tuple(map(dbl, lt)) for lt in layers], [dbl(t) for t in tabs[0]],
                  [dbl(t) for t in tabs[1]], dbl(tabs[2]))
        ref = reverse_sweep_plain(*args64, steps=6, with_noise=False, residual=d.residual)
        err_u = float((got.double() - ref).abs().max())
        err_p = float((want.double() - ref).abs().max())
        print(f"[unfused] B={b} 6 steps noiseless: against fp64: unfused {err_u:.3e}, plain fp32 {err_p:.3e} "
              f"(limit 2 x plain + 2e-4); unfused - plain fp32 {float((got - want).abs().max()):.3e}")
        if not err_u <= 2 * err_p + 2e-4:
            raise AssertionError("unfused sweep further from the fp64 plain version than fp32 allows")
        out["fp64"] = {"b": b, "unfused_err": err_u, "plain_fp32_err": err_p}

        # 2. B=500, 100 steps, on K2's own normals: moments.
        b, n, seed = 500, d.n_interval, 0x5EED
        z, xemb = normal(b, nz), q.prior_embed(normal(b, nz))
        tabs = tables(n, xemb)
        got = unfused(z, tabs, n, k2_normals(seed, b, n))
        k2 = fused_reverse_sweep(z, fourier, layers, tabs[0], tabs[1], tabs[2], steps=n, residual=d.residual,
                                 seed=seed)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("unfused sweep: non-finite output at 100 steps")
        scale = float(k2.std(0).mean())
        d_mean = float((got.mean(0) - k2.mean(0)).abs().max())
        d_std = float((got.std(0) - k2.std(0)).abs().max())
        print(f"[unfused] B={b} {n} steps on K2's normals: max |d mean|={d_mean:.3e}, max |d std|={d_std:.3e}, "
              f"K2's mean std={scale:.3e} (limit 0.1 x mean std each)")
        if d_mean > 0.1 * scale or d_std > 0.1 * scale:
            raise AssertionError("unfused sweep: moments disagree with K2's")
        out["moments"] = {"b": b, "d_mean": d_mean, "d_std": d_std, "mean_std": scale}

        # 3. Guidance, through sample_q on images (route "guided").
        b = 16
        x = torch.from_numpy(train_images(b)).to(dev).float() / 255.0 * 2.0 - 1.0
        z, noise, guide = normal(b, nz), normal(n, b, nz), normal(n, b, nz)
        if sweep_route(q, 0.5, True) != "guided":
            raise AssertionError("cond_w > 0 on a conditional draw must take the guided route")
        guided = sample_q(q, x, z, 0, cond_w=0.5, noise=noise, guide_noise=guide)
        xe = q.encode(x)
        plain = reverse_diffusion_sample(lambda zz, logsnr: q.p(zz, logsnr, xe), z, n, d.logsnr_min,
                                         d.logsnr_max, d.var_type, True, noise=noise)
        apart = float((guided - plain).abs().max())
        print(f"[unfused] guided B={b} cond_w=0.5: finite {bool(torch.isfinite(guided).all())}, max |guided - "
              f"unguided| {apart:.3e} on the same normals")
        if not bool(torch.isfinite(guided).all()) or apart <= 1e-3:
            raise AssertionError("guided sweep: non-finite, or no different from the unguided one")

    # 4. The route rule.
    with torch.device("meta"):
        sg = DAMCAmortizer(nz=7168, nxemb=7168, ntemb=128, dataset="stylegan")
    routes = {"cifar10": sweep_route(q), "stylegan": sweep_route(sg), "cifar10_guided": sweep_route(q, 0.5, True)}
    print(f"[unfused] routes {routes}")
    if routes != {"cifar10": "k2", "stylegan": "tables", "cifar10_guided": "guided"}:
        raise AssertionError(f"sweep_route: {routes}")

    # 5. Times, 100 steps, stream mode.
    times = {}
    with torch.no_grad():
        for b in UNFUSED_BATCHES:
            z, xemb = normal(b, nz), q.prior_embed(normal(b, nz))
            tabs = tables(n, xemb)
            noise = k2_normals(seed, b, n)
            u_ms = time_ms(lambda: unfused(z, tabs, n, noise), 5)
            k_ms = time_ms(lambda: fused_reverse_sweep(z, fourier, layers, tabs[0], tabs[1], tabs[2], steps=n,
                                                       residual=d.residual, seed=seed), 10)
            times[b] = {"unfused_ms": u_ms, "k2_ms": k_ms}
    print("[unfused] " + json.dumps({"steps": n, "median_ms": times}))
    out["times"] = times
    return out


STYLEGAN_RES = 256
STYLEGAN_IMAGES, STYLEGAN_SIZE = 16, (1024, 1024)  # seeded PNGs at FFHQ's published 1024x1024
STYLEGAN_B, STYLEGAN_REFINE = 8, 100


class _Spans:
    """CUDA events around each call of wrapped functions, read after a sync."""

    def __init__(self):
        self.events = {}

    def wrap(self, name, fn):
        import torch

        def call(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            return out

        return call

    def ms(self, name):
        return [s.elapsed_time(e) for s, e in self.events.get(name, [])]


def stylegan_phase(counters):
    """Item 6 at full size: resolution 256, nz = nxemb = 7168, the 1024-wide
    Q (313M weights), random StyleGAN weights from the seed in the reference
    layout, saved as .pth files; 16 seeded PNGs at 1024x1024, which the
    reader resizes to 256. With every launch count at 0: two iterations of
    `make_inversion_train_step` at B=8 (100 refine steps, 6 Q updates, each
    of which must change Q), Q saved in the port's checkpoint format, and
    the eval CLI twice from it over the 16 images at --batch_size 8, which
    must print the same numbers; then K1 and K2 must not have launched and
    the unfused sweep must have run once a batch (route "tables"). Then
    `nan_rescue` on a z0 with one NaN row, the ms of `invert_batch` split
    into encoder, Q sweep, rescue, Adam refine and decode (CUDA events,
    the median of 2 batches), images/s, peak memory, one batch under the
    profiler (idle share, top kernels) and the FLOP count beside its fp32
    bound. Returns the numbers."""
    import os
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from damc_tpu_torch.cli import eval_stylegan_inv
    from damc_tpu_torch.cli.common import to_pm1
    from damc_tpu_torch.config import preset
    from damc_tpu_torch.data.datasets import load_image_folder
    from damc_tpu_torch.models import amortizer as amortizer_module
    from damc_tpu_torch.models import sweep_route
    from damc_tpu_torch.models.stylegan import W_DIM, build_stylegan, sample_w_codes
    from damc_tpu_torch.train import stylegan_inv as inv
    from damc_tpu_torch.utils.checkpoint import save_checkpoint
    from damc_tpu_torch.utils.flops import inversion_phase_flops

    cfg = preset("celebaHQ")  # the eval CLI's diffusion settings
    tmp = tempfile.mkdtemp(prefix="damc_stylegan_smoke_")
    sweeps = []
    original_sweep = amortizer_module.reverse_diffusion_sample

    def counted_sweep(*args, **kwargs):
        sweeps.append(args[1].shape[0])
        return original_sweep(*args, **kwargs)

    amortizer_module.reverse_diffusion_sample = counted_sweep
    try:
        t0 = time.perf_counter()
        nets = build_stylegan(STYLEGAN_RES, SEED, "cuda")
        paths = {}
        for name, flag in (("generator", "G"), ("encoder", "E"), ("vgg", "F")):
            paths[flag] = os.path.join(tmp, f"{name}.pth")
            torch.save(getattr(nets, name).state_dict(), paths[flag])
        sizes = {f: os.path.getsize(p) for f, p in paths.items()}
        weights_s = time.perf_counter() - t0
        tree = os.path.join(tmp, "ffhq")
        tree_s = write_png_tree(tree, STYLEGAN_IMAGES, STYLEGAN_SIZE, SEED + 100)
        t0 = time.perf_counter()
        images = to_pm1(load_image_folder(tree, STYLEGAN_RES))
        decode_s = time.perf_counter() - t0
        print(f"[stylegan] random weights in the reference layout saved in {weights_s:.2f} s ({sizes} bytes); "
              f"{STYLEGAN_IMAGES} PNGs at {STYLEGAN_SIZE} written in {tree_s:.2f} s, decoded and resized to "
              f"{STYLEGAN_RES} in {decode_s:.2f} s")
        x = torch.from_numpy(images[:STYLEGAN_B]).cuda()

        # The main path, with every launch count at 0.
        for k in counters.values():
            k.launches = 0
        state = inv.create_inversion_state(cfg, STYLEGAN_RES, SEED, "cuda")
        q = state.models.amortizer
        n_q = sum(p.numel() for p in q.parameters())
        if sweep_route(q) != "tables":
            raise AssertionError(f"the StyleGAN Q must take the tables route, not {sweep_route(q)!r}")
        opt = state.opts.q
        changed, original_step = [], opt.step

        def checked_step(grads):
            before = torch.cat([p.detach().reshape(-1) for p in q.parameters()])
            original_step(grads)
            changed.append(not torch.equal(before, torch.cat([p.detach().reshape(-1) for p in q.parameters()])))

        opt.step = checked_step
        step = inv.make_inversion_train_step(q, nets, opt, refine_steps=STYLEGAN_REFINE, refine_lr=0.01,
                                             q_updates=cfg.train.q_updates, p_mask=cfg.diffusion.p_mask)
        train = []
        for it in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            metrics = step(x, gen=state.rng)
            torch.cuda.synchronize()
            state.step += 1
            train.append({"wall_ms": (time.perf_counter() - t1) * 1e3,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                          **{k: float(v) for k, v in metrics.items()}})
        del opt.step
        print("[stylegan] train " + json.dumps({"q_weights": n_q, "iterations": train, "q_updates_changed_q": changed}))
        if not all(np.isfinite(v) for it in train for v in it.values()):
            raise AssertionError("non-finite inversion training metrics")
        if changed != [True] * (2 * cfg.train.q_updates):
            raise AssertionError(f"every Q update must change Q: {changed}")
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, "best", state)
        argv = ["--dataset", "ffhq", "--data_path", tree, "--resolution", str(STYLEGAN_RES),
                "--batch_size", str(STYLEGAN_B), "--n_fid_samples", str(STYLEGAN_IMAGES), "--seed", str(SEED),
                "--q_ckpt_dir", ckpt, "--q_ckpt_name", "best"] + [
                    a for f, p in paths.items() for a in (f"--pretrained_{f}_path", p)]
        cli = []
        for _ in range(2):
            t1 = time.perf_counter()
            out = eval_stylegan_inv.main(argv)
            cli.append({"wall_s": time.perf_counter() - t1, **out})
        launches = {k: c.launches for k, c in counters.items()}
        print("[stylegan] eval CLI " + json.dumps({"runs": cli, "launches": launches, "unfused_sweeps": sweeps}))
        if {k: v for k, v in cli[0].items() if k != "wall_s"} != {k: v for k, v in cli[1].items() if k != "wall_s"}:
            raise AssertionError("two eval CLI runs from one checkpoint printed different numbers")
        if not all(np.isfinite(v) for k, v in cli[0].items()):
            raise AssertionError("non-finite eval CLI metrics")
        if launches != {"K1": 0, "K2": 0}:
            raise AssertionError(f"the StyleGAN path launched a kernel: {launches}")
        n_batches = -(-STYLEGAN_IMAGES // STYLEGAN_B)
        if sweeps != [STYLEGAN_B] * (2 + 2 * n_batches):
            raise AssertionError(f"the unfused sweep must run once a batch: {sweeps}")

        # nan_rescue: one NaN row is replaced, the others are not touched.
        q.eval().requires_grad_(False)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 101)
        bad = STYLEGAN_B // 2
        with torch.no_grad():
            z0 = sample_w_codes(nets.generator, torch.randn(STYLEGAN_B, W_DIM, generator=gen, device="cuda"))
            z0[bad, 17] = float("nan")
            normals = torch.randn(STYLEGAN_B, W_DIM, generator=gen, device="cuda")
            rescued = inv.nan_rescue(nets, z0, x, normals)
            fresh = sample_w_codes(nets.generator, normals)
        others = [i for i in range(STYLEGAN_B) if i != bad]
        ok = bool(torch.isfinite(rescued).all()) and torch.equal(rescued[bad], fresh[bad]) \
            and torch.equal(rescued[others], z0[others])
        print(f"[stylegan] nan_rescue: row {bad} replaced by a fresh W code, the other rows unchanged: {ok}")
        if not ok:
            raise AssertionError("nan_rescue replaced the wrong rows")

        # invert_batch split by CUDA events, then one batch under the profiler.
        spans = _Spans()
        patched = {name: getattr(inv, name) for name in ("sample_q", "nan_rescue", "adam_latent_descent")}
        timed = dataclasses.replace(nets, encoder=spans.wrap("encoder", nets.encoder))
        # The training iterations ran invert_batch already: no warm-up here.
        draws = [inv.inversion_draws(inv.batch_generator(SEED, i, "cuda"), STYLEGAN_B, q.nz, q.n_interval)
                 for i in range(2)]
        try:
            for name, fn in patched.items():
                setattr(inv, name, spans.wrap(name, fn))
            run = spans.wrap("total", lambda d: inv.invert_batch(q, timed, x, d, STYLEGAN_REFINE, 0.01))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for d in draws:
                run(d)
            torch.cuda.synchronize()
        finally:
            for name, fn in patched.items():
                setattr(inv, name, fn)
        peak = torch.cuda.max_memory_allocated() / 2**30
        parts = {"encoder": "encoder", "q_sweep": "sample_q", "rescue": "nan_rescue", "refine": "adam_latent_descent"}
        split = {k: statistics.median(spans.ms(v)) for k, v in parts.items()}
        total = statistics.median(spans.ms("total"))
        split["decode_and_rest"] = total - sum(split.values())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            inv.invert_batch(q, nets, x, draws[0], STYLEGAN_REFINE, 0.01)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        # Device rows of kernels only: the `inversion/*` labels have device rows too.
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "/" not in e.key]
        dev_ms = lambda e: e.self_device_time_total / 1e3
        kernels.sort(key=dev_ms, reverse=True)
        busy_ms = sum(dev_ms(e) for e in kernels)
        flops = inversion_phase_flops(STYLEGAN_B, STYLEGAN_RES, q.n_interval, STYLEGAN_REFINE, cfg.model.ntemb)
        bound_ms, _ = bound(flops["total"], 0.0)
        res = {
            "b": STYLEGAN_B, "ms_per_invert_batch": total, "split_ms": split,
            "images_per_s": STYLEGAN_B / total * 1e3, "peak_gib_invert_batch": peak,
            "profile": {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
                        "top": [{"name": e.key[:60], "ms": dev_ms(e), "calls": e.count} for e in kernels[:8]]},
            "flops": flops, "fp32_bound_ms": bound_ms, "bound_share": bound_ms / total,
            "train": train, "eval_cli": cli, "tree_s": tree_s, "decode_s": decode_s,
        }
        print("[stylegan] " + json.dumps(res))
        return res
    finally:
        amortizer_module.reverse_diffusion_sample = original_sweep
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    print(card_line())

    from damc_tpu_torch.config import preset
    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.ops.cuda import build
    from damc_tpu_torch.ops.cuda.fused_langevin import fused_prior_langevin
    from damc_tpu_torch.ops.cuda.fused_qsweep import fused_reverse_sweep

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    built = build.build()
    print(f"[build] {len(built)} kernel libraries in {time.monotonic() - t0:.1f} s")
    for name, info in built.items():
        print(f"[build] {name}: {info['path']}")
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {line.strip()}")

    cfg = preset("cifar10")
    models = build_models(cfg, seed=SEED, device="cuda")
    res = kernel_phase(models, cfg)
    res_stream = stream_kernel_phase(models, cfg)
    row_independence_phase(models, cfg)
    counters = {"K1": fused_prior_langevin, "K2": fused_reverse_sweep}
    total, _ = serving_phase(models, cfg, counters)
    profile_phase(models, cfg)
    del models
    state, total_train, train_ms = training_phase(cfg, counters)
    rerun_phase(cfg)
    gpu_cpu_phase(cfg)
    train_profile_phase(cfg, state)
    del state
    models = build_models(cfg, seed=SEED, device="cuda")
    res_eval = eval_kernel_phase(models, cfg)
    del models
    eval_info = eval_phase(cfg, counters)
    _, inception_ms, _ = inception_phase()
    eval_timing_phase(cfg, inception_ms, eval_info, train_ms)
    cfg_anomaly, cfg_toy = preset("mnist_anomaly"), preset("toy")
    res_anomaly = anomaly_kernel_phase(cfg_anomaly)
    anomaly_info = anomaly_phase(cfg_anomaly, counters)
    image_profile_phase(cfg_anomaly, "anomaly")
    res_toy = toy_kernel_phase(cfg_toy)
    toy_info = toy_phase(cfg_toy, counters)
    toy_profile_phase(cfg_toy)
    print(decoders_line())
    cfg_svhn, cfg_c64, cfg_hq = preset("svhn"), preset("celeba64"), preset("celebaHQ")
    walls = {}
    t0 = time.perf_counter()
    res_svhn = preset_kernel_phase(cfg_svhn, "svhn", 30, eval_k1=((100, 0.4), (60, 0.4)), serve=True, rows=True)
    chain_trace(cfg_svhn, 100, 1.6, 30)
    svhn_info = svhn_phase(cfg_svhn, counters)
    image_profile_phase(cfg_svhn, "svhn")
    walls["svhn"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_c64 = preset_kernel_phase(cfg_c64, "celeba64", 50)
    c64_info = celeba64_phase(cfg_c64, counters)
    image_profile_phase(cfg_c64, "celeba64")
    walls["celeba64"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_hq = preset_kernel_phase(cfg_hq, "celebaHQ", 70)
    hq_info = celebahq_phase(cfg_hq, counters)
    walls["celebaHQ"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    models = build_models(cfg, seed=SEED, device="cuda")
    unfused_sweep_phase(models, cfg)
    del models
    walls["unfused_sweep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    stylegan_phase(counters)
    walls["stylegan"] = time.perf_counter() - t0
    print("[walls] " + json.dumps({f"{k}_phase_s": v for k, v in walls.items()}))

    meta = {
        "K1": ("fused_prior_langevin", "damc_tpu_torch/csrc/fused_langevin.cu",
               "damc_tpu/ops/pallas/fused_langevin.py:311"),
        "K2": ("fused_reverse_sweep", "damc_tpu_torch/csrc/fused_qsweep.cu",
               "damc_tpu/ops/pallas/fused_qsweep.py:344"),
    }
    kernels = []
    # (path, noise, kernel, its result at the path's shape, its launches in the path's run)
    entries = [
        ("serve", "counter", key, res[key][16], total[key]) for key in meta  # the serving shape B=16
    ] + [("train", "stream", key, res_stream[key], total_train[key]) for key in meta] + [
        ("eval", "stream", key, res_eval[key], eval_info["cli_launches"][key])  # B=500: K1 100 steps, K2 prior
        for key in meta
    ] + [
        ("anomaly", "stream", "K1", res_anomaly["K1"], anomaly_info["train"]["K1"]),  # B=128, nz=8
        ("anomaly", "stream", "K2", res_anomaly["K2"], anomaly_info["train"]["K2"]),  # B=128, nz=8
        # B=500 posterior, nz=8: the train CLI's AUPRC evals, then the eval CLI's own run.
        ("anomaly_eval", "stream", "K2", res_anomaly["K2_auprc"], anomaly_info["eval"]["K2"]),
        ("anomaly_eval_cli", "stream", "K2", res_anomaly["K2_auprc"], anomaly_info["cli"]["K2"]),
        ("toy", "stream", "K2", res_toy["K2"], toy_info["train"]["K2"] + toy_info["eval"]["K2"]),  # B=500, nz=2
        # nz=100: the svhn train CLI run (6 iterations and their 3 evals), K1 over 2B=256, K2 B=128 posterior.
        ("svhn", "stream", "K1", res_svhn["K1"], svhn_info["total"]["K1"]),
        ("svhn", "stream", "K2", res_svhn["K2"], svhn_info["total"]["K2"]),
        # The svhn eval CLI: K1 B=500, 100 steps at 0.4; K2 B=500 (the FID batch's prior tables).
        ("svhn_eval", "stream", "K1", res_svhn["K1_eval_100_0.4"], svhn_info["cli_launches"]["K1"]),
        ("svhn_eval", "stream", "K2", res_svhn["K2_prior"], svhn_info["cli_launches"]["K2"]),
        # ckpt/best served through the serve CLI: B=16, counter mode.
        ("svhn_serve", "counter", "K1", res_svhn["K1_serve"], svhn_info["serve_total"]["K1"]),
        ("svhn_serve", "counter", "K2", res_svhn["K2_serve"], svhn_info["serve_total"]["K2"]),
        # nz=100 at 64x64: both train CLI runs; nz=128 at 256x256: the train CLI run.
        ("celeba64", "stream", "K1", res_c64["K1"], c64_info["launches"]["K1"]),
        ("celeba64", "stream", "K2", res_c64["K2"], c64_info["launches"]["K2"]),
        ("celebaHQ", "stream", "K1", res_hq["K1"], hq_info["launches"]["K1"]),
        ("celebaHQ", "stream", "K2", res_hq["K2"], hq_info["launches"]["K2"]),
    ]
    for path, mode, key, r, launches in entries:
        name, source, replaces = meta[key]
        bound_ms, bound_by = bound(r["flops"], r["bytes"])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "path": path, "noise": mode, "batch": r["b"],
        })
    for key, (name, _, _) in meta.items():
        shapes = [("serving counter", res[key][16]), ("training stream", res_stream[key]),
                  ("counter", res[key][500])]
        shapes += [(f"eval stream {k}", r) for k, r in res_eval.items() if k.startswith(key)]
        shapes += [(f"anomaly stream {k}", r) for k, r in res_anomaly.items() if k.startswith(key)]
        shapes += [(f"toy {k}", r) for k, r in res_toy.items() if k.startswith(key)]
        for tag, res_p in (("svhn", res_svhn), ("celeba64", res_c64), ("celebaHQ", res_hq)):
            shapes += [(f"{tag} {k}", r) for k, r in res_p.items() if k.startswith(key)]
        for label, r in shapes:
            b_ms, by = bound(r["flops"], r["bytes"])
            print(f"[kernels] {name} {label} B={r['b']}: ms={r['ms']} plain_ms={r['plain_ms']} "
                  f"bound_ms={b_ms} ({by}) flops={r['flops']} bytes={r['bytes']} max_abs_err={r['max_abs_err']}")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
