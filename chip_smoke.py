#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`damc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. prints the card's name and power limit (nvidia-smi); needs CUDA;
  2. builds every CUDA kernel from `damc_tpu_torch/csrc`, one nvcc each, all
     at once, and beside them the host C++ libraries of
     `damc_tpu_torch/csrc/host` (batch engine, JPEG and WebP decoders, LMDB
     reader), one g++ each;
  3. holds each kernel against its plain PyTorch version on the card, at the
     serving shape B=16 and the FID shape B=500 (ragged row tiles) in
     counter and noiseless mode, and in stream mode at the training shapes
     (K1 over 2B=256 chains, K2 over B=128 rows), and times both beside
     their bounds; then, in counter mode, rows 0, 7, 250 and 499 of a B=500
     launch of each kernel must equal, bit for bit, the same rows launched
     alone and inside batches of 16, 64, 80 and 128 (every K2 row tile the
     main path runs); K1's bf16-dot variants against their plain bf16
     version at B=256 and B=500 (nz=128), B=128 (nz=8), B=256 (nz=100) on
     the tensor cores in one block (K1_tc), and at B=256 at ndf=512 and
     ndf=640 (K1_tc over clusters of 4 and 8) and ndf=1024 (K1_l2): 6
     noiseless steps pointwise, the 60-step stream chain in moments, apart
     from the float32 variant, and timed beside it; K1_tc's rows of a B=500
     counter launch bit for bit as alone and in batches of 16 and 128, and
     each of two ranks' stream rows at their row_base (K4a) as that launch's;
  4. serves the full-width `cifar10` preset (random weights from a seed) over
     HTTP: /sample damc and ebm and /reconstruct, some requests concurrent;
     checks shapes, range, that an item served alone equals the same item
     served coalesced, that the EBM path agrees with the CPU plain versions,
     and that each path launched its kernels;
  5. profiles one B=16 dispatch of each serving path (device busy and idle
     time, top kernels); then serving artifacts (item 7) of phase 4's
     weights, exported on the card and, from the same seeded weights, on the
     CPU (B=16, 5 recon steps), are served on the card over HTTP by a
     separate process that imports no model or training module: the answers
     of both must equal the live service's bit for bit, K2 launch once per
     damc and recon dispatch and K1 once per ebm dispatch, and K2 pack its
     weights once per program; p50/p99 of 20 sequential single-item
     requests a path, artifact beside live; and the two checkpoint CLIs: a
     `.pth.tar` of the seeded weights converted, one training iteration
     resumed from it, exported back and loaded strictly, equal tensor for
     tensor;
  5b. serving over two replicas of the card (`serve_mesh_phase`,
     `LocalMesh(["cuda:0", "cuda:0"])`, max_batch=16): one 16-row dispatch
     of each path's core, where K1's outputs (8 rows a replica) and K2 on
     each half of the one-device launch's inputs must equal that launch bit
     for bit, a rerun must be bit-identical and the images and recon z
     agree within SERVE_MESH_IMAGE_ATOL and SERVE_MESH_Z_ATOL (the sweep's
     tables come from cuBLAS and cuDNN products at 8 rows, not 16); then
     both services over
     HTTP (an item alone == coalesced), K1 or K2 once a replica a dispatch
     on 8 rows, p50/p99 of 20 single-item requests a path beside one
     device's; K1 and K2 at B=8 in counter mode against their plain
     versions;
  5c. the unfused serving route (`serve_unfused_phase`, `SamplerService(
     fused=False)`) at full cifar10 width, max_batch=16: every path over
     HTTP (an item alone == coalesced) with K1 and K2 launched 0 times,
     p50/p99 of 20 single-item requests a path beside the kernel route's;
     one dispatch of both routes on the same draws, the EBM chain's z and
     images against K1's, the damc and recon sweeps over 6 steps held to
     the fp64 unfused route as K2 is, and the 100-step damc sweep at B=128
     in its moments against K2's; cifar10 with ndf=512 served under auto
     on the kernels (K1 over a cluster of 8, K1_c8, held against its
     float64 plain version at B=16; K1_l2 never), with its p50/p99; and
     `cli.serve --fused off --export_artifact` (4 sweep and 4 EBM steps),
     loaded on the card, bit for bit equal to the live unfused service;
  6. trains the full-width `cifar10` preset at B=128 for 10 iterations
     through `train_gen_recon` on images made from a seed, timed by CUDA
     events without a sync per iteration; checks finite metrics, that every
     network changed, that Q_ema changed only at the 10th iteration and that
     K1 and K2 launched once an iteration; then two fresh 2-iteration runs
     must be bit-identical, and one B=8 iteration on the card must agree
     with the CPU plain path on the same draws and z0, in metrics,
     gradients and parameters;
  7. profiles one training iteration (device busy and idle time, the seven
     phases, top kernels); then phases 6 and 7 again with compute_dtype and
     pallas_dots_dtype "bfloat16" (K1's tensor-core variant, K1_tc, once an
     iteration, every other K1 variant never; the card-vs-CPU iteration at
     bf16 limits), and the serving of phase 4 with a bf16 G and encoder (K1
     in float32), and one bf16 FID batch of each prior at B=500 (K1_tc
     once for the EBM prior); the analytic FLOPs of one cifar10 iteration
     at B=128 (`utils/flops.py::train_step_flops`) over the float32 and
     bf16 medians, as shares of the card's fp32 and bf16 peaks;
  7b. the widths K1 pads or spreads (`k1_widths_phase`): cifar10 at full
     width with nz=10 (padded to 12, weights in shared memory over 4
     blocks) for 3 iterations, with ndf=512 (nz=128, weights in shared
     memory over a cluster of 8: the K1_c8 variant) for 1, at B=128
     with use_pallas on, through `train_gen_recon`; before each, K1 over
     that model's 2B=256 chains and K2 over its B=128 rows in stream mode
     against their plain versions (K1 against float64); with ndf=1024
     (weights streamed from L2: the K1_l2 variant) no training, K1 alone
     against float64 over 2B=256 chains, in counter mode at B=16 and with
     bf16 dots at B=256 (stream) and B=16 (counter), and its rows, fp32 and
     bf16, bit for bit as alone, in batches of 16 and 128 and at a rank's
     row_base; at ndf=512 also
     K1 with bf16 dots (K1_tc over a cluster of 4) against float64 in
     stream (B=256) and counter (B=16) mode, and K1_c8's rows of a B=500
     launch bit for bit those of the row alone and in batches of 16 and
     128; each iteration launches K1
     once in the variant the widths take and K2 once; finite metrics, G, E
     and Q changed, each iteration's ms beside the card's name and power
     limit; then, at each of the three widths, K1 on the EBM-prior FID
     batch's draws (B=500) against its float64 plain version, and the
     batch twice (on the trained weights; at ndf=1024 on the seed's):
     finite, bit-identical, one launch a batch of the variant the widths
     take; one ndf=512 iteration profiled (K1's share);
  8. holds each kernel against its plain version at the eval shapes in
     stream mode: K1 at B=500 with the eval CLI's 100 steps at 1.6 and the
     loop's 60 at 0.4; K2 at B=500 under the prior embedding (the FID
     batch) and the encoder (the recon-MSE batch), and at B=64 (the plot
     grids) and B=80 (the loop's recon-MSE tail), whose 100-step rows must
     equal those of the B=500 launch bit for bit;
  9. drives the gen_recon workload through its CLIs at full cifar10 width
     in a temporary directory, on a CIFAR-10 pickle tree made from the seed
     (10,000 train images, cut from 50,000; 1,000 test images, cut from
     10,000): trains 4
     iterations at B=128 with evals, grids and checkpoints every 2 and 1,000
     FID samples (`frechet_rand`: no Inception weights here) and checks the
     metrics rows, the checkpoints, the PNG grids and that K1 and K2
     launched exactly as the protocol implies; resumes to 5 iterations with
     --resume_path auto in the same run directory; restores ckpt/3 into a
     fresh state, equal to the state in memory, and steps both, bit for
     bit; scores ckpt/best once through the eval CLI (K1 100 steps at 1.6,
     K2 at B=500; its rerun cut for time: phase 7b reruns an EBM-prior FID
     batch);
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
     test split cut to 4,000 images through its cache file), trains 6
     iterations through `cli.train_anomaly_det` with an AUPRC eval and
     checkpoints every 3, resumes to 7 in the same directory, and scores
     ckpt/best once through `cli.eval_anomaly_det` (its rerun cut for time);
     checks rows, checkpoints, K1 and K2 once an iteration and K2 once an
     eval batch; profiles one iteration as phase 7 does;
 13. toy workload (`toy`, nz=2, B=500): K2 at the toy's widths in stream,
     counter and noiseless mode against the plain version (6 steps held to
     fp64; stream rows of B=500 equal to the same rows at B=16, bit for
     bit); then 20 iterations through `cli.toy` with a parity eval (1,000
     ground-truth steps, 2 batches of 500) every 10 and at the end; checks
     finite g_loss_q, g_loss_l and mmd2, a 600x600 KDE PNG per cloud and
     eval, K2 once an iteration and once an eval batch, K1 never; profiles
     one iteration;
 14. prints which image decoders the machine has (jpeglib.h; PIL with the
     libwebp and libjpeg-turbo versions it bundles);
 15. svhn (nz=100, ngf=64, 32x32, full width): K1 over 2B=256 (60 steps at
     0.4) and at B=500 (100 steps at the eval CLI's 0.4; 60 at 0.4), K2 at
     B=500 under the encoder and the prior embedding in stream
     mode, whose rows 0-15, 0-63, 0-79 and 0-127 launched alone must equal
     the B=500 launch's bit for bit, and both kernels at B=16 in counter
     mode; K1 at cifar10's eval step size 1.6, which no svhn path runs,
     traced step by step against its plain version and printed, not held;
     then, on SVHN .mat files made from the seed (73,257 train images;
     2,000 test images), 2 iterations through `cli.train_gen_recon` with
     evals at both, a grid at the first, a checkpoint at the last and 1,000
     FID samples, the eval
     CLI once on ckpt/best, and ckpt/best served through the serve CLI's
     loading path (--ckpt_dir): /sample damc and ebm and /reconstruct must
     equal the restored state's serving core run in process, bit for bit;
     profiles one iteration as phase 7 does;
 16. celeba64 (nz=100, ngf=128, 64x64): K1 and K2 at the training shapes;
     a JPEG tree made from the seed by PIL at CelebA's 178x218 (2,048
     train, 512 test images; 4:2:0 at quality 75, some 4:4:4, some with
     restart markers), written by worker processes; 4 iterations through
     the train CLI with --data_placement host, which decodes the tree and
     writes the train split's .npy cache; every train file decoded by the
     port must equal PIL's decode and the cache the JAX package's PIL
     pipeline, with both decode rates; then a resume to 5 with an eval
     under 'auto' with a device budget below the store, which must read the
     cache memory-mapped and take the host feed; 'device' over the budget
     must raise; host batches queued to the card must equal the CPU's; the
     host feed's ms an iteration and idle share beside the device-resident
     store's; profiles one iteration;
 16b. items 4c's and 4d's decoders (`decoders_4c_phase`): 3,520 files at
     178x218 written on worker processes (by PIL: 1,024 lossy, 256
     lossless, 128 alpha and 32 animated WebPs; 1,024 progressive, 128
     CMYK, 64 YCCK and 64 smoothed, cut progressive JPEGs; by the port's
     writers: 64 each of arithmetic-coded sequential, arithmetic-coded
     progressive and lossless JPEGs, and 32 of each of item 4d's 19 PNG and
     BMP kinds: grey PNG at 1, 2, 4 and 16 bits, palette PNG at 1, 2 and 4,
     16-bit RGB, RGBA and grey + alpha PNG, Adam7 RGB and palette-4 PNG; 1-,
     4- and 16-bit, 5-6-5 and 32-bit bit-field, RLE8 and RLE4 BMP), each
     decoded by the port equal to PIL's decode byte for byte, with the
     decode rates of each kind (JPEG and WebP: 8 threads, 1 thread, PIL on
     1; PNG and BMP, whose readers have no thread pool: 1 thread, PIL on 1);
     then a mixed celeba64 tree drawn from them (1,024 train, 256 test)
     through the train CLI for 3 iterations at B=128, host-fed: the cache
     equal to the JAX package's PIL pipeline, K1 and K2 once an iteration,
     finite metrics, the ms an iteration;
 17. celebaHQ (nz=128, ngf=128, 256x256): K1 and K2 at the training shapes;
     a 512x512 PNG tree (128 train, 16 test images); 2 iterations at B=128
     through the train CLI with evals at 0 and at the end (500 FID samples,
     the 16 test images); one iteration from the last checkpoint with
     remat_generator off and on, bit-identical in metrics and parameters,
     with the peak memory of each; one iteration profiled as in phase 7;
 18. unfused sweep (item 2a) on the full-width cifar10 Q: B=128, 6 noiseless
     steps held to K2's fp64 plain version at sweep_check's limit; B=500,
     100 steps on K2's own stream normals, moments held to K2's; a guided
     sweep (cond_w 0.5) finite and apart from the unguided one; the route
     rule; the 100-step unfused sweep's ms beside K2's at B=16, 128, 500;
 19. StyleGAN inversion (item 6) at full size (256x256, nz 7168, the 313M-
     weight Q, random weights saved as .pth files, 16 seeded 1024x1024
     PNGs): 1 training iteration at B=8 (every Q update changes Q), a Q
     checkpoint, the eval CLI once from it (its rerun cut for time), K1 and
     K2 launched 0 times and the unfused sweep once a batch; nan_rescue;
     invert_batch's ms split by part, images/s, peak memory, the device's
     idle share and top kernels, the FLOP count beside its fp32 bound; the
     eval CLI once more with --compute_dtype bfloat16 (recon MSE within 5%
     of the float32 run's, no kernel launched) and the bf16 refine's split,
     images/s and peak memory beside the bf16 tensor-core bound; LSUN
     (items 4b, 4c): an LMDB of 64 seeded JPEGs up to 256x340, and one of
     64 lossy and lossless WebPs, each read through `LSUNImages` bit-equal
     to PIL's decode, crop and LANCZOS, with the read rate, and the eval
     CLI with --dataset lsun_tower over one batch of 8 of each at 10
     refine steps (the WebPs' with the bf16 refine);
  19b. data parallelism (`dp_phase`, after the stylegan phase, whose
     files it reuses): two ranks of a torch.distributed group share the
     card over gloo, each a process started with torchrun's environment,
     under one hard timeout. gen_recon: K4a (K1 over 2B=256 chains and
     B=500, 60 steps at 0.4) and K4b (K2 at B=128 under the encoder and
     B=500 under the prior embedding), each in stream, counter and
     noiseless mode, gathered over the ranks, must equal one K1 or K2
     launch bit for bit, and each rank's own stream launch (its rows at its
     row_base) the same rows of that launch; those launches are held
     against the plain versions and timed, one rank at a time. Then 3
     iterations of `cli.train_gen_recon --use_mesh --dist_backend gloo` at
     full cifar10 width and global B=128 on a 2,000-image CIFAR-10 tree
     made from the seed (evals at 0 and at the end, 500 FID samples; a
     checkpoint): K1 and K2 once a step on each rank at 128 and 64 rows
     with the rank's row_base, the replicas equal bit for bit, one run
     directory, only rank 0 writes; and the card-vs-CPU iteration of phase
     6 on two ranks against the same iteration in one process on the card,
     within FP32_LIMITS. The anomaly workload (nz=8): K4a over B=128 chains
     and K4b at B=128 and B=500 under the encoder, checked the same way; 4
     iterations of `cli.train_anomaly_det --use_mesh` at full width and
     global B=128 on a seeded mnist.npz (AUPRC evals at 0 and 3, a
     checkpoint): K1 and K2 once a step on each rank at its 64 rows, K2
     once an AUPRC batch at its 250 of 500, replicas equal, one writer;
     `cli.eval_anomaly_det --use_mesh` on ckpt/best against the one-process
     CLI, AUPRC within 2 / (the anomalous count). The inversion eval CLI
     with `--use_mesh` over phase 19's files (16 images, B=8, 4 a rank):
     recon MSE within INV_MESH_RTOL of phase 19's one-process run, no K1 or
     K2. The 256x256 synthesis with its wide parameters channel-sharded
     over the ranks (`parallel/tp.py`) against the replicated forward, at
     rtol 1e-4, atol 1e-5. Prints the ms an iteration of the two ranks
     sharing one H100 beside phase 6's;
 20. prints one JSON line {"kernels": [...]} with launches, errors and times
     of each kernel on each path (serve, serve_artifact: the card-exported
     artifact's requests in its serving process, serve_ndf512: phase 5c's
     ndf=512 service (K1_c8), train, train_nz10, train_ndf512 (K1_c8),
     eval_nz10, eval_ndf512 (K1_c8) and eval_ndf1024 (K1_l2): phase 7b's
     runs, eval, anomaly, anomaly_eval:
     the train CLI's AUPRC evals, anomaly_eval_cli: the eval CLI's run,
     toy, svhn: the train CLI run, svhn_eval: the eval CLI run,
     svhn_serve: the served checkpoint, celeba64: both train CLI runs,
     celeba64_4c: the train CLI run over the mixed tree of item 4c,
     train_dp rank 0 and rank 1: each rank's launches of K4a and K4b in
     the data-parallel train CLI run, its own rows' times and bound,
     anomaly_dp rank 0 and rank 1: each rank's K4a and K4b launches in the
     training steps of the data-parallel anomaly run, anomaly_dp_eval: rank
     0's K4b launches in the two-rank eval CLI, serve_mesh: the
     two-replica service's K1 and K2 launches over its HTTP requests,
     celebaHQ: the train CLI run, train_bf16: the bf16 training run,
     eval_bf16: the bf16 EBM-prior FID batch, both K1_tc);
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

PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
SEED = 0
# Timed calls of a kernel's plain version (its `plain_ms`), after the run of
# its check: the plain versions repeat the kernels' arithmetic in 80 to 500
# ms a call, 84 of them, so more calls would cost minutes of the time limit.
PLAIN_REPS = 1


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


def peak_rate(dtype: str = "float32") -> float:
    """The card's dense peak FLOP/s in `dtype`, from the port's table
    (`damc_tpu_torch/utils/flops.py::peak_flops`)."""
    import torch

    from damc_tpu_torch.utils.flops import peak_flops

    rate = peak_flops(torch.cuda.get_device_name(0), dtype)
    if rate is None:
        raise AssertionError(f"no {dtype} peak for {torch.cuda.get_device_name(0)} in utils/flops.py")
    return rate


def bound(flops: float, nbytes: float, peak_flops: float = None):
    t_ops, t_bytes = flops / (peak_flops or peak_rate()) * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def langevin_cost(b, nz, ndf, steps, weight_bytes=4):
    """FLOP and bytes of a K1 launch: the four products per chain and step;
    z in and out, the two weight matrices (weight_bytes each: 2 for the
    bf16-dot variant, whose bound takes them in bf16), biases, head and
    one int32 seed per chain."""
    flops = 2.0 * b * steps * (2 * nz * ndf + 2 * ndf * ndf)
    nbytes = 4.0 * (2 * b * nz + 3 * ndf + b) + weight_bytes * (nz * ndf + ndf * ndf)
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

    if "seed" not in noise:
        return None
    return dict(row_seeds=_int32(stream_row_seeds(noise["seed"], b, dev, noise.get("row_base", 0))))


def report(name, r):
    b_ms, by = bound(r["flops"], r["bytes"], r.get("peak"))
    print(f"  {name} B={r['b']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"bound {b_ms:.5g} ms ({by}), {r['flops']:.4g} FLOP, {r['bytes']:.4g} B")


def chain_check(ebm_w, z, noise, steps, step_size, label, against_fp64=False, dots_dtype="float32"):
    """K1 against its plain version on z (B, nz) under `noise` (row_seeds
    or seed), then both timed. The counter bits are exact; logf/cosf may
    differ from torch by an ulp, so atol 1e-4. In stream mode the kernel
    must also equal counter mode on stream_row_seeds, bit for bit.
    `dots_dtype` "bfloat16" runs the bf16-dot variant, and the plain
    versions (float32 and float64) round the products' operands to bf16 as
    the kernel does; its bound is at the bf16 rate.

    With `against_fp64` the kernel is held to the plain version in float64
    instead, as sweep_check holds K2: at most twice as far from it as the
    float32 plain version is, plus 1e-4. The energy is piecewise linear, so
    a chain that crosses a kink on one side of a rounding and not on the
    other takes a gradient step that differs by O(step^2): over 60 steps a
    float32 pair can then part by more than 1e-4 (1.06e-4 at nz=10, B=256,
    on an H100) with neither at fault."""
    import torch

    from damc_tpu_torch.ops.cuda.fused_langevin import fused_prior_langevin, prior_langevin_plain

    b, nz = z.shape
    kw = dict(steps=steps, step_size=step_size, dots_dtype=dots_dtype)
    got = fused_prior_langevin(z, *ebm_w, **noise, **kw)
    counter = _stream_as_counter(noise, b, z.device)
    if counter is not None and not torch.equal(got, fused_prior_langevin(z, *ebm_w, **counter, **kw)):
        raise AssertionError(f"{label}: stream mode differs from counter mode on stream_row_seeds")
    want = prior_langevin_plain(z, *ebm_w, **noise, **kw)
    name = f"{label} B={b}, {steps} steps at {step_size}"
    if against_fp64:
        ref = prior_langevin_plain(z.double(), *[t.double() for t in ebm_w], **noise, **kw)
        err = float((got - want).abs().max())
        err_k, err_p = float((got.double() - ref).abs().max()), float((want.double() - ref).abs().max())
        ok = err_k <= 2 * err_p + 1e-4
        print(f"  {name}: kernel-plain {err:.3e}; against fp64: kernel {err_k:.3e}, plain fp32 {err_p:.3e} "
              f"(limit 2 x plain + 1e-4) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: kernel further from fp64 than fp32 allows")
    else:
        err = check_close(name, got, want, atol=1e-4)
    bf16 = dots_dtype == "bfloat16"
    flops, nbytes = langevin_cost(b, nz, ebm_w[0].shape[1], steps, weight_bytes=2 if bf16 else 4)
    r = dict(b=b, max_abs_err=err, flops=flops, bytes=nbytes, peak=peak_rate(dots_dtype),
             ms=time_ms(lambda: fused_prior_langevin(z, *ebm_w, **noise, **kw), 20),
             plain_ms=time_ms(lambda: prior_langevin_plain(z, *ebm_w, **noise, **kw), PLAIN_REPS, warmup=0))
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
                 plain_ms=time_ms(lambda: reverse_sweep_plain(*a, steps=n, residual=d.residual, **kw), PLAIN_REPS,
                                  warmup=0))
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
        rows_check(name, run, b, ROW_BATCHES)


def rows_check(name, run, b, batches):
    """Rows ROW_PICKS of run(all b rows) must equal, bit for bit, the same
    rows of run(idx) for idx the row alone and for batches of each size of
    `batches`, row i at slot i % n among other rows."""
    import torch

    dev = torch.device("cuda")
    full = run(torch.arange(b, device=dev))
    for i in ROW_PICKS:
        same = {"alone": torch.equal(full[i], run(torch.tensor([i], device=dev))[0])}
        for n in batches:
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


# K1 bf16 against its plain version. The product of two bf16 operands is
# exact in float32, so the kernel and its plain version differ in summation
# order; a one-ulp float32 difference between two sums can flip the bf16
# rounding of an operand. 6 noiseless steps are held at 2e-5 (the largest
# reading, 2.6e-6 at nz=8, times 8), and the float32 variant's output must
# lie at least K1_BF16_APART times the kernel's error from the bf16
# kernel's: a kernel that rounds no operand, or only some, or rounds by
# truncation, is caught there (the float32 variant lies 4.9e-4 to 1.7e-3
# away). The noisy chain is held in moments, as sweep_check holds K2's.
K1_BF16_ATOL = 2e-5
K1_BF16_APART = 20
K1_BF16_MOMENTS = 0.1  # share of the plain version's mean per-dimension std
K1_BF16_SHAPES = (  # (label, preset, its widths changed, B, steps, step size)
    ("train", "cifar10", {}, 256, 60, 0.4),  # the 2B prior chains of cifar10 training (tensor cores, 1 block)
    ("eval", "cifar10", {}, 500, 60, 0.4),  # the training loop's EBM-prior FID batch
    ("anomaly", "mnist_anomaly", {}, 128, 60, 0.4),  # the single chains at nz=8 (padded to 16)
    ("svhn", "svhn", {}, 256, 60, 0.4),  # nz=100 (padded to 112)
    ("train_ndf512", "cifar10", {"ndf": 512}, 256, 60, 0.4),  # tensor cores over a cluster of 4
    ("train_ndf1024", "cifar10", {"ndf": 1024}, 256, 60, 0.4),  # the variant that reads L2
)
# The tensor-core variant over a cluster of 8 (ndf 513 to 640 at nz=128),
# held against its float64 plain version as the other width checks are
# (`chain_check`'s `against_fp64`): at ndf=640 the float32 plain version's
# own rounding flips an operand where the kernel's does not.
K1_TC_C8_NDF = 640
K1_ROW_BATCHES = (16, 128)  # the serving and training shapes
K1_ROW_RANKS = 2  # K4a's split of the B=500 stream launch in the rows check


def k1_bf16_phase():
    """K1's bf16-dot variants against their plain bf16 version on the card
    at the shapes of K1_BF16_SHAPES, on each preset's random EBM from the
    seed (the tensor-core variant, K1_tc, in one block at the presets'
    widths and over a cluster of 4 at ndf=512; at ndf=1024 the variant
    that reads the weights from L2), each shape launching the variant
    `launch_widths` names:
    6 noiseless steps pointwise (K1_BF16_ATOL), the full stream-noise chain
    in per-dimension mean and std over the batch (K1_BF16_MOMENTS) and
    equal, bit for bit, to counter mode on stream_row_seeds; the float32
    variant's output on the same 6 steps must lie at least K1_BF16_APART
    times the kernel's error from it (the variant rounds as its plain
    version does). Then the bf16 kernel, its plain
    version and the float32 kernel are timed on the full chain. Then
    K1_tc over a cluster of 8 (ndf=K1_TC_C8_NDF) against float64 in stream
    mode at B=256 and counter mode at B=16, and `k1_rows_check` on the
    cifar10 EBM. Returns ({label: check}, {hold label: check})."""
    import torch

    from damc_tpu_torch.config import preset
    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.ops.cuda.fused_langevin import (
        ebm_params_to_dense_weights, fused_prior_langevin, launch_count, launch_widths, prior_langevin_plain,
    )

    gen = torch.Generator(device="cpu").manual_seed(SEED + 5)
    seed = 987654321
    res = {}
    weights = {}
    for label, name, widths, b, steps, step_size in K1_BF16_SHAPES:
        if (name, str(widths)) not in weights:
            cfg = preset(name)
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **widths))
            weights[name, str(widths)] = ebm_params_to_dense_weights(build_models(cfg, seed=SEED, device="cuda").ebm)
        w = weights[name, str(widths)]
        nz, ndf = w[0].shape
        z = torch.randn(b, nz, generator=gen).cuda()
        bf = dict(dots_dtype="bfloat16")
        short = dict(steps=6, step_size=step_size, with_noise=False)
        variant, count = k1_key(nz, ndf, "bfloat16"), launch_count(launch_widths(nz, ndf, "bfloat16"))
        before = count.launches
        got6 = fused_prior_langevin(z, *w, **short, **bf)
        print(f"  K1 bf16 {label}: nz={nz}, ndf={ndf} launch as {variant} at {launch_widths(nz, ndf, 'bfloat16')}")
        if count.launches != before + 1:
            raise AssertionError(f"K1 bf16 {label}: the launch did not count in {variant}")
        fp32_6 = fused_prior_langevin(z, *w, **short)
        err6 = check_close(f"K1 bf16 {label} B={b} nz={nz}, 6 noiseless steps", got6,
                           prior_langevin_plain(z, *w, **short, **bf), atol=K1_BF16_ATOL)
        apart = float((got6 - fp32_6).abs().max())
        print(f"  K1 bf16 against the float32 variant, same 6 steps: max_abs_diff={apart:.3e} "
              f"({apart / max(err6, 1e-30):.3g} times the error; at least {K1_BF16_APART})")
        if not (apart > 0 and apart >= K1_BF16_APART * err6):
            raise AssertionError(f"K1 bf16 {label}: the float32 variant is not {K1_BF16_APART} times farther "
                                 "from the kernel than the plain bf16 version is")
        kw = dict(steps=steps, step_size=step_size, seed=seed, **bf)
        got = fused_prior_langevin(z, *w, **kw)
        counter = _stream_as_counter(dict(seed=seed), b, z.device)
        if not torch.equal(got, fused_prior_langevin(z, *w, steps=steps, step_size=step_size, **counter, **bf)):
            raise AssertionError(f"K1 bf16 {label}: stream mode differs from counter mode on stream_row_seeds")
        want = prior_langevin_plain(z, *w, **kw)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K1 bf16 {label}: non-finite chain")
        err = float((got - want).abs().max())
        scale = float(want.std(dim=0).mean())
        mom = max(float((got.mean(0) - want.mean(0)).abs().max()), float((got.std(0) - want.std(0)).abs().max()))
        ok = mom <= K1_BF16_MOMENTS * scale
        print(f"  K1 bf16 {label} B={b}, {steps} steps at {step_size}, stream: pointwise max_abs_err={err:.3e} "
              f"(not held); moments max diff {mom:.3e} (limit {K1_BF16_MOMENTS * scale:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K1 bf16 {label}: moments of the chain differ from the plain version's")
        flops, nbytes = langevin_cost(b, nz, ndf, steps, weight_bytes=2)
        fp32_kw = dict(steps=steps, step_size=step_size, seed=seed)
        r = dict(b=b, nz=nz, ndf=ndf, variant=variant, steps=steps, max_abs_err=err, max_abs_err_6_noiseless=err6,
                 apart_from_fp32=apart, moment_err=mom, flops=flops, bytes=nbytes, peak=peak_rate("bfloat16"),
                 ms=time_ms(lambda: fused_prior_langevin(z, *w, **kw), 20),
                 plain_ms=time_ms(lambda: prior_langevin_plain(z, *w, **kw), PLAIN_REPS, warmup=0),
                 fp32_kernel_ms=time_ms(lambda: fused_prior_langevin(z, *w, **fp32_kw), 20))
        report(f"K1 bf16 {label} ({variant})", r)
        print(f"  K1 float32 variant, same shape: {r['fp32_kernel_ms']:.4f} ms")
        res[label] = r
    cfg = preset("cifar10")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, ndf=K1_TC_C8_NDF))
    w = ebm_params_to_dense_weights(build_models(cfg, seed=SEED, device="cuda").ebm)
    if k1_key(cfg.model.nz, K1_TC_C8_NDF, "bfloat16") != "K1_tc" or launch_widths(
            cfg.model.nz, K1_TC_C8_NDF, "bfloat16").cluster != 8:
        raise AssertionError(f"ndf={K1_TC_C8_NDF} does not take the tensor-core variant over a cluster of 8")
    holds = {}
    for label, b in (("stream", 256), ("counter", 16)):
        z = torch.randn(b, cfg.model.nz, generator=gen).cuda()
        noise = (dict(seed=-86420) if label == "stream" else
                 dict(row_seeds=torch.randint(0, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).cuda()))
        holds[f"{label} ndf{K1_TC_C8_NDF}"] = chain_check(
            w, z, noise, 60, 0.4, f"K1_tc (cluster of 8) {label} bf16 ndf{K1_TC_C8_NDF}", against_fp64=True,
            dots_dtype="bfloat16")
    k1_rows_check(weights["cifar10", "{}"], gen, "bfloat16", "K1_tc")
    return res, holds


def k1_rows_check(w, gen, dots_dtype, variant):
    """The rows of the K1 variant `variant` (the one `launch_widths` takes
    for w's widths and `dots_dtype`) are functions of their own inputs: in
    counter mode (60 steps at 0.4), rows ROW_PICKS of a B=500 launch equal,
    bit for bit, the same rows launched alone and in batches of
    K1_ROW_BATCHES; in stream mode, each of K1_ROW_RANKS ranks' rows of
    the B=500 launch launched on their own with `row_base` (what K4a
    launches) equal that launch's rows, and so does
    `fused_prior_langevin_sharded` on a mesh of one. (The streamed variant
    takes 48 chains a cluster at B=500 and 16 at the others: every chain
    count it runs.)"""
    import torch

    from damc_tpu_torch.ops.cuda.fused_langevin import fused_prior_langevin, fused_prior_langevin_sharded

    nz, ndf = w[0].shape
    if k1_key(nz, ndf, dots_dtype) != variant:
        raise AssertionError(f"the rows check at nz={nz}, ndf={ndf}, {dots_dtype} dots is not {variant}'s")
    b = 500
    z = torch.randn(b, nz, generator=gen).cuda()
    seeds = torch.randint(0, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).cuda()
    kw = dict(steps=60, step_size=0.4, dots_dtype=dots_dtype)
    name = f"{variant} {dots_dtype} ndf{ndf}"
    rows_check(name, lambda idx: fused_prior_langevin(z[idx], *w, row_seeds=seeds[idx], **kw), b, K1_ROW_BATCHES)
    full = fused_prior_langevin(z, *w, seed=-24680, **kw)
    local = -(-b // K1_ROW_RANKS)
    same = [torch.equal(full[r * local:(r + 1) * local], fused_prior_langevin(
        z[r * local:(r + 1) * local], *w, seed=-24680, row_base=r * local, **kw)) for r in range(K1_ROW_RANKS)]
    same.append(torch.equal(full, fused_prior_langevin_sharded(None, z, *w, seed=-24680, **kw)))
    print(f"[rows] {name} stream B={b}: each of {K1_ROW_RANKS} ranks' rows at their row_base equal the launch's: "
          f"{same[:-1]}; sharded on no mesh: {same[-1]}")
    if not all(same):
        raise AssertionError(f"{name}: a rank's stream rows differ from the one launch's")


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


def serving_phase(models, cfg, counters, cpu_atol=1e-3, tag="serve"):
    """Full-width cifar10 over HTTP; returns per-path kernel launches and stats.
    The EBM path is held to the CPU plain path at `cpu_atol`; K1's bf16
    variant, where `counters` has it, must not launch (serving keeps K1 in
    float32)."""
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
            print(f"[{tag}] {path}: alone == coalesced; kernel launches {launches[path]}")
        stats = json.loads(urllib.request.urlopen(base + "/stats", timeout=60).read())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
        service.close()
    total = {name: k.launches for name, k in counters.items()}
    if launches["damc"]["K2"] < 1 or launches["recon"]["K2"] < 1 or launches["ebm"]["K1"] < 1:
        raise AssertionError(f"a path did not launch its kernel: {launches}")
    if launches["damc"]["K1"] or launches["ebm"]["K2"] or any(
            l.get("K1_tc") or l.get("K1_l2_bf16") for l in launches.values()):
        raise AssertionError(f"a path launched a kernel it should not: {launches}")
    for path, s in stats.items():
        print(f"[{tag}] {path}: p50 {s['latency_p50_ms']:.3f} ms, p99 {s['latency_p99_ms']:.3f} ms, "
              f"{s['requests']} requests, {s['items']} items in {s['batches']} batches")
    print(f"[{tag}] /stats " + json.dumps(stats))

    # The EBM path against the plain versions on the CPU, same seed and items:
    # a 60-step contracting chain, then G; 1e-3 covers cuDNN against the CPU
    # in float32 (a bf16 G's caller passes its own limit).
    cpu = build_models(cfg, seed=SEED, device="cpu")
    want = build_serving_fns(cpu, cfg)["ebm"](stack_draws([item_draws(7, i, cfg.model.nz) for i in range(2)], "cpu"))
    err = float(np.abs(served["ebm"] - want.numpy()).max())
    print(f"[{tag}] ebm items (7, 0..1) against the CPU plain path: max_abs_err={err:.3e} (atol {cpu_atol:g})")
    if err > cpu_atol:
        raise AssertionError("ebm path disagrees with the CPU plain path")
    return total, stats


def bf16_fid_batch_phase(models, cfg, counters):
    """One EBM-prior FID batch (B=500, the loop eval's 60-step chain) and one
    DAMC-prior batch with compute_dtype and pallas_dots_dtype bf16, through
    `train.gen_recon.make_fid_batch_fn`, counts at 0 before each: the EBM
    batch launches K1's tensor-core variant (K1_tc) once and nothing else,
    the DAMC batch K2 once and nothing else; the images are bf16 in [0, 1].
    Returns the EBM batch's launches and both batches' ms (CUDA events,
    after one warm-up each)."""
    import torch

    from damc_tpu_torch.train.gen_recon import make_draws_fn, make_fid_batch_fn

    draws = make_draws_fn(SEED, "fid_ebm", 0, cfg.model.nz, "cuda")(0, 500)
    out = {}
    for prior, launched in (("ebm", "K1_tc"), ("damc", "K2")):
        want = {**{name: 0 for name in counters}, launched: 1}
        fn = make_fid_batch_fn(models, cfg, prior)
        for k in counters.values():
            k.launches = 0
        x = fn(draws)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        ok = x.dtype == torch.bfloat16 and x.shape == (500, 32, 32, 3) and bool(
            ((x >= 0) & (x <= 1)).all())
        print(f"[eval_bf16] {prior} FID batch B=500: launches {launches}, bf16 images in [0, 1]: {ok}")
        if launches != want or not ok:
            raise AssertionError(f"the bf16 {prior} FID batch launched {launches} (want {want}) or is malformed")
        out[prior] = {"launches": launches, "ms": time_ms(lambda: fn(draws), 5)}
    print("[eval_bf16] " + json.dumps(out))
    return out


def profile_phase(models, cfg, fused=True, tag="profile"):
    """One B=16 dispatch of each path's serving core (the `fused` route's)
    under torch.profiler: host wall time, device busy time (sum of kernel
    self times), the device's idle share and the kernels that take the most
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from damc_tpu_torch.serve import build_serving_fns, item_draws, stack_draws

    fns = build_serving_fns(models, cfg, fused=fused)
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
        print(f"[{tag}] " + json.dumps({
            "path": path, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None, "top": top,
        }))


ARTIFACT_B = 16  # the serving bucket
ARTIFACT_RECON_STEPS = 5  # the exports' trace time goes with it: cut for time
ARTIFACT_ATOL = 0.0  # the artifact's answers against the live service's: bit for bit
LATENCY_REQUESTS = 20
ARTIFACT_PATHS = ("damc", "ebm", "recon")


def serve_requests(base, x, path):
    """The artifact phase's requests of one path over HTTP at `base`: an
    item alone, then two requests at once (seeds 7 and 8 of /sample, n=8;
    /reconstruct of x[:4] and x[4:] with seeds 3 and 4). Item (seed, 0)
    alone must equal it coalesced. Returns the coalesced answers by name."""
    if path != "recon":
        sample = lambda n, seed: _array(
            _post(base + "/sample", {"n": n, "prior": path, "seed": seed, "encoding": "b64"})["images"])
        alone = sample(1, 7)
        a, b = _concurrent([lambda: sample(8, 7), lambda: sample(8, 8)])
        if not np.array_equal(a[0], alone[0]):
            raise AssertionError(f"{path}: item (7, 0) alone differs from it coalesced")
        return {f"{path}_7": a, f"{path}_8": b}

    def recon(imgs, seed):
        body = _post(base + "/reconstruct", {
            "image_b64": base64.b64encode(np.ascontiguousarray(imgs).tobytes()).decode(),
            "shape": list(imgs.shape), "seed": seed, "encoding": "b64",
        })
        return _array(body["x_hat"]), _array(body["z"])

    alone = recon(x[:1], 3)
    (x3, z3), (x4, z4) = _concurrent([lambda: recon(x[:4], 3), lambda: recon(x[4:], 4)])
    if not (np.array_equal(x3[0], alone[0][0]) and np.array_equal(z3[0], alone[1][0])):
        raise AssertionError("recon: item (3, 0) alone differs from it coalesced")
    return {"recon_3_x": x3, "recon_3_z": z3, "recon_4_x": x4, "recon_4_z": z4}


def request_latency(base, x, n=LATENCY_REQUESTS):
    """p50 and p99 (ms) of n sequential single-item requests of each path,
    on the host clock around each HTTP round trip."""
    one = lambda i: {"image_b64": base64.b64encode(np.ascontiguousarray(x[i % len(x)]).tobytes()).decode(),
                     "shape": list(x.shape[1:])}
    out = {}
    for path in ARTIFACT_PATHS:
        ms = []
        for i in range(n):
            t0 = time.perf_counter()
            if path == "recon":
                _post(base + "/reconstruct", {**one(i), "seed": 100 + i, "encoding": "b64"})
            else:
                _post(base + "/sample", {"n": 1, "prior": path, "seed": 100 + i, "encoding": "b64"})
            ms.append((time.perf_counter() - t0) * 1e3)
        out[path] = {"p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99))}
    return out


def _artifact_x():
    return np.random.default_rng(SEED + 1).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)


def _serve_all(service, counters, latency=True):
    """Serve `service` over HTTP and run every path's requests, the counts
    at 0 before each path, then (with `latency`) the latency requests.
    Returns (answers, {path: kernel launches}, {path: dispatches}, latency
    or None)."""
    from damc_tpu_torch.serve import make_http_server

    server = make_http_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    x = _artifact_x()
    answers, launches, batches = {}, {}, {}
    try:
        for path in ARTIFACT_PATHS:
            for k in counters.values():
                k.launches = 0
            before = service.stats[path].batches
            answers.update(serve_requests(base, x, path))
            launches[path] = {name: k.launches for name, k in counters.items()}
            batches[path] = service.stats[path].batches - before
        latency = request_latency(base, x) if latency else None
    finally:
        server.shutdown()
        server.server_close()
        thread.join(30)
    return answers, launches, batches, latency


def artifact_server() -> int:
    """The artifact phase's serving process: starts CUDA, then reads its
    spec (one JSON line) from standard input, loads each artifact of it on
    the card with `SamplerService.from_artifact`, serves it over HTTP
    (`_serve_all`), counts K2's weight packings, and writes the answers
    (npz) and the readings (json) where the spec says. It imports only the
    port's serving and artifact modules (and through them the ops)."""
    import torch
    import torch.export.passes  # noqa: F401  (the loader's machinery, imported ahead)

    from damc_tpu_torch.ops.cuda import fused_langevin, fused_qsweep
    from damc_tpu_torch.serve import SamplerService

    # CUDA, cuBLAS, cuDNN and the kernel libraries start while the exports run.
    x = torch.ones(1, 1, 4, 4, device="cuda")
    torch.nn.functional.conv2d(x, x[:, :, :3, :3]) @ x[0, 0, :2, :2]
    fused_langevin._library(), fused_qsweep._library()
    torch.cuda.synchronize()
    spec = json.loads(sys.stdin.readline())
    packs = [0]
    pack = fused_qsweep.pack_weights

    def counting_pack(layers):
        packs[0] += 1
        return pack(layers)

    fused_qsweep.pack_weights = counting_pack
    counters = {"K1": fused_langevin.fused_prior_langevin, "K2": fused_qsweep.fused_reverse_sweep}
    readings, answers = {}, {}
    for name, directory in spec["dirs"].items():
        packs[0] = 0
        t0 = time.perf_counter()
        service = SamplerService.from_artifact(directory, device="cuda")
        service.warmup()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        try:
            out, launches, batches, latency = _serve_all(service, counters)
        finally:
            service.close()
        answers.update({f"{name}/{k}": v for k, v in out.items()})
        readings[name] = {"load_and_warmup_s": load_s, "launches": launches, "batches": batches,
                          "packs": packs[0], "latency": latency}
    readings["modules"] = sorted(m for m in sys.modules if m.startswith("damc_tpu_torch"))
    np.savez(spec["out"] + ".npz", **answers)
    with open(spec["out"] + ".json", "w") as f:
        json.dump(readings, f)
    return 0


def artifact_phase(models, cfg, counters):
    """Serving artifacts of phase 4's full-width cifar10 weights: exported on
    the card and, from the same seeded weights, on the CPU, at B=16 with
    ARTIFACT_RECON_STEPS recon steps; both served on the card by a separate process
    (`artifact_server`) that must import no model or training module, over
    HTTP, and answer exactly as the live service does in this process;
    K2 must launch once per damc and recon dispatch, K1 once per ebm
    dispatch, and K2 pack its weights once per program. Prints each path's
    p50/p99 over 20 sequential single-item requests, artifact beside live.
    Returns the card artifact's launches over its requests and the live
    service's latency."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="damc_artifact_") as tmp:
        return _artifact_phase(models, cfg, counters, tmp)


def _artifact_phase(models, cfg, counters, tmp):
    import os

    import torch

    from damc_tpu_torch.artifact import export_serving_artifact
    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.serve import SamplerService

    dirs = {"card": os.path.join(tmp, "card"), "cpu": os.path.join(tmp, "cpu")}
    # The serving process starts now and reads its spec once both artifacts
    # are written.
    server = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.artifact_server())"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    walls = {}
    try:
        for where, m in (("card", models), ("cpu", build_models(cfg, seed=SEED, device="cpu"))):
            t0 = time.perf_counter()
            export_serving_artifact(m, cfg, dirs[where], batch_size=ARTIFACT_B,
                                    recon_langevin_steps=ARTIFACT_RECON_STEPS)
            torch.cuda.synchronize()
            walls[f"export_{where}_s"] = time.perf_counter() - t0
            sizes = {f: os.path.getsize(os.path.join(dirs[where], f)) for f in sorted(os.listdir(dirs[where]))}
            print(f"[serve_artifact] exported on the {where} in {walls[f'export_{where}_s']:.1f} s: {sizes} (bytes)")
        spec = {"dirs": dirs, "out": os.path.join(tmp, "served")}
        t0 = time.perf_counter()
        _, err = server.communicate(json.dumps(spec) + "\n", timeout=600)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    walls["serving_after_exports_s"] = time.perf_counter() - t0
    if server.returncode != 0:
        raise AssertionError(f"the artifact serving process failed (rc {server.returncode}):\n{err[-6000:]}")
    with open(spec["out"] + ".json") as f:
        readings = json.load(f)
    served = dict(np.load(spec["out"] + ".npz"))
    bad = [m for m in readings["modules"] if m.startswith(("damc_tpu_torch.models", "damc_tpu_torch.train"))]
    print(f"[serve_artifact] serving process imported {readings['modules']}")
    if bad:
        raise AssertionError(f"the artifact serving process imported model or training code: {bad}")

    live = SamplerService(models, cfg, max_batch=ARTIFACT_B, recon_langevin_steps=ARTIFACT_RECON_STEPS,
                          device="cuda")
    live.warmup()
    try:
        want, live_launches, live_batches, live_latency = _serve_all(live, counters)
    finally:
        live.close()
    for where in dirs:
        r = readings[where]
        expect = {p: {"K1": r["batches"][p] if p == "ebm" else 0, "K2": 0 if p == "ebm" else r["batches"][p]}
                  for p in ARTIFACT_PATHS}
        print(f"[serve_artifact] {where}-exported: dispatches {r['batches']}, launches {r['launches']}, "
              f"K2 weight packings {r['packs']}, load and warm-up {r['load_and_warmup_s']:.2f} s")
        if r["launches"] != expect or min(r["batches"].values()) < 1:
            raise AssertionError(f"{where}-exported artifact: launches {r['launches']}, want {expect}")
        if r["packs"] != 2:
            raise AssertionError(f"{where}-exported artifact packed K2's weights {r['packs']} times, want 2")
        errs = {k: float(np.abs(served[f"{where}/{k}"] - v).max()) for k, v in want.items()}
        equal = all(np.array_equal(served[f"{where}/{k}"], v) for k, v in want.items())
        print(f"[serve_artifact] {where}-exported artifact against the live service: bit for bit {equal}, "
              f"max_abs_err {errs} (atol {ARTIFACT_ATOL:g})")
        if max(errs.values()) > ARTIFACT_ATOL:
            raise AssertionError(f"the {where}-exported artifact's answers differ from the live service's")
    lat = {"live": live_latency, "artifact_card": readings["card"]["latency"],
           "artifact_cpu_exported": readings["cpu"]["latency"]}
    print(f"[serve_artifact] {card_line()}: {LATENCY_REQUESTS} sequential single-item requests a path, "
          "HTTP round trip ms " + json.dumps(lat))
    print(f"[serve_artifact] live dispatches {live_batches}, launches {live_launches}")
    print("[serve_artifact] walls " + json.dumps(walls))
    return {k: sum(r[k] for r in readings["card"]["launches"].values()) for k in ("K1", "K2")}, live_latency


# The unfused serving route (`serve_unfused_phase`). The EBM chain by
# autograd against K1 on the same draws: K1 is held to its plain version at
# 1e-4 over the same 60 contracting steps (`chain_check`), and so is z here;
# the images through G at 1e-3, `serving_phase`'s limit for the EBM path.
UNFUSED_Z_ATOL, UNFUSED_IMAGE_ATOL = 1e-4, 1e-3
UNFUSED_HOLD_STEPS = 6  # sweep_check's: the 100-step sweeps are chaotic pointwise at random full-width weights
UNFUSED_MOMENT_B = 128
# The unfused artifact's check runs 4 sweep steps and 4 EBM steps: its
# trace and export take time in proportion to the loops' steps (43.7 s at
# 10 and 10 on the H100's host).
UNFUSED_ARTIFACT_DEPTH = ("--n_interval", "2", "--e_l_steps", "2")  # cut for time


def _unfused_sweep_hold(models, cfg, draws, x, label):
    """The serving sweep of `sample_q_per_item` over UNFUSED_HOLD_STEPS
    steps on one set of draws, unfused, on K2 and through K2's plain
    version (fp32, cuBLAS products), each against the fp64 unfused route
    on the same embedding and counter normals. As `sweep_check` holds K2,
    the unfused route may be at most twice as far from fp64 as the fp32
    plain version is, plus 2e-4: K2's own summation order lands nearer
    fp64 than cuBLAS's does (PERF.md, PR 14), so K2 is printed beside it."""
    import copy

    import torch

    from damc_tpu_torch.models.amortizer import sample_q_per_item
    from damc_tpu_torch.ops.cuda.fused_qsweep import denoiser_layer_params, reverse_sweep_plain
    from damc_tpu_torch.ops.noise import counter_normals
    from damc_tpu_torch.ops.reverse_diffusion import reverse_diffusion_sample

    amort = copy.copy(models.amortizer)
    amort.n_interval = UNFUSED_HOLD_STEPS
    tables = amort.step_tables("cuda")
    cond = dict(x=x) if x is not None else dict(emb_noise=draws.emb_noise)
    kw = dict(step_tables=tables, **cond)
    got = sample_q_per_item(amort, draws.z_init, draws.sweep_seed, fused=False, **kw)
    k2 = sample_q_per_item(amort, draws.z_init, draws.sweep_seed, fused=True, **kw)
    # The fp64 route takes the fp32 tables cast up, as sweep_check's fp64
    # plain version does (the time embedding computes in float32).
    with torch.no_grad():
        xemb = amort.encode(x) if x is not None else amort.prior_embed(draws.emb_noise)
        t32 = amort.p.sample_tables(tables[0], xemb)
    p64 = copy.deepcopy(amort.p).double()
    pre_x = [t.double() for t in t32["pre_x"]]
    ref = reverse_diffusion_sample(
        lambda z, logsnr, pre_t_step: p64.denoise_from_tables(z, pre_t_step, pre_x), draws.z_init.double(),
        UNFUSED_HOLD_STEPS, amort.logsnr_min, amort.logsnr_max, amort.var_type, amort.with_noise,
        noise=counter_normals(draws.sweep_seed, UNFUSED_HOLD_STEPS - 1, cfg.model.nz).double(),
        step_xs=[t.double() for t in t32["pre_t"]],
    )
    plain = reverse_sweep_plain(draws.z_init, *denoiser_layer_params(amort.p), t32["pre_x"], t32["pre_t"], tables[1],
                                steps=UNFUSED_HOLD_STEPS, with_noise=amort.with_noise, residual=amort.p.residual,
                                row_seeds=draws.sweep_seed)
    err, err_k2, err_plain = (float((t.double() - ref).abs().max()) for t in (got, k2, plain))
    print(f"[serve_unfused] {label} B={got.shape[0]} {UNFUSED_HOLD_STEPS} steps: unfused-K2 "
          f"{float((got - k2).abs().max()):.3e}; against the fp64 unfused route: unfused {err:.3e}, plain fp32 "
          f"{err_plain:.3e}, K2 {err_k2:.3e} (limit 2 x plain + 2e-4)")
    if err > 2 * err_plain + 2e-4:
        raise AssertionError(f"{label}: the unfused sweep is further from fp64 than fp32 allows")
    return {"unfused_vs_fp64": err, "plain_fp32_vs_fp64": err_plain, "k2_vs_fp64": err_k2}


def serve_unfused_phase(models, cfg, counters, fused_latency):
    """The unfused serving route on the card, at full cifar10 width and
    max_batch 16 (`SamplerService(fused=False)`): over HTTP every path's
    requests (`_serve_all`: an item alone == coalesced) with K1 and K2
    launched 0 times, and p50/p99 of 20 sequential single-item requests a
    path, printed beside `fused_latency`, the kernel route's on the same
    weights (the artifact phase's live service); one unfused B=16 dispatch
    of each path profiled (`profile_phase`). One 16-row dispatch of each
    route's core on the same draws: the EBM chain's z against K1's at
    UNFUSED_Z_ATOL and its images at UNFUSED_IMAGE_ATOL; the damc and
    recon sweeps over 6 steps against the fp64 unfused route
    (`_unfused_sweep_hold`), and the 100-step damc sweep at B=128 in its
    moments against K2's (within 0.1 x the mean std, as `sweep_check`).
    Then cifar10 with ndf=512 under `auto`: it must take the kernels (K1
    over a cluster of 8, K1_c8, once an ebm dispatch; K1_l2, which reads
    the weights from L2, never) and serve finite images, with its p50/p99,
    and K1_c8 is held against its float64 plain version on the 16 rows'
    draws in counter mode. Then
    `cli.serve --fused off --export_artifact` on the card, loaded, must
    answer bit for bit as the live unfused service; this check runs at
    UNFUSED_ARTIFACT_DEPTH (the trace and export take time in proportion
    to the loops' steps). Returns the readings."""
    import os
    import tempfile

    import torch

    from damc_tpu_torch.cli import serve as serve_cli
    from damc_tpu_torch.cli.common import config_from_args
    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.models.amortizer import sample_q_per_item
    from damc_tpu_torch.ops.langevin import prior_langevin_auto
    from damc_tpu_torch.serve import SamplerService, build_serving_fns, item_draws, stack_draws

    out = {"card": card_line()}
    kw = dict(max_batch=ARTIFACT_B, recon_langevin_steps=ARTIFACT_RECON_STEPS, device="cuda")
    no_kernel = lambda launches: not any(n for l in launches.values() for n in l.values())
    service = SamplerService(models, cfg, fused=False, **kw)
    try:
        if service.fused:
            raise AssertionError("fused=False must serve the unfused route")
        service.warmup()
        _, launches, batches, latency = _serve_all(service, counters)
    finally:
        service.close()
    print(f"[serve_unfused] over HTTP: dispatches {batches}, launches {launches}")
    if not no_kernel(launches):
        raise AssertionError(f"the unfused route launched a kernel: {launches}")
    out["latency"] = {"unfused": latency, "fused": fused_latency}
    print(f"[serve_unfused] {card_line()}: {LATENCY_REQUESTS} sequential single-item requests a path, HTTP "
          "round trip ms " + json.dumps(out["latency"]))
    profile_phase(models, cfg, fused=False, tag="serve_unfused profile")

    # One dispatch of each route's core on the same draws.
    draws = stack_draws([item_draws(21, i, cfg.model.nz) for i in range(ARTIFACT_B)], "cuda")
    x = torch.from_numpy(np.concatenate([_artifact_x(), _artifact_x()[::-1]])).cuda()
    mc = cfg.mcmc
    z, img = {}, {}
    for fused in (False, True):
        z[fused], _ = prior_langevin_auto(draws.z_init, models.ebm, mc.e_l_steps, mc.e_l_step_size,
                                          mc.e_l_with_noise, row_seeds=draws.chain_seed, use_pallas=fused)
        img[fused] = build_serving_fns(models, cfg, fused=fused)["ebm"](draws)
    errs = {"ebm_z": float((z[False] - z[True]).abs().max()), "ebm_images": float((img[False] - img[True]).abs().max())}
    print(f"[serve_unfused] ebm B={ARTIFACT_B}, {mc.e_l_steps} steps at {mc.e_l_step_size}, same draws: autograd "
          f"chain against K1 max_abs_err z {errs['ebm_z']:.3e} (atol {UNFUSED_Z_ATOL:g}), images "
          f"{errs['ebm_images']:.3e} (atol {UNFUSED_IMAGE_ATOL:g})")
    if errs["ebm_z"] > UNFUSED_Z_ATOL or errs["ebm_images"] > UNFUSED_IMAGE_ATOL:
        raise AssertionError("the unfused EBM chain disagrees with K1")
    out["ebm"] = errs
    out["damc_hold"] = _unfused_sweep_hold(models, cfg, draws, None, "damc")
    out["recon_hold"] = _unfused_sweep_hold(models, cfg, draws, x, "recon")
    wide = stack_draws([item_draws(22, i, cfg.model.nz) for i in range(UNFUSED_MOMENT_B)], "cuda")
    amort = models.amortizer
    sweeps = {fused: sample_q_per_item(amort, wide.z_init, wide.sweep_seed, emb_noise=wide.emb_noise,
                                       fused=fused) for fused in (False, True)}
    if not bool(torch.isfinite(sweeps[False]).all()):
        raise AssertionError("the 100-step unfused sweep is not finite")
    scale = float(sweeps[True].std(0).mean())
    d_mean = float((sweeps[False].mean(0) - sweeps[True].mean(0)).abs().max())
    d_std = float((sweeps[False].std(0) - sweeps[True].std(0)).abs().max())
    print(f"[serve_unfused] damc sweep B={UNFUSED_MOMENT_B} {amort.n_interval} steps, unfused against K2: max "
          f"|d mean|={d_mean:.3e}, max |d std|={d_std:.3e}, mean std={scale:.3e} (limit 0.1 x mean std each)")
    if d_mean > 0.1 * scale or d_std > 0.1 * scale:
        raise AssertionError("the unfused sweep's moments disagree with K2's")
    out["damc_moments"] = {"d_mean": d_mean, "d_std": d_std, "mean_std": scale}

    # ndf=512 under auto: K1 takes it over a cluster of 8 (K1_c8).
    from damc_tpu_torch.ops.cuda.fused_langevin import ebm_params_to_dense_weights

    cfg512 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, ndf=512))
    models512 = build_models(cfg512, seed=SEED, device="cuda")
    counters512 = {**counters, **k1_variant_counters()}
    wide_svc = SamplerService(models512, cfg512, **kw)
    try:
        if not wide_svc.fused:
            raise AssertionError("cifar10 with ndf=512 must take the kernels under auto")
        wide_svc.warmup()
        ans512, launches, batches, lat512 = _serve_all(wide_svc, counters512)
    finally:
        wide_svc.close()
    finite = all(np.isfinite(v).all() for v in ans512.values())
    print(f"[serve_unfused] cifar10 ndf=512 under auto: the kernels, dispatches {batches}, launches {launches}, "
          f"finite {finite}; {card_line()}: HTTP round trip ms " + json.dumps(lat512))
    want = {p: {**{name: 0 for name in counters512}, "K2": 0 if p == "ebm" else batches[p],
                "K1_c8": batches[p] if p == "ebm" else 0} for p in batches}
    if not finite or launches != want:
        raise AssertionError(f"the ndf=512 model must serve finite images with launches {want}")
    r = chain_check(ebm_params_to_dense_weights(models512.ebm), draws.z_init, dict(row_seeds=draws.chain_seed),
                    mc.e_l_steps, mc.e_l_step_size, "K1_c8 counter ndf512 serve", against_fp64=True)
    del models512
    out["ndf512"] = {"latency": lat512, "K1_c8": (r, launches["ebm"]["K1_c8"])}

    # --fused off --export_artifact, loaded on the card, against the live
    # unfused service of the same command line.
    argv = ["--dataset", "cifar10", "--max_batch", str(ARTIFACT_B), "--fused", "off", *UNFUSED_ARTIFACT_DEPTH,
            "--recon_langevin_steps", str(ARTIFACT_RECON_STEPS)]
    cfg_art = config_from_args(serve_cli.parse_args(argv))
    with tempfile.TemporaryDirectory(prefix="damc_unfused_artifact_") as tmp:
        art = os.path.join(tmp, "art")
        t0 = time.perf_counter()
        serve_cli.main(argv + ["--export_artifact", art])
        out["artifact_export_s"] = time.perf_counter() - t0
        services = {"artifact": SamplerService.from_artifact(art, device="cuda"),
                    "live": SamplerService(build_models(cfg_art, seed=SEED, device="cuda"), cfg_art, fused=False, **kw)}
        got = {}
        try:
            for name, svc in services.items():
                svc.warmup()
                got[name], launches, _, _ = _serve_all(svc, counters, latency=False)
                if svc.fused or not no_kernel(launches):
                    raise AssertionError(f"the unfused {name} service launched {launches}")
        finally:
            for svc in services.values():
                svc.close()
    equal = all(np.array_equal(got["artifact"][k], v) for k, v in got["live"].items())
    print(f"[serve_unfused] --fused off artifact at {' '.join(UNFUSED_ARTIFACT_DEPTH)} (export "
          f"{out['artifact_export_s']:.1f} s) against the live unfused service: bit for bit {equal}")
    if not equal:
        raise AssertionError("the unfused artifact differs from the live unfused service")
    print("[serve_unfused] " + json.dumps(out))
    return out


# The two-replica service's answers against one device's. K1 and K2 are
# row-independent bit for bit, but their inputs are not: the sweep's tables
# come from the prior embedding's and the conv encoder's cuBLAS and cuDNN
# products, which round otherwise at 8 rows than at 16, and the 100-step
# noisy sweep at full width with random weights carries last-bit input
# differences to about 1e-2 pointwise (`sweep_check`'s note). Measured on
# the H100: 4.4e-5 on images, 3.8e-3 on recon z.
SERVE_MESH_IMAGE_ATOL, SERVE_MESH_Z_ATOL = 1e-3, 5e-2


def _serve_mesh_limit(key: str) -> float:
    return SERVE_MESH_Z_ATOL if key.endswith("_z") else SERVE_MESH_IMAGE_ATOL


def serve_mesh_phase(models, cfg, counters):
    """Serving over `LocalMesh(["cuda:0", "cuda:0"])` (two replicas sharing
    the card) at max_batch=16, against the one-device service on the same
    weights. One dispatch of 16 rows of each path's core on both: K1's
    outputs (8 rows on each replica, from the same inputs) must equal the
    one launch's bit for bit, and so must K2 relaunched on each half of the
    one-device launch's own inputs; a rerun of the two-replica dispatch
    must be bit-identical; the images and recon z agree within
    SERVE_MESH_IMAGE_ATOL and SERVE_MESH_Z_ATOL (their text says why).
    Then both over HTTP (`_serve_all`: an item alone == coalesced), where
    the two-replica service must launch K1 or K2 once per replica per
    dispatch, on 8 rows, and p50/p99 of 20 sequential single-item requests
    a path, two replicas beside one device. Then K1 and K2 at B=8 in
    counter mode against their plain versions, timed. Returns the launches
    and those results."""
    import torch

    from damc_tpu_torch import serve
    from damc_tpu_torch.models import amortizer
    from damc_tpu_torch.ops.cuda.fused_langevin import ebm_params_to_dense_weights
    from damc_tpu_torch.ops.cuda.fused_qsweep import fused_reverse_sweep
    from damc_tpu_torch.parallel import LocalMesh
    from damc_tpu_torch.serve import SamplerService, item_draws, stack_draws

    log, sweeps = [], []
    q, chain, sweep = amortizer.sample_q_per_item, serve.prior_langevin_auto, amortizer.fused_reverse_sweep
    amortizer.sample_q_per_item = lambda *a, **kw: (lambda z: (log.append(("K2", z)), z)[1])(q(*a, **kw))
    serve.prior_langevin_auto = lambda *a, **kw: (lambda o: (log.append(("K1", o[0])), o)[1])(chain(*a, **kw))
    amortizer.fused_reverse_sweep = lambda *a, **kw: (lambda o: (sweeps.append((a, kw, o)), o)[1])(sweep(*a, **kw))
    kw = dict(max_batch=ARTIFACT_B, recon_langevin_steps=ARTIFACT_RECON_STEPS)
    half = ARTIFACT_B // 2
    services = {}
    try:
        services["one"] = SamplerService(models, cfg, device="cuda", **kw)
        services["two"] = SamplerService(models, cfg, mesh=LocalMesh(["cuda:0", "cuda:0"]), **kw)
        x = _artifact_x()
        draws = stack_draws([item_draws(7, i, cfg.model.nz) for i in range(ARTIFACT_B)], "cuda")
        xs = torch.from_numpy(np.concatenate([x, x])).cuda()
        core, logs, k2_inputs = {}, {}, {}
        for name in ("one", "two", "two_again"):
            svc = services[name[:3]]
            if name != "two_again":
                svc.warmup()
            log.clear()
            sweeps.clear()
            fns = svc._fns
            core[name] = {"damc": fns["damc"](draws), "ebm": fns["ebm"](draws), **dict(zip(
                ("recon_z", "recon_x"), fns["recon"](draws, xs)[::-1]))}
            logs[name], k2_inputs[name] = list(log), list(sweeps)
        shapes = {name: [(k, int(z.shape[0])) for k, z in l] for name, l in logs.items()}
        if shapes["one"] != [("K2", ARTIFACT_B), ("K1", ARTIFACT_B), ("K2", ARTIFACT_B)] or shapes["two"] != [
                ("K2", half), ("K2", half), ("K1", half), ("K1", half), ("K2", half), ("K2", half)]:
            raise AssertionError(f"the kernels ran at {shapes}")
        k1_equal = bool(torch.equal(torch.cat([logs["two"][2][1], logs["two"][3][1]]), logs["one"][1][1]))
        k2_equal = []
        for (z, four, layers, pre_x, pre_t, coeffs), skw, out in k2_inputs["one"]:  # damc, then recon
            parts = [fused_reverse_sweep(z[r], four, layers, [p[r] for p in pre_x], pre_t, coeffs,
                                         **{**skw, "row_seeds": skw["row_seeds"][r]})
                     for r in (slice(0, half), slice(half, None))]
            k2_equal.append(bool(torch.equal(torch.cat(parts), out)))
        rerun = all(torch.equal(core["two"][k], v) for k, v in core["two_again"].items())
        errs = {k: float((core["two"][k] - v).abs().max()) for k, v in core["one"].items()}
        print(f"[serve_mesh] one dispatch of {ARTIFACT_B} rows a path on two replicas of cuda:0, {half} rows each: "
              f"K1 (ebm) outputs equal to the one-device launch's bit for bit {k1_equal}; K2 on each half of the "
              f"one-device launch's inputs (damc, recon) equal to it bit for bit {k2_equal}; a rerun of the "
              f"two-replica dispatch bit for bit {rerun}; max_abs_err against the one-device service {errs} "
              f"(atol images {SERVE_MESH_IMAGE_ATOL:g}, recon z {SERVE_MESH_Z_ATOL:g})")
        if not (k1_equal and all(k2_equal) and len(k2_equal) == 2 and rerun) or any(
                e > _serve_mesh_limit(k) for k, e in errs.items()):
            raise AssertionError("the two-replica service differs from the one-device service")
        answers, launches, batches, latency, rows = {}, {}, {}, {}, {}
        for name in ("two", "one"):
            log.clear()
            answers[name], launches[name], batches[name], latency[name] = _serve_all(services[name], counters)
            rows[name] = sorted({int(z.shape[0]) for _, z in log})
            print(f"[serve_mesh] {name} over HTTP: dispatches {batches[name]}, launches {launches[name]}, kernel "
                  f"rows {rows[name]}")
        b2, l2 = batches["two"], launches["two"]
        if {p: l2[p] for p in b2} != {p: {"K1": 2 * b2[p] if p == "ebm" else 0, "K2": 0 if p == "ebm" else 2 * b2[p]}
                                       for p in b2} or rows["two"] != [half]:
            raise AssertionError("the two-replica service must launch K1 or K2 once a replica a dispatch, on 8 rows")
        errs = {k: float(np.abs(answers["two"][k] - v).max()) for k, v in answers["one"].items()}
        print(f"[serve_mesh] HTTP answers, two replicas against one device: max_abs_err {errs} (atol images "
              f"{SERVE_MESH_IMAGE_ATOL:g}, z {SERVE_MESH_Z_ATOL:g})")
        if any(e > _serve_mesh_limit(k) for k, e in errs.items()):
            raise AssertionError("the two-replica service's answers differ from the one-device service's")
        print(f"[serve_mesh] {card_line()}: {LATENCY_REQUESTS} sequential single-item requests a path, HTTP round "
              "trip ms " + json.dumps({"two_replicas": latency["two"], "one_device": latency["one"]})
              + " (phase 4's concurrent p50/p99 are in its [serve] lines)")
    finally:
        amortizer.sample_q_per_item, serve.prior_langevin_auto, amortizer.fused_reverse_sweep = q, chain, sweep
        for svc in services.values():
            svc.close()

    # The kernels at the rows each replica runs, in counter mode.
    gen = torch.Generator(device="cpu").manual_seed(SEED + 93)
    m, mc = cfg.model, cfg.mcmc
    z = torch.randn(half, m.nz, generator=gen).cuda()
    seeds = torch.randint(0, 2**31 - 1, (half,), generator=gen, dtype=torch.int32).cuda()
    res = {"K1": chain_check(ebm_params_to_dense_weights(models.ebm), z, dict(row_seeds=seeds), mc.e_l_steps,
                             mc.e_l_step_size, "K1 serve_mesh counter")}
    with torch.no_grad():
        xemb = models.amortizer.prior_embed(torch.randn(half, m.nz, generator=gen).cuda())
    res["K2"] = sweep_check(models, cfg, z, xemb, dict(row_seeds=seeds), "K2 serve_mesh counter")[half]
    total = {k: sum(l[k] for l in l2.values()) for k in ("K1", "K2")}
    return {"res": res, "launches": total, "latency": latency}


def checkpoint_cli_phase(models, cfg, counters):
    """The two checkpoint CLIs on the card: a reference `.pth.tar` written
    from phase 4's seeded weights (Q_dummy a scaled Q, iter 5) through
    `cli.convert_checkpoint`; one training iteration resumed from the
    result (K1 and K2 once); the converted checkpoint back through
    `cli.export_checkpoint`, whose state dicts `load_state_dict(strict=True)`
    takes, equal to the file's; the trained state exported the same way."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="damc_ckpt_cli_") as tmp:
        _checkpoint_cli_phase(models, cfg, counters, tmp)


def _checkpoint_cli_phase(models, cfg, counters, tmp):
    import os

    import torch

    from damc_tpu_torch.cli import convert_checkpoint, export_checkpoint
    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.train.gen_recon import train_gen_recon
    from damc_tpu_torch.utils.checkpoint import save_checkpoint

    cpu = lambda m: {k: v.detach().float().cpu().clone() for k, v in m.state_dict().items()}
    ref = {"iter": 5, "G_state_dict": cpu(models.generator), "E_state_dict": cpu(models.ebm),
           "Q_state_dict": cpu(models.amortizer),
           "Q_dummy_state_dict": {k: v * 0.5 for k, v in cpu(models.amortizer).items()}}
    pth = os.path.join(tmp, "ref.pth.tar")
    torch.save(ref, pth)
    t0 = time.perf_counter()
    path = convert_checkpoint.main(["--dataset", "cifar10", "--torch_ckpt", pth, "--out_dir", tmp])
    for k in counters.values():
        k.launches = 0
    state = train_gen_recon(cfg, train_images(cfg.train.batch_size), iterations=6, seed=SEED,
                            resume_path=path, device="cuda")
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in counters.items()}
    print(f"[ckpt_cli] resumed {path} for one iteration: step {state.step}, launches {launches}")
    if state.step != 6 or launches != {"K1": 1, "K2": 1}:
        raise AssertionError("the converted checkpoint did not resume for exactly one iteration")

    def check(pth_out, want, what):
        got = torch.load(pth_out, map_location="cpu", weights_only=True)
        fresh = build_models(cfg, seed=SEED + 1, device="cuda")
        nets = {"G_state_dict": fresh.generator, "E_state_dict": fresh.ebm, "Q_state_dict": fresh.amortizer,
                "Q_dummy_state_dict": fresh.amortizer}
        for key, net in nets.items():
            net.load_state_dict(got[key], strict=True)
            if not all(torch.equal(v.cpu(), want[key][k].cpu()) for k, v in net.state_dict().items()):
                raise AssertionError(f"{what}: {key} does not give back the tensors")
        if got["iter"] != want["iter"]:
            raise AssertionError(f"{what}: iter {got['iter']}, want {want['iter']}")

    export_checkpoint.main(["--ckpt", path, "--out", os.path.join(tmp, "back.pth.tar")])
    check(os.path.join(tmp, "back.pth.tar"), ref, "convert then export")
    trained = save_checkpoint(tmp, "trained", state)
    export_checkpoint.main(["--ckpt", trained, "--out", os.path.join(tmp, "trained.pth.tar")])
    m = state.models
    check(os.path.join(tmp, "trained.pth.tar"),
          {"iter": 6, "G_state_dict": cpu(m.generator), "E_state_dict": cpu(m.ebm),
           "Q_state_dict": cpu(m.amortizer), "Q_dummy_state_dict": cpu(state.amortizer_ema)}, "the trained state")
    print(f"[ckpt_cli] convert, resume, export and strict loads in {time.perf_counter() - t0:.1f} s")


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


def training_phase(cfg, counters, iterations: int = 10, expect=None, tag="train"):
    """`iterations` full-width iterations through `train_gen_recon` at the
    preset's `print_every`; returns (final state, launches over the run).
    Each iteration must launch each kernel of `counters` as `expect` says
    (default K1 and K2 once).

    Nothing in the run waits for the device but the loop's own metric read
    at `print_every` (iteration 1 here): after each iteration the callback
    records a CUDA event, the launch counts (host integers) and device
    copies of the metrics and of Q_ema's parameters, and the checks read
    them after the run. An iteration's time is the device time between the
    events of two iterations, so it counts any wait on the host; `step_ms`
    is each step's own, from an event recorded as it starts. Q_ema must
    change only at iteration `ema_every`; G, E and Q every run. Returns
    the median of iterations 3 on, or of `step_ms` in a shorter run."""
    import torch

    from damc_tpu_torch.train import gen_recon
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

    starts = []
    undo = _timed_steps(gen_recon, starts, before=True)
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    try:
        state = train_gen_recon(cfg, images, iterations=iterations, seed=SEED, on_step=on_step)
    finally:
        undo()
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
    print(f"[{tag}] launches per iteration {per_iter}")
    expect = expect or {"K1": 1, "K2": 1}
    if any(l != expect for l in per_iter):
        raise AssertionError(f"each iteration must launch {expect}")
    for name, module in _state_modules(state).items():
        if name != "Q_ema" and not _changed(module, start[name]):
            raise AssertionError(f"{name} did not change in {iterations} iterations")
    ema = [start["Q_ema"]] + log["ema"]
    changed = [any(not bool((p == q).all()) for p, q in zip(a, b_)) for a, b_ in zip(ema, ema[1:])]
    print(f"[{tag}] Q_ema changed at iterations {[i + 1 for i, c in enumerate(changed) if c]}")
    if changed != [i == cfg.train.ema_every - 1 for i in range(iterations)]:
        raise AssertionError(f"Q_ema must change only at iteration {cfg.train.ema_every}")
    ev = log["events"]
    ms = [a.elapsed_time(b_) for a, b_ in zip(ev, ev[1:])]  # iterations 2 .. iterations
    step_ms = [a.elapsed_time(b_) for a, b_ in zip(starts, ev)]
    out = {"print_every": cfg.train.print_every, "step_ms": step_ms, "wall_s_with_set_up": wall_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30}
    if iterations >= 3:
        out.update({f"ms_per_iteration_2_to_{iterations}": ms,
                    f"median_ms_iterations_3_to_{iterations}": statistics.median(ms[1:]),
                    f"mean_ms_iterations_3_to_{iterations}": ev[1].elapsed_time(ev[-1]) / (iterations - 2)})
    print(f"[{tag}] " + json.dumps(out))
    return state, total, statistics.median(ms[1:] if iterations >= 3 else step_ms)


def flops_line(cfg, train_ms, train16_ms):
    """The analytic FLOPs of one iteration at the preset's batch
    (`utils/flops.py::train_step_flops`) over the measured medians: the
    rate achieved and its share of the card's fp32 and bf16 peaks."""
    from damc_tpu_torch.utils.flops import train_step_flops

    f = train_step_flops(cfg, cfg.train.batch_size)
    rates = {"float32": f["total"] / (train_ms / 1e3), "bfloat16": f["total"] / (train16_ms / 1e3)}
    print(f"[train_flops] {card_line()}: " + json.dumps({
        "batch": cfg.train.batch_size, "flops": f, "median_ms": {"float32": train_ms, "bfloat16": train16_ms},
        "achieved_flops_per_s": rates,
        "share_of_peak": {dtype: rate / peak_rate(dtype) for dtype, rate in rates.items()},
        "peak_flops_per_s": {dtype: peak_rate(dtype) for dtype in rates},
    }))


def rerun_phase(cfg, tag="train"):
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
    print(f"[{tag}] two fresh 2-iteration runs bit-identical: {same}")
    if not same:
        raise AssertionError("two runs from one seed differ")


# (label, widths, training iterations: 0 for none, K2's check and the
# training run left out)
K1_WIDTH_RUNS = (("nz10", {"nz": 10}, 3), ("ndf512", {"ndf": 512}, 1), ("ndf1024", {"ndf": 1024}, 0))
K1_WIDTH_FID_B = 500  # the EBM-prior FID batch


def k1_variant_counters():
    """The count objects of K1's variants beside the presets' fp32 one
    (`K1`): fp32 over a cluster of 8, bf16 dots on the tensor cores, and
    reading the weights from L2 with fp32 and with bf16 dots."""
    from damc_tpu_torch.ops.cuda.fused_langevin import fused_prior_langevin

    return {"K1_c8": fused_prior_langevin.c8, "K1_tc": fused_prior_langevin.tc, "K1_l2": fused_prior_langevin.l2,
            "K1_l2_bf16": fused_prior_langevin.l2.bf16}


def k1_key(nz, ndf, dots_dtype="float32"):
    """The counter key of the K1 variant `launch_widths` takes for (nz, ndf)
    and `dots_dtype`, by the wrapper's own count object for it
    (`launch_count`)."""
    from damc_tpu_torch.ops.cuda.fused_langevin import fused_prior_langevin, launch_count, launch_widths

    count = launch_count(launch_widths(nz, ndf, dots_dtype))
    return next(k for k, c in {"K1": fused_prior_langevin, **k1_variant_counters()}.items() if c is count)


def k1_c8_holds(ebm_w, mc, gen):
    """K1 at ndf=512 with bf16 dots (the tensor-core variant over a cluster
    of 4, K1_tc), which no path runs, beside the fp32 checks of K1_c8 in
    the training run (stream) and the service (counter): against its
    float64 plain version in stream mode at B=256 and in counter mode at
    B=16; then, in counter mode with fp32 dots (K1_c8),
    rows of a B=500 launch equal, bit for bit, the same rows launched alone
    and in batches of 16 and 128. Returns {label: check}."""
    import torch

    from damc_tpu_torch.ops.cuda.fused_langevin import fused_prior_langevin

    nz = ebm_w[0].shape[0]
    out = {}
    for label, b, dots in (("stream bf16", 256, "bfloat16"), ("counter bf16", 16, "bfloat16")):
        z = torch.randn(b, nz, generator=gen).cuda()
        noise = (dict(seed=-97531) if label.startswith("stream") else
                 dict(row_seeds=torch.randint(0, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).cuda()))
        key = k1_key(nz, ebm_w[0].shape[1], dots)
        out[label] = chain_check(ebm_w, z, noise, mc.e_l_steps, mc.e_l_step_size, f"{key} {label} ndf512",
                                 against_fp64=True, dots_dtype=dots)
        out[label]["variant"] = key
    b = 500
    z = torch.randn(b, nz, generator=gen).cuda()
    seeds = torch.randint(0, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).cuda()
    rows_check("K1_c8 ndf512", lambda idx: fused_prior_langevin(
        z[idx], *ebm_w, row_seeds=seeds[idx], steps=mc.e_l_steps, step_size=mc.e_l_step_size), b, K1_ROW_BATCHES)
    return out


def k1_l2_holds(ebm_w, mc, gen):
    """The streamed variant (K1_l2) at ndf=1024, beside its fp32 checks in
    the phase (B=256 stream and the FID batch, B=500): against its float64
    plain version with fp32 dots in counter mode at B=16 (serving's bucket)
    and with bf16 dots in stream mode at B=256 and counter mode at B=16
    (`chain_check`'s `against_fp64`, its limits as they stand); then
    `k1_rows_check` with fp32 and with bf16 dots. Returns {label: check}."""
    import torch

    nz, ndf = ebm_w[0].shape
    out = {}
    for label, b, dots in (("counter", 16, "float32"), ("stream bf16", 256, "bfloat16"),
                           ("counter bf16", 16, "bfloat16")):
        z = torch.randn(b, nz, generator=gen).cuda()
        noise = (dict(seed=-75319) if label.startswith("stream") else
                 dict(row_seeds=torch.randint(0, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).cuda()))
        key = k1_key(nz, ndf, dots)
        out[label] = chain_check(ebm_w, z, noise, mc.e_l_steps, mc.e_l_step_size, f"{key} {label} ndf{ndf}",
                                 against_fp64=True, dots_dtype=dots)
        out[label]["variant"] = key
    for dots in ("float32", "bfloat16"):
        k1_rows_check(ebm_w, gen, dots, k1_key(nz, ndf, dots))
    return out


def k1_widths_phase(cfg, counters):
    """Training and the EBM-prior eval at widths K1 pads or spreads over a
    larger cluster: cifar10 at full width with nz=10 (padded to 12, the
    weights in shared memory over 4 blocks) for 3 iterations and with
    ndf=512 (nz=128: a block's slices take 223 KB over a cluster of 8,
    K1_c8) for 1, at B=128 with use_pallas on, through `training_phase`;
    with ndf=1024 (past every cluster's shared memory, so the weights are
    streamed from L2, K1_l2), which no configuration trains, the eval alone.
    On each model's random weights from the seed, K1 over the 2B=256 prior
    chains in stream mode against its float64 plain version (`chain_check`'s
    `against_fp64`) and, where it trains, K2 over B=128 rows of Q against
    its plain version; at ndf=512 also `k1_c8_holds`, at ndf=1024
    `k1_l2_holds`. Each iteration must
    launch K1 once in the variant `launch_widths` names (the others 0) and
    K2 once; finite metrics, G, E and Q changed, each iteration's ms beside
    the card's name and power limit. Then, on the trained weights (at
    ndf=1024 the seed's), K1 against its float64 plain version on an
    EBM-prior FID batch's draws (B=500), and that batch twice through
    `gen_samples_ebm_prior`: finite, equal bit for bit, that K1 variant
    launched once a batch and no other. One ndf=512 iteration
    under the profiler (`train_profile_phase`) gives K1_c8's share of it.
    Returns ({path: {kernel:
    (check, launches)}}, {hold label: check})."""
    import torch

    from damc_tpu_torch.models import build_models, sweep_route
    from damc_tpu_torch.ops.cuda.fused_langevin import ebm_params_to_dense_weights, fits_ebm, launch_widths
    from damc_tpu_torch.train.sampling import eval_draws, gen_samples_ebm_prior

    counters = {**counters, **k1_variant_counters()}
    out, holds = {}, {}
    for i, (label, widths, iterations) in enumerate(K1_WIDTH_RUNS):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **widths))
        m, mc, b = c.model, c.mcmc, c.train.batch_size
        models = build_models(c, seed=SEED, device="cuda")
        key = k1_key(m.nz, m.ndf)
        if not c.train.use_pallas or not fits_ebm(models.ebm) or sweep_route(models.amortizer) != "k2":
            raise AssertionError(f"{label}: the phase needs use_pallas on and both kernels taking the models")
        print(f"[k1_widths] {label} ({json.dumps(widths)}): K1 launches as {key} at {launch_widths(m.nz, m.ndf)}")
        gen = torch.Generator(device="cpu").manual_seed(SEED + 90 + i)
        chains = 2 * b if c.train.prior_chains == "double" else b
        z1 = torch.randn(chains, m.nz, generator=gen).cuda()
        ebm_w = ebm_params_to_dense_weights(models.ebm)
        r1 = chain_check(ebm_w, z1, dict(seed=135792468 + i), mc.e_l_steps, mc.e_l_step_size,
                         f"{key} stream {label}", against_fp64=True)
        if key == "K1_c8":
            holds.update({f"{k} ndf512": r for k, r in k1_c8_holds(ebm_w, mc, gen).items()})
        elif key == "K1_l2":
            holds.update({f"{k} ndf1024": r for k, r in k1_l2_holds(ebm_w, mc, gen).items()})
        del ebm_w
        state = None
        if iterations:
            x = torch.rand(b, m.image_size, m.image_size, m.nc, generator=gen).cuda() * 2 - 1
            z2 = torch.randn(b, m.nz, generator=gen).cuda()
            with torch.no_grad():
                post = models.amortizer.encode(x)
            r2 = sweep_check(models, c, z2, post, dict(seed=246813579 + i), f"K2 stream {label}")[b]
            del models
            expect = {**{name: 0 for name in counters}, "K2": 1, key: 1}
            state, total, median_ms = training_phase(c, counters, iterations, expect=expect,
                                                     tag=f"k1_widths {label}")
            print(f"[k1_widths] {label} ({json.dumps(widths)}, B={b}, {iterations} iterations): median ms an "
                  f"iteration {median_ms} on {card_line()}; launches {total}")
            out[f"train_{label}"] = {key: (r1, total[key]), "K2": (r2, total["K2"])}
            models = state.models
        d = eval_draws(SEED, "fid_ebm", 0, 0, K1_WIDTH_FID_B, m.nz, "cuda")
        r = chain_check(ebm_params_to_dense_weights(models.ebm), d.z0, dict(seed=d.chain_seed),
                        mc.e_l_steps, mc.e_l_step_size, f"{key} stream {label} FID batch", against_fp64=True)
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        runs = [gen_samples_ebm_prior(models, c, d) for _ in range(2)]
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 2
        launches = {name: k.launches for name, k in counters.items()}
        finite, same = bool(torch.isfinite(runs[0]).all()), torch.equal(runs[0], runs[1])
        print(f"[k1_widths] EBM-prior FID batch of {K1_WIDTH_FID_B} at {label} "
              f"({'trained' if iterations else 'seed'} weights): shape {tuple(runs[0].shape)}, finite {finite}, "
              f"two runs bit-identical {same}, launches {launches}, wall s a batch {wall}")
        want = {name: 2 if name == key else 0 for name in counters}
        if not finite or not same or launches != want:
            raise AssertionError(f"the {label} EBM-prior batch is not finite, not reproducible, or not "
                                 f"launches {want}")
        out[f"eval_{label}"] = {key: (r, launches[key])}
        if key == "K1_c8":  # K1's share of the iteration: the prior_langevin phase
            train_profile_phase(c, state, path=f"train_{label}")
        del models, state
    return out, holds


# Card against CPU after one iteration from one z0, held to one set of
# limits per mode. float32: the metrics by the rule of the CPU tests against
# the JAX package (tests/test_torch_port_train.py), each network's gradient
# and each leaf's within relative L2 error 1e-4.
@dataclasses.dataclass(frozen=True)
class CardCpuLimits:
    metric_rtol: float  # each metric within METRIC_ATOL + metric_rtol |CPU's|
    grad_rtol: float  # each network's gradient, relative L2 error
    leaf_rtol: float  # each leaf's gradient, relative L2 error
    exempt_zero: bool  # leave the conv biases in front of InstanceNorm out (`zero_by_construction`)


METRIC_ATOL = 1e-5
FP32_LIMITS = CardCpuLimits(metric_rtol=1e-5, grad_rtol=1e-4, leaf_rtol=1e-4, exempt_zero=False)
# bf16 (compute_dtype and pallas_dots_dtype "bfloat16"): cuDNN on the card
# and oneDNN on the CPU sum G's and the encoder's convolutions in other
# orders and round each activation to bf16 (8 significant bits), so
# elements of every layer differ by one bf16 ulp (2^-8 relative) and the
# backward passes take those differences on. A leaf whose gradient is a
# batch sum of terms that nearly cancel (the FiLM gates of Q's layers, fed
# by the bf16 embedding) carries them further. The conv biases in front of
# InstanceNorm, whose true gradient is 0, are rounding on both sides and
# printed apart. The control is the same iteration on the card in float32
# (BF16_CONTROL): its distance from the CPU's bf16 iteration is of the same
# kind, half an ulp in every element where the sound run differs by one ulp
# in some, so the two readings lie about 1.3 to 2 times apart. Each limit
# is their geometric mean: metrics 3.09e-4 and 6.09e-4, network gradients
# 4.04e-2 and 7.54e-2, leaves 0.178 and 0.234 (Q's, both), on the H100.
# The control must break a limit. The K1 variant is not seen here (a
# float32-dot chain moves E's gradient from 3.64e-3 to 3.87e-3): K1's bf16
# phase and the launch counts hold it.
BF16_LIMITS = CardCpuLimits(metric_rtol=4.3e-4, grad_rtol=5.5e-2, leaf_rtol=0.2, exempt_zero=True)
BF16_CONTROL = ("float32", "float32")  # the control's compute_dtype and pallas_dots_dtype
# Serving: the EBM path's images, G's bf16 output on z that differs by
# float32 rounding, within 4 bf16 ulps of 1.
BF16_SERVE_ATOL = 2.0**-6
ZERO_LEAF = 1e-6  # a leaf whose gradient norm is below this share of its network's is zero to rounding


def _recording(opt, log):
    """Make `opt.step` keep a copy of the gradients it is given (before the
    clip) in `log`."""
    step = opt.step

    def record(grads):
        log.append([g.detach().clone() for g in grads])
        step(grads)

    opt.step = record


def zero_by_construction(module):
    """Names of the conv biases that an InstanceNorm follows: the norm takes
    each channel's mean out, so their true gradient is 0 and what either
    side computes for them is rounding."""
    import torch

    out = set()
    for prefix, m in module.named_modules():
        if isinstance(m, torch.nn.Sequential):
            kids = list(m.named_children())
            for (name, a), (_, b) in zip(kids, kids[1:]):
                if isinstance(a, torch.nn.Conv2d) and isinstance(b, torch.nn.InstanceNorm2d):
                    out.add(f"{prefix}.{name}.bias" if prefix else f"{name}.bias")
    return out


_NETS = ("G", "E", "Q")
_MODULES = {"G": "generator", "E": "ebm", "Q": "amortizer"}


def _one_iteration(small, dev, x, draws, z0, mesh=None):
    """One iteration of `small` on `dev` from the seed's state, with `z0` as
    Q_ema's proposal. Returns ((metrics, named parameters per network, the
    gradients each optimizer received), all on the CPU; the models). With a
    `mesh` (a data-parallel rank), x, draws and z0 are the global batch's
    and the rank steps its rows."""
    from damc_tpu_torch.parallel import shard_batch
    from damc_tpu_torch.train import step as step_module
    from damc_tpu_torch.train.state import create_state
    from damc_tpu_torch.train.step import make_train_step

    def to(t):
        return None if t is None else t.to(dev)

    d = dataclasses.replace(
        draws, mask_u=to(draws.mask_u), z0_init=to(draws.z0_init), neg_init=to(draws.neg_init),
        post_noise=to(draws.post_noise),
        q=[tuple(None if qd is None else dataclasses.replace(
            qd, prior_noise=to(qd.prior_noise), u=to(qd.u), eps=to(qd.eps)) for qd in pair) for pair in draws.q],
    )
    state = create_state(small, SEED, dev)
    grads = {name: [] for name in _NETS}
    for name, opt in zip(_NETS, (state.opts.g, state.opts.e, state.opts.q)):
        _recording(opt, grads[name])
    step = make_train_step(state.models, state.opts, small, mesh=mesh)
    original = step_module.sample_q
    step_module.sample_q = lambda ema, xx, z_init, seed, row_base=0: z0[row_base:row_base + len(xx)].to(xx.device)
    try:
        state, metrics = step(state, (x if mesh is None else shard_batch(mesh, x)).to(dev), d)
    finally:
        step_module.sample_q = original
    return (
        {k: float(v) for k, v in metrics.items()},
        {k: [(n, p.detach().cpu()) for n, p in v.named_parameters()] for k, v in _state_modules(state).items()},
        {k: [g.cpu() for g in v[0]] for k, v in grads.items()},
    ), state.models


def _card_cpu_readings(small, cpu, card, models, limits, tag, quiet=False, names=("card", "CPU")):
    """The card's iteration `card` against the CPU's `cpu` (or two other
    runs, printed under `names`): the readings that `limits` holds, and the
    names of those that break it."""
    import torch

    say = (lambda s: None) if quiet else print
    (m_c, p_c, g_c), (m_g, p_g, g_g) = cpu, card
    failed, readings = [], {}
    norm = lambda ts: float(torch.sqrt(sum((t.double() ** 2).sum() for t in ts)))
    worst_m = 0.0
    for k in m_c:
        diff = abs(m_g[k] - m_c[k])
        limit = METRIC_ATOL + limits.metric_rtol * abs(m_c[k])
        worst_m = max(worst_m, max(diff - METRIC_ATOL, 0.0) / abs(m_c[k]))
        say(f"[{tag}]   {k}: {names[0]} {m_g[k]:.9g}, {names[1]} {m_c[k]:.9g}, diff {diff:.3e}, limit {limit:.3e}")
        if diff > limit:
            failed.append(k)
    readings["metrics"] = worst_m  # the least metric_rtol that every metric passes
    lrs = {"G": small.optim.g_lr, "E": small.optim.e_lr, "Q": small.optim.q_lr}
    for name in _NETS:
        names = [n for n, _ in p_c[name]]
        deltas = [gg - gc for gg, gc in zip(g_g[name], g_c[name])]
        exempt = zero_by_construction(getattr(models, _MODULES[name])) if limits.exempt_zero else set()
        for n, dl, gc in zip(names, deltas, g_c[name]):
            if n in exempt:
                say(f"[{tag}]   {name} {n} (zero by construction): card-CPU {norm([dl]):.3e}, CPU {norm([gc]):.3e}")
        kept = [i for i, n in enumerate(names) if n not in exempt]
        net_norm = norm([g_c[name][i] for i in kept])
        net_rel = norm([deltas[i] for i in kept]) / net_norm
        leaf_rel = {names[i]: norm([deltas[i]]) / norm([g_c[name][i]]) for i in kept
                    if norm([g_c[name][i]]) >= ZERO_LEAF * net_norm}
        worst = max(leaf_rel, key=leaf_rel.get)
        readings[f"{name} gradient"], readings[f"{name} leaf"] = net_rel, leaf_rel[worst]
        say(f"[{tag}]   {name} gradient: relative L2 error {net_rel:.3e} (limit {limits.grad_rtol:g}); worst leaf "
            f"{worst} {leaf_rel[worst]:.3e} (limit {limits.leaf_rtol:g}); {len(kept) - len(leaf_rel)} of "
            f"{len(names)} leaves zero to rounding, {len(exempt)} zero by construction")
        if exempt:
            top = sorted(leaf_rel, key=leaf_rel.get, reverse=True)[:4]
            say(f"[{tag}]   {name} worst leaves (relative L2 error, share of the network's norm): " + ", ".join(
                f"{n} {leaf_rel[n]:.3e} {norm([g_c[name][names.index(n)]]) / net_norm:.3e}" for n in top))
        if net_rel > limits.grad_rtol:
            failed.append(f"{name} gradient")
        if leaf_rel[worst] > limits.leaf_rtol:
            failed.append(f"{name} leaf")
        limit = lrs[name] / 36 + 1e-6
        held = loose = 0
        worst_p = 0.0
        for (n, pc), (_, pg), gc, dl in zip(p_c[name], p_g[name], g_c[name], deltas):
            keep = gc.abs() > 10 * dl.abs()
            held += int(keep.sum())
            loose += int((~keep).sum())
            if bool(keep.any()):
                worst_p = max(worst_p, float((pg - pc).abs()[keep].max()))
        readings[f"{name} parameters"] = worst_p / limit
        say(f"[{tag}]   {name} parameters: {held} elements held, max abs diff {worst_p:.3e} "
            f"(limit {limit:.3e}); {loose} set by rounding (share {loose / (held + loose):.3e})")
        if worst_p > limit:
            failed.append(f"{name} parameters")
    same_ema = all(torch.equal(a, c) for (_, a), (_, c) in zip(p_g["Q_ema"], p_c["Q_ema"]))
    say(f"[{tag}]   Q_ema equal: {same_ema}")
    if not same_ema:
        failed.append("Q_ema")
    return readings, failed


def small_iteration_inputs(cfg):
    """(config, x, draws, z0) of the card-vs-CPU iteration (gpu_cpu_phase):
    B=8, 2 posterior steps, noiseless kernels, one Q update; the draws and
    Q_ema's z0 made on the CPU from the seed."""
    import torch

    from damc_tpu_torch.models import sample_q
    from damc_tpu_torch.train.state import create_state
    from damc_tpu_torch.train.step import draw_step

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
    return small, x, draws, z0


def gpu_cpu_phase(cfg, limits=FP32_LIMITS, tag="train", control=None):
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
    to rounding. The rest differs in rounding only (no TF32, deterministic
    cuDNN), and is held to `limits` (CardCpuLimits):
      * every metric within rtol `metric_rtol` / atol METRIC_ATOL of the
        CPU's;
      * each network's gradient, as its optimizer receives it, within
        relative L2 error `grad_rtol`, and each leaf's within `leaf_rtol`
        unless its gradient is zero to rounding (below ZERO_LEAF of the
        network's norm) or, with `exempt_zero`, a conv bias in front of
        InstanceNorm (`zero_by_construction`), left out and printed apart;
      * each updated parameter element whose CPU gradient g is more than
        10 times the card's difference d from it within lr / 36 + 1e-6 of
        the CPU's. Adam's first step is -lr g / (|g| + eps); where
        |d| < |g| / 10 it moves by at most lr |d| eps / (0.9 |g| + eps)^2
        <= lr / 36. Elements with |g| <= 10 |d| take a step whose direction
        rounding sets, on either side, and are counted, not held;
      * Q_ema, which one iteration does not mix, equal.
    `control` (compute_dtype, pallas_dots_dtype) runs the same iteration on
    the card with those switches, which must break a limit: the limits are
    shown to tell the mode asked for from another. Returns the readings of
    the card run and of the control."""
    small, x, draws, z0 = small_iteration_inputs(cfg)
    cpu, _ = _one_iteration(small, "cpu", x, draws, z0)
    card, models = _one_iteration(small, "cuda", x, draws, z0)
    readings, failed = _card_cpu_readings(small, cpu, card, models, limits, tag)
    if failed:
        raise AssertionError(f"card and CPU disagree beyond rounding: {failed}")
    out = {"card": readings}
    if control is not None:
        dtype, dots = control
        small_c = dataclasses.replace(small, model=dataclasses.replace(small.model, compute_dtype=dtype),
                                      train=dataclasses.replace(small.train, pallas_dots_dtype=dots))
        card_c, _ = _one_iteration(small_c, "cuda", x, draws, z0)
        out["control"], broke = _card_cpu_readings(small, cpu, card_c, models, limits, tag, quiet=True)
        print(f"[{tag}] control, the card with compute_dtype {dtype} and pallas_dots_dtype {dots}: breaks "
              f"{broke or 'no limit'}; readings (the card run, the control) " + json.dumps(out))
        if not broke:
            raise AssertionError(f"the limits do not tell the card's {control} run from the CPU's {tag} run")
    return out


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


EVAL_TRAIN_IMAGES = 10_000  # CIFAR-10's train split holds 50,000: cut to make room for the mesh phases
EVAL_TEST_IMAGES = 1_000  # the test split holds 10,000: cut so that the MSE eval stays short
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
    temporary directory: train 4 iterations with evals, grids and
    checkpoints every 2; resume to 5 with --resume_path auto; restore
    ckpt/3 and step it against the state in memory; score ckpt/best
    once through the eval CLI. Returns what the timing and JSON lines need."""
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
              f"split holds 50,000; cut to keep the script within its time), {EVAL_TEST_IMAGES} test images "
              f"(the real split holds 10,000; cut so the MSE eval stays short), written in "
              f"{time.perf_counter() - t0:.2f} s")
        b, n_fid = cfg.train.batch_size, 1000
        common = ["--dataset", "cifar10", "--data_path", data, "--log_path", logs, "--seed", str(SEED)]
        train_args = common + ["--batch_size", str(b), "--eval_every", "2", "--ckpt_every", "2",
                               "--plot_every", "2", "--print_every", "1", "--n_fid_samples", str(n_fid)]

        # 1. Train 4 iterations.
        run_info = train_cli_run(cfg, counters, train_args + ["--iterations", "4"], logs, evals=[0, 2, 3],
                                 plots=[0, 2], n_fid=n_fid, n_test=EVAL_TEST_IMAGES)
        state, run, runs, calls = run_info["state"], run_info["run"], run_info["runs"], run_info["calls"]
        eval_walls, n_mse_b = run_info["eval_walls"], run_info["n_mse_b"]
        ckpts = sorted(os.listdir(os.path.join(run, "ckpt")))
        print(f"[eval] checkpoints {ckpts}")
        if not {"2", "3", "best"} <= set(ckpts):
            raise AssertionError("ckpt/2, ckpt/3 or ckpt/best is missing")

        # 2. Resume to 5 iterations in the same run directory.
        for k in counters.values():
            k.launches = 0
        resumed = train_gen_recon.main(train_args + ["--iterations", "5", "--resume_path", "auto"])
        runs_after = os.listdir(os.path.join(logs, "cifar10"))
        rows = _jsonl(os.path.join(run, "metrics.jsonl"))
        steps_after = [r["step"] for r in rows if r["phase"] == "train"]
        print(f"[eval] resumed run: directories {runs_after}, train rows {steps_after}, step {resumed.step}, "
              f"launches {dict((k, c.launches) for k, c in counters.items())}")
        if runs_after != runs or steps_after != list(range(5)) or resumed.step != 5:
            raise AssertionError("the resumed run did not continue at iteration 4 in the same directory")
        del resumed

        # 3. Restore ckpt/3 into a fresh state: equal to the state in memory,
        # and one more step from each, bit for bit.
        restored = restore_checkpoint(os.path.join(run, "ckpt"), "3", create_state(cfg, 123, "cuda"))
        same = _states_equal(restored, state)
        print(f"[eval] ckpt/3 restored into a fresh state equals the state in memory: {same}")
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

        # 4. The eval CLI on ckpt/best, once (its rerun cut for time).
        eval_args = common + ["--ckpt_dir", os.path.join(run, "ckpt"), "--n_fid_samples", "1000"]
        _, walls, cli_launches = eval_cli_runs(cfg, counters, eval_args, 1, 1000, EVAL_TEST_IMAGES)
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
ANOMALY_ITERATIONS, ANOMALY_EVAL_EVERY, ANOMALY_RESUME_TO = 6, 3, 7
TOY_ITERATIONS, TOY_VIZ_EVERY, TOY_VIZ_BATCHES, TOY_GT_STEPS = 20, 10, 2, 1000


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


def _timed_steps(module, events, before=False):
    """Wrap `module.make_train_step` so that every step it builds records a
    CUDA event after it (no sync), or before it with `before`; returns the
    undo."""
    import torch

    original = module.make_train_step

    def make(*args, **kwargs):
        step = original(*args, **kwargs)

        def record():
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            events.append(event)

        def timed(*a, **k):
            if before:
                record()
            out = step(*a, **k)
            if not before:
                record()
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


def write_mnist(data: str, digit: int, tag: str) -> int:
    """An MNIST-shaped mnist.npz made from the seed in `data` (70,000
    images: 50,000/10,000/10,000 in x_train/x_test/x_valid), its split for
    held-out `digit` cached, the test split cut to ANOMALY_TEST_IMAGES
    through its cache file. Returns the anomalous count of the cut split."""
    import os

    from damc_tpu_torch.data.datasets import load_mnist_anomaly, synthetic_mnist_npz

    os.makedirs(data)
    t0 = time.perf_counter()
    synthetic_mnist_npz(os.path.join(data, "mnist.npz"), (50_000, 10_000, 10_000), seed=SEED)
    train_x, _ = load_mnist_anomaly(data, digit, "train")
    test_x, test_y = load_mnist_anomaly(data, digit, "test")
    n_test = len(test_x)
    # The cut: the first images of the split, through its own cache file.
    cache = os.path.join(data, f"heldout_{digit}_test.npy")
    split = np.load(cache, allow_pickle=True).item()
    np.save(cache, {k: v[:ANOMALY_TEST_IMAGES] for k, v in split.items()})
    cut_x, cut_y = load_mnist_anomaly(data, digit, "test")
    if not (np.array_equal(cut_x, test_x[:ANOMALY_TEST_IMAGES]) and np.array_equal(cut_y, test_y[:len(cut_y)])
            and len(cut_x) == ANOMALY_TEST_IMAGES):
        raise AssertionError("the cut test split does not read back")
    print(f"[{tag}] MNIST-shaped mnist.npz made from the seed (70,000 images), held-out digit {digit}: "
          f"{len(train_x)} train images, {n_test} test images cut to {len(cut_x)} ({int(cut_y.sum())} "
          f"anomalous; cut so each AUPRC eval stays short), in {time.perf_counter() - t0:.2f} s")
    return int(cut_y.sum())


def anomaly_phase(cfg, counters):
    """The anomaly workload through its CLIs at full mnist_anomaly width, in
    a temporary directory, on an MNIST-shaped mnist.npz made from the seed
    (70,000 images: 50,000/10,000/10,000 in x_train/x_test/x_valid): train
    6 iterations at B=128 with an AUPRC eval and checkpoints every 3 (the
    test split cut to 4,000 images through its cache file), resume to 7
    with --resume_path auto in the same directory, then score ckpt/best
    twice through the eval CLI. Returns the times and launches."""
    import os
    import shutil
    import tempfile

    import torch

    from damc_tpu_torch.cli import eval_anomaly_det, train_anomaly_det
    from damc_tpu_torch.train import anomaly

    tmp = tempfile.mkdtemp(prefix="damc_anomaly_smoke_")
    try:
        data, logs = os.path.join(tmp, "data"), os.path.join(tmp, "logs")
        digit = cfg.train.heldout_digit
        write_mnist(data, digit, "anomaly")
        b = cfg.train.batch_size
        common = ["--data_path", data, "--log_path", logs, "--seed", str(SEED), "--label", str(digit)]
        train_args = common + ["--eval_every", str(ANOMALY_EVAL_EVERY), "--ckpt_every", str(ANOMALY_EVAL_EVERY),
                               "--print_every", "5"]

        # 1. Train ANOMALY_ITERATIONS iterations.
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
        want_evals = [0, ANOMALY_EVAL_EVERY, ANOMALY_ITERATIONS - 1]
        if train_steps != list(range(0, ANOMALY_ITERATIONS, 5)) or [r["step"] for r in eval_rows] != want_evals:
            raise AssertionError("metrics.jsonl lacks a train or an eval row")
        for r in rows:
            if not all(np.isfinite(v) for k, v in r.items() if k not in ("phase",)):
                raise AssertionError(f"non-finite metric in row {r}")
        if not all(0.0 < r["auprc"] <= 1.0 for r in eval_rows) or best != max(r["auprc"] for r in eval_rows):
            raise AssertionError(f"AUPRC out of (0, 1] or best {best} is not the largest")
        ckpts = sorted(os.listdir(os.path.join(run, "ckpt")))
        print(f"[anomaly] checkpoints {ckpts}; best AUPRC {best}")
        if ckpts != sorted([str(ANOMALY_EVAL_EVERY), str(ANOMALY_ITERATIONS - 1), "best"]):
            raise AssertionError(f"ckpt/{ANOMALY_EVAL_EVERY}, the terminal checkpoint or ckpt/best is missing")
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

        # 2. Resume one iteration further in the same directory (no eval on the way).
        resumed, _ = train_anomaly_det.main(
            common + ["--iterations", str(ANOMALY_RESUME_TO), "--resume_path", "auto", "--eval_every", "0",
                      "--ckpt_every", str(ANOMALY_EVAL_EVERY), "--print_every", "1"])
        rows = _jsonl(os.path.join(run, "metrics.jsonl"))
        resumed_rows = [r["step"] for r in rows if r["phase"] == "train"][len(train_steps):]
        print(f"[anomaly] resumed: directories {os.listdir(os.path.join(logs, 'mnist'))}, new train rows "
              f"{resumed_rows}, step {resumed.step}")
        if resumed.step != ANOMALY_RESUME_TO or resumed_rows != list(range(ANOMALY_ITERATIONS, ANOMALY_RESUME_TO)):
            raise AssertionError(f"the resumed run did not continue at iteration {ANOMALY_ITERATIONS} in the same "
                                 "directory")
        del resumed

        # 3. The eval CLI on ckpt/best, once (its rerun cut for time: the
        # data-parallel phase scores ckpt/best in one process and over two ranks).
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        score = eval_anomaly_det.main(common + ["--ckpt_dir", os.path.join(run, "ckpt")])
        torch.cuda.synchronize()
        walls = [time.perf_counter() - t0]
        cli_launches = {k: c.launches for k, c in counters.items()}
        print(f"[anomaly] eval CLI AUPRC {score}; launches {cli_launches}; wall s {walls}")
        if not 0.0 < score <= 1.0:
            raise AssertionError(f"the eval CLI printed AUPRC {score}")
        if cli_launches != {"K1": 0, "K2": n_batches}:
            raise AssertionError(f"eval CLI launches {cli_launches}, expected K2 {n_batches}")
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
    in a temporary directory: 20 iterations with a parity eval (1,000
    ground-truth Langevin steps, 2 batches of 500) every 10 and at the end;
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
# CelebA-HQ's images: one batch of 128 an epoch and a small test split. The
# files are 512x512, not CelebA-HQ's 1024x1024, to keep the script within its
# limit: the CLI's first cache decoded the 1024x1024 PNGs in 31 s (0.2 s a
# file in numpy on one core); the loader resizes to 256x256 either way.
CELEBAHQ_TRAIN, CELEBAHQ_TEST, CELEBAHQ_SIZE = 128, 16, (512, 512)


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
    the real split; 2,000 test images): train 2 iterations at B=128 (cut
    for time) with evals at both, a grid at the first, a checkpoint at the
    last and 1,000 FID samples; score
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
            "--iterations", "2", "--eval_every", "2", "--ckpt_every", "2", "--plot_every", "2", "--print_every", "1",
            "--n_fid_samples", str(n_fid)], logs, evals=[0, 1], plots=[0], n_fid=n_fid,
            n_test=SVHN_TEST_IMAGES, tag="svhn")
        ckpt = os.path.join(info["run"], "ckpt")
        ckpts = sorted(os.listdir(ckpt))
        print(f"[svhn] checkpoints {ckpts}")
        if not {"1", "best"} <= set(ckpts):
            raise AssertionError("ckpt/1 or ckpt/best is missing")
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
    code = ("import PIL.Image, PIL.features as f; "
            "print(PIL.__version__, f.version('webp'), f.version('libjpeg_turbo'))")
    pil = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    if pil.returncode == 0:
        version, webp, turbo = pil.stdout.split()
        found = f"imports, version {version}, libwebp {webp}, libjpeg-turbo {turbo}"
    else:
        found = "does not import"
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


def synthetic_jpeg_tree(root: str, n: int, size, seed: int, start: int = 0) -> None:
    """n JPEGs of `size` (width, height) made from `seed`, written by PIL to
    root/{start + i:06d}.jpg, as CelebA's published files are: smooth
    images with a little pixel noise, 4:2:0 at quality 75, every eighth
    4:4:4 at quality 90, every fourth (from the second) with a restart
    marker every MCU row."""
    import os

    from PIL import Image

    w, h = int(size[0]), int(size[1])
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        k = start + i
        low = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3), dtype=np.uint8)
        img = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR)).astype(np.int16)
        img = np.clip(img + rng.integers(-6, 7, (h, w, 3)), 0, 255).astype(np.uint8)
        kw = dict(quality=90, subsampling=0) if k % 8 == 7 else dict(quality=75, subsampling=2)
        if k % 4 == 1:
            kw["restart_marker_rows"] = 1
        Image.fromarray(img).save(os.path.join(root, f"{k:06d}.jpg"), "JPEG", **kw)


def write_jpeg_tree(root: str, n: int, size, seed: int) -> float:
    """`synthetic_jpeg_tree` of n files under root, written by up to 8
    worker processes at once; returns the wall in seconds."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1, n))
    per = -(-n // workers)
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = [pool.submit(synthetic_jpeg_tree, root, min(per, n - k * per), size, seed + k, k * per)
                for k in range(workers) if k * per < n]
        for job in jobs:
            job.result()
    return time.perf_counter() - t0


def pil_folder_pipeline(images, size: int) -> np.ndarray:
    """The JAX package's image-folder transform of RGB `images`, through
    PIL: the shorter side resized to `size` (bilinear), then the centre
    crop; (N, size, size, 3) uint8."""
    from PIL import Image

    folder = []
    for img in images:
        h, w = img.shape[:2]
        scale = size / min(w, h)
        r = Image.fromarray(img).resize((max(size, round(w * scale)), max(size, round(h * scale))), Image.BILINEAR)
        left, top = (r.size[0] - size) // 2, (r.size[1] - size) // 2
        folder.append(np.asarray(r.crop((left, top, left + size, top + size))))
    return np.stack(folder)


def jpeg_check(root: str, cached: np.ndarray, size: int) -> dict:
    """Every JPEG under root decoded by the port (`decode_jpegs`, its thread
    pool) must equal PIL's `Image.open(...).convert("RGB")`, byte for byte,
    and the folder reader's (size, size) images (`cached`) must equal the
    JAX package's PIL pipeline (bilinear resize of the shorter side, centre
    crop). Returns the decode rates in images/s: the port on all cores and
    on one thread, PIL on one."""
    import io
    import os

    from PIL import Image

    from damc_tpu_torch.data.jpeg import decode_jpegs

    paths = sorted(os.path.join(root, f) for f in os.listdir(root))
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    t0 = time.perf_counter()
    port = decode_jpegs(blobs, paths)
    port_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decode_jpegs(blobs, paths, threads=1)
    port1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pil = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB")) for b in blobs]
    pil_s = time.perf_counter() - t0
    bad = [p for p, a, b in zip(paths, port, pil) if not np.array_equal(a, b)]
    same_folder = np.array_equal(pil_folder_pipeline(pil, size), np.asarray(cached))
    out = {"files": len(paths), "bytes": sum(map(len, blobs)), "port_images_per_s": len(paths) / port_s,
           "port_one_thread_images_per_s": len(paths) / port1_s, "pil_images_per_s": len(paths) / pil_s,
           "threads": min(16, os.cpu_count() or 4), "differ_from_pil": len(bad),
           "folder_reader_equals_pil_pipeline": same_folder}
    print("[celeba64] JPEG decode " + json.dumps(out) + " " + card_line())
    if bad or not same_folder:
        raise AssertionError(f"the port's JPEG decode differs from PIL's: {bad[:5]}, folder equal {same_folder}")
    return out


def _record_placements(log):
    """Wrap the gen_recon driver's `make_batch_source`, logging each
    source's placement; returns the undo."""
    from damc_tpu_torch.train import gen_recon

    original = gen_recon.make_batch_source

    def make(*args, **kwargs):
        out = original(*args, **kwargs)
        log.append(out[2])
        return out

    gen_recon.make_batch_source = make
    return lambda: setattr(gen_recon, "make_batch_source", original)


def feed_phase(cfg, store, iterations: int = 3):
    """The host feed against the device-resident store at celeba64's
    shapes, in one process on one state: for each placement, the card's
    batches first (the host ones must equal the CPU's host stream, so that
    the pinned, non-blocking copy is seen to land intact), then one
    warm-up iteration, `iterations` timed by CUDA events (batch included)
    and one under the profiler (wall, device busy, idle share)."""
    import dataclasses as dc

    import torch
    from torch.profiler import ProfilerActivity, profile

    from damc_tpu_torch.train.driver_utils import make_batch_source
    from damc_tpu_torch.train.state import create_state
    from damc_tpu_torch.train.step import make_train_step

    state = create_state(cfg, SEED, "cuda")
    step = make_train_step(state.models, state.opts, cfg)
    out = {}
    for placement in ("host", "device"):
        tc = dc.replace(cfg.train, data_placement=placement)
        if placement == "host":
            card, cpu = make_batch_source(store, tc, SEED, "cuda"), make_batch_source(store, tc, SEED, "cpu")
            try:
                busy = torch.randn(4096, 4096, device="cuda")
                queued = []
                for _ in range(4):
                    busy = busy @ busy / 64.0  # keeps the stream busy while the copies are queued
                    queued.append(card[0]())
                same = all(torch.equal(x.cpu(), cpu[0]()) for x in queued)
            finally:
                card[1]()
                cpu[1]()
            print(f"[celeba64-feed] 4 host batches queued to the card behind busy work == the CPU's host "
                  f"stream: {same}")
            if not same:
                raise AssertionError("a host batch changed on its way to the card")
        next_batch, close, got = make_batch_source(store, tc, SEED, "cuda")
        try:
            if got != placement:
                raise AssertionError(f"placement {got}, asked {placement}")
            state, _ = step(state, next_batch())
            torch.cuda.synchronize()
            events = [torch.cuda.Event(enable_timing=True) for _ in range(iterations + 1)]
            events[0].record()
            for e in events[1:]:
                state, _ = step(state, next_batch())
                e.record()
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, _ = step(state, next_batch())
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            close()
        cuda = torch.autograd.DeviceType.CUDA
        annotation = lambda e: getattr(e, "is_user_annotation", False) or "/" in e.name or "#" in e.name
        busy_ms = sum((e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
                      if e.device_type == cuda and not annotation(e))
        out[placement] = {"ms_per_iteration": ms, "median_ms": statistics.median(ms), "profiled_wall_ms": wall_ms,
                          "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms}
    print("[celeba64-feed] " + json.dumps(out) + " " + card_line())
    return out


def celeba64_phase(cfg, counters):
    """celeba64 (nz=100, ngf=128, 64x64) through the train CLI at full width
    in a temporary directory, on a JPEG tree made from the seed at CelebA's
    aligned size, 178x218 (2,048 train and 512 test images; CelebA's
    published format): every train file decoded by the port must equal
    PIL's decode; train 4 iterations at B=128 with --data_placement host
    (grids at 0, a checkpoint at the end), which writes the train split's
    cache celeba64_train_64.npy, equal to the JAX package's PIL pipeline;
    then resume to 5 with an eval (500 FID samples, the 512 test images)
    under 'auto' with --data_device_budget_gb below the store, which must
    read the cache memory-mapped and fall back to the host feed;
    'device' over that budget must raise; then the host feed beside the
    device-resident store (`feed_phase`)."""
    import dataclasses as dc
    import os
    import shutil
    import tempfile

    from damc_tpu_torch.train.driver_utils import make_batch_source

    tmp = tempfile.mkdtemp(prefix="damc_celeba64_smoke_")
    reads, placements = [], []
    undo = [_record_reads(reads), _record_placements(placements)]
    try:
        data, logs = os.path.join(tmp, "data"), os.path.join(tmp, "logs")
        tree_s = write_jpeg_tree(os.path.join(data, "celeba64_train"), CELEBA64_TRAIN, CELEBA64_SIZE, SEED + 20)
        tree_s += write_jpeg_tree(os.path.join(data, "celeba64_test"), CELEBA64_TEST, CELEBA64_SIZE, SEED + 40)
        n_files = CELEBA64_TRAIN + CELEBA64_TEST
        print(f"[celeba64] JPEG tree made from the seed: {n_files} images at {CELEBA64_SIZE[0]}x{CELEBA64_SIZE[1]} "
              f"(4:2:0 at quality 75, every eighth 4:4:4, every fourth with restart markers), written by PIL in "
              f"{tree_s:.2f} s")
        n_fid = 500
        common = ["--dataset", "celeba64", "--data_path", data, "--log_path", logs, "--seed", str(SEED),
                  "--print_every", "1", "--n_fid_samples", str(n_fid)]
        t0 = time.perf_counter()
        first = train_cli_run(cfg, counters, common + ["--iterations", "4", "--eval_every", "0", "--plot_every", "4",
                                                       "--data_placement", "host"],
                              logs, evals=[], plots=[0], n_fid=n_fid, n_test=CELEBA64_TEST, tag="celeba64")
        cache = os.path.join(data, "celeba64_train_64.npy")
        decoded = [r for r in reads if r["what"] == "load_image_folder"]
        train_decode = next(r for r in decoded if r["root"].endswith("celeba64_train"))
        cached = next(r for r in reads if r["what"] == "load_image_folder_cached")
        print(f"[celeba64] first run: placement {placements}; decode of {CELEBA64_TRAIN} train images "
              f"{train_decode['s']:.2f} s, the cache written and mapped {cached['s'] - train_decode['s']:.2f} s, "
              f"decode of {CELEBA64_TEST} test images {sum(r['s'] for r in decoded if r is not train_decode):.2f} s; "
              f"{os.path.basename(cache)} written: {os.path.exists(cache)}")
        if placements != ["host"]:
            raise AssertionError(f"--data_placement host trained on {placements}")
        if not os.path.exists(cache) or not np.array_equal(np.load(cache), train_decode["value"]):
            raise AssertionError("the first run did not write the train split's cache, or it differs from the decode")
        if sorted(os.listdir(os.path.join(first["run"], "ckpt"))) != ["3"]:
            raise AssertionError("the first run's checkpoint ckpt/3 is missing")
        del first["state"]
        rates = jpeg_check(os.path.join(data, "celeba64_train"), train_decode["value"], 64)
        store_gib = train_decode["value"].nbytes / 2**30
        budget = store_gib / 2
        reads.clear()
        placements.clear()
        second = train_cli_run(cfg, counters, common + [
            "--iterations", "5", "--eval_every", "4", "--plot_every", "0", "--resume_path", "auto",
            "--data_placement", "auto", "--data_device_budget_gb", repr(budget)],
            logs, evals=[4], plots=[], n_fid=n_fid, n_test=CELEBA64_TEST, resumed=True, tag="celeba64")
        (cached,) = [r for r in reads if r["what"] == "load_image_folder_cached"]
        store = cached["value"]
        redecoded = [r["root"] for r in reads if r["what"] == "load_image_folder" and r["root"].endswith("_train")]
        same = isinstance(store, np.memmap) and store.mode == "r" and np.array_equal(store, train_decode["value"])
        print(f"[celeba64] resumed run: step {second['state'].step}; placement {placements} under 'auto' with a "
              f"budget of {budget:.5f} GiB for a {store_gib:.5f} GiB store; the train split read from the cache "
              f"memory-mapped in {cached['s']:.4f} s, equal to the first run's decode: {same}; decoded again: "
              f"{redecoded or 'none'}")
        if second["state"].step != 5 or not same or redecoded:
            raise AssertionError("the resumed run did not continue at 4 from the cache")
        if placements != ["host"]:
            raise AssertionError(f"'auto' over the budget trained on {placements}, not the host feed")
        del second["state"]
        try:
            make_batch_source(store, dc.replace(cfg.train, data_placement="device", data_device_budget_gb=budget),
                              SEED, "cuda")
        except ValueError as e:
            print(f"[celeba64] 'device' over the budget raised: {e}")
        else:
            raise AssertionError("data_placement 'device' over the budget did not raise")
        feed = feed_phase(cfg, store)
        wall = time.perf_counter() - t0
        print(f"[celeba64] phase wall without the tree {wall:.2f} s")
        launches = {k: first["total"][k] + second["total"][k] for k in counters}
        return {"launches": launches, "tree_s": tree_s, "decode_s": train_decode["s"], "wall": wall,
                "ms": first["ms"] + second["ms"], "rates": rates, "feed": feed}
    finally:
        for u in undo:
            u()
        shutil.rmtree(tmp, ignore_errors=True)

# Item 4c's trees at CelebA's 178x218, written by PIL, and the arithmetic
# and lossless JPEGs by the port's writer (tools/jpeg_writer.py), which PIL
# cannot write; item 4d's PNG and BMP kinds (tools/image_writer.py::KINDS),
# by the port's writer, which writes what PIL does not: (kind, files).
TREE_4D = ("png_grey1", "png_grey2", "png_grey4", "png_grey16", "png_palette1", "png_palette2", "png_palette4",
           "png_rgb16", "png_rgba16", "png_grey_alpha16", "png_adam7_rgb8", "png_adam7_palette4",
           "bmp_1", "bmp_4", "bmp_16", "bmp_bf565", "bmp_bf32", "bmp_rle8", "bmp_rle4")
TREE_4C = (("webp_lossy", 1024), ("webp_lossless", 256), ("webp_alpha", 128), ("webp_anim", 32),
           ("jpeg_progressive", 1024), ("jpeg_cmyk", 128), ("jpeg_ycck", 64), ("jpeg_arith", 64),
           ("jpeg_arith_progressive", 64), ("jpeg_lossless", 64), ("jpeg_smoothed", 64)) + tuple(
    (kind, 32) for kind in TREE_4D)
MIXED_TRAIN, MIXED_TEST = 1024, 256  # the mixed celeba64 tree drawn from them
ONE_THREAD_FILES = 256  # the port's one-thread rate is timed on the first of each kind


def synthetic_4c_tree(root: str, kind: str, n: int, size, seed: int, start: int = 0) -> None:
    """n files of one kind of TREE_4C, (width, height) `size`, made from
    `seed` and written to root/{start + i:06d}_{kind}.webp or .jpg: smooth
    images with a little pixel noise. By PIL: lossy WebP cycles quality 0
    to 100 and method 0 to 6; lossless WebP quality and method 0 to 4,
    every fourth a palette of 16 or 200 colours; alpha WebP a quarter fully
    transparent, lossy and lossless by turns; animations three frames;
    progressive JPEG 4:2:0 at quality 75 and 4:4:4 at 90 by turns, every
    fourth with a restart marker every MCU row; CMYK JPEG baseline and
    progressive by turns, and YCCK the same files with the Adobe transform
    byte set to 2; smoothed JPEG, a progressive file cut after 1 to 6 of
    its scans, plus an EOI (libjpeg smooths its blocks). By the port's
    writer: arithmetic-coded JPEG sequential, 4:2:0 at quality 75 and
    4:4:4 at 90 by turns, every fourth with a restart marker every 11
    MCUs; the same progressive (libjpeg's simple progression); lossless
    JPEG, predictors 1 to 7 in turn, point transform 0 and 1 by turns. The
    PNG and BMP kinds: `tools/image_writer.py::write_kind` with `k` (row
    filters, 16-bit grey at or past 255, short palettes, top-down, the
    bit-field layout by turns), written to .png or .bmp."""
    import io
    import os

    from PIL import Image

    from damc_tpu_torch.tools.image_writer import write_kind
    from damc_tpu_torch.tools.jpeg_writer import write_jpeg, write_lossless_jpeg

    w, h = int(size[0]), int(size[1])
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        k = start + i
        low = rng.integers(0, 256, (max(h // 16, 2), max(w // 16, 2), 3), dtype=np.uint8)
        pix = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR)).astype(np.int16)
        img = Image.fromarray(np.clip(pix + rng.integers(-6, 7, (h, w, 3)), 0, 255).astype(np.uint8))
        path = os.path.join(root, f"{k:06d}_{kind}." + ("jpg" if kind.startswith("jpeg") else kind.split("_")[0]))
        if kind in TREE_4D:
            with open(path, "wb") as f:
                f.write(write_kind(kind, np.asarray(img), k))
        elif kind == "webp_lossy":
            img.save(path, "WEBP", quality=(37 * k) % 101, method=k % 7)
        elif kind == "webp_lossless":
            if k % 4 == 0:
                img = img.quantize(16 if k % 8 else 200).convert("RGB")
            img.save(path, "WEBP", lossless=True, quality=(29 * k) % 101, method=k % 5)
        elif kind == "webp_alpha":
            alpha = rng.integers(0, 256, (h, w), dtype=np.uint8)
            alpha[: h // 4] = 0
            Image.fromarray(np.dstack([np.asarray(img), alpha]), "RGBA").save(path, "WEBP", quality=80,
                                                                               lossless=k % 2 == 1)
        elif kind == "webp_anim":
            frames = [img, img.transpose(Image.FLIP_LEFT_RIGHT), img.rotate(180)]
            frames[0].save(path, "WEBP", save_all=True, append_images=frames[1:], duration=50, lossless=k % 2 == 1)
        elif kind == "jpeg_progressive":
            kw = dict(quality=90, subsampling=0) if k % 2 else dict(quality=75, subsampling=2)
            if k % 4 == 1:
                kw["restart_marker_rows"] = 1
            img.save(path, "JPEG", progressive=True, **kw)
        elif kind in ("jpeg_arith", "jpeg_arith_progressive", "jpeg_lossless", "jpeg_smoothed"):
            pix = np.asarray(img)
            if kind == "jpeg_lossless":
                data = write_lossless_jpeg(pix, predictor=1 + k % 7, pt=k % 2)
            elif kind == "jpeg_smoothed":
                buf = io.BytesIO()
                img.save(buf, "JPEG", progressive=True, quality=75 + 15 * (k % 2), subsampling=2 * (1 - k % 2))
                data = buf.getvalue()
                scans = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
                data = data[:scans[1 + k % 6]] + b"\xff\xd9"
            else:
                sampling = [(1, 1)] * 3 if k % 2 else [(2, 2), (1, 1), (1, 1)]
                data = write_jpeg(pix, sampling, 90 if k % 2 else 75, arithmetic=True,
                                  progressive=kind == "jpeg_arith_progressive", restart=11 if k % 4 == 1 else 0)
            with open(path, "wb") as f:
                f.write(data)
        else:
            buf = io.BytesIO()
            img.convert("CMYK").save(buf, "JPEG", quality=85, progressive=k % 2 == 1)
            data = buf.getvalue()
            if kind == "jpeg_ycck":
                at = data.index(b"\xff\xee") + 4 + 11
                data = data[:at] + b"\x02" + data[at + 1:]
            with open(path, "wb") as f:
                f.write(data)


def write_4c_tree(root: str, size, seed: int) -> float:
    """Every kind of TREE_4C under root, written by up to 8 worker
    processes at once; returns the wall in seconds."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    t0 = time.perf_counter()
    workers = max(1, min(8, os.cpu_count() or 1))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        jobs = []
        for j, (kind, n) in enumerate(TREE_4C):
            per = -(-n // workers)
            jobs += [pool.submit(synthetic_4c_tree, root, kind, min(per, n - k * per), size,
                                 seed + 100 * j + k, k * per) for k in range(workers) if k * per < n]
        for job in jobs:
            job.result()
    return time.perf_counter() - t0


def decoders_4c_phase(cfg, counters):
    """Items 4c and 4d on the card's machine: the TREE_4C files (lossy,
    lossless, alpha and animated WebP; progressive, CMYK, YCCK,
    arithmetic-coded sequential and progressive, lossless and smoothed
    progressive JPEG; the TREE_4D PNG and BMP kinds at CelebA's 178x218);
    every file decoded by the port must equal PIL's `convert("RGB")` byte
    for byte, with the decode rates of each kind (host side: JPEG and
    WebP on 8 threads, and on 1 over their first ONE_THREAD_FILES; PNG and
    BMP, which have no thread pool, on 1; PIL on 1). Then a
    mixed celeba64 tree drawn from them (MIXED_TRAIN train, MIXED_TEST test
    images, hard links) through the train CLI at full width, 3 iterations
    at B=128 with --data_placement host (the last one timed: the first
    interval is first use): its cache celeba64_train_64.npy
    must equal the JAX package's PIL pipeline over the same files, K1 and
    K2 must launch once an iteration and every metric must be finite."""
    import io
    import os
    import shutil
    import tempfile

    from PIL import Image

    from damc_tpu_torch.data.images import decode_bmp, decode_parsed, parse_png
    from damc_tpu_torch.data.jpeg import decode_jpegs
    from damc_tpu_torch.data.webp import decode_webps
    from damc_tpu_torch.tools.image_writer import KINDS

    def decode_png_bmp(blobs, paths):
        """The port's PNG and BMP readers as the folder reader runs them: the
        PNGs through one `decode_parsed` (each pass shape unfiltered once),
        each BMP alone."""
        if paths[0].endswith(".png"):
            return decode_parsed([parse_png(b, p) for b, p in zip(blobs, paths)])
        return [decode_bmp(b, p) for b, p in zip(blobs, paths)]

    tmp = tempfile.mkdtemp(prefix="damc_4c_smoke_")
    reads, placements = [], []
    undo = [_record_reads(reads), _record_placements(placements)]
    try:
        every = os.path.join(tmp, "every")
        tree_s = write_4c_tree(every, CELEBA64_SIZE, SEED + 130)
        names = sorted(os.listdir(every))
        blobs = {}
        for name in names:
            with open(os.path.join(every, name), "rb") as f:
                blobs[name] = f.read()
        pil, rates, bad = {}, {}, []
        for kind, n in TREE_4C:
            group = [name for name in names if name.split("_", 1)[1].rsplit(".", 1)[0] == kind]
            data = [blobs[name] for name in group]
            pooled = kind not in TREE_4D
            decode = decode_webps if kind.startswith("webp") else decode_jpegs if pooled else decode_png_bmp
            decode(data[:1], group[:1])  # first use (the library's load), untimed, as PIL's below
            Image.open(io.BytesIO(data[0])).convert("RGB")
            rates[kind] = {"files": len(group), "bytes": sum(map(len, data))}
            if pooled:
                t0 = time.perf_counter()
                port = decode(data, group, threads=8)
                rates[kind]["port_8_threads_images_per_s"] = len(group) / (time.perf_counter() - t0)
                t0 = time.perf_counter()
                one = decode(data[:ONE_THREAD_FILES], group[:ONE_THREAD_FILES], threads=1)
                rates[kind]["port_1_thread_images_per_s"] = len(one) / (time.perf_counter() - t0)
            else:  # the PNG and BMP readers have no thread pool
                t0 = time.perf_counter()
                port = decode(data, group)
                rates[kind]["port_1_thread_images_per_s"] = len(group) / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            want = [np.asarray(Image.open(io.BytesIO(b)).convert("RGB")) for b in data]
            rates[kind]["pil_images_per_s"] = len(group) / (time.perf_counter() - t0)
            rates[kind]["port_1_thread_over_pil"] = rates[kind]["port_1_thread_images_per_s"] / rates[kind][
                "pil_images_per_s"]
            bad += [name for name, a, b in zip(group, port, want) if not np.array_equal(a, b)]
            pil.update(zip(group, want))
        print(f"[decoders_4c] {len(names)} files at {CELEBA64_SIZE[0]}x{CELEBA64_SIZE[1]} written in "
              f"{tree_s:.2f} s; differing from PIL's decode: {len(bad)}; host-side decode rates "
              + json.dumps(rates) + " " + card_line())
        if len(names) != sum(n for _, n in TREE_4C) or bad or TREE_4D != KINDS:
            raise AssertionError(f"the port's decode differs from PIL's: {bad[:5]} ({len(bad)} files), or the "
                                 "tree's PNG and BMP kinds are not image_writer.KINDS")
        data_dir, logs = os.path.join(tmp, "data"), os.path.join(tmp, "logs")
        order = np.random.default_rng(SEED + 131).permutation(len(names))
        splits = {"celeba64_train": order[:MIXED_TRAIN], "celeba64_test": order[MIXED_TRAIN:MIXED_TRAIN + MIXED_TEST]}
        for split, picks in splits.items():
            os.makedirs(os.path.join(data_dir, split))
            for i in picks:
                os.link(os.path.join(every, names[i]), os.path.join(data_dir, split, names[i]))
        train_names = sorted(names[i] for i in splits["celeba64_train"])
        kinds = sorted({name.split("_", 1)[1].rsplit(".", 1)[0] for name in train_names})
        n_fid = 500
        run = train_cli_run(cfg, counters, ["--dataset", "celeba64", "--data_path", data_dir, "--log_path", logs,
                                            "--seed", str(SEED), "--print_every", "1", "--n_fid_samples", str(n_fid),
                                            "--iterations", "3", "--eval_every", "0", "--plot_every", "0",
                                            "--data_placement", "host"],
                            logs, evals=[], plots=[], n_fid=n_fid, n_test=MIXED_TEST, tag="decoders_4c")
        cache = os.path.join(data_dir, "celeba64_train_64.npy")
        same = os.path.exists(cache) and np.array_equal(
            np.load(cache), pil_folder_pipeline([pil[name] for name in train_names], cfg.model.image_size))
        rows = [r for r in _jsonl(os.path.join(run["run"], "metrics.jsonl")) if r["phase"] == "train"]
        finite = all(np.isfinite(v) for r in rows for v in r.values() if isinstance(v, float))
        decoded = {os.path.basename(r["root"]): r["s"] for r in reads if r["what"] == "load_image_folder"}
        out = {"tree_s": tree_s, "rates": rates, "train_kinds": kinds, "placement": placements,
               "decode_s": decoded, "cache_equals_pil_pipeline": same, "train_rows": len(rows),
               "metrics_finite": finite, "launches": run["total"], "ms_per_iteration": run["ms"],
               "train_cli_wall_s": run["train_wall"]}
        del run["state"]
        print("[decoders_4c] mixed celeba64 tree " + json.dumps(out) + " " + card_line())
        if not same or not finite or placements != ["host"] or len(kinds) != len(TREE_4C):
            raise AssertionError("the mixed celeba64 run: cache, metrics, placement or kinds wrong")
        return out
    finally:
        for u in undo:
            u()
        shutil.rmtree(tmp, ignore_errors=True)


def celebahq_phase(cfg, counters):
    """celebaHQ (nz=128, ngf=128, 256x256, G up to 2048 channels) through the
    train CLI at full width in a temporary directory, on a PNG tree made
    from the seed at 512x512 (128 train and 16 test images; CELEBAHQ_SIZE
    says why not CelebA-HQ's 1024x1024): 2 iterations at B=128 (cut for time) with evals at 0 and at
    the end (500 FID
    samples, the 16-image recon-MSE set) and a checkpoint at the end; then
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
                "--iterations", "2", "--eval_every", "2", "--ckpt_every", "2", "--plot_every", "0",
                "--print_every", "1", "--n_fid_samples", str(n_fid)]
        t0 = time.perf_counter()
        info = train_cli_run(cfg, counters, argv, logs, evals=[0, 1], plots=[], n_fid=n_fid, n_test=CELEBAHQ_TEST,
                             tag="celebaHQ")
        decodes = {os.path.basename(r["root"]): r["s"] for r in reads if r["what"] == "load_image_folder"}
        cached = next(r for r in reads if r["what"] == "load_image_folder_cached")
        print(f"[celebaHQ] decode and resize of the train split ({CELEBAHQ_TRAIN} files) {decodes['train']:.2f} s, "
              f"of the test split ({CELEBAHQ_TEST}) {decodes['test']:.2f} s; the cache written and mapped "
              f"{cached['s'] - decodes['train']:.2f} s")
        ckpt = os.path.join(info["run"], "ckpt")
        if not {"1", "best"} <= set(os.listdir(ckpt)):
            raise AssertionError("ckpt/1 or ckpt/best is missing")
        del info["state"]
        store = cached["value"]
        x = torch.from_numpy(np.asarray(store[:cfg.train.batch_size])).cuda().float() / 255.0 * 2.0 - 1.0

        # One iteration from ckpt/1 with remat_generator off, then on.
        out = {}
        for remat in (False, True):
            c = dc.replace(cfg, train=dc.replace(cfg.train, remat_generator=remat))
            state = restore_checkpoint(ckpt, "1", create_state(c, SEED, "cuda"))
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
        state = restore_checkpoint(ckpt, "1", create_state(cfg, SEED, "cuda"))
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
# invert_batch is timed over one batch, to keep the script within about
# 800 s of its 1,200 s limit.
STYLEGAN_TRAIN_ITERATIONS, STYLEGAN_TIMED_BATCHES = 1, 1


LSUN_IMAGES = 64  # the LMDB's JPEGs; the CLI scores the first batch of STYLEGAN_B
LSUN_WEBP_IMAGES = 64  # a second LMDB of WebPs (item 4c), lossy and lossless by turns
LSUN_SIZES = ((256, 340), (340, 256), (256, 256), (200, 300), (300, 200), (180, 240), (128, 170), (96, 96))
# The LSUN eval CLI batches hold the reader, the CLI's dataset path and
# finite numbers, not the refine's outcome (the FFHQ runs hold that at the
# preset's 100 steps): their Adam refine takes 10 steps, cut for time.
LSUN_REFINE_STEPS = 10


def _lsun_db(root: str, n: int, seed: int, fmt: str) -> dict:
    """An LMDB (tests/lmdb_fixture.py) root/tower_val_lmdb of n seeded images
    of LSUN_SIZES written by PIL: JPEG (4:2:0, every third 4:4:4, quality
    85) or WebP (lossy at quality 80 and lossless by turns); returns
    {key: bytes}."""
    import io
    import os

    from PIL import Image

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from lmdb_fixture import build_lmdb

    rng = np.random.default_rng(seed)
    items = {}
    for i in range(n):
        w, h = LSUN_SIZES[i % len(LSUN_SIZES)]
        low = rng.integers(0, 256, (h // 16, w // 16, 3), dtype=np.uint8)
        img = np.asarray(Image.fromarray(low).resize((w, h), Image.BILINEAR)).astype(np.int16)
        img = np.clip(img + rng.integers(-6, 7, (h, w, 3)), 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        if fmt == "JPEG":
            Image.fromarray(img).save(buf, "JPEG", quality=85, subsampling=0 if i % 3 == 2 else 2)
        else:
            Image.fromarray(img).save(buf, "WEBP", quality=80, lossless=i % 2 == 1)
        items[f"{i:08d}".encode()] = buf.getvalue()
    build_lmdb(os.path.join(root, "tower_val_lmdb"), items)
    return items


def _lsun_check(root: str, items: dict, argv, counters, sweeps, tag: str) -> dict:
    """`LSUNImages` over root's tower_val database must read it bit-equal to
    the reference transform computed with PIL (decode, centre crop,
    LANCZOS), with its read rate beside PIL's; then the eval CLI with
    --dataset lsun_tower and `argv` over one batch of STYLEGAN_B: finite
    numbers, no K1 or K2 launch, the unfused sweep once."""
    import io
    import os

    from PIL import Image

    from damc_tpu_torch.cli import eval_stylegan_inv
    from damc_tpu_torch.data.datasets import LSUNImages

    n = len(items)
    t0 = time.perf_counter()
    got = LSUNImages(root, ["tower_val"], STYLEGAN_RES)[np.arange(n)]
    port_s = time.perf_counter() - t0

    def reference(data):
        img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        crop = min(img.shape[:2])
        top, left = (img.shape[0] - crop) // 2, (img.shape[1] - crop) // 2
        img = img[top:top + crop, left:left + crop]
        return np.asarray(Image.fromarray(img).resize((STYLEGAN_RES, STYLEGAN_RES), Image.LANCZOS))

    t0 = time.perf_counter()
    want = np.stack([reference(items[k]) for k in sorted(items)])
    pil_s = time.perf_counter() - t0
    same = np.array_equal(got, want)
    for k in counters.values():
        k.launches = 0
    n_sweeps = len(sweeps)
    t0 = time.perf_counter()
    out = eval_stylegan_inv.main(argv + ["--dataset", "lsun_tower", "--data_path", root, "--lsun_classes",
                                         "tower_val", "--limit", str(STYLEGAN_B), "--n_fid_samples", str(STYLEGAN_B),
                                         "--g_l_steps", str(LSUN_REFINE_STEPS)])
    cli_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    res = {"images": n, "sizes": LSUN_SIZES, "lmdb_bytes": os.path.getsize(
        os.path.join(root, "tower_val_lmdb", "data.mdb")),
        "port_read_images_per_s": n / port_s, "pil_images_per_s": n / pil_s,
        "equal_to_pil": same, "cli": {"wall_s": cli_s, **out}, "launches": launches,
        "unfused_sweeps": sweeps[n_sweeps:]}
    print(f"[{tag}] " + json.dumps(res) + " " + card_line())
    if not same:
        raise AssertionError(f"LSUNImages differs from PIL's transform at {np.argwhere((got != want).any((1, 2, 3)))}")
    if not all(np.isfinite(v) for v in out.values()) or any(launches.values()):
        raise AssertionError("the lsun_tower eval CLI printed a non-finite number or launched a kernel")
    if sweeps[n_sweeps:] != [STYLEGAN_B]:
        raise AssertionError(f"the lsun_tower batch must run the unfused sweep once: {sweeps[n_sweeps:]}")
    return res


def lsun_phase(tmp, argv, counters, sweeps):
    """LSUN-tower at the inversion's 256x256: an LMDB of LSUN_IMAGES seeded
    JPEGs of sizes up to 256x340, and one of LSUN_WEBP_IMAGES WebPs (lossy
    and lossless), each written by PIL and checked by `_lsun_check` (the
    read against PIL's transform, then one eval CLI batch of STYLEGAN_B
    from the StyleGAN phase's weights and checkpoint, LSUN_REFINE_STEPS
    refine steps: in float32 for the JPEGs, with the bf16 refine for the
    WebPs)."""
    import os

    out = {}
    for fmt, n, seed, tag, extra in (("JPEG", LSUN_IMAGES, SEED + 110, "lsun", []),
                                     ("WEBP", LSUN_WEBP_IMAGES, SEED + 111, "lsun-webp",
                                      ["--compute_dtype", "bfloat16"])):
        root = os.path.join(tmp, tag)
        t0 = time.perf_counter()
        items = _lsun_db(root, n, seed, fmt)
        write_s = time.perf_counter() - t0
        out[tag] = {"write_s": write_s, **_lsun_check(root, items, argv + extra, counters, sweeps, tag)}
    return out


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


def stylegan_phase(counters, tmp):
    """Item 6 at full size: resolution 256, nz = nxemb = 7168, the 1024-wide
    Q (313M weights), random StyleGAN weights from the seed in the reference
    layout, saved as .pth files; 16 seeded PNGs at 1024x1024, which the
    reader resizes to 256. With every launch count at 0:
    STYLEGAN_TRAIN_ITERATIONS iterations of `make_inversion_train_step` at
    B=8 (100 refine steps, 6 Q updates, each of which must change Q), Q
    saved in the port's checkpoint format, and the eval CLI once from it
    over the 16 images at --batch_size 8 (its rerun, which had to print the
    same numbers, was cut for time); then K1 and K2 must not have launched
    and the unfused sweep
    must have run once a batch (route "tables"). Then `nan_rescue` on a z0
    with one NaN row, the ms of `invert_batch` split into encoder, Q sweep,
    rescue, Adam refine and decode (CUDA events, the median of
    STYLEGAN_TIMED_BATCHES batches), images/s, peak memory, one batch under
    the profiler (idle share, top kernels) and the FLOP count beside its
    fp32 bound. Then the bf16 Adam refine (`compute_dtype` bfloat16): the
    eval CLI once with --compute_dtype bfloat16 from the same checkpoint
    over the same images, whose recon MSE must be within 5% of the float32
    run's (the bound of tests/test_cli_stylegan_inv.py) with no kernel
    launched, and the same split, images/s and peak memory, with the FLOP
    count beside
    the bf16 tensor-core bound. The files (weights, images, the Q
    checkpoint) are written under `tmp` and stay there for the
    data-parallel phase's inversion eval; the eval CLI's arguments are in
    the result ("argv"). Returns the numbers."""
    import os

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
        for it in range(STYLEGAN_TRAIN_ITERATIONS):
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
        if changed != [True] * (STYLEGAN_TRAIN_ITERATIONS * cfg.train.q_updates):
            raise AssertionError(f"every Q update must change Q: {changed}")
        ckpt = os.path.join(tmp, "ckpt")
        save_checkpoint(ckpt, "best", state)
        argv = ["--dataset", "ffhq", "--data_path", tree, "--resolution", str(STYLEGAN_RES),
                "--batch_size", str(STYLEGAN_B), "--n_fid_samples", str(STYLEGAN_IMAGES), "--seed", str(SEED),
                "--q_ckpt_dir", ckpt, "--q_ckpt_name", "best"] + [
                    a for f, p in paths.items() for a in (f"--pretrained_{f}_path", p)]
        # One run of the eval CLI: its rerun (equal output, about 28 s) was
        # cut to keep the script within its time limit.
        t1 = time.perf_counter()
        cli = [{**eval_stylegan_inv.main(argv), "wall_s": time.perf_counter() - t1}]
        launches = {k: c.launches for k, c in counters.items()}
        print("[stylegan] eval CLI " + json.dumps({"runs": cli, "launches": launches, "unfused_sweeps": sweeps}))
        if not all(np.isfinite(v) for k, v in cli[0].items()):
            raise AssertionError("non-finite eval CLI metrics")
        if any(launches.values()):
            raise AssertionError(f"the StyleGAN path launched a kernel: {launches}")
        n_batches = -(-STYLEGAN_IMAGES // STYLEGAN_B)
        if sweeps != [STYLEGAN_B] * (STYLEGAN_TRAIN_ITERATIONS + n_batches):
            raise AssertionError(f"the unfused sweep must run once a batch: {sweeps}")
        lsun = lsun_phase(tmp, argv, counters, sweeps)

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
        draws = [inv.inversion_draws(inv.batch_generator(SEED, i, "cuda"), STYLEGAN_B, q.nz, q.n_interval)
                 for i in range(STYLEGAN_TIMED_BATCHES)]

        def split_run(compute_dtype):
            """(median ms of invert_batch over `draws`, its split, peak GiB)."""
            spans = _Spans()
            patched = {name: getattr(inv, name) for name in ("sample_q", "nan_rescue", "adam_latent_descent")}
            timed = dataclasses.replace(nets, encoder=spans.wrap("encoder", nets.encoder))
            try:
                for name, fn in patched.items():
                    setattr(inv, name, spans.wrap(name, fn))
                run = spans.wrap("total", lambda d: inv.invert_batch(q, timed, x, d, STYLEGAN_REFINE, 0.01,
                                                                     compute_dtype=compute_dtype))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for d in draws:
                    run(d)
                torch.cuda.synchronize()
            finally:
                for name, fn in patched.items():
                    setattr(inv, name, fn)
            parts = {"encoder": "encoder", "q_sweep": "sample_q", "rescue": "nan_rescue",
                     "refine": "adam_latent_descent"}
            split = {k: statistics.median(spans.ms(v)) for k, v in parts.items()}
            total = statistics.median(spans.ms("total"))
            split["decode_and_rest"] = total - sum(split.values())
            return total, split, torch.cuda.max_memory_allocated() / 2**30

        # The training iterations ran invert_batch already: no warm-up here.
        total, split, peak = split_run(torch.float32)
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
            "train": train, "eval_cli": cli, "tree_s": tree_s, "decode_s": decode_s, "lsun": lsun,
        }
        print("[stylegan] " + json.dumps(res))

        # The bf16 Adam refine: the eval CLI once (which also warms the bf16
        # convolutions up), then the split.
        for k in counters.values():
            k.launches = 0
        t1 = time.perf_counter()
        out16 = eval_stylegan_inv.main(argv + ["--compute_dtype", "bfloat16"])
        cli16 = {"wall_s": time.perf_counter() - t1, **out16}
        launches16 = {k: c.launches for k, c in counters.items()}
        gap = abs(out16["recon_mse"] - cli[0]["recon_mse"]) / cli[0]["recon_mse"]
        print("[stylegan_bf16] eval CLI " + json.dumps({"run": cli16, "launches": launches16,
                                                        "recon_mse_gap_to_fp32": gap}))
        if not all(np.isfinite(v) for v in out16.values()):
            raise AssertionError("non-finite bf16 eval CLI metrics")
        if gap >= 0.05:
            raise AssertionError(f"the bf16 recon MSE is {gap:.3%} from the float32 run's (limit 5%)")
        if any(launches16.values()):
            raise AssertionError(f"the bf16 StyleGAN path launched a kernel: {launches16}")
        total16, split16, peak16 = split_run(torch.bfloat16)
        bound16_ms, _ = bound(flops["total"], 0.0, peak_rate("bfloat16"))
        res["bf16"] = {
            "b": STYLEGAN_B, "ms_per_invert_batch": total16, "split_ms": split16,
            "images_per_s": STYLEGAN_B / total16 * 1e3, "peak_gib_invert_batch": peak16,
            "bf16_bound_ms": bound16_ms, "bound_share": bound16_ms / total16, "eval_cli": cli16,
        }
        print("[stylegan_bf16] " + json.dumps(res["bf16"]))
        return {**res, "argv": argv}
    finally:
        amortizer_module.reverse_diffusion_sample = original_sweep


# The data-parallel phase: two ranks of a torch.distributed group share the
# one card over gloo (nccl refuses two ranks on one card), each a process
# started here with torchrun's environment.
DP_WORLD = 2
DP_TIMEOUT_S = 600  # the whole group: it is killed and the phase fails after this
DP_ITERATIONS = 3  # the fewest that leave a timed step (`_dp_cli`)
DP_TRAIN_IMAGES, DP_TEST_IMAGES, DP_FID = 2_000, 500, 500
DP_K1_SHAPES = ((256, 60, 0.4), (500, 60, 0.4))  # the 2B training chains; the loop's EBM-prior FID batch
DP_K2_SHAPES = ((128, "encoder"), (500, "prior"))  # Q_ema's training rows; the DAMC-prior FID batch
# The anomaly workload's (nz=8): its B single chains, Q_ema's rows, the AUPRC batch.
DP_ANOMALY_K1_SHAPES = ((128, 60, 0.4),)
DP_ANOMALY_K2_SHAPES = ((128, "encoder"), (500, "encoder"))
DP_ANOMALY_ITERATIONS, DP_ANOMALY_EVAL_EVERY = 3, 3  # the fewest that leave a timed step


def _dp_noises(b, gen, dev):
    import torch

    seeds = torch.randint(-2**31, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).to(dev)
    return {"stream": dict(seed=-987654321), "counter": dict(row_seeds=seeds), "noiseless": dict(with_noise=False)}


def _dp_turns(mesh, fn):
    """fn() on one rank at a time, the others waiting at a barrier, so that
    a rank's time is not shared with its peer's work on the card."""
    import torch.distributed as dist

    out = None
    for r in range(mesh.world):
        if mesh.rank == r:
            out = fn()
        dist.barrier()
    return out


def _dp_kernels(mesh, models, cfg, k1_shapes, k2_shapes, seed):
    """K4a and K4b on the card at `k1_shapes` ((B, steps, step size)) and
    `k2_shapes` ((B, "encoder" or "prior"): the tables of Q's encoder of
    images or of the prior embedding of noise): at each shape and noise
    mode the gathered result of the ranks must equal one unsharded K1 or K2
    launch bit for bit, and so must each rank's own launch (its rows at its
    row_base) in stream mode; that launch is then held against the plain
    version on the same rows and timed (`chain_check`, `sweep_check`), one
    rank at a time."""
    import torch

    from damc_tpu_torch.ops.cuda.fused_langevin import (
        ebm_params_to_dense_weights, fused_prior_langevin, fused_prior_langevin_sharded,
    )
    from damc_tpu_torch.ops.cuda.fused_qsweep import (
        denoiser_layer_params, fused_reverse_sweep, fused_reverse_sweep_sharded,
    )
    from damc_tpu_torch.ops.diffusion import step_coefficients, sweep_logsnr_grid

    dev, m, d = mesh.device, cfg.model, cfg.diffusion
    gen = torch.Generator(device="cpu").manual_seed(seed)  # the same draws on every rank
    ebm_w = ebm_params_to_dense_weights(models.ebm)
    fourier, layers = denoiser_layer_params(models.amortizer.p)
    grid, _ = sweep_logsnr_grid(d.n_interval, d.logsnr_min, d.logsnr_max)
    coeffs = step_coefficients(d.n_interval, d.logsnr_min, d.logsnr_max, d.var_type).to(dev)
    res, equal = {}, {}
    for b, steps, size in k1_shapes:
        z = torch.randn(b, m.nz, generator=gen).to(dev)
        local = b // mesh.world
        rows = slice(mesh.rank * local, (mesh.rank + 1) * local)
        for mode, noise in _dp_noises(b, gen, dev).items():
            kw = dict(steps=steps, step_size=size, **noise)
            whole = fused_prior_langevin(z, *ebm_w, **kw)
            equal[f"K4a B={b} {mode}"] = bool(torch.equal(fused_prior_langevin_sharded(mesh, z, *ebm_w, **kw), whole))
            if mode == "stream":
                own = fused_prior_langevin(z[rows], *ebm_w, row_base=rows.start, **kw)
                equal[f"K4a B={b} stream, own rows"] = bool(torch.equal(own, whole[rows]))
                res[f"K4a_{b}"] = _dp_turns(mesh, lambda: chain_check(
                    ebm_w, z[rows], dict(noise, row_base=rows.start), steps, size,
                    f"K4a rank {mesh.rank}, rows {rows.start}-{rows.stop - 1} of {b}"))
    for b, tables in k2_shapes:
        z = torch.randn(b, m.nz, generator=gen).to(dev)
        with torch.no_grad():
            if tables == "encoder":  # a training or scoring batch: Q's encoder of images
                x = torch.rand(b, m.image_size, m.image_size, m.nc, generator=gen).to(dev) * 2 - 1
                xemb = models.amortizer.encode(x)
            else:  # the DAMC-prior FID batch: the prior embedding of noise
                xemb = models.amortizer.prior_embed(torch.randn(b, m.nz, generator=gen).to(dev))
            t = models.amortizer.p.sample_tables(grid.to(dev), xemb)
        local = b // mesh.world
        rows = slice(mesh.rank * local, (mesh.rank + 1) * local)
        for mode, noise in _dp_noises(b, gen, dev).items():
            kw = dict(steps=d.n_interval, residual=d.residual, **noise)
            args = (fourier, layers, t["pre_x"], t["pre_t"], coeffs)
            whole = fused_reverse_sweep(z, *args, **kw)
            equal[f"K4b B={b} {mode}"] = bool(torch.equal(fused_reverse_sweep_sharded(mesh, z, *args, **kw), whole))
            if mode == "stream":
                own = fused_reverse_sweep(z[rows], fourier, layers, [p[rows] for p in t["pre_x"]], t["pre_t"],
                                          coeffs, row_base=rows.start, **kw)
                equal[f"K4b B={b} stream, own rows"] = bool(torch.equal(own, whole[rows]))
                res[f"K4b_{b}"] = _dp_turns(mesh, lambda: sweep_check(
                    models, cfg, z[rows], xemb[rows], dict(noise, row_base=rows.start),
                    f"K4b rank {mesh.rank}, rows {rows.start}-{rows.stop - 1} of {b}")[local])
    return res, equal


def _digest(state) -> str:
    """sha256 of every tensor of a TrainState's networks, in order."""
    import hashlib

    import torch

    from damc_tpu_torch.train.driver_utils import state_tensors

    h = hashlib.sha256()
    for t in state_tensors(state):
        h.update(t.detach().cpu().contiguous().view(-1).view(dtype=torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dp_cli(mesh, main, argv, step_module, eval_name=None):
    """A train CLI's `main(argv)` on this rank, counted: the launches, rows
    and row_base of K1 and K2 in each training step (`step_module`'s
    `make_train_step`), those of each call of `step_module.<eval_name>`,
    the files this rank wrote, a CUDA event after each step, the final
    state's digest."""
    import torch

    from damc_tpu_torch.models import amortizer
    from damc_tpu_torch.ops import langevin
    from damc_tpu_torch.ops.cuda.fused_langevin import fused_prior_langevin
    from damc_tpu_torch.ops.cuda.fused_qsweep import fused_reverse_sweep
    from damc_tpu_torch.train import driver_utils, gen_recon
    from damc_tpu_torch.train import step as step_module_
    from damc_tpu_torch.utils import logging as port_logging

    counters = {"K1": fused_prior_langevin, "K2": fused_reverse_sweep}
    rows, steps, evals, events = [], [], [], []
    writes = {"checkpoints": [], "grids": [], "metrics": []}
    reduce_s = [0.0]  # host seconds in the step's all-reduces (gradients, metrics), synchronised
    all_mean = step_module_.all_mean

    def timed_mean(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = all_mean(*a, **kw)
        torch.cuda.synchronize()
        reduce_s[0] += time.perf_counter() - t0
        return out
    chain, sweep, make_step = langevin.fused_prior_langevin_sharded, amortizer.fused_reverse_sweep, step_module.make_train_step
    save, grid, log = driver_utils.save_checkpoint, gen_recon.save_image_grid, port_logging.MetricsLogger.log
    evaluate = getattr(step_module, eval_name) if eval_name else None

    def chain_rec(mesh_, z, *a, **kw):
        rows.append(("K1", z.shape[0] // mesh_.world, mesh_.rank * (z.shape[0] // mesh_.world)))
        return chain(mesh_, z, *a, **kw)

    def sweep_rec(z, *a, **kw):
        rows.append(("K2", z.shape[0], kw.get("row_base", 0)))
        return sweep(z, *a, **kw)

    def counted(fn, into):
        def run(*a, **kw):
            before, n = {k: c.launches for k, c in counters.items()}, len(rows)
            reduce_s[0] = 0.0
            out = fn(*a, **kw)
            into.append({"launches": {k: c.launches - before[k] for k, c in counters.items()}, "rows": rows[n:],
                         "all_reduce_ms": reduce_s[0] * 1e3})
            if into is steps:
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                events.append(event)
            return out

        return run

    langevin.fused_prior_langevin_sharded, amortizer.fused_reverse_sweep = chain_rec, sweep_rec
    step_module.make_train_step = lambda *a, **kw: counted(make_step(*a, **kw), steps)
    step_module_.all_mean = timed_mean
    if evaluate is not None:
        setattr(step_module, eval_name, counted(evaluate, evals))
    driver_utils.save_checkpoint = lambda d, name, st: (writes["checkpoints"].append(name), save(d, name, st))[1]
    gen_recon.save_image_grid = lambda a, path, **kw: (writes["grids"].append(path), grid(a, path, **kw))[1]
    port_logging.MetricsLogger.log = lambda self, *a, **kw: (
        writes["metrics"].append(self.path) if self.path else None, log(self, *a, **kw))[1]
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    try:
        out = main(argv)
    finally:
        langevin.fused_prior_langevin_sharded, amortizer.fused_reverse_sweep = chain, sweep
        step_module.make_train_step, driver_utils.save_checkpoint, gen_recon.save_image_grid = make_step, save, grid
        port_logging.MetricsLogger.log, step_module_.all_mean = log, all_mean
        if evaluate is not None:
            setattr(step_module, eval_name, evaluate)
    torch.cuda.synchronize()
    state = out[0] if isinstance(out, tuple) else out
    return {
        "wall_s": time.perf_counter() - t0, "steps": steps, "evals": evals, "step": int(state.step),
        "digest": _digest(state), "launches": {k: c.launches for k, c in counters.items()}, "writes": writes,
        # between the events of steps 2-3 and 3-4: step 1's interval holds the evals and grids of iteration 0
        "ms_per_iteration": [a.elapsed_time(b) for a, b in zip(events[1:], events[2:])],
    }


def _dp_train(mesh, spec):
    """`cli.train_gen_recon --use_mesh` on this rank, counted (`_dp_cli`)."""
    from damc_tpu_torch.cli import train_gen_recon
    from damc_tpu_torch.train import gen_recon

    return _dp_cli(mesh, train_gen_recon.main, [
        "--dataset", "cifar10", "--data_path", spec["data"], "--log_path", spec["logs"],
        "--seed", str(SEED), "--iterations", str(DP_ITERATIONS), "--n_fid_samples", str(DP_FID),
        "--eval_every", "1000", "--ckpt_every", "1000", "--plot_every", "1000", "--print_every", "1",
        "--use_mesh", "--dist_backend", "gloo",
    ], gen_recon)


def _dp_anomaly(mesh, spec):
    """The anomaly workload on this rank: K4a and K4b at its shapes (nz=8),
    `cli.train_anomaly_det --use_mesh` (DP_ANOMALY_ITERATIONS iterations
    at global B=128, AUPRC evals at 0 and at the end, a checkpoint),
    counted (`_dp_cli`), then `cli.eval_anomaly_det --use_mesh` on the
    run's ckpt/best with its K2 launches and rows."""
    import os

    import torch

    from damc_tpu_torch.cli import eval_anomaly_det, train_anomaly_det
    from damc_tpu_torch.config import preset
    from damc_tpu_torch.models import amortizer, build_models
    from damc_tpu_torch.ops.cuda.fused_qsweep import fused_reverse_sweep
    from damc_tpu_torch.train import anomaly

    cfg = preset("mnist_anomaly")
    models = build_models(cfg, seed=SEED, device=mesh.device)
    kernels, equal = _dp_kernels(mesh, models, cfg, DP_ANOMALY_K1_SHAPES, DP_ANOMALY_K2_SHAPES, SEED + 91)
    del models
    common = ["--data_path", spec["mnist"], "--seed", str(SEED), "--label", str(cfg.train.heldout_digit),
              "--use_mesh", "--dist_backend", "gloo"]
    train = _dp_cli(mesh, train_anomaly_det.main, common + [
        "--log_path", spec["anomaly_logs"], "--iterations", str(DP_ANOMALY_ITERATIONS),
        "--eval_every", str(DP_ANOMALY_EVAL_EVERY), "--ckpt_every", "1000", "--print_every", "1"],
        anomaly, "evaluate_auprc")
    (run,) = os.listdir(os.path.join(spec["anomaly_logs"], "mnist"))
    ckpt = os.path.join(spec["anomaly_logs"], "mnist", run, "ckpt")
    rows, sweep = [], amortizer.fused_reverse_sweep
    amortizer.fused_reverse_sweep = lambda z, *a, **kw: (rows.append((z.shape[0], kw.get("row_base", 0))),
                                                         sweep(z, *a, **kw))[1]
    fused_reverse_sweep.launches = 0
    t0 = time.perf_counter()
    try:
        score = eval_anomaly_det.main(common + ["--log_path", spec["anomaly_logs"], "--ckpt_dir", ckpt])
    finally:
        amortizer.fused_reverse_sweep = sweep
    torch.cuda.synchronize()
    cli = {"auprc": score, "wall_s": time.perf_counter() - t0, "K2": fused_reverse_sweep.launches, "rows": rows,
           "ckpt": ckpt}
    return {"kernels": kernels, "equal": equal, "train": train, "eval_cli": cli}


def _dp_inversion(mesh, spec):
    """`cli.eval_stylegan_inv --use_mesh` on this rank over the stylegan
    phase's files (its weights, images and Q checkpoint): its numbers, K1
    and K2 launches and the unfused sweep's rows."""
    import torch

    from damc_tpu_torch.cli import eval_stylegan_inv
    from damc_tpu_torch.models import amortizer
    from damc_tpu_torch.ops.cuda.fused_langevin import fused_prior_langevin
    from damc_tpu_torch.ops.cuda.fused_qsweep import fused_reverse_sweep

    counters = {"K1": fused_prior_langevin, "K2": fused_reverse_sweep}
    sweeps, original = [], amortizer.reverse_diffusion_sample
    amortizer.reverse_diffusion_sample = lambda *a, **kw: (sweeps.append(a[1].shape[0]), original(*a, **kw))[1]
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    try:
        out = eval_stylegan_inv.main(spec["stylegan_argv"] + ["--use_mesh", "--dist_backend", "gloo"])
    finally:
        amortizer.reverse_diffusion_sample = original
    torch.cuda.synchronize()
    return {"out": out, "wall_s": time.perf_counter() - t0, "launches": {k: c.launches for k, c in counters.items()},
            "sweeps": sweeps}


def _dp_tp(mesh):
    """One forward of the 256x256 synthesis (random weights from the seed)
    with its wide parameters channel-sharded over the ranks
    (`parallel/tp.py`) against the replicated forward on the same W+
    codes: the errors, the elements this rank holds and the wall."""
    import torch

    from damc_tpu_torch.models.stylegan import build_stylegan, num_synthesis_layers
    from damc_tpu_torch.parallel import channel_sharding_tree, shard_params_channelwise

    gen = build_stylegan(STYLEGAN_RES, SEED, mesh.device).generator
    g = torch.Generator(device="cpu").manual_seed(SEED + 92)
    wp = torch.randn(2, num_synthesis_layers(STYLEGAN_RES) * 512, generator=g).to(mesh.device)
    with torch.no_grad():
        want = gen(wp)
        total = sum(p.numel() for p in gen.parameters())
        tree = channel_sharding_tree(mesh, gen, 64)
        shard_params_channelwise(mesh, gen, 64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = gen(wp)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ok = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-5))
    return {"max_abs_err": float((got - want).abs().max()), "within_rtol_1e-4_atol_1e-5": ok,
            "bit_equal": bool(torch.equal(got, want)), "sharded_leaves": sum(d is not None for d in tree.values()),
            "leaves": len(tree), "elements_held": sum(p.numel() for p in gen.parameters()), "elements": total,
            "forward_ms": wall * 1e3}


def dp_rank() -> int:
    """One rank of the data-parallel phase (started by `dp_phase` with
    torchrun's environment and its spec as the one argument): joins the
    group over gloo on the card, checks K4a and K4b, runs the card-vs-world-1
    iteration on its rows, trains through the CLI; then the anomaly
    workload (`_dp_anomaly`), the inversion eval (`_dp_inversion`) and the
    channel-sharded synthesis (`_dp_tp`); and writes its readings to
    <out>/rank<r>.json (and the iteration to <out>/iteration<r>.pt)."""
    import os

    import torch

    from damc_tpu_torch.config import preset
    from damc_tpu_torch.device import resolve_device
    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.parallel.distributed import global_mesh, initialize_distributed, shutdown_distributed

    spec = json.loads(sys.argv[1])
    resolve_device("cuda")
    initialize_distributed(backend="gloo", device="cuda", timeout_s=DP_TIMEOUT_S)
    try:
        mesh = global_mesh("cuda")
        print(f"[train_dp] rank {mesh.rank} of {mesh.world} on {mesh.device} ({torch.distributed.get_backend()})",
              flush=True)
        cfg = preset("cifar10")
        models = build_models(cfg, seed=SEED, device=mesh.device)
        kernels, equal = _dp_kernels(mesh, models, cfg, DP_K1_SHAPES, DP_K2_SHAPES, SEED + 90)
        del models
        small, x, draws, z0 = small_iteration_inputs(cfg)
        iteration, _ = _one_iteration(small, mesh.device, x, draws, z0, mesh=mesh)
        torch.save(iteration, os.path.join(spec["out"], f"iteration{mesh.rank}.pt"))
        train = _dp_train(mesh, spec)
        out = {"kernels": kernels, "equal": equal, "train": train, "anomaly": _dp_anomaly(mesh, spec),
               "inversion": _dp_inversion(mesh, spec), "tp": _dp_tp(mesh)}
        with open(os.path.join(spec["out"], f"rank{mesh.rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        shutdown_distributed()
    return 0


INV_MESH_RTOL = 1e-3  # the two-rank inversion's recon MSE against one process's (4 rows a rank's convolutions, not 8)


def _dp_anomaly_checks(an, cfg, mnist, logs, n_anomalous):
    """The parent's checks of the ranks' anomaly readings (`_dp_anomaly`),
    and the one-process eval CLI on the same checkpoint. Returns the
    readings the kernels line needs."""
    import os

    from damc_tpu_torch.cli import eval_anomaly_det
    from damc_tpu_torch.train.anomaly import EVAL_BATCH

    for key in an[0]["equal"]:
        print(f"[anomaly_dp] {key}: gathered over {DP_WORLD} ranks == one launch, bit for bit: "
              f"{[a['equal'][key] for a in an]}")
    if not all(all(a["equal"].values()) for a in an):
        raise AssertionError("a sharded kernel's gathered result differs from the unsharded launch (nz=8)")
    b, auprc_b = cfg.train.batch_size, EVAL_BATCH
    n_batches = -(-ANOMALY_TEST_IMAGES // auprc_b)
    for r, a in enumerate(an):
        for key, k in a["kernels"].items():
            b_ms, by = bound(k["flops"], k["bytes"])
            print(f"[anomaly_dp] rank {r} {key} stream, its {k['b']} rows: kernel {k['ms']:.4f} ms, plain "
                  f"{k['plain_ms']:.4f} ms, bound {b_ms:.5g} ms ({by}), kernel-plain {k['max_abs_err']:.3e}")
        t, cli = a["train"], a["eval_cli"]
        print(f"[anomaly_dp] rank {r}: steps {t['step']}, per step " + json.dumps(t["steps"]) + "; AUPRC evals "
              + json.dumps([e["launches"] for e in t["evals"]]) + f"; whole run {t['launches']}; writes "
              + json.dumps(t["writes"]) + f"; eval CLI AUPRC {cli['auprc']}, K2 {cli['K2']} at rows {cli['rows']}")
        local, eval_local = b // DP_WORLD, auprc_b // DP_WORLD
        want_rows = [["K2", local, r * local], ["K1", local, r * local]]
        if any(s["launches"] != {"K1": 1, "K2": 1} or s["rows"] != want_rows for s in t["steps"]):
            raise AssertionError(f"rank {r}: a step launched other than K1 and K2 once at {want_rows}")
        eval_rows = [["K2", eval_local, r * eval_local]] * n_batches
        if len(t["evals"]) != 2 or any(e["launches"] != {"K1": 0, "K2": n_batches} or e["rows"] != eval_rows
                                       for e in t["evals"]):
            raise AssertionError(f"rank {r}: the AUPRC evals did not launch K2 once a batch at its rows")
        if t["step"] != DP_ANOMALY_ITERATIONS or len(t["steps"]) != DP_ANOMALY_ITERATIONS:
            raise AssertionError(f"rank {r} took {t['step']} steps")
        if cli["K2"] != n_batches or cli["rows"] != [[eval_local, r * eval_local]] * n_batches:
            raise AssertionError(f"rank {r}: the eval CLI launched K2 {cli['K2']} times at {cli['rows']}")
    if len({a["train"]["digest"] for a in an}) != 1 or len({a["eval_cli"]["auprc"] for a in an}) != 1:
        raise AssertionError("the anomaly replicas, or the ranks' AUPRCs, differ")
    if any(an[1]["train"]["writes"][k] for k in an[1]["train"]["writes"]):
        raise AssertionError("a rank other than 0 wrote a log or checkpoint")
    (run,) = os.listdir(os.path.join(logs, "mnist"))
    ckpts = sorted(os.listdir(os.path.join(logs, "mnist", run, "ckpt")))
    rows = _jsonl(os.path.join(logs, "mnist", run, "metrics.jsonl"))
    evals = [(r["step"], r["auprc"]) for r in rows if r["phase"] == "eval"]
    print(f"[anomaly_dp] one run directory; checkpoints {ckpts}; eval rows (step, AUPRC) {evals}")
    last = DP_ANOMALY_ITERATIONS - 1
    if ckpts != [str(last), "best"] or [e[0] for e in evals] != [0, last] or not all(0 < e[1] <= 1 for e in evals):
        raise AssertionError("the anomaly run lacks its checkpoints or eval rows, or an AUPRC is out of (0, 1]")
    ckpt = an[0]["eval_cli"]["ckpt"]
    t0 = time.perf_counter()
    one = eval_anomaly_det.main(["--data_path", mnist, "--seed", str(SEED), "--label", str(cfg.train.heldout_digit),
                                 "--log_path", logs, "--ckpt_dir", ckpt])
    one_s = time.perf_counter() - t0
    mesh_auprc, limit = an[0]["eval_cli"]["auprc"], 2.0 / n_anomalous
    print(f"[anomaly_dp] eval CLI AUPRC: two ranks {mesh_auprc}, one process {one} (|diff| "
          f"{abs(mesh_auprc - one):.3e}, limit 2 / {n_anomalous} anomalous = {limit:.3e}); walls s: two ranks "
          f"{an[0]['eval_cli']['wall_s']:.2f}, one process {one_s:.2f}")
    if abs(mesh_auprc - one) > limit:
        raise AssertionError("the two-rank eval CLI's AUPRC is not the one-process CLI's")
    return {r: {"train": a["train"]["launches"], "steps": DP_ANOMALY_ITERATIONS, "eval_cli_K2": a["eval_cli"]["K2"]}
            for r, a in enumerate(an)}


def _dp_inversion_checks(inv, stylegan):
    """The parent's checks of the ranks' inversion eval (`_dp_inversion`)
    against the stylegan phase's one-process run on the same files."""
    one = {k: v for k, v in stylegan["eval_cli"][0].items() if k != "wall_s"}
    n_batches = -(-STYLEGAN_IMAGES // STYLEGAN_B)
    for r, i in enumerate(inv):
        print(f"[stylegan_dp] rank {r}: " + json.dumps(i))
        if any(i["launches"].values()) or i["sweeps"] != [STYLEGAN_B // DP_WORLD] * n_batches:
            raise AssertionError(f"rank {r}: K1 or K2 launched, or the unfused sweep did not run once a batch "
                                 "on the rank's rows")
    if inv[0]["out"] != inv[1]["out"]:
        raise AssertionError("the ranks printed different inversion numbers")
    got = inv[0]["out"]
    rel = abs(got["recon_mse"] - one["recon_mse"]) / one["recon_mse"]
    print(f"[stylegan_dp] {card_line()}: {STYLEGAN_IMAGES} images at B={STYLEGAN_B}, {STYLEGAN_B // DP_WORLD} a "
          f"rank: two ranks {got} in {inv[0]['wall_s']:.1f} s; one process (stylegan phase) {one} in "
          f"{stylegan['eval_cli'][0]['wall_s']:.1f} s; recon MSE relative difference {rel:.3e} (limit "
          f"{INV_MESH_RTOL:g})")
    if rel > INV_MESH_RTOL or not all(np.isfinite(v) for v in got.values()):
        raise AssertionError("the two-rank inversion's recon MSE is not the one-process run's")


def dp_phase(cfg, train_ms, stylegan):
    """The data-parallel paths on the card: DP_WORLD ranks (`dp_rank`), one
    process each, sharing the H100 over gloo, with a hard timeout on the
    group. gen_recon: K4a and K4b at the training and FID shapes in stream,
    counter and noiseless mode, gathered, must equal one K1 or K2 launch
    bit for bit; DP_ITERATIONS iterations of `cli.train_gen_recon
    --use_mesh` at full cifar10 width and global B=128 on a CIFAR-10 tree
    made from the seed (evals at 0 and at the end with DP_FID samples, a
    checkpoint): K1 and K2 once a step on each rank at 128 and 64 rows, the
    replicas equal bit for bit, only rank 0 writes; and one iteration of
    the card-vs-CPU configuration on two ranks against the same iteration
    in one process on the card, within FP32_LIMITS. The anomaly workload
    (nz=8, full width): K4a and K4b at its shapes, gathered, equal to one
    launch bit for bit; DP_ANOMALY_ITERATIONS iterations of
    `cli.train_anomaly_det --use_mesh` at global B=128 on a seeded
    mnist.npz (AUPRC evals at 0 and at the end, a checkpoint): K1 and K2
    once a step on each rank at its 64 rows, K2 once an AUPRC batch at its
    250 of 500 rows, replicas equal, only rank 0 writes; then
    `cli.eval_anomaly_det --use_mesh` on ckpt/best, whose AUPRC must be
    the one-process eval CLI's within 2 / (the anomalous count), which one
    pair of scores trading places may move it by. The inversion eval CLI
    with `--use_mesh` over the stylegan phase's files (`stylegan`, its
    result), 4 images a rank of each batch of STYLEGAN_B: recon MSE within
    INV_MESH_RTOL of the stylegan phase's one-process run, no K1 or K2.
    The 256x256 synthesis channel-sharded over the ranks (`parallel/tp.py`)
    against the replicated forward, at rtol 1e-4, atol 1e-5. Returns each
    rank's readings."""
    import os
    import shutil
    import socket
    import subprocess
    import tempfile

    import torch

    from damc_tpu_torch.config import preset

    tmp = tempfile.mkdtemp(prefix="damc_dp_smoke_")
    procs, logs = [], []
    try:
        data, logdir = os.path.join(tmp, "data"), os.path.join(tmp, "logs")
        write_cifar_tree(data, DP_TRAIN_IMAGES, DP_TEST_IMAGES)
        cfg_anomaly = preset("mnist_anomaly")
        mnist, anomaly_logs = os.path.join(tmp, "mnist"), os.path.join(tmp, "anomaly_logs")
        n_anomalous = write_mnist(mnist, cfg_anomaly.train.heldout_digit, "anomaly_dp")
        spec = json.dumps({"data": data, "logs": logdir, "out": tmp, "mnist": mnist, "anomaly_logs": anomaly_logs,
                           "stylegan_argv": stylegan["argv"]})
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        for r in range(DP_WORLD):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DP_WORLD), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(DP_WORLD), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.dp_rank())", spec],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT, cwd=os.path.dirname(os.path.abspath(__file__))))
        deadline = time.monotonic() + DP_TIMEOUT_S
        for p in procs:
            try:
                p.wait(max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                pass
        wall = time.perf_counter() - t0
        codes = [p.poll() for p in procs]
        for r, f in enumerate(logs):
            f.seek(0)
            for line in f.read().splitlines()[-60:]:
                print(f"[train_dp rank {r}] {line}")
        if codes != [0] * DP_WORLD:
            raise AssertionError(f"the data-parallel ranks ended with {codes} (None: killed at {DP_TIMEOUT_S} s)")
        ranks = []
        for r in range(DP_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))

        # 1. The sharded kernels.
        for key in ranks[0]["equal"]:
            print(f"[train_dp] {key}: gathered over {DP_WORLD} ranks == one launch, bit for bit: "
                  f"{[rk['equal'][key] for rk in ranks]}")
        if not all(all(rk["equal"].values()) for rk in ranks):
            raise AssertionError("a sharded kernel's gathered result differs from the unsharded launch")
        for r, rk in enumerate(ranks):
            for key, k in rk["kernels"].items():
                b_ms, by = bound(k["flops"], k["bytes"])
                print(f"[train_dp] rank {r} {key} stream, its {k['b']} rows: kernel {k['ms']:.4f} ms, plain "
                      f"{k['plain_ms']:.4f} ms, bound {b_ms:.5g} ms ({by}), kernel-plain {k['max_abs_err']:.3e}")

        # 2. Training.
        trains = [rk["train"] for rk in ranks]
        b = cfg.train.batch_size
        for r, t in enumerate(trains):
            print(f"[train_dp] rank {r}: steps {t['step']}, per step (launches, rows, row_base; ms in the "
                  f"all-reduces of gradients and metrics, synchronised) " + json.dumps(t["steps"])
                  + f"; whole run {t['launches']}; writes " + json.dumps(t["writes"]))
            want_rows = [("K2", b // DP_WORLD, r * b // DP_WORLD), ("K1", 2 * b // DP_WORLD, r * 2 * b // DP_WORLD)]
            for s in t["steps"]:
                if s["launches"] != {"K1": 1, "K2": 1} or [tuple(x) for x in s["rows"]] != want_rows:
                    raise AssertionError(f"rank {r}: a step launched {s}, expected K1 and K2 once at {want_rows}")
            if t["step"] != DP_ITERATIONS or len(t["steps"]) != DP_ITERATIONS:
                raise AssertionError(f"rank {r} took {t['step']} steps")
        if len({t["digest"] for t in trains}) != 1:
            raise AssertionError("the replicas differ after training")
        if any(trains[r]["writes"][k] for r in range(1, DP_WORLD) for k in trains[r]["writes"]):
            raise AssertionError("a rank other than 0 wrote a log, grid or checkpoint")
        w0 = trains[0]["writes"]
        (run,) = os.listdir(os.path.join(logdir, "cifar10"))
        ckpts = sorted(os.listdir(os.path.join(logdir, "cifar10", run, "ckpt")))
        rows = _jsonl(os.path.join(logdir, "cifar10", run, "metrics.jsonl"))
        evals = [r["step"] for r in rows if r["phase"] == "eval"]
        print(f"[train_dp] one run directory; checkpoints {ckpts}; eval rows at {evals}; rank 0 saved "
              f"{w0['checkpoints']} and {len(w0['grids'])} grids; replicas equal (sha256 {trains[0]['digest'][:16]})")
        if ckpts != [str(DP_ITERATIONS - 1), "best"] or evals != [0, DP_ITERATIONS - 1]:
            raise AssertionError("the run lacks its checkpoints or eval rows")
        for r in rows:
            if r["phase"] == "eval" and not all(np.isfinite(r[k]) for k in ("frechet_rand_damc", "recon_mse")):
                raise AssertionError(f"eval row {r}: not finite")

        # 3. One iteration on two ranks against one process, on the card.
        small, x, draws, z0 = small_iteration_inputs(cfg)
        world1, models = _one_iteration(small, "cuda", x, draws, z0)
        world2 = torch.load(os.path.join(tmp, "iteration0.pt"), weights_only=False)
        other = torch.load(os.path.join(tmp, "iteration1.pt"), weights_only=False)
        same = world2[0] == other[0] and all(torch.equal(a, c) for k in world2[1] for (_, a), (_, c) in
                                             zip(world2[1][k], other[1][k]))
        print(f"[train_dp] the card-vs-CPU iteration (B=8) on {DP_WORLD} ranks against one process; replicas "
              f"equal: {same}")
        if not same:
            raise AssertionError("the two ranks' replicas differ after one iteration")
        readings, failed = _card_cpu_readings(small, world1, world2, models, FP32_LIMITS, "train_dp",
                                              names=("world 2", "world 1"))
        if failed:
            raise AssertionError(f"world 2 and world 1 disagree beyond rounding: {failed}")
        ms = trains[0]["ms_per_iteration"]
        print(f"[train_dp] ms an iteration at global B={b}, two ranks sharing one H100 over gloo (not a scaling "
              f"figure): {ms} (median {statistics.median(ms)}); one process, phase 6: {train_ms}; group wall "
              f"{wall:.1f} s; readings " + json.dumps(readings))

        anomaly = _dp_anomaly_checks([rk["anomaly"] for rk in ranks], cfg_anomaly, mnist, anomaly_logs, n_anomalous)
        _dp_inversion_checks([rk["inversion"] for rk in ranks], stylegan)
        for r, rk in enumerate(ranks):
            t = rk["tp"]
            print(f"[tp] rank {r}: the {STYLEGAN_RES}x{STYLEGAN_RES} synthesis with {t['sharded_leaves']} of "
                  f"{t['leaves']} parameters channel-sharded over {DP_WORLD} ranks against the replicated forward: "
                  f"max_abs_err {t['max_abs_err']:.3e} (rtol 1e-4, atol 1e-5), bit for bit {t['bit_equal']}; "
                  f"elements held {t['elements_held']} of {t['elements']}; forward {t['forward_ms']:.1f} ms "
                  "(host clock, synchronised)")
            if not t["within_rtol_1e-4_atol_1e-5"] or t["elements_held"] >= t["elements"]:
                raise AssertionError(f"rank {r}: the channel-sharded synthesis differs, or holds every element")
        return {"ranks": ranks, "ms": ms, "wall_s": wall, "anomaly": anomaly}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    import shutil
    import tempfile

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

    from concurrent.futures import ThreadPoolExecutor

    from damc_tpu_torch.data import _native_build

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.monotonic()
    with ThreadPoolExecutor(1) as pool:  # g++ for the host libraries beside nvcc for the kernels
        host = pool.submit(_native_build.build)
        built = build.build()
        host_built = host.result()
    print(f"[build] {len(built)} kernel libraries and {len(host_built)} host libraries in "
          f"{time.monotonic() - t0:.1f} s ({_native_build.compiler()[0]} {_native_build.compiler()[1]})")
    for name, info in host_built.items():
        print(f"[build] host {name}: {info['path']} ({info['seconds']:.1f} s)")
    for name, info in built.items():
        print(f"[build] {name}: {info['path']}")
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {line.strip()}")

    walls, mark = {"build": time.monotonic() - t0}, [time.perf_counter()]

    def lap(name):
        """The wall since the previous lap, under `name` in the [walls] line."""
        now = time.perf_counter()
        walls[name] = now - mark[0]
        mark[0] = now

    cfg = preset("cifar10")
    models = build_models(cfg, seed=SEED, device="cuda")
    res = kernel_phase(models, cfg)
    res_stream = stream_kernel_phase(models, cfg)
    lap("kernels")
    res_bf16, k1_tc_holds = k1_bf16_phase()
    lap("k1_bf16")
    row_independence_phase(models, cfg)
    counters = {"K1": fused_prior_langevin, "K2": fused_reverse_sweep}
    total, _ = serving_phase(models, cfg, counters)
    profile_phase(models, cfg)
    lap("serve")
    serve_mesh = serve_mesh_phase(models, cfg, counters)
    lap("serve_mesh")
    total_artifact, live_latency = artifact_phase(models, cfg, counters)
    checkpoint_cli_phase(models, cfg, counters)
    lap("serve_artifact")
    unfused = serve_unfused_phase(models, cfg, counters, live_latency)
    del models
    lap("serve_unfused")
    state, total_train, train_ms = training_phase(cfg, counters)
    rerun_phase(cfg)
    lap("train")
    gpu_cpu_phase(cfg)
    lap("train_card_cpu")
    train_profile_phase(cfg, state)
    del state
    lap("train_profile")
    k1_widths, k1_widths_holds = k1_widths_phase(cfg, counters)
    lap("k1_widths")
    # The bfloat16 mode: G and the encoder in bf16, K1's bf16-dot variant on
    # the tensor cores (K1_tc) and no other K1 variant.
    cfg_bf16 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"),
                                   train=dataclasses.replace(cfg.train, pallas_dots_dtype="bfloat16"))
    counters16 = {**counters, **k1_variant_counters()}
    state, total_train16, train16_ms = training_phase(
        cfg_bf16, counters16, expect={**{name: 0 for name in counters16}, "K2": 1, "K1_tc": 1}, tag="train_bf16")
    rerun_phase(cfg_bf16, tag="train_bf16")
    lap("train_bf16")
    gpu_cpu_phase(cfg_bf16, BF16_LIMITS, tag="train_bf16", control=BF16_CONTROL)
    lap("train_bf16_card_cpu")
    train_profile_phase(cfg_bf16, state, path="train_bf16")
    del state
    print(f"[train_bf16] median ms an iteration (iterations 3 to 10): float32 {train_ms}, bf16 {train16_ms}")
    flops_line(cfg, train_ms, train16_ms)
    models = build_models(cfg_bf16, seed=SEED, device="cuda")
    serving_phase(models, cfg_bf16, counters16, cpu_atol=BF16_SERVE_ATOL, tag="serve_bf16")
    fid16 = bf16_fid_batch_phase(models, cfg_bf16, counters16)
    del models
    lap("bf16_profile_and_serve")
    models = build_models(cfg, seed=SEED, device="cuda")
    res_eval = eval_kernel_phase(models, cfg)
    del models
    eval_info = eval_phase(cfg, counters)
    _, inception_ms, _ = inception_phase()
    eval_timing_phase(cfg, inception_ms, eval_info, train_ms)
    lap("eval")
    cfg_anomaly, cfg_toy = preset("mnist_anomaly"), preset("toy")
    res_anomaly = anomaly_kernel_phase(cfg_anomaly)
    anomaly_info = anomaly_phase(cfg_anomaly, counters)
    image_profile_phase(cfg_anomaly, "anomaly")
    lap("anomaly")
    res_toy = toy_kernel_phase(cfg_toy)
    toy_info = toy_phase(cfg_toy, counters)
    toy_profile_phase(cfg_toy)
    print(decoders_line())
    lap("toy")
    cfg_svhn, cfg_c64, cfg_hq = preset("svhn"), preset("celeba64"), preset("celebaHQ")
    res_svhn = preset_kernel_phase(cfg_svhn, "svhn", 30, eval_k1=((100, 0.4), (60, 0.4)), serve=True, rows=True)
    chain_trace(cfg_svhn, 100, 1.6, 30)
    svhn_info = svhn_phase(cfg_svhn, counters)
    image_profile_phase(cfg_svhn, "svhn")
    lap("svhn")
    res_c64 = preset_kernel_phase(cfg_c64, "celeba64", 50)
    c64_info = celeba64_phase(cfg_c64, counters)
    image_profile_phase(cfg_c64, "celeba64")
    lap("celeba64")
    c64_4c = decoders_4c_phase(cfg_c64, counters)
    lap("decoders_4c")
    res_hq = preset_kernel_phase(cfg_hq, "celebaHQ", 70)
    hq_info = celebahq_phase(cfg_hq, counters)
    lap("celebaHQ")
    models = build_models(cfg, seed=SEED, device="cuda")
    unfused_sweep_phase(models, cfg)
    del models
    lap("unfused_sweep")
    stylegan_tmp = tempfile.mkdtemp(prefix="damc_stylegan_smoke_")
    try:
        stylegan = stylegan_phase(counters16, stylegan_tmp)
        lap("stylegan")
        torch.cuda.empty_cache()  # the ranks of the data-parallel phase share the card with this process
        dp = dp_phase(cfg, train_ms, stylegan)
        lap("train_dp")
    finally:
        shutil.rmtree(stylegan_tmp, ignore_errors=True)
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
    ] + [
        # The card-exported serving artifact, served by its own process: B=16, counter mode.
        ("serve_artifact", "counter", key, res[key][16], total_artifact[key]) for key in meta
    ] + [("train", "stream", key, res_stream[key], total_train[key]) for key in meta] + [
        # The widths K1 pads or spreads: nz=10 (K1 over 2B=256 chains, K2 B=128)
        # and ndf=512 (K1 over a cluster of 8) in training, and the EBM-prior
        # FID batches (B=500) of these and of ndf=1024 (K1 with the weights in L2).
        (path, "stream", key, r, launches) for path, ks in k1_widths.items() for key, (r, launches) in ks.items()
    ] + [
        ("serve_ndf512", "counter", "K1_c8", *unfused["ndf512"]["K1_c8"]),  # B=16 under auto
    ] + [
        ("eval", "stream", key, res_eval[key], eval_info["cli_launches"][key])  # B=500: K1 100 steps, K2 prior
        for key in meta
    ] + [
        ("anomaly", "stream", "K1", res_anomaly["K1"], anomaly_info["train"]["K1"]),  # B=128, nz=8
        ("anomaly", "stream", "K2", res_anomaly["K2"], anomaly_info["train"]["K2"]),  # B=128, nz=8
        # B=500 posterior, nz=8: the train CLI's AUPRC evals, then the eval CLI's own run.
        ("anomaly_eval", "stream", "K2", res_anomaly["K2_auprc"], anomaly_info["eval"]["K2"]),
        ("anomaly_eval_cli", "stream", "K2", res_anomaly["K2_auprc"], anomaly_info["cli"]["K2"]),
        ("toy", "stream", "K2", res_toy["K2"], toy_info["train"]["K2"] + toy_info["eval"]["K2"]),  # B=500, nz=2
        # nz=100: the svhn train CLI run (2 iterations and their 2 evals), K1 over 2B=256, K2 B=128 posterior.
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
        # The same shapes over the mixed tree of item 4c's kinds: 3 iterations.
        ("celeba64_4c", "stream", "K1", res_c64["K1"], c64_4c["launches"]["K1"]),
        ("celeba64_4c", "stream", "K2", res_c64["K2"], c64_4c["launches"]["K2"]),
        ("celebaHQ", "stream", "K1", res_hq["K1"], hq_info["launches"]["K1"]),
        ("celebaHQ", "stream", "K2", res_hq["K2"], hq_info["launches"]["K2"]),
        # cifar10 with compute_dtype and pallas_dots_dtype bfloat16: K1's bf16-dot
        # variant on the tensor cores over 2B=256 chains (every other K1 variant
        # launched 0 times), K2 B=128.
        ("train_bf16", "stream", "K1_tc", res_bf16["train"], total_train16["K1_tc"]),
        # The EBM-prior FID batch in bf16 (B=500, 60 steps at 0.4).
        ("eval_bf16", "stream", "K1_tc", res_bf16["eval"], fid16["ebm"]["launches"]["K1_tc"]),
        ("train_bf16", "stream", "K2", res_stream["K2"], total_train16["K2"]),
    ]
    if total_train16["K1"]:
        raise AssertionError("the bf16 training run launched K1's float32 variant")
    meta["K1_c8"] = ("fused_prior_langevin_c8", "damc_tpu_torch/csrc/fused_langevin.cu",
                     "damc_tpu/ops/pallas/fused_langevin.py:311")
    meta["K1_l2"] = ("fused_prior_langevin_l2", "damc_tpu_torch/csrc/fused_langevin.cu",
                     "damc_tpu/ops/pallas/fused_langevin.py:311")
    meta["K1_tc"] = ("fused_prior_langevin_tc", "damc_tpu_torch/csrc/fused_langevin.cu",
                     "damc_tpu/ops/pallas/fused_langevin.py:311")
    # The data-parallel run: each rank's own launches (K1 on its 128 of the
    # 2B=256 chains, K2 on its 64 of B=128 rows) and its whole run's count.
    meta["K4a"] = ("fused_prior_langevin_sharded", "damc_tpu_torch/csrc/fused_langevin.cu",
                   "damc_tpu/ops/pallas/fused_langevin.py:335")
    meta["K4b"] = ("fused_reverse_sweep_sharded", "damc_tpu_torch/csrc/fused_qsweep.cu",
                   "damc_tpu/ops/pallas/fused_qsweep.py:364")
    entries += [
        (f"train_dp rank {r}", "stream", key, rk["kernels"][f"{key}_{b}"], rk["train"]["launches"][counter])
        for r, rk in enumerate(dp["ranks"])
        for key, b, counter in (("K4a", 2 * cfg.train.batch_size, "K1"), ("K4b", cfg.train.batch_size, "K2"))
    ]
    # The data-parallel anomaly run (nz=8): each rank's K1 on its 64 of the
    # B=128 chains and K2 on its 64 of 128 rows, launched once a training
    # step; then the two-rank eval CLI's K2 on rank 0's 250 of each 500.
    b_anomaly = cfg_anomaly.train.batch_size
    entries += [
        (f"anomaly_dp rank {r}", "stream", key, rk["anomaly"]["kernels"][f"{key}_{b_anomaly}"],
         sum(s["launches"][counter] for s in rk["anomaly"]["train"]["steps"]))
        for r, rk in enumerate(dp["ranks"]) for key, counter in (("K4a", "K1"), ("K4b", "K2"))
    ] + [("anomaly_dp_eval", "stream", "K4b", dp["ranks"][0]["anomaly"]["kernels"]["K4b_500"],
          dp["anomaly"][0]["eval_cli_K2"])]
    # Serving over two replicas of the card: K1 and K2 on each replica's 8 rows, counter mode.
    entries += [("serve_mesh", "counter", key, serve_mesh["res"][key], serve_mesh["launches"][key]) for key in ("K1", "K2")]
    for path, mode, key, r, launches in entries:
        name, source, replaces = meta[key]
        bound_ms, bound_by = bound(r["flops"], r["bytes"], r.get("peak"))
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "path": path, "noise": mode, "batch": r["b"],
        })
    for label, r in res_bf16.items():
        b_ms, by = bound(r["flops"], r["bytes"], peak_rate("bfloat16"))
        print(f"[kernels] {r['variant']} bf16 {label} stream B={r['b']} nz={r['nz']} ndf={r['ndf']}: ms={r['ms']} "
              f"plain_ms={r['plain_ms']} fp32_kernel_ms={r['fp32_kernel_ms']} bound_ms={b_ms} ({by}) "
              f"flops={r['flops']} bytes={r['bytes']} max_abs_err={r['max_abs_err']} "
              f"max_abs_err_6_noiseless={r['max_abs_err_6_noiseless']}")
    for label, r in k1_tc_holds.items():
        b_ms, by = bound(r["flops"], r["bytes"], r["peak"])
        print(f"[kernels] K1_tc {label} B={r['b']} (held, on no path): ms={r['ms']} plain_ms={r['plain_ms']} "
              f"bound_ms={b_ms} ({by}) flops={r['flops']} bytes={r['bytes']} max_abs_err={r['max_abs_err']}")
    for label, r in k1_widths_holds.items():
        b_ms, by = bound(r["flops"], r["bytes"], r["peak"])
        print(f"[kernels] {r['variant']} {label} B={r['b']} (held, on no path): ms={r['ms']} "
              f"plain_ms={r['plain_ms']} bound_ms={b_ms} ({by}) flops={r['flops']} bytes={r['bytes']} "
              f"max_abs_err={r['max_abs_err']}")
    for key in ("K1", "K2"):
        name = meta[key][0]
        shapes = [("serving counter", res[key][16]), ("training stream", res_stream[key]),
                  ("counter", res[key][500])]
        shapes += [(f"eval stream {k}", r) for k, r in res_eval.items() if k.startswith(key)]
        shapes += [(f"{path} stream", ks[k][0]) for path, ks in k1_widths.items() for k in ks if k == key]
        shapes += [(f"anomaly stream {k}", r) for k, r in res_anomaly.items() if k.startswith(key)]
        shapes += [(f"toy {k}", r) for k, r in res_toy.items() if k.startswith(key)]
        for tag, res_p in (("svhn", res_svhn), ("celeba64", res_c64), ("celebaHQ", res_hq)):
            shapes += [(f"{tag} {k}", r) for k, r in res_p.items() if k.startswith(key)]
        shapes += [(f"train_dp rank {i} {k} (its rows)", r) for i, rk in enumerate(dp["ranks"])
                   for k, r in rk["kernels"].items() if k.startswith({"K1": "K4a", "K2": "K4b"}[key])]
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
