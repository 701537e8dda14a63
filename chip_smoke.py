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
     alone and inside a B=16 batch;
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
  8. prints one JSON line {"kernels": [...]} with launches, errors and times
     of each kernel on each path;
  9. prints {"ok": true, "device": {...}} as the last line.
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


def kernel_phase(models, cfg):
    """Each kernel against its plain version at B=16 and B=500."""
    import torch

    from damc_tpu_torch.ops.cuda.fused_langevin import (
        ebm_params_to_dense_weights, fused_prior_langevin, prior_langevin_plain,
    )
    from damc_tpu_torch.ops.cuda.fused_qsweep import (
        denoiser_layer_params, fused_reverse_sweep, reverse_sweep_plain,
    )
    from damc_tpu_torch.ops.cuda.fused_qsweep import max_active_clusters, row_tile
    from damc_tpu_torch.ops.diffusion import step_coefficients, sweep_logsnr_grid

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    m, d, mc = cfg.model, cfg.diffusion, cfg.mcmc
    ebm_w = ebm_params_to_dense_weights(models.ebm)
    fourier, layers = denoiser_layer_params(models.amortizer.p)
    res = {"K1": {}, "K2": {}}
    k2_max = max_active_clusters(m.nz, [lt[0].shape[0] for lt in layers], [lt[0].shape[1] for lt in layers])
    print(f"[kernels] K2 clusters the card runs at once: {k2_max}; row tiles: "
          + ", ".join(f"B={b} {row_tile(b, k2_max)} rows" for b in (16, cfg.train.batch_size, 500)))

    for b in (16, 500):
        print(f"[kernels] B={b}")
        z = torch.randn(b, m.nz, generator=gen).to(dev)
        seeds = torch.randint(0, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).to(dev)
        # K1: the 60-step prior chain at step size 0.4.
        kw = dict(steps=mc.e_l_steps, step_size=mc.e_l_step_size)
        got = fused_prior_langevin(z, *ebm_w, with_noise=False, **kw)
        want = prior_langevin_plain(z, *ebm_w, with_noise=False, **kw)
        check_close(f"K1 noiseless {mc.e_l_steps} steps", got, want, atol=1e-5)
        got = fused_prior_langevin(z, *ebm_w, row_seeds=seeds, **kw)
        want = prior_langevin_plain(z, *ebm_w, row_seeds=seeds, **kw)
        # The counter bits are exact; logf/cosf may differ from torch by an ulp.
        err1 = check_close(f"K1 counter noise {mc.e_l_steps} steps", got, want, atol=1e-4)
        flops, nbytes = langevin_cost(b, m.nz, m.ndf, mc.e_l_steps)
        k_ms = time_ms(lambda: fused_prior_langevin(z, *ebm_w, row_seeds=seeds, **kw), 20)
        p_ms = time_ms(lambda: prior_langevin_plain(z, *ebm_w, row_seeds=seeds, **kw), 5)
        res["K1"][b] = dict(max_abs_err=err1, ms=k_ms, plain_ms=p_ms, flops=flops, bytes=nbytes)

        # K2: tables from the prior embedding of noise, as the damc path builds them.
        with torch.no_grad():
            xemb = models.amortizer.prior_embed(torch.randn(b, m.nz, generator=gen).to(dev))
        for n in (6, d.n_interval):
            grid, _ = sweep_logsnr_grid(n, d.logsnr_min, d.logsnr_max)
            coeffs = step_coefficients(n, d.logsnr_min, d.logsnr_max, d.var_type).to(dev)
            with torch.no_grad():
                tables = models.amortizer.p.sample_tables(grid.to(dev), xemb)
            args = (z, fourier, layers, tables["pre_x"], tables["pre_t"], coeffs)
            kw2 = dict(steps=n, residual=d.residual)
            if n == 6:
                # At full width with random weights six steps amplify fp32
                # rounding to ~1e-2 (the plain version in fp32 against fp64),
                # so no fp32 pair meets 2e-4 here: hold the kernel to the fp64
                # plain version, at most twice as far as the fp32 plain
                # version is, plus 2e-4.
                args64 = (z.double(), fourier.double(), [tuple(t.double() for t in lt) for lt in layers],
                          [t.double() for t in tables["pre_x"]], [t.double() for t in tables["pre_t"]],
                          coeffs.double())
                for label, noise in (("noiseless", dict(with_noise=False)), ("counter noise", dict(row_seeds=seeds))):
                    got = fused_reverse_sweep(*args, **noise, **kw2)
                    want = reverse_sweep_plain(*args, **noise, **kw2)
                    ref = reverse_sweep_plain(*args64, **noise, **kw2)
                    err_plain = float((want.double() - ref).abs().max())
                    err_k = float((got.double() - ref).abs().max())
                    err2 = float((got - want).abs().max())
                    print(f"  K2 {label} 6 steps: kernel-plain {err2:.3e}; against fp64: kernel "
                          f"{err_k:.3e}, plain fp32 {err_plain:.3e} (limit 2 x plain + 2e-4)")
                    if err_k > 2 * err_plain + 2e-4:
                        raise AssertionError(f"K2 {label}: kernel further from fp64 than fp32 allows")
                continue
            # 100 noisy steps are chaotic pointwise: hold the per-dimension
            # moments over the batch instead (both see the same noise).
            got = fused_reverse_sweep(*args, row_seeds=seeds, **kw2)
            want = reverse_sweep_plain(*args, row_seeds=seeds, **kw2)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError("K2 100 steps: non-finite output")
            if b >= 500:
                scale = float(want.std(0).mean())
                d_mean = float((got.mean(0) - want.mean(0)).abs().max())
                d_std = float((got.std(0) - want.std(0)).abs().max())
                print(f"  K2 {n} steps: max |d mean|={d_mean:.3e}, max |d std|={d_std:.3e}, "
                      f"mean std={scale:.3e} (limit 0.1 x mean std each)")
                if d_mean > 0.1 * scale or d_std > 0.1 * scale:
                    raise AssertionError("K2 100 steps: moments disagree with the plain version")
            flops, nbytes = sweep_cost(b, fourier, layers, n)
            k_ms = time_ms(lambda: fused_reverse_sweep(*args, row_seeds=seeds, **kw2), 10)
            p_ms = time_ms(lambda: reverse_sweep_plain(*args, row_seeds=seeds, **kw2), 3, warmup=1)
            res["K2"][b] = dict(max_abs_err=err2, ms=k_ms, plain_ms=p_ms, flops=flops, bytes=nbytes)
        for name in ("K1", "K2"):
            r = res[name][b]
            b_ms, by = bound(r["flops"], r["bytes"])
            print(f"  {name} B={b}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {b_ms:.5g} ms ({by}), {r['flops']:.4g} FLOP, {r['bytes']:.4g} B")
    return res


ROW_PICKS = (0, 7, 250, 499)


def row_independence_phase(models, cfg):
    """Counter mode, each kernel at its serving step count: rows 0, 7, 250
    and 499 of a B=500 launch must equal, bit for bit, the same rows
    launched alone (B=1) and inside a B=16 batch, where row i sits at slot
    i % 16 among 15 other rows. The row tile, the cluster and the slot
    differ between the three launches; the row's inputs do not."""
    import torch

    from damc_tpu_torch.ops.cuda.fused_langevin import ebm_params_to_dense_weights, fused_prior_langevin
    from damc_tpu_torch.ops.cuda.fused_qsweep import denoiser_layer_params, fused_reverse_sweep
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
            alone = run(torch.tensor([i], device=dev))
            idx = [(i + 1 + k) % b for k in range(16)]
            idx[i % 16] = i
            batch = run(torch.tensor(idx, device=dev))
            same_alone = torch.equal(full[i], alone[0])
            same_batch = torch.equal(full[i], batch[i % 16])
            print(f"[rows] {name} row {i} of B={b}: == alone {same_alone}, == slot {i % 16} of B=16 "
                  f"{same_batch}")
            if not (same_alone and same_batch):
                raise AssertionError(f"{name}: row {i} depends on the batch it is launched in")


def _int32(u):
    """uint32 values held in int64 -> int32 with the same bits."""
    import torch

    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def stream_kernel_phase(models, cfg):
    """Stream mode (one int32 seed a launch) at the training shapes: K1 over
    the 2B=256 prior chains, K2 over the B=128 Q_ema rows."""
    import torch

    from damc_tpu_torch.ops.cuda.fused_langevin import (
        ebm_params_to_dense_weights, fused_prior_langevin, prior_langevin_plain,
    )
    from damc_tpu_torch.ops.cuda.fused_qsweep import (
        denoiser_layer_params, fused_reverse_sweep, reverse_sweep_plain,
    )
    from damc_tpu_torch.ops.diffusion import step_coefficients, sweep_logsnr_grid
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
    kw = dict(steps=mc.e_l_steps, step_size=mc.e_l_step_size)
    got = fused_prior_langevin(z, *ebm_w, seed=seed, **kw)
    # The row seeds the kernel derives equal the plain ones: stream mode is
    # counter mode fed stream_row_seeds, bit for bit.
    if not torch.equal(got, fused_prior_langevin(z, *ebm_w, row_seeds=_int32(stream_row_seeds(seed, b1, dev)), **kw)):
        raise AssertionError("K1: stream mode differs from counter mode on stream_row_seeds")
    want = prior_langevin_plain(z, *ebm_w, seed=seed, **kw)
    err1 = check_close(f"K1 stream {mc.e_l_steps} steps", got, want, atol=1e-4)
    flops, nbytes = langevin_cost(b1, m.nz, m.ndf, mc.e_l_steps)
    k_ms = time_ms(lambda: fused_prior_langevin(z, *ebm_w, seed=seed, **kw), 20)
    p_ms = time_ms(lambda: prior_langevin_plain(z, *ebm_w, seed=seed, **kw), 5)
    res["K1"] = dict(b=b1, max_abs_err=err1, ms=k_ms, plain_ms=p_ms, flops=flops, bytes=nbytes)

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
    res_k2 = {}
    for n in (6, d.n_interval):
        grid, _ = sweep_logsnr_grid(n, d.logsnr_min, d.logsnr_max)
        coeffs = step_coefficients(n, d.logsnr_min, d.logsnr_max, d.var_type).to(dev)
        with torch.no_grad():
            tables = models.amortizer.p.sample_tables(grid.to(dev), xemb)
        args = (z, fourier, layers, tables["pre_x"], tables["pre_t"], coeffs)
        kw2 = dict(steps=n, residual=d.residual)
        got = fused_reverse_sweep(*args, seed=seed, **kw2)
        if not torch.equal(got, fused_reverse_sweep(*args, row_seeds=_int32(stream_row_seeds(seed, b2, dev)), **kw2)):
            raise AssertionError("K2: stream mode differs from counter mode on stream_row_seeds")
        want = reverse_sweep_plain(*args, seed=seed, **kw2)
        if n == 6:
            # As in counter mode: against the fp64 plain version, at most
            # twice as far as the fp32 plain version, plus 2e-4.
            args64 = (z.double(), fourier.double(), [tuple(t.double() for t in lt) for lt in layers],
                      [t.double() for t in tables["pre_x"]], [t.double() for t in tables["pre_t"]],
                      coeffs.double())
            ref = reverse_sweep_plain(*args64, seed=seed, **kw2)
            err_plain = float((want.double() - ref).abs().max())
            err_k = float((got.double() - ref).abs().max())
            res_k2["max_abs_err"] = float((got - want).abs().max())
            print(f"  K2 stream 6 steps: kernel-plain {res_k2['max_abs_err']:.3e}; against fp64: kernel "
                  f"{err_k:.3e}, plain fp32 {err_plain:.3e} (limit 2 x plain + 2e-4)")
            if err_k > 2 * err_plain + 2e-4:
                raise AssertionError("K2 stream: kernel further from fp64 than fp32 allows")
            continue
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("K2 stream 100 steps: non-finite output")
        scale = float(want.std(0).mean())
        d_mean = float((got.mean(0) - want.mean(0)).abs().max())
        d_std = float((got.std(0) - want.std(0)).abs().max())
        print(f"  K2 stream {n} steps: max |d mean|={d_mean:.3e}, max |d std|={d_std:.3e}, "
              f"mean std={scale:.3e} (limit 0.1 x mean std each)")
        if d_mean > 0.1 * scale or d_std > 0.1 * scale:
            raise AssertionError("K2 stream 100 steps: moments disagree with the plain version")
        flops, nbytes = sweep_cost(b2, fourier, layers, n)
        k_ms = time_ms(lambda: fused_reverse_sweep(*args, seed=seed, **kw2), 10)
        p_ms = time_ms(lambda: reverse_sweep_plain(*args, seed=seed, **kw2), 3, warmup=1)
        res_k2.update(b=b2, ms=k_ms, plain_ms=p_ms, flops=flops, bytes=nbytes)
    res["K2"] = res_k2
    for name, r in res.items():
        b_ms, by = bound(r["flops"], r["bytes"])
        print(f"  {name} stream B={r['b']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {b_ms:.5g} ms ({by}), {r['flops']:.4g} FLOP, {r['bytes']:.4g} B")
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
    return state, total


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


def train_profile_phase(cfg, state):
    """One training iteration under torch.profiler: host wall time, device
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
        "path": "train", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "phases": phases,
        "top": [{"name": n[:60], "ms": ms, "calls": c} for n, (ms, c) in top],
    }))


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
    state, total_train = training_phase(cfg, counters)
    rerun_phase(cfg)
    gpu_cpu_phase(cfg)
    train_profile_phase(cfg, state)

    meta = {
        "K1": ("fused_prior_langevin", "damc_tpu_torch/csrc/fused_langevin.cu",
               "damc_tpu/ops/pallas/fused_langevin.py:311"),
        "K2": ("fused_reverse_sweep", "damc_tpu_torch/csrc/fused_qsweep.cu",
               "damc_tpu/ops/pallas/fused_qsweep.py:344"),
    }
    kernels = []
    for path, mode, results, launches in (
        ("serve", "counter", {k: res[k][16] for k in meta}, total),  # the serving shape B=16
        ("train", "stream", res_stream, total_train),
    ):
        for key, (name, source, replaces) in meta.items():
            r = results[key]
            bound_ms, bound_by = bound(r["flops"], r["bytes"])
            kernels.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[key], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None, "path": path, "noise": mode, "batch": r.get("b", 16),
            })
    for key, (name, _, _) in meta.items():
        shapes = (("serving B=16 counter", res[key][16]), (f"training B={res_stream[key]['b']} stream",
                  res_stream[key]), ("B=500 counter", res[key][500]))
        for label, r in shapes:
            b_ms, by = bound(r["flops"], r["bytes"])
            print(f"[kernels] {name} {label}: ms={r['ms']} plain_ms={r['plain_ms']} "
                  f"bound_ms={b_ms} ({by}) flops={r['flops']} bytes={r['bytes']}")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
