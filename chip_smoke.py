#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`damc_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):
  1. prints the card's name and power limit (nvidia-smi); needs CUDA;
  2. builds every CUDA kernel of the serving path from `damc_tpu_torch/csrc`;
  3. holds each kernel against its plain PyTorch version on the card, at the
     serving shape B=16 and the FID shape B=500 (ragged row tiles), and
     times both;
  4. serves the full-width `cifar10` preset (random weights from a seed) over
     HTTP: /sample damc and ebm and /reconstruct, some requests concurrent;
     checks shapes, range, that an item served alone equals the same item
     served coalesced, that the EBM path agrees with the CPU plain versions,
     and that each path launched its kernels;
  5. profiles one B=16 dispatch of each path (device busy and idle time,
     top kernels);
  6. prints one JSON line {"kernels": [...]} with launches, errors and times;
  7. prints {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import base64
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
    from damc_tpu_torch.ops.diffusion import step_coefficients, sweep_logsnr_grid

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    m, d, mc = cfg.model, cfg.diffusion, cfg.mcmc
    ebm_w = ebm_params_to_dense_weights(models.ebm)
    fourier, layers = denoiser_layer_params(models.amortizer.p)
    res = {"K1": {}, "K2": {}}

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
            print(f"  {name} B={b}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"{r['flops']:.4g} FLOP, {r['bytes']:.4g} B")
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
    counters = {"K1": fused_prior_langevin, "K2": fused_reverse_sweep}
    total, _ = serving_phase(models, cfg, counters)
    profile_phase(models, cfg)

    meta = {
        "K1": ("fused_prior_langevin", "damc_tpu_torch/csrc/fused_langevin.cu",
               "damc_tpu/ops/pallas/fused_langevin.py:311"),
        "K2": ("fused_reverse_sweep", "damc_tpu_torch/csrc/fused_qsweep.cu",
               "damc_tpu/ops/pallas/fused_qsweep.py:344"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        r = res[key][16]  # the serving shape
        bound_ms, bound_by = bound(r["flops"], r["bytes"])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": total[key], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
        r5 = res[key][500]
        b5, by5 = bound(r5["flops"], r5["bytes"])
        print(f"[kernels] {name} B=500: ms={r5['ms']} plain_ms={r5['plain_ms']} "
              f"bound_ms={b5} ({by5}) flops={r5['flops']} bytes={r5['bytes']}")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
