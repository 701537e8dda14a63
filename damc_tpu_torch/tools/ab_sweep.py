"""Alternating comparison of versions of the reverse-sweep kernel (K2).

    python3 -m damc_tpu_torch.tools.ab_sweep DIR

Builds the committed `csrc/fused_qsweep.cu` and every `DIR/*.cu` (each a
whole replacement of that file with the same C interface; `DIR` also needs
a copy of `counter_noise.cuh`), one nvcc each, all at once. Then, in one
process on one card, launches each through the wrapper in turns (forward,
then backward, then forward) on the same inputs: the full-width cifar10
denoiser (random weights from seed 0), 100 noisy steps in counter mode at
B=16, 128 and 500. Prints each version's median time and whether its
output equals the committed kernel's bit for bit. Two calls may land on
different cards: compare versions only within one run of this tool.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

from .sweep_phases import card_line, time_ms


def main(argv) -> int:
    import torch

    from damc_tpu_torch.config import preset
    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.ops.cuda import build
    from damc_tpu_torch.ops.cuda import fused_qsweep as k2
    from damc_tpu_torch.ops.diffusion import step_coefficients, sweep_logsnr_grid

    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_sweep: CUDA is not available", file=sys.stderr)
        return 1
    print(card_line())
    sources = {"committed": build.SRC_DIR / "fused_qsweep.cu"}
    sources.update({p.stem: p for p in sorted(Path(argv[0]).glob("*.cu"))})
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {
            name: subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", f"{tmp}/{name}.so", str(src)],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, src in sources.items()
        }
        for name, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
            libs[name] = ctypes.CDLL(f"{tmp}/{name}.so")
    argtypes = k2._library().damc_fused_qsweep.argtypes
    for lib in libs.values():
        lib.damc_error_string.argtypes = [ctypes.c_int]
        lib.damc_error_string.restype = ctypes.c_char_p
        lib.damc_fused_qsweep.argtypes = argtypes
        lib.damc_fused_qsweep.restype = ctypes.c_int

    cfg = preset("cifar10")
    m, d = cfg.model, cfg.diffusion
    models = build_models(cfg, seed=0, device="cuda")
    fourier, layers = k2.denoiser_layer_params(models.amortizer.p)
    grid, _ = sweep_logsnr_grid(d.n_interval, d.logsnr_min, d.logsnr_max)
    coeffs = step_coefficients(d.n_interval, d.logsnr_min, d.logsnr_max, d.var_type).cuda()
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = {}
    for b in (16, 128, 500):
        z = torch.randn(b, m.nz, generator=gen).cuda()
        seeds = torch.randint(0, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).cuda()
        with torch.no_grad():
            xemb = models.amortizer.prior_embed(torch.randn(b, m.nz, generator=gen).cuda())
            cases[b] = (z, seeds, models.amortizer.p.sample_tables(grid.cuda(), xemb))
    times = {(name, b): [] for name in libs for b in cases}
    outs = {}
    order = list(libs)
    for rep in range(3):
        for name in order if rep % 2 == 0 else order[::-1]:
            k2._library = lambda lib=libs[name]: lib
            for b, (z, seeds, tables) in cases.items():
                run = lambda: k2.fused_reverse_sweep(
                    z, fourier, layers, tables["pre_x"], tables["pre_t"], coeffs, row_seeds=seeds,
                    steps=d.n_interval, residual=d.residual)
                times[(name, b)].append(time_ms(run))
                outs.setdefault((name, b), run())
    for name in libs:
        cols = "  ".join(f"B={b} {statistics.median(times[(name, b)]):.4f} ms" for b in cases)
        same = all(torch.equal(outs[(name, b)], outs[("committed", b)]) for b in cases)
        print(f"{name}: {cols}; equal to committed: {same}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
