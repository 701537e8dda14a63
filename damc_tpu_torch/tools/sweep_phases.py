"""Where a step of the reverse-sweep kernel (K2) spends its time.

    python3 -m damc_tpu_torch.tools.sweep_phases

Builds a copy of `csrc/fused_qsweep.cu` in which thread 0 of block 0 reads
`clock64()` between the phases of a step (the input and context gather,
a compute warp's wait for and work on each weight stage, the partial sums,
the cluster barriers, the ancestral step and the Fourier features), runs
it through the wrapper on the full-width cifar10 denoiser (random weights
from seed 0) at B=16 and B=128 for 100 steps, and prints the cycles per
step of each phase, as one warp sees them. The timers slow the kernel a
little and add registers; the shares are what to read. The copy is made
by text replacement: if the kernel's source changes, a pattern stops
matching and the tool says which.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

TIMER = r'''
__device__ unsigned long long g_phase_cycles[16];
#define PT(i) do { if (threadIdx.x == 0 && blockIdx.x == 0) { long long _t = clock64(); \
  phase[i] += _t - t_last; t_last = _t; } } while (0)
'''
# (pattern, replacement): PT(i) adds the cycles since the previous timer to phase i.
PATTERNS = [
    ("namespace cg = cooperative_groups;", "namespace cg = cooperative_groups;" + TIMER),
    ("float* part, float* out) {", "float* part, float* out, long long* phase, long long& t_last) {"),
    ("ring, full, empty, table, g, total,\n                      part, out);",
     "ring, full, empty, table, g, total,\n                      part, out, phase, t_last);"),
    ("      if (lane == 0) mbar_wait(full + g % kStages, (g / kStages) & 1);\n      __syncwarp();",
     "      PT(3);\n      if (lane == 0) mbar_wait(full + g % kStages, (g / kStages) & 1);\n      __syncwarp();\n      PT(4);"),
    ("  if (warp != kProducer) {\n    float* pp", "  PT(3);\n  if (warp != kProducer) {\n    float* pp"),
    ("  int g = 0;  // weight stages consumed\n",
     "  int g = 0;\n  long long phase[16] = {};\n  long long t_last = clock64();\n"),
    ("a.d_max);\n      __syncthreads();\n      // The next layer", "a.d_max);\n      PT(0);\n      __syncthreads();\n      // The next layer"),
    ("      float* out = otile + l * kRows * kMaxTile;", "      PT(1);\n      float* out = otile + l * kRows * kMaxTile;"),
    ("      cluster.sync();  // every output and context tile of layer l is out",
     "      PT(5);\n      cluster.sync();\n      PT(6);"),
    ("    if (step + 1 < steps) {\n      __syncthreads();\n      fourier_tile<kRows>(zs, fourier, nz, nfour, rank, etile);\n"
     "      cluster.sync();  // the next step's embedding is out\n    }\n  }",
     "    PT(7);\n    if (step + 1 < steps) {\n      __syncthreads();\n      fourier_tile<kRows>(zs, fourier, nz, nfour, rank, etile);\n"
     "      PT(8);\n      cluster.sync();\n      PT(9);\n    }\n  }\n"
     "  if (threadIdx.x == 0 && blockIdx.x == 0) for (int i = 0; i < 16; ++i) g_phase_cycles[i] = phase[i];"),
]
READER = r'''
extern "C" int damc_phase_cycles(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
}
'''
PHASES = [
    "gather input and context", "barrier after the gather, context loads",
    "(unused)", "a warp's products of a weight stage", "wait for a weight stage",
    "partial sums, reduction, context store", "cluster barrier of a layer",
    "ancestral step", "Fourier features", "cluster barrier of the features",
]


def instrument(src: str) -> str:
    for old, new in PATTERNS:
        if old not in src:
            raise RuntimeError(f"fused_qsweep.cu no longer contains:\n{old}")
        src = src.replace(old, new)
    return src + READER


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 5) -> float:
    import torch

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


def main() -> int:
    import torch

    from damc_tpu_torch.config import preset
    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.ops.cuda import build
    from damc_tpu_torch.ops.cuda import fused_qsweep as k2
    from damc_tpu_torch.ops.diffusion import step_coefficients, sweep_logsnr_grid

    if not torch.cuda.is_available():
        print("sweep_phases: CUDA is not available", file=sys.stderr)
        return 1
    print(card_line())
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "fused_qsweep.cu"
        src.write_text(instrument((build.SRC_DIR / "fused_qsweep.cu").read_text()))
        (Path(tmp) / "counter_noise.cuh").write_text((build.SRC_DIR / "counter_noise.cuh").read_text())
        lib_path = Path(tmp) / "phases.so"
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(lib_path))
    lib.damc_error_string.argtypes = [ctypes.c_int]
    lib.damc_error_string.restype = ctypes.c_char_p
    lib.damc_fused_qsweep.argtypes = k2._library().damc_fused_qsweep.argtypes
    lib.damc_fused_qsweep.restype = ctypes.c_int
    k2._library = lambda: lib

    cfg = preset("cifar10")
    m, d = cfg.model, cfg.diffusion
    models = build_models(cfg, seed=0, device="cuda")
    fourier, layers = k2.denoiser_layer_params(models.amortizer.p)
    grid, _ = sweep_logsnr_grid(d.n_interval, d.logsnr_min, d.logsnr_max)
    coeffs = step_coefficients(d.n_interval, d.logsnr_min, d.logsnr_max, d.var_type).cuda()
    gen = torch.Generator(device="cpu").manual_seed(0)
    for b in (16, 128):
        z = torch.randn(b, m.nz, generator=gen).cuda()
        seeds = torch.randint(0, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).cuda()
        with torch.no_grad():
            xemb = models.amortizer.prior_embed(torch.randn(b, m.nz, generator=gen).cuda())
            tables = models.amortizer.p.sample_tables(grid.cuda(), xemb)
        ms = time_ms(lambda: k2.fused_reverse_sweep(
            z, fourier, layers, tables["pre_x"], tables["pre_t"], coeffs, row_seeds=seeds,
            steps=d.n_interval, residual=d.residual))
        cycles = (ctypes.c_ulonglong * 16)()
        build.check(lib, lib.damc_phase_cycles(cycles), "damc_phase_cycles")
        total = sum(cycles)
        rows = k2.row_tile(b, k2.max_active_clusters(m.nz, [lt[0].shape[0] for lt in layers],
                                                      [lt[0].shape[1] for lt in layers]))
        print(f"B={b} ({rows}-row tiles): {ms:.4f} ms with timers; cycles a step, thread 0 of block 0:")
        for i, name in enumerate(PHASES):
            if cycles[i]:
                print(f"  {name}: {cycles[i] / d.n_interval:.0f} ({cycles[i] / total:.1%})")
        print(f"  total: {total / d.n_interval:.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
