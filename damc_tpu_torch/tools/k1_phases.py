"""Where a step of K1's tensor-core kernel (bf16 dots) spends its time.

    python3 -m damc_tpu_torch.tools.k1_phases

Builds a copy of `csrc/fused_langevin.cu` in which thread 0 of block 0
(warp 0, which holds own-column tiles) and thread 480 (warp 15, which
draws the step's normals) read `clock64()` between the phases of a step of
`prior_langevin_mma_kernel`, runs it on the full-width cifar10 EBM (random
weights from seed 0, ndf=200 in one block) over 60 steps at 0.4 in stream
mode at B=256, and prints each phase's clocks per step as each warp sees
them, beside the uninstrumented kernel's ms. The timers add registers and
a few instructions; the shares are what to read. The copy is made by text
replacement: if the kernel's source changes, a pattern stops matching and
the tool says which.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

from .sweep_phases import card_line, time_ms

TIMER = r'''
__device__ long long g_phase_cycles[32];
#define PT(i) do { if ((threadIdx.x == 0 || threadIdx.x == 480) && blockIdx.x == 0) { \
  long long _t = clock64(); phase[i] += _t - t_last; t_last = _t; } } while (0)
'''
# (pattern, replacement): PT(i) adds the clocks since the previous timer to phase i.
PATTERNS = [
    ("namespace cg = cooperative_groups;", "namespace cg = cooperative_groups;" + TIMER),
    ("  const int nzp = mma_pad_nz(nz), ndfp = mma_pad_ndf(ndf, kCluster), J = ndfp / kCluster;\n  int rank",
     "  long long phase[16] = {};\n  long long t_last = clock64();\n"
     "  const int nzp = mma_pad_nz(nz), ndfp = mma_pad_ndf(ndf, kCluster), J = ndfp / kCluster;\n  int rank"),
    ("  cluster_barrier<kCluster>();\n\n  // The step's normals: the warps",
     "  cluster_barrier<kCluster>();\n  PT(0);\n\n  // The step's normals: the warps"),
    ("    own_products<true>(acc, k1s, ldw, own_tiles, zb, ldz, nzp);\n",
     "    own_products<true>(acc, k1s, ldw, own_tiles, zb, ldz, nzp);\n    PT(1);\n"),
    ("    cluster_barrier<kCluster>();\n    // d2 = lrelu'", "    PT(2);\n    cluster_barrier<kCluster>();\n    PT(3);\n    // d2 = lrelu'"),
    ("    own_products<true>(acc, k2s, ldw, own_tiles, h1b, ldh, ndfp);\n",
     "    own_products<true>(acc, k2s, ldw, own_tiles, h1b, ldh, ndfp);\n    PT(4);\n"),
    ("    __syncthreads();\n    // d2 K2^T over own columns; d1",
     "    PT(5);\n    __syncthreads();\n    PT(6);\n    // d2 K2^T over own columns; d1"),
    ("      own_products<false>(acc, k2s, ldw, own_tiles, d2b, ldd, J);\n",
     "      own_products<false>(acc, k2s, ldw, own_tiles, d2b, ldd, J);\n      PT(7);\n"),
    ("    __syncthreads();\n    // d1 K1^T over own columns, and z",
     "    PT(8);\n    __syncthreads();\n    PT(9);\n    // d1 K1^T over own columns, and z"),
    ("    __syncthreads();\n  }\n  if constexpr (kCluster > 1) cluster_barrier<kCluster>();",
     "    PT(10);\n    __syncthreads();\n    PT(11);\n  }\n"
     "  if (blockIdx.x == 0 && (threadIdx.x == 0 || threadIdx.x == 480))\n"
     "    for (int i = 0; i < 16; ++i) g_phase_cycles[(threadIdx.x ? 16 : 0) + i] = phase[i];\n"
     "  if constexpr (kCluster > 1) cluster_barrier<kCluster>();"),
]
READER = r'''
extern "C" int damc_phase_cycles(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
}
'''
PHASES = [
    "set-up (once)", "h1p products (warp 15: normals)", "h1 stores", "barrier",
    "h2p products (warp 15: normals)", "d2 stores", "barrier", "d2 K2^T products (warp 15: normals)",
    "d1 stores", "barrier", "d1 K1^T products and the z update", "barrier",
]
STEPS, B = 60, 256


def instrument(src: str) -> str:
    for old, new in PATTERNS:
        if src.count(old) != 1:
            raise RuntimeError(f"fused_langevin.cu no longer contains, once:\n{old}")
        src = src.replace(old, new)
    return src + READER


def main() -> int:
    import torch

    from damc_tpu_torch.config import preset
    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.ops.cuda import build
    from damc_tpu_torch.ops.cuda import fused_langevin as k1

    if not torch.cuda.is_available():
        print("k1_phases: CUDA is not available", file=sys.stderr)
        return 1
    print(card_line())
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "fused_langevin_phases.cu"
        src.write_text(instrument((build.SRC_DIR / "fused_langevin.cu").read_text()))
        (Path(tmp) / "counter_noise.cuh").write_text((build.SRC_DIR / "counter_noise.cuh").read_text())
        out = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", f"{tmp}/phases.so", str(src)],
                             capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed:\n{out.stdout}{out.stderr}")
        lib = ctypes.CDLL(f"{tmp}/phases.so")
    lib.damc_fused_langevin.argtypes = k1._library().damc_fused_langevin.argtypes
    lib.damc_fused_langevin.restype = ctypes.c_int
    lib.damc_error_string.argtypes = [ctypes.c_int]
    lib.damc_error_string.restype = ctypes.c_char_p

    w = k1.ebm_params_to_dense_weights(build_models(preset("cifar10"), seed=0, device="cuda").ebm)
    nz, ndf = w[0].shape
    launch = k1.launch_widths(nz, ndf, "bfloat16")
    if not launch.mma or launch.cluster != 1:
        raise RuntimeError(f"cifar10's EBM does not take the tensor-core kernel in one block: {launch}")
    z = torch.randn(B, nz, generator=torch.Generator().manual_seed(0)).cuda()
    out = torch.empty_like(z)
    rc = lib.damc_fused_langevin(z.data_ptr(), *[t.data_ptr() for t in w], None, -1357911, 1, 0, 1, 1, 1, k1.ROWS,
                                 None, out.data_ptr(), B, nz, ndf, STEPS, 0.4, 0.08,
                                 torch.cuda.current_stream().cuda_stream)
    build.check(lib, rc, "instrumented K1_tc")
    torch.cuda.synchronize()
    cycles = (ctypes.c_longlong * 32)()
    build.check(lib, lib.damc_phase_cycles(cycles), "reading the phase clocks")
    ms = time_ms(lambda: k1.fused_prior_langevin(z, *w, seed=-1357911, steps=STEPS, step_size=0.4,
                                                 dots_dtype="bfloat16"), 20)
    print(f"K1_tc, cifar10 EBM (nz={nz}, ndf={ndf} in one block), B={B}, {STEPS} steps, stream: the wrapper's "
          f"call {ms:.4f} ms uninstrumented")
    for name, base in (("warp 0", 0), ("warp 15", 16)):
        per_step = [cycles[base + i] / (1 if i == 0 else STEPS) for i in range(len(PHASES))]
        total = sum(per_step[1:])
        print(f"{name}: clocks a step {total:.0f}; " + ", ".join(
            f"{p} {c:.0f}" + ("" if i == 0 else f" ({c / total:.0%})") for i, (p, c) in enumerate(zip(PHASES, per_step))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
