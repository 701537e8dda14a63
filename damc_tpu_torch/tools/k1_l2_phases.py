"""Where a step of K1's streamed kernel (K1_l2) spends its time.

    python3 -m damc_tpu_torch.tools.k1_l2_phases

Builds a copy of `csrc/fused_langevin.cu` in which thread 0 (warp 0, which
also issues the weight tiles' bulk copies) and the last thread of block 0
of `prior_langevin_l2_kernel` read `clock64()` between the phases of a
step, runs it on the full-width cifar10 EBM widened to ndf=1024 (random
weights from seed 0) over 60 steps at 0.4 in stream mode at B=16, 256 and
500 with the chains a cluster the wrapper takes (`l2_chains`), fp32 dots,
and prints each phase's clocks per step as each thread sees them, beside
the uninstrumented wrapper's ms. The timers add registers and
instructions; the shares are what to read. The copy is made by text
replacement: if the kernel's source changes, a pattern stops matching and
the tool says which.
"""

from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import sys
import tempfile
from pathlib import Path

from .sweep_phases import card_line, time_ms

TIMER = r'''
__device__ long long g_l2_cycles[16];
#define PH(i) { const long long t_ = clock64(); ph[i] += t_ - tq; tq = t_; }
'''
READER = r'''
extern "C" int damc_l2_cycles(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_l2_cycles, sizeof(g_l2_cycles));
}
'''
KERNEL = "__global__ void __launch_bounds__(L2Shape<kM>::kThreads, 1) prior_langevin_l2_kernel("
# (pattern, replacement, times) inside the kernel: PH(i) adds the clocks since the previous timer to phase i.
PATTERNS = [
    ("  const bool noisy = seeds != nullptr || stream_noise;\n  if (tid < kM)\n",
     "  long long ph[8] = {};\n  long long tq = clock64();\n"
     "  const bool noisy = seeds != nullptr || stream_noise;\n  if (tid < kM)\n", 1),
    ("    wait_parity(full + slot, (used / kL2Stages) & 1);\n",
     "    wait_parity(full + slot, (used / kL2Stages) & 1);\n    PH(0);\n", 1),
    ("    __syncthreads();\n    issue();\n    ++used;",
     "    __syncthreads();\n    PH(1);\n    issue();\n    PH(2);\n    ++used;", 1),
    ("        if (next) put(p, stg + ((f + 1) % 2) * kM * ldk, v);",
     "        PH(3);\n        if (next) put(p, stg + ((f + 1) % 2) * kM * ldk, v);\n        PH(4);", 1),
    ("        if (active) col_product<kTc, kBf16>(acc, zt + t * kt * kM + col_chain, kM, w + col_out, cols, kt);\n",
     "        if (active) col_product<kTc, kBf16>(acc, zt + t * kt * kM + col_chain, kM, w + col_out, cols, kt);\n"
     "        PH(3);\n", 1),
    ("        if (active) row_product<kTc>(acc, xs + row_chain * ldx + t * kt, ldx, w + row_out * ldk, ldk, kt);\n",
     "        if (active) row_product<kTc>(acc, xs + row_chain * ldx + t * kt, ldx, w + row_out * ldk, ldk, kt);\n"
     "        PH(3);\n", 1),
    ("    cluster.sync();\n", "    PH(5);\n    cluster.sync();\n    PH(6);\n", 3),
    ("      zt[e] = z;\n    }\n  }\n", "      zt[e] = z;\n    }\n    PH(7);\n  }\n", 1),
    ("  cluster.sync();  // no block leaves while another may still read its partials\n",
     "  cluster.sync();  // no block leaves while another may still read its partials\n"
     "  if (blockIdx.x == 0 && (tid == 0 || tid == kThr - 1))\n"
     "    for (int i = 0; i < 8; ++i) g_l2_cycles[(tid ? 8 : 0) + i] = ph[i];\n", 1),
]
PHASES = ["waiting for a tile", "block barrier", "issuing a tile", "products", "activation copies",
          "epilogues", "cluster barriers", "z update"]
STEPS, BATCHES, NDF = 60, (16, 256, 500), 1024


def instrument(src: str) -> str:
    i = src.index(KERNEL)
    head, body = src[:i], src[i:]
    for old, new, times in PATTERNS:
        if body.count(old) != times:
            raise RuntimeError(f"fused_langevin.cu's streamed kernel no longer contains, {times} times:\n{old}")
        body = body.replace(old, new)
    head = head.replace("namespace cg = cooperative_groups;", "namespace cg = cooperative_groups;" + TIMER, 1)
    return head + body + READER


def main() -> int:
    import torch

    from damc_tpu_torch.config import preset
    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.ops.cuda import build
    from damc_tpu_torch.ops.cuda import fused_langevin as k1

    if not torch.cuda.is_available():
        print("k1_l2_phases: CUDA is not available", file=sys.stderr)
        return 1
    print(card_line())
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "fused_langevin_l2_phases.cu"
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

    cfg = preset("cifar10")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, ndf=NDF))
    w = k1.ebm_params_to_dense_weights(build_models(cfg, seed=0, device="cuda").ebm)
    nz, ndf = w[0].shape
    launch = k1.launch_widths(nz, ndf)
    if launch.smem_weights or (launch.nz, launch.ndf) != (nz, ndf):
        raise RuntimeError(f"the ndf={NDF} EBM does not take the streamed kernel at its own widths: {launch}")
    packed = torch.empty(k1.l2_packed_floats(nz, ndf), device="cuda")
    cycles = (ctypes.c_longlong * 16)()
    for b in BATCHES:
        z = torch.randn(b, nz, generator=torch.Generator().manual_seed(b)).cuda()
        out = torch.empty_like(z)
        chains = k1.l2_chains(launch.chains, b, lambda c: k1.max_active_clusters(nz, ndf, c))
        rc = lib.damc_fused_langevin(z.data_ptr(), *[t.data_ptr() for t in w], None, -1357911, 1, 0, 0, 0,
                                     launch.cluster, chains, packed.data_ptr(), out.data_ptr(), b, nz, ndf, STEPS,
                                     0.4, 0.08, torch.cuda.current_stream().cuda_stream)
        build.check(lib, rc, "instrumented K1_l2")
        torch.cuda.synchronize()
        build.check(lib, lib.damc_l2_cycles(cycles), "reading the phase clocks")
        ms = time_ms(lambda: k1.fused_prior_langevin(z, *w, seed=-1357911, steps=STEPS, step_size=0.4), 20)
        print(f"K1_l2, cifar10 EBM at ndf={ndf}, B={b} ({chains} chains a cluster), {STEPS} steps, stream: "
              f"the wrapper's call {ms:.4f} ms uninstrumented")
        for name, base in (("thread 0", 0), ("last thread", 8)):
            per_step = [cycles[base + i] / STEPS for i in range(len(PHASES))]
            total = sum(per_step)
            print(f"  {name}: clocks a step {total:.0f}; " + ", ".join(
                f"{p} {c:.0f} ({c / total:.0%})" for p, c in zip(PHASES, per_step)))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
