"""Alternating comparison of versions of K1's bf16-dot chain.

    python3 -m damc_tpu_torch.tools.ab_k1 [DIR]

Builds the committed `csrc/fused_langevin.cu` and every `DIR/*.cu` (earlier
versions of that file with the same C entry `damc_fused_langevin`; `DIR`
also needs a copy of `counter_noise.cuh`), one nvcc each, all at once.
Then, in one process on one card, launches each with bf16 dots in turns
(forward, backward, forward, each 20 timed launches) on the same inputs:
the full-width cifar10 EBM (random weights from seed 0) at ndf=200 and
ndf=512, 60 steps at 0.4, B=256 and B=500 in stream mode and B=16 in
counter mode. The committed version launches as the wrapper does
(`launch_widths(nz, ndf, "bfloat16")`: the tensor-core variant, which pads
the widths itself); an earlier version at the fp32 route's widths and
cluster with bf16 dots set (`launch_widths(nz, ndf)`, `pad_widths`), as the
wrapper launched its bf16 variant before the tensor-core one. The library
is called directly, the inputs already padded, so a time is the kernel's.
Prints each version's median ms (CUDA events), its largest distance from
the plain bf16 version over 6 noiseless steps, the bf16 bound, the
committed wrapper's own call (`fused_prior_langevin`) and what padding the
widths with `pad_widths` on the card would add to a call. Compare versions
only within one run of this tool.
"""

from __future__ import annotations

import ctypes
import dataclasses
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

from .sweep_phases import card_line, time_ms

SHAPES = (  # (label, ndf, B, stream mode)
    ("B=256 stream", 200, 256, True),  # cifar10 training's 2B prior chains
    ("B=500 stream", 200, 500, True),  # the EBM-prior FID batch
    ("B=16 counter", 200, 16, False),  # serving's bucket
    ("ndf512 B=256 stream", 512, 256, True),
    ("ndf512 B=16 counter", 512, 16, False),
)
STEPS, STEP_SIZE = 60, 0.4
REPS = 20


def main(argv) -> int:
    import torch

    from damc_tpu_torch.config import preset
    from damc_tpu_torch.models import build_models
    from damc_tpu_torch.ops.cuda import build
    from damc_tpu_torch.ops.cuda import fused_langevin as k1
    from damc_tpu_torch.utils.flops import peak_flops

    if len(argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_k1: CUDA is not available", file=sys.stderr)
        return 1
    print(card_line())
    sources = {"committed": build.SRC_DIR / "fused_langevin.cu"}
    if argv:
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
            print(f"[build] {name}: " + "; ".join(l.strip() for l in log.splitlines() if "registers" in l))
            libs[name] = ctypes.CDLL(f"{tmp}/{name}.so")
    argtypes = k1._library().damc_fused_langevin.argtypes
    for lib in libs.values():
        lib.damc_error_string.argtypes = [ctypes.c_int]
        lib.damc_error_string.restype = ctypes.c_char_p
        lib.damc_fused_langevin.argtypes = argtypes
        lib.damc_fused_langevin.restype = ctypes.c_int

    def launcher(name, z, w, noise, steps):
        """A call of version `name`'s library on inputs padded as it takes them."""
        b, nz = z.shape
        ndf = w[0].shape[1]
        widths = k1.launch_widths(nz, ndf, "bfloat16") if name == "committed" else k1.launch_widths(nz, ndf)
        if widths.mma:
            zz, ww, nz_p, ndf_p = z, list(w), nz, ndf
        else:
            zz, *ww = k1.pad_widths(z, *w, widths.nz, widths.ndf)
            nz_p, ndf_p = widths.nz, widths.ndf
        out = torch.empty_like(zz)
        seeds = noise.get("row_seeds")
        stream = "seed" in noise
        lib = libs[name]

        def run():
            rc = lib.damc_fused_langevin(
                zz.data_ptr(), *[t.data_ptr() for t in ww], None if seeds is None else seeds.data_ptr(),
                noise.get("seed", 0), int(stream), 0, 1, int(widths.smem_weights), widths.cluster, out.data_ptr(),
                b, nz_p, ndf_p, steps, STEP_SIZE, 0.5 * STEP_SIZE * STEP_SIZE, torch.cuda.current_stream().cuda_stream)
            build.check(lib, rc, f"{name} fused_prior_langevin")
            return out[:, :nz]

        return run, widths

    cfg = preset("cifar10")
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases = {}
    for label, ndf, b, stream in SHAPES:
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, ndf=ndf))
        w = k1.ebm_params_to_dense_weights(build_models(c, seed=0, device="cuda").ebm)
        z = torch.randn(b, c.model.nz, generator=gen).cuda()
        noise = (dict(seed=-1357911) if stream else
                 dict(row_seeds=torch.randint(0, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).cuda()))
        cases[label] = (z, w, noise)
    times = {(name, label): [] for name in libs for label in cases}
    order = list(libs)
    for rep in range(3):
        for name in order if rep % 2 == 0 else order[::-1]:
            for label, (z, w, noise) in cases.items():
                run, _ = launcher(name, z, w, noise, STEPS)
                times[(name, label)].append(time_ms(run, REPS))
    peak = peak_flops(torch.cuda.get_device_name(0), "bfloat16")
    for label, (z, w, noise) in cases.items():
        b, nz = z.shape
        ndf = w[0].shape[1]
        flops = 2.0 * b * STEPS * (2 * nz * ndf + 2 * ndf * ndf)
        nbytes = 4.0 * (2 * b * nz + 3 * ndf + b) + 2 * (nz * ndf + ndf * ndf)
        bound_ms = max(flops / peak, nbytes / 3.35e12) * 1e3
        want = k1.prior_langevin_plain(z, *w, steps=6, step_size=STEP_SIZE, with_noise=False, dots_dtype="bfloat16")
        for name in libs:
            run, widths = launcher(name, z, w, {}, 6)
            err = float((run() - want).abs().max())
            print(f"[ab_k1] {label} nz={nz} ndf={ndf}: {name} at {tuple(widths)} "
                  f"{statistics.median(times[(name, label)]):.4f} ms (turns {times[(name, label)]}), "
                  f"6 noiseless steps {err:.3e} from the plain bf16 version; bound {bound_ms:.5g} ms")
        wrapper = time_ms(lambda: k1.fused_prior_langevin(z, *w, steps=STEPS, step_size=STEP_SIZE,
                                                          dots_dtype="bfloat16", **noise), REPS)
        nz_p, ndf_p = k1.launch_widths(nz, ndf, "bfloat16")[:2]
        pad = time_ms(lambda: k1.pad_widths(z, *w, nz_p, ndf_p), REPS)
        print(f"[ab_k1] {label}: the committed wrapper's call {wrapper:.4f} ms; pad_widths to ({nz_p}, {ndf_p}) "
              f"on the card {pad:.4f} ms")
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
