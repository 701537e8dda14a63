"""Alternating comparison of versions of K1: the bf16-dot chain and the
streamed variant (K1_l2).

    python3 -m damc_tpu_torch.tools.ab_k1 [DIR]

Builds the committed `csrc/fused_langevin.cu` and every `DIR/*.cu` (earlier
versions of that file with the C entry `damc_fused_langevin`; `DIR` also
needs a copy of `counter_noise.cuh`), one nvcc each, all at once. Then, in
one process on one card, launches each in turns (forward, backward,
forward, each 20 timed launches) on the same inputs, the full-width
cifar10 EBM (random weights from seed 0) at the widths below, 60 steps at
0.4, in stream mode at B=256 and B=500 and in counter mode at B=16:

  * bf16 dots at ndf=200 and 512. The committed version launches as the
    wrapper does (`launch_widths(nz, ndf, "bfloat16")`: the tensor-core
    variant, which pads the widths itself); an earlier version at the fp32
    route's widths and cluster with bf16 dots set, as the wrapper launched
    its bf16 variant before the tensor-core one;
  * ndf=1024, fp32 and bf16 dots, where both take the variant that reads
    the weights from L2: the committed one the streamed kernel at its
    tiling (`l2_tiling`, the chains a cluster `l2_chains` takes, its packed
    scratch), an earlier one (whose C entry has no `chains` and no scratch,
    as before the streamed kernel) over clusters of 4, nz padded to a
    multiple of 4 and ndf to one of 16;
  * ndf=512, fp32, the committed version only: the streamed kernel at its
    tiling of those widths beside K1_c8, which the route takes there;
  * ndf=200, fp32 dots, every version at the fp32 route's widths and
    cluster (`launch_widths(nz, ndf)`): the kernel that holds the weights
    on chip, to show a change to the file left it as it was.

The library is called directly, the inputs already padded, so a time is
the kernel's (the streamed kernel's with its packing). Prints each
version's median ms (CUDA events), its largest distance from the plain
version of its dot precision over 6 noiseless steps, the bound, and for
bf16 at ndf=200 and 512 the committed wrapper's own call
(`fused_prior_langevin`) and what padding the widths with `pad_widths` on
the card would add to a call. Compare versions only within one run of this
tool.
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

# (label, ndf, B, stream mode, dots dtype, route): route "mma" the bf16
# comparison, "l2" the streamed one, "c8" the streamed kernel beside K1_c8,
# "fp32" the on-chip fp32 kernel.
SHAPES = (
    ("B=256 stream", 200, 256, True, "bfloat16", "mma"),  # cifar10 training's 2B prior chains
    ("B=500 stream", 200, 500, True, "bfloat16", "mma"),  # the EBM-prior FID batch
    ("B=16 counter", 200, 16, False, "bfloat16", "mma"),  # serving's bucket
    ("ndf512 B=256 stream", 512, 256, True, "bfloat16", "mma"),
    ("ndf512 B=16 counter", 512, 16, False, "bfloat16", "mma"),
    ("ndf1024 B=500 stream", 1024, 500, True, "float32", "l2"),  # the ndf=1024 EBM-prior FID batch
    ("ndf1024 B=256 stream", 1024, 256, True, "float32", "l2"),
    ("ndf1024 B=16 counter", 1024, 16, False, "float32", "l2"),
    ("ndf1024 B=256 stream bf16", 1024, 256, True, "bfloat16", "l2"),
    ("ndf1024 B=16 counter bf16", 1024, 16, False, "bfloat16", "l2"),
    ("ndf512 B=256 stream fp32", 512, 256, True, "float32", "c8"),
    ("B=256 stream fp32", 200, 256, True, "float32", "fp32"),
    ("B=16 counter fp32", 200, 16, False, "float32", "fp32"),
)
STEPS, STEP_SIZE = 60, 0.4
REPS = 20
OLD_L2_CLUSTER = 4  # the variant that read the weights from L2 before the streamed kernel


def _has(lib, name: str) -> bool:
    try:
        getattr(lib, name)
        return True
    except AttributeError:
        return False


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
    new_args = k1._library().damc_fused_langevin.argtypes
    old_args = new_args[:13] + new_args[15:]  # without chains and the scratch
    streamed = {}
    for name, lib in libs.items():
        lib.damc_error_string.argtypes = [ctypes.c_int]
        lib.damc_error_string.restype = ctypes.c_char_p
        streamed[name] = _has(lib, "damc_fused_langevin_l2_tiling")
        lib.damc_fused_langevin.argtypes = new_args if streamed[name] else old_args
        lib.damc_fused_langevin.restype = ctypes.c_int

    def launcher(name, z, w, noise, steps, dots, route):
        """A call of version `name`'s library on inputs padded as it takes them."""
        b, nz = z.shape
        ndf = w[0].shape[1]
        bf16 = dots == "bfloat16"
        if route == "mma":
            widths = k1.launch_widths(nz, ndf, "bfloat16") if name == "committed" else k1.launch_widths(nz, ndf)
        elif route == "fp32":
            widths = k1.launch_widths(nz, ndf)
        elif streamed[name]:
            widths = k1.launch_widths(nz, ndf, dots)
            if route == "c8":
                t = k1.l2_tiling(nz, ndf)
                widths = k1.Launch(t.nz, t.ndf, False, k1.L2_CLUSTER, bf16, t.chains)
        else:
            widths = k1.Launch(-(-nz // 4) * 4, -(-ndf // 16) * 16, False, OLD_L2_CLUSTER, bf16)
        if widths.mma:
            zz, ww, nz_p, ndf_p = z, list(w), nz, ndf
        else:
            zz, *ww = k1.pad_widths(z, *w, widths.nz, widths.ndf)
            nz_p, ndf_p = widths.nz, widths.ndf
        out = torch.empty_like(zz)
        seeds = noise.get("row_seeds")
        stream = "seed" in noise
        lib = libs[name]
        extra = []
        if streamed[name]:
            chains, packed = k1.ROWS, None
            if not widths.smem_weights:
                chains = k1.l2_chains(widths.chains, b, lambda c: k1.max_active_clusters(nz_p, ndf_p, c, bf16))
                packed = torch.empty(k1.l2_packed_floats(nz_p, ndf_p), device=z.device)
            extra = [chains, None if packed is None else packed.data_ptr()]

        def run():
            rc = lib.damc_fused_langevin(
                zz.data_ptr(), *[t.data_ptr() for t in ww], None if seeds is None else seeds.data_ptr(),
                noise.get("seed", 0), int(stream), 0, int(bf16), int(widths.smem_weights), widths.cluster, *extra,
                out.data_ptr(), b, nz_p, ndf_p, steps, STEP_SIZE, 0.5 * STEP_SIZE * STEP_SIZE,
                torch.cuda.current_stream().cuda_stream)
            build.check(lib, rc, f"{name} fused_prior_langevin")
            return out[:, :nz]

        return run, widths

    cfg = preset("cifar10")
    gen = torch.Generator(device="cpu").manual_seed(0)
    cases, weights = {}, {}
    for label, ndf, b, stream, dots, route in SHAPES:
        if ndf not in weights:
            c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, ndf=ndf))
            weights[ndf] = k1.ebm_params_to_dense_weights(build_models(c, seed=0, device="cuda").ebm)
        z = torch.randn(b, cfg.model.nz, generator=gen).cuda()
        noise = (dict(seed=-1357911) if stream else
                 dict(row_seeds=torch.randint(0, 2**31 - 1, (b,), generator=gen, dtype=torch.int32).cuda()))
        cases[label] = (z, weights[ndf], noise, dots, route)
    versions = {label: ["committed"] if route == "c8" else list(libs) for label, *_, route in SHAPES}
    times = {(name, label): [] for label in cases for name in versions[label]}
    for rep in range(3):
        for label, (z, w, noise, dots, route) in cases.items():
            order = versions[label] if rep % 2 == 0 else versions[label][::-1]
            for name in order:
                run, _ = launcher(name, z, w, noise, STEPS, dots, route)
                times[(name, label)].append(time_ms(run, REPS))
    for label, (z, w, noise, dots, route) in cases.items():
        b, nz = z.shape
        ndf = w[0].shape[1]
        wb = 2 if dots == "bfloat16" else 4
        flops = 2.0 * b * STEPS * (2 * nz * ndf + 2 * ndf * ndf)
        nbytes = 4.0 * (2 * b * nz + 3 * ndf + b) + wb * (nz * ndf + ndf * ndf)
        bound_ms = max(flops / peak_flops(torch.cuda.get_device_name(0), dots), nbytes / 3.35e12) * 1e3
        want = k1.prior_langevin_plain(z, *w, steps=6, step_size=STEP_SIZE, with_noise=False, dots_dtype=dots)
        for name in versions[label]:
            run, widths = launcher(name, z, w, {}, 6, dots, route)
            err = float((run() - want).abs().max())
            what = (f"{widths.cluster} blocks" if widths.smem_weights else
                    f"streamed, {widths.nz}x{widths.ndf}" if streamed[name] else f"from L2 over {widths.cluster}")
            print(f"[ab_k1] {label} nz={nz} ndf={ndf} {dots}: {name} ({what}) "
                  f"{statistics.median(times[(name, label)]):.4f} ms (turns {times[(name, label)]}), "
                  f"6 noiseless steps {err:.3e} from the plain version; bound {bound_ms:.5g} ms")
        if route == "c8":
            kw = dict(seed=noise.get("seed"), steps=STEPS, step_size=STEP_SIZE)
            c8 = time_ms(lambda: k1.fused_prior_langevin(z, *w, **kw), REPS)
            print(f"[ab_k1] {label}: the route's variant there, "
                  f"{k1.launch_widths(nz, ndf)} through the wrapper, {c8:.4f} ms")
        if route == "mma":
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
