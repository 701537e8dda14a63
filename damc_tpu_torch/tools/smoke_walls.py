"""Where chip_smoke.py's time goes: run it with a wall-clock timer around
each of its top-level functions, the CLIs' `main`s, a few library calls
(model and state construction, checkpoint writes, `torch.save`/`load`,
the profiler's `key_averages` and exit) and the same in the data-parallel
ranks it starts, and append every call of a second or more to a file,
one line each: process id, clock time, the call (indented by nesting)
and its seconds.

    python -m damc_tpu_torch.tools.smoke_walls [--out build/smoke_walls.txt]

Run from the repository's root on a machine with a card; chip_smoke's own
output and exit code are unchanged. The timers cost microseconds a call.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import inspect
import os
import sys
import threading
import time

LIBRARY = (("damc_tpu_torch.models", ("build_models",)),
           ("damc_tpu_torch.models.stylegan", ("build_stylegan",)),
           ("damc_tpu_torch.train.stylegan_inv", ("create_inversion_state", "invert_batch")),
           ("damc_tpu_torch.utils.checkpoint", ("save_checkpoint",)),
           ("damc_tpu_torch.data.datasets", ("load_image_folder",)))
CLIS = ("convert_checkpoint", "eval_anomaly_det", "eval_gen_recon", "eval_stylegan_inv", "export_checkpoint",
        "serve", "toy", "train_anomaly_det", "train_gen_recon")
FLOOR_S = 1.0  # calls shorter than this are not written
_depth = threading.local()


def _wrap(owner, name: str, label: str, out: str) -> None:
    fn = getattr(owner, name)
    if getattr(fn, "_timed", False):
        return

    @functools.wraps(fn)
    def call(*args, **kwargs):
        depth = getattr(_depth, "d", 0)
        _depth.d = depth + 1
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            _depth.d = depth
            seconds = time.perf_counter() - t0
            if seconds >= FLOOR_S:
                with open(out, "a") as f:
                    f.write(f"{os.getpid()} {time.strftime('%H:%M:%S')} {'  ' * depth}{label} {seconds:.2f}\n")

    call._timed = True
    setattr(owner, name, call)


def install(out: str) -> None:
    """Wrap chip_smoke's functions and the library calls above, and make
    the data-parallel ranks chip_smoke starts install the same timers."""
    import subprocess

    import torch
    import torch.profiler

    import chip_smoke

    for name, fn in list(vars(chip_smoke).items()):
        if inspect.isfunction(fn) and fn.__module__ == "chip_smoke" and name not in ("main", "dp_rank"):
            _wrap(chip_smoke, name, name, out)
    for module, names in LIBRARY:
        m = importlib.import_module(module)
        for name in names:
            _wrap(m, name, f"{module.rsplit('.', 1)[1]}.{name}", out)
    for cli in CLIS:
        _wrap(importlib.import_module(f"damc_tpu_torch.cli.{cli}"), "main", f"cli.{cli}.main", out)
    _wrap(torch.profiler.profile, "key_averages", "profile.key_averages", out)
    _wrap(torch.profiler.profile, "__exit__", "profile.__exit__", out)
    _wrap(torch, "save", "torch.save", out)
    _wrap(torch, "load", "torch.load", out)
    base = subprocess.Popen

    class Popen(base):
        def __init__(self, args, *rest, **kwargs):
            if isinstance(args, list) and len(args) > 2 and "chip_smoke.dp_rank" in str(args[2]):
                args = args[:2] + [f"import sys, chip_smoke; from damc_tpu_torch.tools import smoke_walls; "
                                   f"smoke_walls.install({out!r}); sys.exit(chip_smoke.dp_rank())"] + args[3:]
            super().__init__(args, *rest, **kwargs)

    subprocess.Popen = Popen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "smoke_walls.txt"))
    args = ap.parse_args(argv)
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    sys.path.insert(0, os.getcwd())  # chip_smoke.py sits at the repository's root
    install(out)
    import chip_smoke

    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
