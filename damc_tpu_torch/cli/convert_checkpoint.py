"""CLI: a reference `.pth.tar` checkpoint -> a port training checkpoint.

Counterpart of `python -m damc_tpu.cli.convert_checkpoint`. Reads a
reference checkpoint (`G_state_dict`, `E_state_dict`, `Q_state_dict`,
`Q_dummy_state_dict`, `iter`: the `train_gen_recon.py:282-294` save format,
or what `damc_tpu_torch.cli.export_checkpoint` writes) and writes the
port's full training state (`utils/checkpoint.py`) under
<out_dir>/<name>, which the train CLIs' `--resume_path` takes. G, E and Q
load strictly, Q_ema from `Q_dummy_state_dict` (a file without it gets
Q_ema = Q), and the iteration count carries over; the optimizers start
fresh (Adam moments are not in the reference format). The toy has no E.

    python -m damc_tpu_torch.cli.convert_checkpoint --dataset cifar10 \\
        --torch_ckpt best.pth.tar --out_dir converted [--device cpu]
    python -m damc_tpu_torch.cli.train_gen_recon --dataset cifar10 ... \\
        --resume_path converted/<iter>

The configuration comes from the train CLIs' flags (`--dataset` and the
width flags of the run that wrote the file); `--seed` seeds the state's
generator (default 0).
"""

from __future__ import annotations

import argparse
import os

from .common import add_common_flags, config_from_args, refuse_mesh


def main(argv=None) -> str:
    """Convert; returns the written checkpoint's path."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(p)
    p.add_argument("--torch_ckpt", required=True, help="reference-format .pth.tar")
    p.add_argument("--out_dir", required=True, help="directory of the written checkpoint")
    p.add_argument("--name", default=None, help="checkpoint name (default: the file's iter)")
    args = p.parse_args(argv)

    from ..convert import load_reference_checkpoint
    from ..train.state import create_state
    from ..utils.checkpoint import save_checkpoint

    refuse_mesh(args)
    cfg = config_from_args(args)
    state = create_state(cfg, 0 if args.seed is None else args.seed, args.device)
    state.step = load_reference_checkpoint(state.models, args.torch_ckpt, state.amortizer_ema)
    name = args.name or str(state.step)
    path = save_checkpoint(args.out_dir, name, state)
    print(f"[damc] wrote converted checkpoint (iter {state.step}) to {path}")
    print(f"[damc] resume with: --resume_path {os.path.join(args.out_dir, name)}")
    return path


if __name__ == "__main__":
    main()
