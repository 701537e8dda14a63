"""CLI: a port training checkpoint -> a reference-format `.pth.tar`.

Counterpart of `python -m damc_tpu.cli.export_checkpoint`, the reverse of
`damc_tpu_torch.cli.convert_checkpoint`. Writes {G,Q,Q_dummy,E}_state_dict
and `iter` (the `train_gen_recon.py:163-170` resume format; the toy's has
no E), which `load_state_dict(strict=True)` takes into the reference
networks: the port's modules keep the reference key layout, so the state
dicts are written as the checkpoint holds them, as float32 CPU tensors.
Q_dummy is the checkpoint's Q_ema.

    python -m damc_tpu_torch.cli.export_checkpoint \\
        --ckpt logs/cifar10/<run>/ckpt/best --out best_export.pth.tar
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> dict:
    """Export; returns the written dict."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt", required=True, help="a port checkpoint directory, <run>/ckpt/<name>")
    p.add_argument("--out", required=True, help="output .pth.tar path")
    args = p.parse_args(argv)

    import torch

    from ..utils.checkpoint import FILE

    saved = torch.load(os.path.join(args.ckpt, FILE), map_location="cpu", weights_only=True)
    parts = {"G_state_dict": "generator", "Q_state_dict": "amortizer", "Q_dummy_state_dict": "amortizer_ema",
             "E_state_dict": "ebm"}
    missing = [key for key, part in parts.items() if part != "ebm" and saved[part] is None]
    if missing:
        raise ValueError(f"{args.ckpt} lacks {missing}: not a gen_recon, anomaly or toy training checkpoint")
    out = {"iter": int(saved["step"])}
    for key, part in parts.items():
        if saved[part] is not None:
            out[key] = {k: v.detach().float().cpu().contiguous() for k, v in saved[part].items()}
    torch.save(out, args.out)
    print(f"[damc] exported iteration {out['iter']} to {args.out} "
          f"(reference {{G,Q,Q_dummy,E}}_state_dict format)")
    return out


if __name__ == "__main__":
    main()
