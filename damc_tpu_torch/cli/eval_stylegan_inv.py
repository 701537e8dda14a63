"""CLI: StyleGAN inversion evaluation (FFHQ, LSUN-tower).

    python -m damc_tpu_torch.cli.eval_stylegan_inv --data_path <image folder> \
        --pretrained_G_path styleganinv_ffhq256_generator.pth \
        --pretrained_E_path styleganinv_ffhq256_encoder.pth \
        --pretrained_F_path vgg16.pth [--q_ckpt_dir <dir> --q_ckpt_name best] [--device cpu]

As `python -m damc_tpu.cli.eval_stylegan_inv`: loads the pretrained
StyleGAN generator, inversion encoder and VGG16 (`models/stylegan.py::
load_stylegan`) and Q from the port's own checkpoint format
(`utils/checkpoint.py`; without `--q_ckpt_dir`, Q has random weights from
seed 0), sweeps the test images with the Q init and `--g_l_steps` Adam
steps, and prints the recon MSE and the Frechet distance of the
reconstructions (`frechet_rand` without the Inception weights). Every draw
comes from `--seed`, so two runs print the same numbers. Not ported:
`--compute_dtype bfloat16` (ROADMAP.md, queue 1, item 2b), `--use_mesh`
(item 8) and LSUN's lmdb folders (item 4b).
"""

from __future__ import annotations

import argparse
import dataclasses
import os.path as osp

import torch


def main(argv=None):
    """Score Q; returns {metric: value}."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--dataset", type=str, default="ffhq", choices=["ffhq", "lsun_tower"])
    p.add_argument("--data_path", type=str, required=True,
                   help="folder of test images, or (lsun_tower) the LSUN root")
    p.add_argument("--lsun_classes", type=str, default="tower_val", help="comma-separated LSUN classes")
    p.add_argument("--pretrained_G_path", type=str, required=True)
    p.add_argument("--pretrained_E_path", type=str, required=True)
    p.add_argument("--pretrained_F_path", type=str, required=True, help="vgg16.pth")
    p.add_argument("--q_ckpt_dir", type=str, default=None, help="checkpoint directory of a trained Q")
    p.add_argument("--q_ckpt_name", type=str, default="best")
    p.add_argument("--resolution", type=int, default=256, help="StyleGAN resolution (published models: 256)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--compute_dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="Adam-refine dtype (the port computes in float32; bfloat16 raises)")
    p.add_argument("--g_l_steps", type=int, default=100)
    p.add_argument("--g_l_step_size", type=float, default=0.01)
    p.add_argument("--n_fid_samples", type=int, default=50000)
    p.add_argument("--limit", type=int, default=None, help="cap on test images")
    p.add_argument("--use_mesh", action="store_true", help="data-parallel over all devices (not ported)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.compute_dtype != "float32":
        raise NotImplementedError(
            "--compute_dtype bfloat16 is not ported (ROADMAP.md, queue 1, item 2b): the port computes "
            "in float32"
        )
    if args.use_mesh:
        raise NotImplementedError("--use_mesh (several devices) is not ported (ROADMAP.md, queue 1, item 8)")
    first = args.lsun_classes.split(",")[0] + "_lmdb"
    if args.dataset == "lsun_tower" and osp.isdir(osp.join(args.data_path, first)):
        raise NotImplementedError(
            f"{osp.join(args.data_path, first)}: LSUN's lmdb reader is not ported (ROADMAP.md, queue 1, "
            "item 4b); give a folder of decoded images instead"
        )

    from ..config import preset
    from ..data.datasets import load_image_folder
    from ..device import resolve_device
    from ..metrics.fid import compute_stats, images_to_unit
    from ..models.stylegan import load_stylegan
    from ..train.stylegan_inv import create_inversion_state, evaluate_inversion
    from ..utils.checkpoint import restore_checkpoint
    from .common import make_feature_fn, to_pm1

    device = resolve_device(args.device)
    res = args.resolution
    nets = load_stylegan(args.pretrained_G_path, args.pretrained_E_path, args.pretrained_F_path, res, device)
    cfg = preset("celebaHQ")  # the 256^2 diffusion settings, as the JAX CLI
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, image_size=res))
    state = create_inversion_state(cfg, res, 0, device)
    if args.q_ckpt_dir:
        state = restore_checkpoint(args.q_ckpt_dir, args.q_ckpt_name, state)
        print(f"[damc] restored Q (step {state.step}) from {args.q_ckpt_dir}/{args.q_ckpt_name}", flush=True)
    else:
        print("[damc] WARNING: no --q_ckpt_dir given; using random Q init")
    q = state.models.amortizer.eval().requires_grad_(False)

    images = to_pm1(load_image_folder(args.data_path, res, limit=args.limit))
    feature_fn, metric_name = make_feature_fn(cfg, device)
    unit = images_to_unit(images[: args.n_fid_samples])
    real_mu, real_sigma = compute_stats(
        feature_fn, (torch.from_numpy(unit[i : i + 64]).to(device) for i in range(0, len(unit), 64))
    )
    out = evaluate_inversion(
        q, nets, images, batch=args.batch_size, steps=args.g_l_steps, lr=args.g_l_step_size,
        seed=args.seed, feature_fn=feature_fn, real_mu=real_mu, real_sigma=real_sigma,
        fid_metric_name=metric_name,
    )
    label = "FID" if metric_name == "fid" else metric_name
    print(f"[damc] recon MSE {out['recon_mse']:.5f} {label} {out.get(metric_name, float('nan')):.3f}", flush=True)
    return out


if __name__ == "__main__":
    main()
