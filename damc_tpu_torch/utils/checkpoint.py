"""Full-state checkpoints of a `TrainState` (counterpart of
`damc_tpu/utils/checkpoint.py`).

One checkpoint is one file, `<directory>/<name>/state.pt`, written by
`torch.save` and read back by `torch.load(weights_only=True)`. It holds the
whole state, so a resumed run continues exactly: the iteration count, the
run seed, the state dicts of G, E, Q and Q_ema, each optimizer's torch
state dict and update count, and the device generator's state. A part the
state lacks (the toy's E, and its G and E optimizers) is saved as None,
and a restore requires the target to lack the same parts. `name` is
an iteration number or `best`, as in the JAX package's layout, so
`<run>/ckpt/<iteration>` names a checkpoint there and here.

A save writes into a `<name>.tmp-*` staging directory and commits it with
`os.replace`; `latest_step` accepts digit names only, so a save cut short
is never picked up. Replacing an existing checkpoint (`best`) first moves
the old one aside, so a reader sees the old or the new one, or for a moment
none, never a mixture.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch

FILE = "state.pt"


def _module_state(module) -> Optional[dict]:
    return None if module is None else module.state_dict()


def _opt_state(opt) -> Optional[dict]:
    return None if opt is None else {"torch": opt.opt.state_dict(), "count": int(opt.count)}


def state_payload(state) -> dict:
    """The dict `save_checkpoint` writes for a `TrainState`."""
    m, o = state.models, state.opts
    return {
        "step": int(state.step),
        "seed": int(state.seed),
        "generator": m.generator.state_dict(),
        "ebm": _module_state(m.ebm),
        "amortizer": m.amortizer.state_dict(),
        "amortizer_ema": state.amortizer_ema.state_dict(),
        "opt_g": _opt_state(o.g),
        "opt_e": _opt_state(o.e),
        "opt_q": _opt_state(o.q),
        "rng": state.rng.get_state(),
    }


def save_checkpoint(directory: str, name: str, state) -> str:
    """Save `state` under <directory>/<name> (e.g. '100000' or 'best');
    returns that path."""
    directory = os.path.abspath(directory)
    path = os.path.join(directory, name)
    os.makedirs(directory, exist_ok=True)
    staging = tempfile.mkdtemp(prefix=f"{name}.tmp-", dir=directory)
    try:
        torch.save(state_payload(state), os.path.join(staging, FILE))
        old = None
        if os.path.exists(path):
            old = tempfile.mkdtemp(prefix=f"{name}.old-", dir=directory)
            os.replace(path, os.path.join(old, name))
        os.replace(staging, path)
    except BaseException:
        shutil.rmtree(staging, ignore_errors=True)
        raise
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)
    return path


def _check_present(key: str, target_part, saved_part) -> bool:
    """Whether `key` is to be loaded: the target and the checkpoint must
    both hold it or both lack it."""
    if (target_part is None) != (saved_part is None):
        have, saved = ("lacks", "holds") if target_part is None else ("holds", "lacks")
        raise ValueError(f"restore_checkpoint: the target state {have} {key!r}, the checkpoint {saved} it")
    return target_part is not None


def _load_module(key: str, module, saved: dict) -> None:
    if _check_present(key, module, saved[key]):
        module.load_state_dict(saved[key], strict=True)


def _load_opt(key: str, opt, saved: dict) -> None:
    if _check_present(key, opt, saved[key]):
        opt.opt.load_state_dict(saved[key]["torch"])
        opt.count = int(saved[key]["count"])


def restore_checkpoint(directory: str, name: str, target):
    """Load <directory>/<name> into `target`, a `TrainState` of the same
    configuration, in place (its modules and optimizers keep their
    identity, so a train step built on them goes on working); returns it."""
    path = os.path.join(os.path.abspath(directory), name, FILE)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    m, o = target.models, target.opts
    _load_module("generator", m.generator, saved)
    _load_module("ebm", m.ebm, saved)
    _load_module("amortizer", m.amortizer, saved)
    _load_module("amortizer_ema", target.amortizer_ema, saved)
    _load_opt("opt_g", o.g, saved)
    _load_opt("opt_e", o.e, saved)
    _load_opt("opt_q", o.q, saved)
    target.rng.set_state(saved["rng"])
    target.step = int(saved["step"])
    target.seed = int(saved["seed"])
    return target


def latest_step(directory: str) -> Optional[int]:
    """Largest integer-named checkpoint in `directory`, or None. Staging
    (`<name>.tmp-*`) and `best` directories fail the digit test."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory) if d.isdigit()]
    return max(steps) if steps else None
