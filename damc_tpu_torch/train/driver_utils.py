"""Host-loop plumbing of the training drivers (counterpart of
`damc_tpu/train/driver_utils.py:26-66, 154-192, 280-436`), for one process:
resume-path resolution (with `auto`, the preemption-recovery mode), the
log and checkpoint directories, the contrastive-divergence gap monitor and
the preemption checkpoint. The multi-host pieces (batch placement, host
shards, metric broadcast) are not ported (ROADMAP.md, queue 1, item 8).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np

from ..utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..utils.logging import MetricsLogger


def resolve_resume_path(resume_path: Optional[str], ckpt_dir: Optional[str]) -> Optional[str]:
    """'auto' -> the newest integer checkpoint in this run's ckpt dir (None
    when the run is fresh); anything else passes through."""
    if resume_path != "auto":
        return resume_path
    step_no = latest_step(ckpt_dir) if ckpt_dir else None
    return os.path.join(ckpt_dir, str(step_no)) if step_no is not None else None


def restore_for_resume(state, resume_path: Optional[str], ckpt_dir: Optional[str]):
    """Returns (state, start_iter), restoring the whole state in place when
    resuming: weights, Q_ema, every optimizer and the generator."""
    resume_path = resolve_resume_path(resume_path, ckpt_dir)
    if not resume_path:
        return state, 0
    directory, name = os.path.split(resume_path.rstrip("/"))
    state = restore_checkpoint(directory, name, state)
    start_iter = int(state.step)
    print(f"[damc] resumed from {resume_path} at iteration {start_iter}", flush=True)
    return state, start_iter


def init_driver_logging(log_dir: Optional[str]) -> Tuple[MetricsLogger, Optional[str]]:
    """(logger, ckpt_dir): metrics go to <log_dir>/metrics.jsonl and
    checkpoints to <log_dir>/ckpt; without a log_dir, to stdout only and
    nowhere."""
    ckpt_dir = os.path.join(log_dir, "ckpt") if log_dir else None
    return MetricsLogger(log_dir), ckpt_dir


def cd_history_path(logger_path: Optional[str], resume_path: Optional[str]) -> Optional[str]:
    """metrics.jsonl to replay into the CD-gap monitor on resume.

    `--resume_path auto` relaunches into the original run dir, so the
    current logger's jsonl is the pre-resume history. An explicit
    `--resume_path <run>/ckpt/<step>` lands in a fresh dir whose jsonl is
    empty: then the resumed run's own metrics.jsonl, two levels up from the
    checkpoint, is the history."""
    if logger_path and os.path.exists(logger_path) and os.path.getsize(logger_path):
        return logger_path
    if resume_path and resume_path != "auto":
        run_dir = os.path.dirname(os.path.dirname(resume_path.rstrip("/")))
        cand = os.path.join(run_dir, "metrics.jsonl")
        if os.path.exists(cand):
            return cand
    return logger_path


class CDGapMonitor:
    """Early warning for EBM contrastive-divergence runaway: the alarm
    (`cd_gap_alarm` = 1, and one log line) fires once |e_pos - e_neg|
    exceeds `factor` times the median gap of the first `warmup`
    observations, or `gap_ceiling` when that is larger. Detection only: the
    training is not touched. The JAX package's docstring gives the
    characterisation (artifacts/CD_DIVERGENCE.md)."""

    def __init__(self, warmup: int = 20, factor: float = 50.0, gap_ceiling: Optional[float] = None):
        self._warm = []
        self.warmup = warmup
        self.factor = factor
        self.gap_ceiling = gap_ceiling
        self.fired_at = None

    def update(self, it: int, host_metrics, quiet: bool = False) -> dict:
        if "e_pos" not in host_metrics or "e_neg" not in host_metrics:
            return {}
        gap = abs(host_metrics["e_pos"] - host_metrics["e_neg"])
        if len(self._warm) < self.warmup:
            self._warm.append(gap)
            return {"cd_gap_alarm": 0.0}
        base = max(float(np.median(self._warm)), 1e-3)
        threshold = self.factor * base
        if self.gap_ceiling is not None:
            threshold = max(threshold, self.gap_ceiling)
        alarmed = gap > threshold
        if alarmed and self.fired_at is None:
            self.fired_at = it
            if not quiet:
                print(
                    f"[damc] WARNING: contrastive-divergence gap runaway at "
                    f"iteration {it}: |e_pos - e_neg| = {gap:.3e} > "
                    f"threshold {threshold:.3e} ({self.factor:.0f}x warmup "
                    f"median {base:.3e}"
                    + (f", ceiling {self.gap_ceiling:.3e}" if self.gap_ceiling is not None else "")
                    + "). The EBM prior chains have likely stopped mixing; later "
                    "checkpoints will not improve (best-ckpt gating preserves the "
                    "optimum). See artifacts/CD_DIVERGENCE.md.",
                    flush=True,
                )
        return {"cd_gap_alarm": 1.0 if alarmed else 0.0}

    def seed_from_history(self, metrics_path: Optional[str], upto_iter: int) -> None:
        """Replay the pre-resume gap trajectory (metrics.jsonl rows of phase
        train before `upto_iter`) into the monitor, so a resumed run keeps
        its warmup baseline and its alarm."""
        if not metrics_path or not os.path.exists(metrics_path):
            return
        with open(metrics_path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail line from a preempted writer
                if row.get("phase") != "train":
                    continue
                step = row.get("step")
                if step is None or step >= upto_iter:
                    continue
                self.update(int(step), row, quiet=True)
        if self.fired_at is not None:
            print(
                f"[damc] note: resumed run had already tripped the CD-gap alarm at "
                f"iteration {self.fired_at}; alarm stays armed with the pre-resume "
                "warmup baseline.",
                flush=True,
            )


def cd_gap_ceiling(e_energy_reg: float) -> Optional[float]:
    """CDGapMonitor ceiling with the E-energy regularizer alpha: 1.25 / alpha
    (the stationary gap is 1 / alpha); None when alpha = 0."""
    return 1.25 / e_energy_reg if e_energy_reg > 0.0 else None


def preemption_checkpoint(shutdown, ckpt_dir: Optional[str], it: int, state) -> None:
    """Save the full state at a signal-interrupted iteration boundary."""
    if ckpt_dir:
        path = save_checkpoint(ckpt_dir, str(it), state)
        print(f"[damc] signal {shutdown.signum}: checkpointed to {path}; exiting", flush=True)
