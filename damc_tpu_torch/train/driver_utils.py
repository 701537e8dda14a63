"""Host-loop plumbing of the training drivers (counterpart of
`damc_tpu/train/driver_utils.py:26-66, 154-192, 280-436`), for one process:
resume-path resolution (with `auto`, the preemption-recovery mode), the
log and checkpoint directories, the contrastive-divergence gap monitor, the
preemption checkpoint, the training-batch source (`make_batch_source`:
the device-resident store or the host feed), and the loop around the
iterations that the gen_recon and anomaly drivers share (`MetricsReport`,
`run_loop`).

Data parallelism (a `parallel.Mesh`): every rank is a process, so these
follow the JAX package's multi-host branches. Each rank reads its own
shard of the training set (`host_shard`) in batches of B / world
(`local_batch_size`), seeded seed + rank * 7919; rank 0 alone writes the
logs, grids and checkpoints (`is_primary`, `init_driver_logging`,
`save_state`: the other ranks wait at a barrier after each save); every
rank resumes from rank 0's path (`restore_for_resume`); a preemption
signal stops every rank at the same iteration once one rank has it
(`shutdown_agreed`); and a score that gates a save is rank 0's on every
rank (`broadcast_metric`). Every rank holds a whole replica of the state,
so JAX's `host_local_state` has no counterpart.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..data.device_data import DEFAULT_DEVICE_BUDGET_BYTES, DeviceDataset, fits_device
from ..data.native_loader import make_loader
from ..data.prefetch import Prefetcher
from ..parallel.mesh import Mesh, broadcast_object, replicate
from ..utils.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..utils.logging import MetricsLogger
from ..utils.preemption import graceful_shutdown


def is_primary(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes the run's files: rank 0, or the only one."""
    return mesh is None or mesh.rank == 0


def host_shard(images, mesh: Optional[Mesh]):
    """This rank's disjoint share of the training set, strided (every
    world-th image from its rank on), as JAX's `host_shard`; the whole set
    without a mesh."""
    return images if mesh is None else images[mesh.rank::mesh.world]


def local_batch_size(global_batch: int, mesh: Optional[Mesh]) -> int:
    """This rank's share of the global training batch."""
    if mesh is None:
        return global_batch
    if global_batch % mesh.world:
        raise ValueError(f"global batch_size {global_batch} must divide across {mesh.world} ranks")
    return global_batch // mesh.world


def shutdown_agreed(shutdown, mesh: Optional[Mesh]) -> bool:
    """Whether any rank has a preemption signal (an all-reduce MAX of the
    flag, at the same loop point on every rank): every rank then stops at
    the same iteration, none is left in a collective of the next one."""
    local = bool(shutdown)
    if mesh is None:
        return local
    flag = torch.tensor([int(local)], dtype=torch.int32, device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def broadcast_metric(value: float, mesh: Optional[Mesh]) -> float:
    """Rank 0's value on every rank. A branch into a save (the best
    checkpoint) is gated on it: the ranks' evals may differ in the last
    ulp, and a save some ranks enter and others skip would leave them at
    different barriers."""
    if mesh is None:
        return float(value)
    t = torch.tensor([float(value)], dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, src=0)
    return float(t.item())


def save_state(ckpt_dir: str, name: str, state, mesh: Optional[Mesh]) -> Optional[str]:
    """`save_checkpoint` on rank 0; every rank then waits at a barrier, so
    none reads or replaces the checkpoint before it is whole."""
    path = save_checkpoint(ckpt_dir, name, state) if is_primary(mesh) else None
    if mesh is not None:
        dist.barrier()
    return path


def state_tensors(state) -> list:
    """The parameters and buffers of every network of a `TrainState`."""
    m = state.models
    mods = [m.generator, m.ebm, m.amortizer, state.amortizer_ema]
    return [t for mod in mods if mod is not None for t in mod.state_dict().values()]


def replicate_state(mesh: Optional[Mesh], state, global_batch: int) -> None:
    """Before a data-parallel run (JAX's `make_step_fn` under a mesh): the
    global batch must divide over the ranks, and every network is made
    rank 0's on every rank. They are built from the one seed, or restored
    from the one checkpoint, so this changes nothing unless a rank went
    astray. A no-op without a mesh."""
    if mesh is not None:
        local_batch_size(global_batch, mesh)
        replicate(mesh, state_tensors(state))


def resolve_resume_path(resume_path: Optional[str], ckpt_dir: Optional[str]) -> Optional[str]:
    """'auto' -> the newest integer checkpoint in this run's ckpt dir (None
    when the run is fresh); anything else passes through."""
    if resume_path != "auto":
        return resume_path
    step_no = latest_step(ckpt_dir) if ckpt_dir else None
    return os.path.join(ckpt_dir, str(step_no)) if step_no is not None else None


def restore_for_resume(state, resume_path: Optional[str], ckpt_dir: Optional[str], mesh: Optional[Mesh] = None):
    """Returns (state, start_iter), restoring the whole state in place when
    resuming: weights, Q_ema, every optimizer and the generator. With a
    mesh every rank restores the path rank 0 resolved."""
    resume_path = broadcast_object(mesh, resolve_resume_path(resume_path, ckpt_dir))
    if not resume_path:
        return state, 0
    directory, name = os.path.split(resume_path.rstrip("/"))
    state = restore_checkpoint(directory, name, state)
    start_iter = int(state.step)
    if is_primary(mesh):
        print(f"[damc] resumed from {resume_path} at iteration {start_iter}", flush=True)
    return state, start_iter


def init_driver_logging(log_dir: Optional[str], mesh: Optional[Mesh] = None) -> Tuple[MetricsLogger, Optional[str]]:
    """(logger, ckpt_dir): metrics go to <log_dir>/metrics.jsonl and
    checkpoints to <log_dir>/ckpt; without a log_dir, to stdout only and
    nowhere. With a mesh, rank 0 alone writes and echoes the metrics, and
    every rank knows ckpt_dir (to resume from it)."""
    ckpt_dir = os.path.join(log_dir, "ckpt") if log_dir else None
    primary = is_primary(mesh)
    return MetricsLogger(log_dir if primary else None, echo=primary), ckpt_dir


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


def make_stream(loader):
    """loader.stream(), with background prefetch for loaders that do not
    already overlap batch assembly (the C++ engine does)."""
    stream = loader.stream()
    if not getattr(loader, "native_prefetch", False):
        stream = Prefetcher(stream, depth=2)
    return stream


def put_batch(x_np: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host batch on `device`. To a card it goes through pinned memory
    with a copy that does not block the host: `pin_memory()` copies the
    batch into a block of PyTorch's caching host allocator, which records
    the copy's event on the stream and hands the block out again only after
    the copy has landed, so no later batch can overwrite it in flight. On
    the CPU the batch is used as it is (each host batch is a fresh array)."""
    x = torch.from_numpy(x_np)
    if device.type != "cuda":
        return x
    return x.pin_memory().to(device, non_blocking=True)


def make_batch_source(
    train_images, tc, seed: int, device: Union[str, torch.device], augment_flip: bool = True,
    mesh: Optional[Mesh] = None,
):
    """One `next_batch()` per training iteration, on `device` either way
    (counterpart of `damc_tpu/train/driver_utils.py::make_batch_source`).

    Placement (`tc.data_placement`):
      * 'device', or 'auto' when the store is a uint8 or float32 ndarray
        under the device budget (`tc.data_device_budget_gb`, default
        `DEFAULT_DEVICE_BUDGET_BYTES`): `DeviceDataset`, the whole store on
        the card, each batch a gather and flip there. 'device' over the
        budget raises ValueError, as in JAX.
      * 'host', or 'auto' over the budget or for a lazy store: the host
        loader (the C++ engine for uint8 arrays, the NumPy `Loader`
        otherwise, the JAX package's streams for the same seed), a
        background `Prefetcher` where the loader has no threads of its own,
        then `put_batch`.

    With a mesh, this rank's shard of the store (`host_shard`) in batches
    of B / world (`local_batch_size`), seeded seed + rank * 7919, through
    the same placement rule.

    Returns (next_batch, close, placement); `close()` stops the host
    loader's threads."""
    placement = getattr(tc, "data_placement", "auto")
    if placement not in ("auto", "device", "host"):
        raise ValueError(f"data_placement must be auto|device|host, got {placement!r}")
    device = torch.device(device)
    batch_size = local_batch_size(tc.batch_size, mesh)
    if mesh is not None:
        train_images = host_shard(train_images, mesh)
        seed = seed + mesh.rank * 7919
    budget_gb = getattr(tc, "data_device_budget_gb", None)
    budget = int(budget_gb * (1 << 30)) if budget_gb is not None else DEFAULT_DEVICE_BUDGET_BYTES
    eligible = fits_device(train_images, budget)
    if placement == "device" and not eligible:
        raise ValueError(
            f"data_placement='device' but the store is ineligible (a lazy dataset, or over the device budget "
            f"of {budget / (1 << 30):g} GiB): use 'auto' or 'host'"
        )
    if placement != "host" and eligible:
        stream = DeviceDataset(
            train_images, batch_size=batch_size, augment_flip=augment_flip, seed=seed, device=device,
        ).stream()
        return (lambda: next(stream)[0]), (lambda: None), "device"

    loader = make_loader(train_images, batch_size=batch_size, shuffle=True, drop_last=True,
                         augment_flip=augment_flip, seed=seed)
    stream = make_stream(loader)

    def next_batch():
        x_np, _ = next(stream)
        return put_batch(x_np, device)

    def close():
        stream.close()
        if hasattr(loader, "close"):
            loader.close()

    return next_batch, close, "host"


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


def preemption_checkpoint(shutdown, ckpt_dir: Optional[str], it: int, state, mesh: Optional[Mesh] = None) -> None:
    """Save the full state at a signal-interrupted iteration boundary (a
    rank that never had the signal reports signum None)."""
    if ckpt_dir:
        path = save_state(ckpt_dir, str(it), state, mesh)
        if is_primary(mesh):
            print(f"[damc] signal {shutdown.signum}: checkpointed to {path}; exiting", flush=True)


class MetricsReport:
    """The `print_every` report of a training loop: the metrics read back
    to the host, a FloatingPointError on any non-finite value (a NaN'd run
    would otherwise train blind: the CD monitor never alarms on NaN gaps,
    and best-checkpoint gating keeps a stale best), the CD-gap monitor, the
    wall rate since the last report, one log row."""

    def __init__(self, logger: MetricsLogger, cd_monitor: CDGapMonitor):
        self.logger = logger
        self.cd_monitor = cd_monitor
        self.last = None  # (iteration, perf_counter) of the last report

    def __call__(self, it: int, metrics, extra: Optional[Dict[str, float]] = None) -> None:
        host = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in host.items() if not math.isfinite(v)]
        if bad:
            raise FloatingPointError(f"non-finite training metrics {bad} at iteration {it}; last metrics: {host}")
        out = self.cd_monitor.update(it, host)
        now = time.perf_counter()
        if self.last is not None and it > self.last[0]:
            out["iters_per_s_wall"] = (it - self.last[0]) / (now - self.last[1])
        self.last = (it, now)
        self.logger.log(it, {**host, **(extra or {}), **out})


def run_loop(
    tc, state, start_iter: int, iterations: int, ckpt_dir: Optional[str],
    iterate: Callable[[int], None], run_eval: Optional[Callable[[int], None]] = None,
    mesh: Optional[Mesh] = None,
) -> bool:
    """The iterations [start_iter, iterations) of a driver, as the JAX
    drivers run them: before each, a SIGTERM or SIGINT checkpoints `state`
    at that iteration and stops the loop; `iterate(it)` runs the iteration
    and its reports; then every `ckpt_every` iterations (not at 0) a
    checkpoint and every `eval_every` a `run_eval(it)`. The reference's loop
    is inclusive of the last iteration and this one keeps step ==
    iterations, so after the last one the tail is saved and scored here
    unless the intervals just did it. Returns whether a signal stopped it.
    With a mesh the ranks agree on the signal (`shutdown_agreed`) and rank
    0 saves (`save_state`)."""
    with graceful_shutdown() as shutdown:
        for it in range(start_iter, iterations):
            if shutdown_agreed(shutdown, mesh):
                preemption_checkpoint(shutdown, ckpt_dir, it, state, mesh)
                return True
            iterate(it)
            if ckpt_dir and tc.ckpt_every > 0 and it > 0 and it % tc.ckpt_every == 0:
                save_state(ckpt_dir, str(it), state, mesh)
            if run_eval is not None and tc.eval_every > 0 and it % tc.eval_every == 0:
                run_eval(it)
        if iterations > start_iter:
            last_it = iterations - 1
            if ckpt_dir and tc.ckpt_every > 0 and not (last_it > 0 and last_it % tc.ckpt_every == 0):
                save_state(ckpt_dir, str(last_it), state, mesh)
            if run_eval is not None and tc.eval_every > 0 and last_it % tc.eval_every != 0:
                run_eval(last_it)
    return False
