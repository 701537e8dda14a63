"""`StepTimer`: host wall time per phase with EMA smoothing (counterpart of
`damc_tpu/utils/profiling.py:36-79`).

Its phases are host time: a launch returns before the device has
run it, so a phase that waits on the device (a metric read) absorbs the
device time of the phases before it. Time device work with CUDA events or
the profiler.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict


class StepTimer:
    """Per-phase host wall-clock timer with EMA smoothing.

        timer = StepTimer()
        with timer.phase("train_step"):
            state, metrics = step(state, x)
        metrics |= timer.report()"""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self._avg: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            prev = self._avg.get(name)
            self._avg[name] = dt if prev is None else self.ema * prev + (1 - self.ema) * dt

    def report(self, prefix: str = "time_s/") -> Dict[str, float]:
        out = {f"{prefix}{k}": v for k, v in self._avg.items()}
        for k, v in self._avg.items():
            if v > 0:
                out[f"steps_per_s/{k}"] = 1.0 / v
        return out
