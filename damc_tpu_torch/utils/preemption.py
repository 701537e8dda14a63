"""Graceful preemption (the port's copy of `damc_tpu/utils/preemption.py`).

A preemptible machine gets SIGTERM shortly before it is taken away. The
training loop runs under `graceful_shutdown()`: the first SIGTERM (or
SIGINT) sets a flag the loop checks at each iteration boundary, the loop
saves a full-state checkpoint and returns, and `--resume_path auto` picks
the run up from the newest checkpoint. A second signal falls through to
the previous handler, so a double Ctrl-C still kills a hung run.
"""

from __future__ import annotations

import contextlib
import signal
import threading


class ShutdownFlag:
    """Set by the signal handler; polled by the training loop."""

    def __init__(self):
        self._event = threading.Event()
        self.signum: int | None = None

    def __bool__(self) -> bool:
        return self._event.is_set()

    def set(self, signum: int) -> None:
        self.signum = signum
        self._event.set()


@contextlib.contextmanager
def graceful_shutdown(signals=(signal.SIGTERM, signal.SIGINT)):
    """Context manager yielding a ShutdownFlag that trips on SIGTERM/SIGINT.

    Restores the previous handlers on exit. Outside the main thread (where
    Python forbids installing signal handlers) it yields a flag that never
    trips."""
    flag = ShutdownFlag()
    if threading.current_thread() is not threading.main_thread():
        yield flag
        return

    previous = {}

    def _handler(signum, frame):
        if flag:  # second signal: defer to the original behavior
            handler = previous.get(signum)
            if callable(handler):
                handler(signum, frame)
                return
            signal.signal(signum, handler or signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        flag.set(signum)

    try:
        for s in signals:
            previous[s] = signal.signal(s, _handler)
        yield flag
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
