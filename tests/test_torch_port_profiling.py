"""The port's tracing hooks (`damc_tpu_torch/utils/profiling.py`): `trace`
writes a Chrome trace of its block into the directory, in which an
`annotate` span appears by name, and `StepTimer` reports its phases."""

from __future__ import annotations

import json

import torch

from damc_tpu_torch.utils.profiling import StepTimer, annotate, trace


def test_trace_writes_a_chrome_trace_with_the_annotated_span(tmp_path):
    with trace(str(tmp_path / "traces")) as prof:
        with annotate("damc/test_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "traces").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "damc/test_span"]
    assert spans and all(e.get("ph") == "X" and e["dur"] >= 0 for e in spans)
    assert any(e.key == "damc/test_span" for e in prof.key_averages())


def test_annotate_outside_a_trace_is_a_no_op():
    with annotate("damc/untraced"):
        assert torch.equal(torch.ones(2) + 1, torch.full((2,), 2.0))


def test_step_timer_reports_each_phase():
    timer = StepTimer(ema=0.5)
    for _ in range(2):
        with timer.phase("step"):
            pass
    report = timer.report()
    assert report["time_s/step"] >= 0.0
    assert set(report) <= {"time_s/step", "steps_per_s/step"}
