"""The readers of the train step's input spans over a trace made by hand:
`train.input_ms_per_step` and `train.input_idle_ms_per_step`."""

import pytest

from evbench import harness, tracing

IN_MS = harness.reader("train.input_ms_per_step")
IN_IDLE = harness.reader("train.input_idle_ms_per_step")


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def record(events, steps=1):
    tr = tracing.reduce_trace(events)
    tr.update(window_s=400e-6, steps=steps)
    return {"kind": "train", "trace": tr}


# one step: the dense copy at 100-110, the host's id check 110-150 with the
# device idle, the ids' and labels' copies, then the stage spans
STEP = [
    ev("evbench.step", "user_annotation", 0, 400),
    ev("train_step", "user_annotation", 10, 380),
    ev("train_step.inputs", "user_annotation", 20, 160),
    ev("train_step.inputs.copy", "user_annotation", 20, 90),
    ev("train_step.inputs.check", "user_annotation", 110, 40),
    ev("train_step.inputs.copy", "user_annotation", 150, 15),
    ev("train_step.inputs.copy", "user_annotation", 165, 15),
    ev("train_step.gather", "user_annotation", 200, 20),
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 100, 10),
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 150, 10),
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 165, 5),
    ev("gather_kernel", "kernel", 210, 30),
]


def test_readers_over_a_step_with_its_input_spans():
    rec = record(STEP, steps=2)
    # 160 µs in `train_step.inputs` over two steps
    assert IN_MS(rec) == pytest.approx(1e3 * 160e-6 / 2)
    # gaps 110-150 (.check) and 160-165 (.copy) are the inputs'; 170-210
    # has its middle in `train_step`, outside the inputs
    gaps = dict(rec["trace"]["idle_gaps"])
    assert gaps["train_step.inputs.check"] == pytest.approx(40e-6)
    assert gaps["train_step"] == pytest.approx(40e-6)
    assert IN_IDLE(rec) == pytest.approx(1e3 * 45e-6 / 2)


def test_input_idle_reads_zero_when_the_gaps_lie_elsewhere():
    events = [e for e in STEP if e["cat"] != "gpu_memcpy"] + [
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 20, 170)]
    rec = record(events)
    assert IN_MS(rec) == pytest.approx(1e3 * 160e-6)
    assert IN_IDLE(rec) == 0.0


def test_readers_read_none_without_a_trace_or_the_span():
    for rec in ({"kind": "train", "trace": None}, {"kind": "train"}):
        assert IN_MS(rec) is None and IN_IDLE(rec) is None
    # a program with only the four stage spans (no input spans)
    rec = record([e for e in STEP if not e["name"].startswith("train_step")
                  or e["name"] == "train_step.gather"])
    assert IN_MS(rec) is None and IN_IDLE(rec) is None
