"""The reader of the train step's staged inputs over a trace made by hand:
`train.staged_input_share`."""

import pytest

from evbench import harness, tracing

SHARE = harness.reader("train.staged_input_share")


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def record(events, steps=1):
    tr = tracing.reduce_trace(events)
    tr.update(window_s=400e-6, steps=steps)
    return {"kind": "train", "trace": tr}


def step(t0, staged):
    """One step's spans from t0: the id check, then for each of three
    inputs a host write into its staging buffer (where `staged`) and its
    copy, queued on the copy stream."""
    out = [ev("evbench.step", "user_annotation", t0, 400),
           ev("train_step", "user_annotation", t0 + 10, 380),
           ev("train_step.inputs", "user_annotation", t0 + 20, 160),
           ev("train_step.inputs.check", "user_annotation", t0 + 20, 40),
           ev("train_step.gather", "user_annotation", t0 + 200, 20),
           ev("gather_kernel", "kernel", t0 + 210, 30)]
    for k in range(3):
        t = t0 + 60 + 40 * k
        if staged:
            out.append(ev("train_step.inputs.stage", "user_annotation", t,
                          25))
        out += [ev("train_step.inputs.copy", "user_annotation", t + 25, 10),
                ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", t + 30,
                   5)]
    return out


def test_every_copy_staged_reads_100():
    rec = record(step(0, True) + step(400, True), steps=2)
    assert SHARE(rec) == pytest.approx(100.0)


def test_no_copy_staged_reads_0():
    rec = record(step(0, False) + step(400, False), steps=2)
    assert SHARE(rec) == 0.0


def test_reads_none_without_copy_spans_or_a_trace():
    events = [e for e in step(0, True)
              if e["name"] != "train_step.inputs.copy"]
    assert SHARE(record(events)) is None
    for rec in ({"kind": "train", "trace": None}, {"kind": "train"}):
        assert SHARE(rec) is None
