"""The trace's reduction and the readers over a trace made by hand."""

import pytest

from evbench import harness, tracing


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    ev("void (anonymous namespace)::interaction_fwd_kernel<float, float4>"
       "(float const*)", "kernel",
       100, 10),
    ev("void gather_kernel<float4, unsigned int, TwoSources>(int)", "kernel",
       105, 10),                              # overlaps the first
    ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 200, 20),
    ev("train_step.row_update", "user_annotation", 110, 95),
    ev("evbench.step", "user_annotation", 50, 300),
    ev("ProfilerStep#3", "user_annotation", 0, 1000),
    ev("aten::mm", "cpu_op", 0, 5),
]


def test_reduce_trace_unions_busy_time_and_names_gaps():
    r = tracing.reduce_trace(EVENTS)
    assert r["busy_s"] == pytest.approx(35e-6)
    assert r["device_ops_n"] == 3
    assert r["kernels"]["(anonymous namespace)::interaction_fwd_kernel"] == {
        "launches": 1, "seconds": pytest.approx(10e-6)}
    assert r["kernels"]["gather_kernel"]["launches"] == 1
    assert r["kernels"]["gpu_memcpy"]["seconds"] == pytest.approx(20e-6)
    # the gap 115-200 lies in the row update's span, the innermost one
    assert r["idle_gaps"] == [["train_step.row_update",
                               pytest.approx(85e-6)]]
    assert "ProfilerStep#3" not in r["spans"]
    assert r["spans"]["evbench.step"]["count"] == 1
    assert tracing.short_name("void a::b<int>(float)") == "a::b"


def test_readers_on_a_record():
    tr = tracing.reduce_trace(EVENTS)
    tr.update(window_s=100e-6, steps=1, unique_keys=[10])
    rec = {"kind": "train", "steps": 4, "batch_size": 2, "window_s": 0.5,
           "dims": {"dim": 4, "table_sizes": [5, 5, 5],
                    "mlp_bot": [2, 4], "mlp_top": [10, 1]}, "trace": tr}
    assert harness.reader("train.host_ms_per_step")(rec) == pytest.approx(
        1e3 * 95e-6)
    assert harness.reader("train.launches_per_step")(rec) == 3
    assert harness.reader("device_idle.train")(rec) == pytest.approx(65.0)
    from evbench.roofline import k1, step
    assert harness.reader("k1_roofline.train")(rec) == pytest.approx(
        100 * k1.bound(2, 3, 4) / 10e-6)
    assert harness.reader("mfu.train")(rec) == pytest.approx(
        100 * step.train_flops(rec["dims"], 2) * 4 / 0.5 / 67e12)
    rec["trace"] = None
    assert harness.reader("k1_roofline.train")(rec) is None
    assert harness.reader("device_idle.train")(rec) is None
