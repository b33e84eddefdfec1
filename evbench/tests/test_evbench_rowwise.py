"""The row-wise training cells (`kinds/train_rowwise.py`): MLPerf's
DLRM-DCNv2 with bags of a length per table, and the Kaggle DLRM under
rwsadagrad.  Their readers on records made by hand, the bags' stream, the
operation and byte counts, and small runs on the CPU: a sound run is
correct, and the TF32 control and each fault the cell can have are not."""

import numpy as np
import pytest
import torch

from evbench import harness, inputs, tracing
from evbench.kinds import train_rowwise as kind
from evbench.roofline import dcnv2, k2, k5, k8, peaks
from evbench.tests import cases
from evbench.traffic import bags

DCN = "mlperf-dcnv2.train.rwsadagrad-b16384"
KAG = "kaggle.train.rwsadagrad-b65536"
# the DCNv2 cell at CPU size: its widths, tables cut, batches of 64
DCN_B = 64


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def dcn_dims():
    cfg = harness.config_of(harness.manifest(),
                            harness.cell(harness.manifest(), DCN))
    return kind.model_dims(cfg)


def dcn_record():
    """Two traced steps of a DLRM-DCNv2 record, B = 4: per step three K8
    forwards, three backwards with their bias sums, a grouped gather, two
    K5 launches, the input and cross spans."""
    events = []
    for s in range(2):
        t = 1000 * s
        events += [ev("evbench.step", "user_annotation", t, 1000),
                   ev("train_step", "user_annotation", t + 10, 980),
                   ev("train_step.inputs", "user_annotation", t + 10, 100),
                   ev("train_step.inputs.check", "user_annotation", t + 10,
                      50),
                   ev("train_step.inputs.copy", "user_annotation", t + 60,
                      50),
                   ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy",
                      t + 60, 40),
                   ev("train_step.gather", "user_annotation", t + 110, 20),
                   ev("void gather_kernel<uint4, unsigned int, Grouped<"
                      "uint4> >(int)", "kernel", t + 130, 30),
                   ev("train_step.forward_backward", "user_annotation",
                      t + 130, 600),
                   ev("dlrm.cross", "user_annotation", t + 200, 60),
                   ev("dlrm.cross.backward", "user_annotation", t + 400, 90)]
        for k in range(3):
            events += [
                ev("void dcn::cross_fwd_kernel<4>(float const*, float "
                   "const*, float const*, float const*, float*, long, int)",
                   "kernel", t + 200 + 20 * k, 10),
                ev("void dcn::cross_bwd_kernel<4>(float const*, float "
                   "const*)", "kernel", t + 400 + 30 * k, 15),
                ev("dcn::cross_bias_sum_kernel(float const*, float*, int, "
                   "int)", "kernel", t + 415 + 30 * k, 2)]
        events += [ev("train_step.row_update", "user_annotation", t + 800,
                      150),
                   ev("void chunk_sums_kernel<float>(int)", "kernel",
                      t + 820, 20),
                   ev("void chunk_sums_kernel<float>(int)", "kernel",
                      t + 900, 20)]
    tr = tracing.reduce_trace(events)
    tr.update(window_s=2000e-6, steps=2, unique_keys=[700, 600])
    return {"kind": "train_rowwise", "steps": 10, "batch_size": 4,
            "window_s": 0.5, "dims": dcn_dims(), "trace": tr,
            "gathered_rows_per_step": 4 * 214}


def test_the_new_readers_on_a_record_made_by_hand():
    rec = dcn_record()
    d = rec["dims"]
    N = 27 * 128
    assert dcnv2.cross_width(d) == N and sum(d["bag_sizes"]) == 214
    # K8: three layers a step; 2 steps x 3 x (10 + 15 + 2) us of device
    k8_share = harness.reader("k8_roofline.train")(rec)
    assert k8_share == pytest.approx(
        100 * 2 * k8.step_bound(4, N, 3) / (2 * 3 * 27e-6))
    assert harness.reader("train.cross_ms_per_step")(rec) == \
        pytest.approx(1e3 * (60e-6 + 90e-6))
    assert harness.reader("mfu.train_dcnv2")(rec) == pytest.approx(
        100 * dcnv2.train_flops(d, 4) * 10 / 0.5 / peaks.F32_FLOPS)
    assert harness.reader("k2_roofline.train_bags")(rec) == \
        pytest.approx(100 * (k2.bound(4 * 214, 700, 128)
                             + k2.bound(4 * 214, 600, 128)) / 2 / 30e-6)
    assert harness.reader("k5_roofline.train_bags")(rec) == \
        pytest.approx(100 * (k5.bound(4 * 214, 700, 128)
                             + k5.bound(4 * 214, 600, 128)) / 2 * 4 / 80e-6)


def test_the_appended_readers_read_a_dcnv2_record():
    rec = dcn_record()
    assert harness.reader("train.launches_per_step")(rec) == 13
    assert harness.reader("device_idle.train")(rec) == pytest.approx(
        100 * (1 - rec["trace"]["busy_s"] / 2000e-6))
    assert harness.reader("train.input_ms_per_step")(rec) == \
        pytest.approx(0.1)
    assert harness.reader("train.input_idle_ms_per_step")(rec) is not None
    assert harness.reader("train.host_ms_per_step")(rec) == pytest.approx(
        1e3 * (20 + 600 + 150) * 1e-6)


def test_the_kaggle_rowwise_record_reads_as_the_accepted_k2_and_k5():
    """One id a table (bags of 1): the accepted K2 and K5 readers take
    B x T entries, as the bag readers take B x sum L_t, and count each of
    K5's two launches a step at its per-call bound."""
    rec = dcn_record()
    d = kind.model_dims(harness.config_of(
        harness.manifest(), harness.cell(harness.manifest(), KAG)))
    assert d["bag_sizes"] == [1] * 26
    kag = dict(rec, dims=d)
    for acc, bags_ in (("k2_roofline.train", "k2_roofline.train_bags"),
                       ("k5_roofline.train", "k5_roofline.train_bags")):
        assert harness.reader(acc)(kag) == pytest.approx(
            harness.reader(bags_)(kag))
    assert harness.reader("k5_roofline.train")(kag) == pytest.approx(
        100 * (k5.bound(4 * 26, 700, d["dim"])
               + k5.bound(4 * 26, 600, d["dim"])) / 2 * 4 / 80e-6)


def test_readers_read_none_where_there_is_nothing_to_read():
    rec = dcn_record()
    kag = dict(rec, dims=dict(rec["dims"], interaction="dot"))
    assert harness.reader("mfu.train_dcnv2")(kag) is None
    assert harness.reader("k8_roofline.train")(kag) is None
    no_trace = dict(rec, trace=None)
    for name in ("k8_roofline.train", "train.cross_ms_per_step",
                 "k2_roofline.train_bags", "k5_roofline.train_bags"):
        assert harness.reader(name)(no_trace) is None
    # a program without the cross spans (the parent of the change)
    tr = dict(rec["trace"], spans={k: v for k, v in
                                   rec["trace"]["spans"].items()
                                   if not k.startswith("dlrm")})
    assert harness.reader("train.cross_ms_per_step")(
        dict(rec, trace=tr)) is None


def test_k8_and_the_step_counts_by_hand():
    assert k8.forward_cost(2, 5) == (4 * (4 * 10 + 5), 30)
    assert k8.backward_cost(2, 5, True) == (4 * (6 * 10 + 10), 50)
    assert k8.backward_cost(2, 5, False) == (4 * (5 * 10 + 10), 50)
    # 1.58 TFLOP a step of 16,384: 96.25 MFLOP a sample
    assert dcnv2.train_flops(dcn_dims(), 16384) == pytest.approx(
        1.577e12, rel=1e-3)
    # the cross layers are 66% of a sample's multiply-adds
    d = dcn_dims()
    mlp = sum(m * n for w in (d["mlp_bot"], d["mlp_top"])
              for m, n in zip(w[:-1], w[1:]))
    cross = 3 * 2 * 3456 * 512
    assert round(cross / (mlp + cross), 2) == 0.66


def test_the_configuration_holds_one_chips_share_of_the_recipe():
    cfg = harness.config_of(harness.manifest(),
                            harness.cell(harness.manifest(), DCN))
    pub, held = cfg["num_embeddings_per_feature"], cfg["arch_embedding_size"]
    assert sum(pub) == 204_184_588 and sum(held) == 54_184_588
    assert [h for p, h in zip(pub, held) if p != h] == [10_000_000] * 5
    assert all(h == p // 4 for p, h in zip(pub, held) if p == 40_000_000)
    d = kind.model_dims(cfg)
    assert d["mlp_top"] == [3456, 1024, 1024, 512, 256, 1]
    assert d["mlp_bot"] == [13, 512, 256, 128]
    entry = [c for c in harness.manifest()["configs"]
             if c["name"] == "mlperf-dcnv2"][0]
    assert entry["reduced"] == ["arch_embedding_size"]


def test_the_bags_stream_repeats_and_keeps_each_column_in_its_table():
    mix = {"batch_size": 512, "ids": {"distribution":
                                      "zipf_first_uniform_rest",
                                      "zipf_alpha": 1.05}}
    sizes, L = [3, 1000, 5000], [2, 1, 4]
    seed = 2 ** 31 + 5
    a = bags.make_bag_batches(mix, sizes, L, 13, seed, 3, "cpu")
    b = bags.make_bag_batches(mix, sizes, L, 13, seed, 3, "cpu")
    c = bags.make_bag_batches(mix, sizes, L, 13, seed + 1, 3, "cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[1], c[1])
    idx = a[1]
    assert idx.shape == (3, 512, 7)
    lim = np.repeat(sizes, L)
    assert ((idx >= 0) & (idx < lim)).all()
    # a bag's first id is skewed, the rest are not
    first, rest = idx[:, :, 3].ravel(), idx[:, :, 4:].ravel()
    top_first = np.bincount(first, minlength=5000).max() / first.size
    top_rest = np.bincount(rest, minlength=5000).max() / rest.size
    assert top_first > 0.05 > 10 * top_rest


@pytest.mark.parametrize("name", [KAG, DCN])
def test_a_sound_run_is_correct(name):
    kw = {"batch_size": DCN_B} if name == DCN else {}
    # the stretch from the window's first step: one step traced at least
    line, out = cases.run(name, trace=True, seconds=1.0, trace_skip=0, **kw)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0
    want = {m["name"] for m in harness.metrics_for(harness.manifest(),
                                                   name, True)}
    assert set(line["metrics"]) <= want and line["metrics"]
    rec = out["record"]
    # the CPU's plain gather counts no rows
    assert rec["gathered_rows_per_step"] is None
    assert rec["trace"]["steps"] >= 1
    if name == DCN:
        assert sum(rec["dims"]["bag_sizes"]) == 214
        assert "train.cross_ms_per_step" in line["metrics"]


def _fault_readings(name, batch_size):
    bench, wl, cfg, mix, limits = cases.tiny(name, batch_size=batch_size)
    dims = kind.model_dims(cfg)
    seed = 17
    batches = kind.draw_batches(mix, dims, seed, int(mix["pool_batches"]),
                                "cpu")
    w = inputs.mlp_weights(seed, dims, "cpu")
    w["cross"] = kind.cross_weights(seed, dims, "cpu")
    touched = kind.touched_rows(batches[1][:3], dims["bag_sizes"], "cpu")
    rows0 = [inputs.table(seed, t, n, dims["dim"], "cpu")[touched[t]]
             for t, n in enumerate(dims["table_sizes"])]
    return {f: kind.readings(dims, w, rows0, touched, batches,
                             float(cfg["learning_rate"]), "cpu", None, f)
            for f in kind.faults_of(dims)}, limits


@pytest.mark.parametrize("name", [KAG, DCN])
def test_the_control_and_each_fault_fail_the_limits(name):
    got, limits = _fault_readings(name, DCN_B if name == DCN else 256)
    want = ["tf32", "half_batch"] + (["drop_slot", "no_residual"]
                                     if name == DCN else [])
    assert sorted(got) == sorted(want)
    for fault, r in got.items():
        assert any(r[k] > limits[k] for k in r), (fault, r)


def test_a_faulty_step_in_the_program_fails_the_check():
    from evstore_tpu_torch.train import train_loop
    make = train_loop.make_train_step

    def half(cfg, tcfg):
        step = make(cfg, tcfg)

        def run(model, st, dense, idx, y, bw=None):
            h = len(y) // 2
            return step(model, st, dense[:h], idx[:h], y[:h], bw)
        return run

    train_loop.make_train_step = half
    try:
        line, _ = cases.run(KAG)
    finally:
        train_loop.make_train_step = make
    assert not line["correct"], line["checks"]


def test_a_program_without_dcnv2_fails_before_drawing(monkeypatch):
    """The DLRM-DCNv2 cell on a program that lacks `mlperf_dcnv2_config`
    (the parent of the change) raises before any input is drawn."""
    from evstore_tpu_torch import config as pcfg
    monkeypatch.delattr(pcfg, "mlperf_dcnv2_config")
    drawn = []
    monkeypatch.setattr(kind, "draw_batches",
                        lambda *a, **k: drawn.append(a))
    with pytest.raises(ImportError):
        cases.run(DCN, batch_size=DCN_B)
    assert drawn == []


def test_the_dcnv2_cell_gathers_every_slot_and_no_more(monkeypatch):
    """On the CPU the gather's plain version counts nothing, so count the
    rows the step's grouped gather is handed."""
    from evstore_tpu_torch.models import embedding
    seen = []
    real = embedding.gather_rows_grouped

    def counting(tables, idx):
        seen.append(idx.numel())
        return real(tables, idx)

    monkeypatch.setattr(embedding, "gather_rows_grouped", counting)
    cases.run(DCN, batch_size=DCN_B, seconds=0.1)
    assert seen and set(seen) == {DCN_B * 214}


def test_the_rowwise_controls_read_each_fault(monkeypatch):
    from evbench import rowwise_controls
    bench, wl, cfg, mix, limits = cases.tiny(KAG)
    r = rowwise_controls.readings(cfg, mix, 5, torch.device("cpu"))
    assert set(r) == {"tf32", "half_batch", "unchanged"}
    assert r["unchanged"] == {"grad_gap": 1.0, "change_gap": 1.0}
