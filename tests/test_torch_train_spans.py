"""The train step's `torch.profiler` spans, on the CPU: `train_step` around
the whole step, `train_step.inputs` around bringing the batch to the device
(its host id check `.inputs.check` and each copy `.inputs.copy`), and the
four stage spans inside `train_step`; and `utils/profiling.py::span`, which
makes no `record_function` call while no profiler runs."""

import json

import numpy as np
import pytest
import torch

from evstore_tpu_torch.config import TrainConfig, make_dlrm_config
from evstore_tpu_torch.models.dlrm import DLRM
from evstore_tpu_torch.train.train_loop import (init_opt_state,
                                                make_train_step, train)
from evstore_tpu_torch.utils import staging
from evstore_tpu_torch.utils.profiling import profile_trace, span

SIZES = (50, 35, 20)
STAGES = ("train_step.gather", "train_step.forward_backward",
          "train_step.dense_update", "train_step.row_update")
PARENT = {"train_step.inputs": "train_step",
          "train_step.inputs.check": "train_step.inputs",
          "train_step.inputs.copy": "train_step.inputs",
          **{s: "train_step" for s in STAGES}}


def _model():
    cfg = make_dlrm_config(4, SIZES, (8,), (6,), num_dense=3)
    return cfg, DLRM(cfg, device="cpu", seed=0)


def _batches(n, B=8, L=None, seed=0):
    """n one-hot (dense, idx [B, T], y) batches, or with L bags of L ids
    and their weights (dense, idx [B, T, L], w, y)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        shape = (B, len(SIZES)) + (() if L is None else (L,))
        idx = np.stack([rng.integers(0, n_t, shape[:1] + shape[2:])
                        for n_t in SIZES], axis=1).astype(np.int32)
        dense = rng.random((B, 3), dtype=np.float32)
        y = rng.integers(0, 2, B).astype(np.float32)
        out.append((dense, idx, y) if L is None else
                   (dense, idx, rng.random(shape, dtype=np.float32), y))
    return out


def _spans(path):
    """The trace's host spans: name -> [(start, end)] in µs."""
    out = {}
    for e in json.load(open(path))["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ts = float(e["ts"])
            out.setdefault(e["name"], []).append((ts, ts + float(e["dur"])))
    return out


def _inside(child, parents):
    a, b = child
    return any(pa - 1e-3 <= a and b <= pb + 1e-3 for pa, pb in parents)


@pytest.mark.parametrize("L,copies", [(None, 3), (2, 4)],
                         ids=["one-hot", "bag-weights"])
def test_train_exports_the_step_spans_nested(tmp_path, L, copies):
    cfg, model = _model()
    steps = 3
    with profile_trace(str(tmp_path)):
        train(model, cfg, TrainConfig(batch_size=8, learning_rate=0.1),
              _batches(steps, L=L), log_fn=lambda *_: None)
    spans = _spans(tmp_path / "trace.json")
    assert len(spans["train_step"]) == steps
    assert len(spans["train_step.inputs"]) == steps
    assert len(spans["train_step.inputs.check"]) == steps
    assert len(spans["train_step.inputs.copy"]) == copies * steps
    for name in STAGES:
        assert len(spans[name]) == steps, name
    for child, parent in PARENT.items():
        for iv in spans[child]:
            assert _inside(iv, spans[parent]), (child, iv)


@pytest.mark.parametrize("L", [None, 2], ids=["one-hot", "bag-weights"])
def test_the_id_check_ends_before_the_first_copy(tmp_path, L):
    cfg, model = _model()
    with profile_trace(str(tmp_path)):
        train(model, cfg, TrainConfig(batch_size=8, learning_rate=0.1),
              _batches(3, L=L), log_fn=lambda *_: None)
    spans = _spans(tmp_path / "trace.json")
    for step in spans["train_step"]:
        (check,) = [iv for iv in spans["train_step.inputs.check"]
                    if _inside(iv, [step])]
        copies = [iv for iv in spans["train_step.inputs.copy"]
                  if _inside(iv, [step])]
        assert copies and check[1] <= min(a for a, _ in copies), step


@pytest.mark.parametrize("bad", [-1, 35], ids=["negative", "size"])
def test_a_bad_id_raises_before_any_copy_or_update(monkeypatch, bad):
    from evstore_tpu_torch.train import train_loop
    cfg, model = _model()
    tcfg = TrainConfig(batch_size=8, learning_rate=0.1)
    step = make_train_step(cfg, tcfg)
    opt_state = init_opt_state(model, tcfg)
    dense, idx, y = _batches(1)[0]
    idx[5, 1] = bad
    before = {k: v.clone() for k, v in model.state_dict().items()}
    copies, staged = [], []
    real = train_loop._tensor
    real_stage = staging.InputRing.stage

    def tensor(*args):
        copies.append(args)
        return real(*args)

    def stage(*args):
        staged.append(args)
        return real_stage(*args)
    monkeypatch.setattr(train_loop, "_tensor", tensor)
    monkeypatch.setattr(staging.InputRing, "stage", staticmethod(stage))
    with pytest.raises(ValueError, match=f"row id {bad} of table 1 is "
                       r"outside \[0, 35\)"):
        step(model, opt_state, dense, idx, y)
    assert copies == [] and staged == []
    assert opt_state.step == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_run_training_steps_through_the_same_spans(tmp_path):
    from evstore_tpu_torch.drivers.train import run_training
    cfg, _ = _model()
    batches = _batches(2, seed=1)
    with profile_trace(str(tmp_path)):
        res = run_training(cfg, TrainConfig(batch_size=8, learning_rate=0.1),
                           lambda: batches, log_fn=lambda *_: None,
                           device="cpu")
    assert res.steps == 2
    spans = _spans(tmp_path / "trace.json")
    assert len(spans["train_step.inputs"]) == 2
    for iv in spans["train_step.inputs"]:
        assert _inside(iv, spans["train_step"])


def _spy(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def record_function(name, *args):
        calls.append(name)
        return real(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    return calls


def test_span_makes_no_record_function_call_without_a_profiler(
        monkeypatch):
    calls = _spy(monkeypatch)
    assert not torch.autograd._profiler_enabled()
    first = span("a")
    assert span("b") is first
    with first:
        pass
    cfg, model = _model()
    step = make_train_step(cfg, TrainConfig(batch_size=8))
    step(model, init_opt_state(model, TrainConfig()), *_batches(1)[0])
    assert calls == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("c"):
            pass
    assert calls == ["c"]
    assert span("d") is first
