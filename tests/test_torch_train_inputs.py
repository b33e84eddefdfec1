"""The train step's input path (`utils/staging.py::InputRing`): host inputs
are cast into the ring's host buffers, copied to its device buffers and
handed to the compute stream; inputs already where the model is take no
copy.  On the CPU the ring runs with pinning, the copy stream and the
events off; the tests marked `card` run the same cases on an NVIDIA card,
with them on (`python -m pytest --noconftest -m card
tests/test_torch_train_inputs.py` on the card's machine, which has no
JAX for `tests/conftest.py`).

Both paths feed the same kernels the same values, so five steps give
the same losses, MLPs, tables and optimizer state bit for bit."""

import json

import numpy as np
import pytest
import torch

from evstore_tpu_torch.config import TrainConfig, make_dlrm_config
from evstore_tpu_torch.models.dlrm import DLRM
from evstore_tpu_torch.train import train_loop
from evstore_tpu_torch.train.train_loop import (init_opt_state,
                                                make_train_step, train)
from evstore_tpu_torch.utils import staging
from evstore_tpu_torch.utils.profiling import profile_trace

SIZES = (50, 35, 20)
BAGS = (1, 3, 2)
B, STEPS = 16, 5
# layout -> (config keywords, optimizer)
LAYOUTS = {
    "one-hot": ({}, "sgd"),
    "bag-weights": ({}, "rwsadagrad"),
    "multi-hot-sizes": ({"multi_hot_sizes": BAGS}, "rwsadagrad"),
}


def _config(layout):
    return make_dlrm_config(4, SIZES, (8,), (6,), num_dense=3,
                            **LAYOUTS[layout][0])


def _batches(layout, n=STEPS, seed=0):
    """n numpy batches in the step's argument order: (dense, idx, labels)
    one-hot, or (dense, idx, labels, bag_weights) for bags: padded to
    L = 2 [B, T, 2], or of a length per table [B, sum L_t]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if layout == "multi-hot-sizes":
            idx = np.concatenate([rng.integers(0, SIZES[t], (B, BAGS[t]))
                                  for t in range(len(SIZES))], axis=1)
        else:
            shape = (B,) + (() if layout == "one-hot" else (2,))
            idx = np.stack([rng.integers(0, n_t, shape) for n_t in SIZES],
                           axis=1)
        batch = (rng.random((B, 3), dtype=np.float32),
                 idx.astype(np.int32),
                 rng.integers(0, 2, B).astype(np.float32))
        if layout != "one-hot":
            batch += (rng.random(idx.shape, dtype=np.float32),)
        out.append(batch)
    return out


def _run(layout, dev, feed):
    """STEPS steps from seed 0: `feed(step, model, opt_state, batch)`
    calls the step.  -> (losses, model, opt_state)."""
    cfg = _config(layout)
    tcfg = TrainConfig(batch_size=B, learning_rate=0.1,
                       optimizer=LAYOUTS[layout][1])
    model = DLRM(cfg, device=dev, seed=0)
    st = init_opt_state(model, tcfg)
    step = make_train_step(cfg, tcfg)
    losses = [feed(step, model, st, b).clone()
              for b in _batches(layout)]
    return [float(x) for x in losses], model, st


def _numpy(step, model, st, batch):
    return step(model, st, *batch)


def _device(step, model, st, batch):
    dev = next(model.parameters()).device
    return step(model, st, *(torch.from_numpy(a).to(dev) for a in batch))


def _overwriting(step, model, st, batch):
    """The staged path with a caller that reuses its arrays the moment
    the step returns."""
    mine = tuple(a.copy() for a in batch)
    loss = step(model, st, *mine)
    for a in mine:
        a[...] = 0
    return loss


def _assert_same(a, b):
    la, ma, sa = a
    lb, mb, sb = b
    assert la == lb
    for (k, v), (_, w) in zip(ma.state_dict().items(),
                              mb.state_dict().items()):
        assert torch.equal(v, w), k
    for part in ("dense", "sparse"):
        for k, v in getattr(sa, part).items():
            assert torch.equal(v, getattr(sb, part)[k]), (part, k)
    assert sa.step == sb.step == STEPS


def _same_paths(layout, dev):
    staged = _run(layout, dev, _numpy)
    _assert_same(staged, _run(layout, dev, _device))
    _assert_same(staged, _run(layout, dev, _overwriting))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_staged_and_device_inputs_train_bit_for_bit_alike(layout):
    _same_paths(layout, "cpu")


@pytest.mark.card
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_staged_and_device_inputs_train_alike_on_the_card(layout,
                                                          monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the copy stream and pinned buffers "
                    "need the card")
    rings = _recording(monkeypatch)
    _same_paths(layout, "cuda")
    staged = rings[0]
    assert staged.stream is not None
    for slot in staged.slots:
        for s in slot.host:
            assert s.buf is None or s.buf.is_pinned()
        assert all(d is None or d.is_cuda for d in slot.device)


@pytest.mark.card
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_a_staged_step_waits_for_nothing_on_the_card(layout):
    """After a shape's first steps, a step with free ring slots makes no
    call that waits for the device, so the host can run ahead of it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the copy stream and pinned buffers "
                    "need the card")
    cfg = _config(layout)
    tcfg = TrainConfig(batch_size=B, learning_rate=0.1,
                       optimizer=LAYOUTS[layout][1])
    model = DLRM(cfg, device="cuda", seed=0)
    st = init_opt_state(model, tcfg)
    step = make_train_step(cfg, tcfg)
    batches = _batches(layout, n=4)
    for b in batches[:2]:
        step(model, st, *b)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches[2:]:
            step(model, st, *b)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _recording(monkeypatch):
    """Every `InputRing` the train steps build, in order."""
    made = []

    class Recording(staging.InputRing):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)
    monkeypatch.setattr(train_loop, "InputRing", Recording)
    return made


def _pointers(ring):
    return [(s.buf.data_ptr(), d.data_ptr())
            for slot in ring.slots for s, d in zip(slot.host, slot.device)
            if s.buf is not None]


def test_the_ring_keeps_its_buffers_while_the_shape_holds(monkeypatch):
    rings = _recording(monkeypatch)
    cfg = _config("one-hot")
    tcfg = TrainConfig(batch_size=B, learning_rate=0.1)
    model = DLRM(cfg, device="cpu", seed=0)
    st = init_opt_state(model, tcfg)
    step = make_train_step(cfg, tcfg)
    batches = _batches("one-hot", n=6)
    for b in batches[:2]:
        step(model, st, *b)
    (ring,) = rings
    first = _pointers(ring)
    assert len(first) == 6          # two slots of dense, ids, labels
    for b in batches[2:]:
        step(model, st, *b)
    assert _pointers(ring) == first
    # a larger batch: each buffer built again, once
    for d, i, y in _batches("one-hot", n=2, seed=1):
        step(model, st, *(np.concatenate([a, a]) for a in (d, i, y)))
    grown = _pointers(ring)
    assert all(a != b for (a, _), (b, _) in zip(first, grown))
    assert all(a != b for (_, a), (_, b) in zip(first, grown))
    assert [None if d is None else tuple(d.shape)
            for d in ring.slots[0].device] == [(2 * B, 3), (2 * B, 3),
                                               (2 * B,), None]
    step(model, st, *(np.concatenate([a, a]) for a in batches[0]))
    assert _pointers(ring) == grown


def test_the_ring_reuses_a_slot_by_shape_and_rebuilds_on_a_new_one():
    dev = torch.device("cpu")
    ring = staging.InputRing(dev, (torch.int32, torch.float32))
    a, b = ring.take(), ring.take()
    assert a is not b and ring.take() is a
    x = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    got = ring.enqueue(a, 0, ring.stage(a, 0, x))
    assert got.dtype == torch.int32 and torch.equal(got, x.int())
    ptrs = (a.host[0].buf.data_ptr(), got.data_ptr())
    ring.release(a)
    again = ring.enqueue(a, 0, ring.stage(a, 0, x + 1))
    assert (a.host[0].buf.data_ptr(), again.data_ptr()) == ptrs
    assert torch.equal(again, (x + 1).int())
    # another shape of as many elements keeps the host buffer, and builds
    # the device buffer again
    y = ring.enqueue(a, 0, ring.stage(a, 0, x.reshape(4, 3)))
    assert a.host[0].buf.data_ptr() == ptrs[0]
    assert y.shape == (4, 3) and y.data_ptr() != ptrs[1]
    # more elements build both again
    z = ring.enqueue(a, 0, ring.stage(a, 0, torch.ones(5, 4)))
    assert a.host[0].buf.data_ptr() != ptrs[0] and z.shape == (5, 4)
    assert b.host[0].buf is None and b.device[0] is None
    ring.hand_over(a)
    assert a.ready()


def _count(path, name):
    return sum(1 for e in json.load(open(path))["traceEvents"]
               if e.get("ph") == "X" and e.get("name") == name)


@pytest.mark.parametrize("host,stages", [(True, 3), (False, 0)],
                         ids=["numpy", "device-tensors"])
def test_each_staged_input_has_one_stage_span(tmp_path, host, stages):
    """`train_step.inputs.stage` counts the host writes into a staging
    buffer: one a copy span for numpy inputs, none for inputs already on
    the model's device.  On the CPU nothing waits for a slot."""
    cfg = _config("one-hot")
    model = DLRM(cfg, device="cpu", seed=0)
    batches = _batches("one-hot", n=3)
    if not host:
        batches = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    with profile_trace(str(tmp_path)):
        train(model, cfg, TrainConfig(batch_size=B, learning_rate=0.1),
              batches, log_fn=lambda *_: None)
    path = tmp_path / "trace.json"
    assert _count(path, "train_step.inputs.copy") == 3 * 3
    assert _count(path, "train_step.inputs.stage") == stages * 3
    assert _count(path, "train_step.inputs.wait") == 0
