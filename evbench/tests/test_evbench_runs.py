"""Small runs of a training cell on the CPU, with the kernels' plain
versions, through the harness's whole path but the look for a chip: the
sound program comes out correct, and each fault the cell can have, planted
in the program underneath, comes out not correct."""

import contextlib
import subprocess
import sys

import pytest
import torch

from evbench import harness, inputs
from evbench.kinds import train as train_kind
from evbench.reference import dlrm as ref
from evbench.traffic import streams

from evbench.tests import cases

TRAIN = "kaggle.train.sgd-b65536"
CELLS = ["kaggle.train.sgd-b65536", "terabyte.train.sgd-b65536"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(name, trace):
    line, out = cases.run(name, trace=trace, seconds=2.0 if trace else 0.6)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    want = {m["name"] for m in harness.metrics_for(harness.manifest(),
                                                   name, trace)}
    got = set(line["metrics"])
    if trace:
        # the CPU has no device trace: only the host's readers read
        assert got and got <= want
        assert "busy_s" in line["device"] and "breakdown" in line
    else:
        assert got == want
        assert line["metrics"]["setup_s"]["value"] > 0


@contextlib.contextmanager
def patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _step_fault(kind):
    from evstore_tpu_torch.train import train_loop

    def make(old):
        def make_train_step(cfg, tcfg):
            step = old(cfg, tcfg)

            def faulty(model, st, dense, idx, y, bw=None):
                if kind == "half":
                    h = len(y) // 2
                    return step(model, st, dense[:h], idx[:h], y[:h], bw)
                saved = [p.detach().clone() for p in model.parameters()]
                loss = step(model, st, dense, idx, y, bw)
                with torch.no_grad():
                    for p, s in zip(model.parameters(), saved):
                        p.copy_(s)
                return loss
            return faulty
        return make_train_step

    return patched(train_loop, "make_train_step", make)


def test_the_checked_steps_run_as_the_window_runs():
    from evstore_tpu_torch.train import train_loop

    calls = []

    def make(old):
        def train(model, cfg, tcfg, batches, **kw):
            n = [0]

            def counted():
                for b in batches:
                    n[0] += 1
                    yield b
            out = old(model, cfg, tcfg, counted(), **kw)
            calls.append((tcfg, n[0], out[2]["loss"]))
            return out
        return train

    with patched(train_loop, "train", make):
        line, _ = cases.run(TRAIN)
    assert line["correct"], line["checks"]
    checked, window = calls[0], calls[-1]
    # one call over the three checked steps, with the window's config, so
    # that no loss is read and nothing waits for the device between them
    assert checked[1] == train_kind.N_CHECKED and checked[2] == []
    assert checked[0] == window[0] and window[0].print_freq > window[1]


@pytest.mark.parametrize("kind", ["unchanged", "half"])
def test_a_faulty_train_step_fails_the_train_check(kind):
    with _step_fault(kind):
        line, _ = cases.run(TRAIN)
    assert not line["correct"], line["checks"]


def test_the_tf32_control_and_half_batch_fail_the_train_limits():
    bench, wl, cfg, mix, limits = cases.tiny(TRAIN)
    dims = inputs.model_dims(cfg)
    seed = 13
    batches = streams.make_batches(mix, dims["table_sizes"], 13, seed, 3,
                                   "cpu")
    w = inputs.mlp_weights(seed, dims, "cpu")
    touched = [torch.unique(torch.from_numpy(batches[1][:3, :, t].ravel())
                            .long()) for t in range(26)]
    rows0 = [inputs.table(seed, t, n, dims["dim"], "cpu")[touched[t]]
             for t, n in enumerate(dims["table_sizes"])]
    for kw in ({"tf32": True}, {"half_batch": True}):
        got = train_kind.readings(w, rows0, touched, batches, 0.1, None,
                                  None, None, "cpu", **kw)
        over = [g > limits[k] for g, k in zip(got, ("loss_gap", "grad_gap",
                                                    "change_gap"))]
        assert any(over), (kw, got)


def test_the_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -1.0 - 2 ** -12,
                      3.0])
    assert ref.to_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -1.0, 3.0]


@pytest.mark.card
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell's run needs the card")
    out = subprocess.run(
        [sys.executable, "-m", "evbench", "--workload", TRAIN, "--seed",
         "2147483999", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
