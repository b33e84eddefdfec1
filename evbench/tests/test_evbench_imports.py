"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference loads nothing of the program."""

import os
import subprocess
import sys

from evbench import harness

ROOT = harness.ROOT


def loaded_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_program_or_of_jax():
    mods = loaded_after("import evbench.reference.dlrm")
    assert not mods & {"jax", "jaxlib", "flax", "evstore_tpu",
                       "evstore_tpu_torch"}


def test_a_whole_small_run_loads_no_jax():
    mods = loaded_after(
        ""
        "from evbench.tests import cases\n"
        "cases.run('kaggle.train.sgd-b65536', seconds=0.3)\n"
        "import evbench.controls")
    assert "evstore_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "evstore_tpu"}


def test_forbidden_names_are_compared_whole():
    sys.modules.setdefault("evstore_tpu_torch_probe", sys)
    try:
        assert "evstore_tpu_torch_probe" not in harness.forbidden_modules()
    finally:
        del sys.modules["evstore_tpu_torch_probe"]


def test_a_directory_with_the_benchmark_alone_fails_without_a_result(
        tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "evbench"), tmp_path / "evbench")
    out = subprocess.run(
        [sys.executable, "-m", "evbench", "--workload",
         "kaggle.train.sgd-b65536",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "evstore_tpu_torch" in out.stderr
