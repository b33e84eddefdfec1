"""The port stands alone: it imports neither JAX nor the JAX package, builds
its C++ engine from its own copy into its own `_build/`, names no path of
the JAX package in its code, and its entry points refuse to fall back to
the CPU when no card is present."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "evstore_tpu_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _imported_names(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_every_port_module_imports_without_jax():
    mods = list(_port_modules())
    assert "evstore_tpu_torch.drivers.infer" in mods and len(mods) >= 20
    assert {"evstore_tpu_torch.native", "evstore_tpu_torch.native.build",
            "evstore_tpu_torch.ops.quant", "evstore_tpu_torch.cache.tiers",
            "evstore_tpu_torch.cache.storage",
            "evstore_tpu_torch.cache.policy",
            "evstore_tpu_torch.cache.service",
            "evstore_tpu_torch.ops.cuda_interaction",
            "evstore_tpu_torch.utils.trace",
            "evstore_tpu_torch.data.loader",
            "evstore_tpu_torch.cli", "evstore_tpu_torch.data.criteo",
            "evstore_tpu_torch.drivers.train",
            "evstore_tpu_torch.utils.checkpoint",
            "evstore_tpu_torch.utils.logging",
            "evstore_tpu_torch.utils.config_io",
            "evstore_tpu_torch.utils.memory",
            "evstore_tpu_torch.utils.profiling"} <= set(mods)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and (\n"
        "       m == 'evstore_tpu' or m.startswith('evstore_tpu.')\n"
        "       or m.startswith('jax'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
    for name in _imported_names(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "evstore_tpu"), \
            f"{path.name} imports {name}"


def _code_strings(path: pathlib.Path):
    """The string constants of a module, docstrings left out."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.value


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_code_names_a_path_of_the_jax_package(path):
    """Code (not the docstrings that cite what was ported) names no file or
    directory of `evstore_tpu/`: the port builds and loads its own."""
    for text in _code_strings(path):
        assert "evstore_tpu/" not in text and text != "evstore_tpu", \
            f"{path.name}: {text!r}"


def test_native_sources_include_nothing_of_the_jax_package():
    srcs = sorted(PORT.rglob("*.cpp")) + sorted(PORT.rglob("*.cu")) \
        + sorted(PORT.rglob("*.cuh"))
    assert PORT / "native" / "evstore_core.cpp" in srcs
    for src in srcs:
        for line in src.read_text().splitlines():
            if line.lstrip().startswith("#include"):
                assert "evstore_tpu" not in line, f"{src.name}: {line}"


def test_the_engine_builds_inside_the_port():
    from evstore_tpu_torch.native import build
    for path in (build.SRC, build.BUILD_DIR, build.library_path()):
        assert pathlib.Path(path).resolve().is_relative_to(PORT)
    assert pathlib.Path(build.BUILD_DIR) == PORT / "_build"


def test_logkv_binds_the_ports_engine(tmp_path):
    """LogKVStore's `esv_kv_*` calls go to the port's engine library, built
    in the port's `_build/`, not to the JAX package's."""
    from evstore_tpu_torch.cache.storage import LogKVStore
    from evstore_tpu_torch.native import build, get_lib
    kv = LogKVStore(str(tmp_path / "kv.log"), [4], 4)
    try:
        assert kv._lib is get_lib()
        assert pathlib.Path(kv._lib._name).resolve() == \
            pathlib.Path(build.library_path()).resolve()
        assert pathlib.Path(kv._lib._name).resolve().is_relative_to(PORT)
        assert kv.count() == 0
    finally:
        kv.close()


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from evstore_tpu_torch.cache.device_cache import (DeviceC1Cache,
                                                      NativeDeviceC1Cache)
    from evstore_tpu_torch.cache.storage import StorageManager
    from evstore_tpu_torch.config import CacheConfig, tiny_dlrm_config
    from evstore_tpu_torch.drivers.infer import build_cache, run_inference
    from evstore_tpu_torch.models.dlrm import DLRM

    cfg = tiny_dlrm_config()
    model = DLRM(cfg, device="cpu")
    sm = StorageManager("dummy", dim=cfg.embedding_dim).load(
        tables=[t.detach().numpy() for t in model.tables])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_inference(model, cfg, CacheConfig(total_size=60), [], sm,
                      use_device_cache=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_cache(CacheConfig(total_size=60), cfg, sm,
                    use_device_cache=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceC1Cache(CacheConfig(total_size=60), sm, 3, cfg.embedding_dim)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DLRM(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NativeDeviceC1Cache(CacheConfig(total_size=60), 3,
                            cfg.embedding_dim)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NativeDeviceC1Cache(CacheConfig(total_size=60), 3,
                            cfg.embedding_dim, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_inference(model, cfg, CacheConfig(total_size=60), [], sm,
                      use_device_cache=True, device="cuda")
    for kw in ({}, {"use_native": True}):     # the host caches too
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_inference(model, cfg, CacheConfig(total_size=60), [], sm,
                          **kw)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_without_the_port(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "No module named 'evstore_tpu_torch'" in out.stderr
    assert os.listdir(tmp_path) == ["chip_smoke.py"]
