"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU when no card is present."""

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


def test_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from evstore_tpu_torch.cache.device_cache import DeviceC1Cache
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
        run_inference(model, cfg, CacheConfig(total_size=60), [], sm,
                      use_device_cache=True, device="cuda")


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
