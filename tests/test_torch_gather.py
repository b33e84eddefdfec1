"""The port's row gather (kernel wrapper on CPU tensors, plain version,
plain-table lookup) against the JAX package's, bit for bit, and the kernel
build module's host-side logic.

The JAX side runs the Pallas kernel `gather_rows` in interpret mode.  On CPU
tensors the port's wrapper takes its plain version; the CUDA kernel is held
to it on the card by chip_smoke.py.  Tolerance: none, rows are moved as
bytes.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu.config import tiny_dlrm_config as jax_tiny
from evstore_tpu.models import embedding as jax_emb
from evstore_tpu.ops.pallas_gather import gather_rows as jax_gather_rows
from evstore_tpu_torch import _build
from evstore_tpu_torch.config import tiny_dlrm_config
from evstore_tpu_torch.models import embedding as port_emb
from evstore_tpu_torch.ops.cuda_gather import gather_rows, gather_rows_ref

JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bits(a) -> np.ndarray:
    """Raw bit patterns of a JAX array or torch tensor (f32 or bf16)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16 if a.element_size() == 2
                                   else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [4, 36])
def test_gather_rows_matches_pallas_gather(dtype, D):
    rng = np.random.default_rng(D)
    table = rng.normal(size=(300, D)).astype(np.float32)
    idx = rng.integers(0, 300, 64).astype(np.int32)
    idx[10:20] = idx[3]                      # repeated indices
    idx[-1] = 299
    ref = jax_gather_rows(jnp.asarray(table, JAX_DT[dtype]),
                          jnp.asarray(idx), tile_b=16, interpret=True)
    tt = torch.from_numpy(table).to(TORCH_DT[dtype])
    got = gather_rows(tt, torch.from_numpy(idx))
    assert got.shape == (64, D) and got.dtype == TORCH_DT[dtype]
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("shape", [(40,), (8, 26)])
def test_two_source_gather_matches_take_over_concat(shape):
    """An index < C reads the primary, C + m reads secondary row m."""
    rng = np.random.default_rng(1)
    C, M, D = 50, 16, 36
    primary = rng.normal(size=(C, D)).astype(np.float32)
    secondary = rng.normal(size=(M, D)).astype(np.float32)
    idx = rng.integers(0, C + M, shape).astype(np.int32)
    idx.flat[0] = C                          # first buffer row
    idx.flat[-1] = C + M - 1                 # last buffer row
    idx.flat[1] = idx.flat[2]                # a repeat
    ref = jnp.take(jnp.concatenate([jnp.asarray(primary),
                                    jnp.asarray(secondary)]),
                   jnp.asarray(idx), axis=0)
    got = gather_rows(torch.from_numpy(primary), torch.from_numpy(idx),
                      secondary=torch.from_numpy(secondary))
    assert got.shape == (*shape, D)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(
        got.numpy(), gather_rows_ref(torch.from_numpy(primary),
                                     torch.from_numpy(idx),
                                     torch.from_numpy(secondary)).numpy())


@pytest.mark.parametrize("use_kernel", [True, False])
def test_sparse_arch_lookup_matches_jax(use_kernel):
    """Plain-table lookup: the JAX package's one-hot matmul (tiny tables)
    and take paths are bit-identical to a row copy."""
    cfg_j = jax_tiny()
    cfg_p = tiny_dlrm_config(use_gather_kernel=use_kernel)
    rng = np.random.default_rng(2)
    tables = [rng.normal(size=(n, cfg_p.embedding_dim)).astype(np.float32)
              for n in cfg_p.table_sizes]
    idx = np.stack([rng.integers(0, n, 12) for n in cfg_p.table_sizes],
                   axis=1).astype(np.int32)
    ref = jax_emb.sparse_arch_lookup(
        {f"table_{t}": {"kind_plain": jnp.asarray(tab)}
         for t, tab in enumerate(tables)}, jnp.asarray(idx), cfg_j)
    got = port_emb.sparse_arch_lookup([torch.from_numpy(t) for t in tables],
                                      torch.from_numpy(idx), cfg_p)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_init_embedding_tables_law():
    sizes = (4, 100, 2500)
    tabs = port_emb.init_embedding_tables(sizes, 8,
                                          np.random.default_rng(0))
    for n, t in zip(sizes, tabs):
        assert t.shape == (n, 8) and t.dtype == np.float32
        assert np.abs(t).max() <= np.sqrt(1.0 / n)
    # U(-b, b): mean 0, variance b^2/3 on the largest table
    b = np.sqrt(1.0 / 2500)
    assert abs(tabs[2].mean()) < 0.02 * b
    assert abs(tabs[2].var() / (b * b / 3) - 1) < 0.02


def test_gather_wrapper_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="CUDA device"):
        gather_rows(torch.zeros(4, 8, device="meta"),
                    torch.zeros(3, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CUDA device"):
        gather_rows(torch.zeros(4, 8), torch.zeros(3, dtype=torch.int32),
                    secondary=torch.zeros(2, 8, device="meta"))


def test_library_name_follows_the_sources():
    srcs = [os.path.basename(s) for s in _build.sources()]
    assert srcs == ["common.cuh", "gather_rows.cu", "interaction_bwd.cu",
                    "interaction_fwd.cu", "row_update.cu"]
    path = _build.library_path()
    assert path == _build.library_path()
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libevstore_kernels-")
    assert set(_build.SIGNATURES) == {"interaction_fwd", "interaction_bwd",
                                      "gather_rows", "scatter_sub_sorted"}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_failed_launch_raises():
    _build.check(0, "k")
    with pytest.raises(RuntimeError, match="cudaError 9"):
        _build.check(9, "k")
