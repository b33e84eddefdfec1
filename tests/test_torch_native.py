"""The port's binding of its own copy of the C++ tier engine against the
JAX package's binding, on the CPU, and the engine's build.

`NativeTieredCache` and `NativeAssigner` of both packages run on the same
config, tables and numpy request stream.  Each loads its own library: the
port's is built from `evstore_tpu_torch/native/evstore_core.cpp` into
`evstore_tpu_torch/_build/`, and the two are loaded side by side in one
process (ctypes' RTLD_LOCAL keeps their identical `esv_*` names apart).

Tolerance: none.  `assign_batch`'s slots, scatter list and miss buffer, the
assigner's stats and the engine's tier stats are equal exactly, with one
exception: a row that C2 serves at 16 bits may differ by one f32 ulp
(atol 1.2e-7).  The JAX package builds its engine with -march=native, which
lets g++ contract the 16-bit decode (v / 65000) * 1.3 - 0.65 into an FMA on
a CPU that has one; the port builds for the baseline x86-64, with no FMA,
so its rows are the same on every host.
"""

import ctypes
import os

import numpy as np
import pytest

from evstore_tpu import native as jax_native
from evstore_tpu.config import CacheConfig as JaxCacheConfig
from evstore_tpu_torch import native
from evstore_tpu_torch.config import CacheConfig
from evstore_tpu_torch.native import build

N_TABLES, DIM = 5, 12


def _tables(seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.95, 0.95, (int(n), DIM)).astype(np.float32)
            for n in rng.integers(30, 90, N_TABLES)]


def test_the_port_loads_its_own_library():
    port, ref = native.get_lib(), jax_native.get_lib()
    assert os.path.dirname(port._name) == build.BUILD_DIR
    assert os.path.basename(port._name) == os.path.basename(
        build.library_path())
    assert os.path.realpath(port._name) != os.path.realpath(ref._name)
    addr = [ctypes.cast(lib.esv_assign_batch, ctypes.c_void_p).value
            for lib in (port, ref)]
    assert addr[0] != addr[1]


def test_library_name_follows_source_and_flags(monkeypatch):
    path = build.library_path()
    assert path == build.library_path()
    assert os.path.basename(path).startswith("libevstore_core-")
    assert build.SRC == os.path.join(os.path.dirname(build.__file__),
                                     "evstore_core.cpp")
    monkeypatch.setattr(build, "FLAGS", build.FLAGS + ("-g",))
    assert build.library_path() != path


def test_build_without_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        build.build()


@pytest.mark.parametrize("kw", [
    dict(n_caching_layers=1, total_size=40, main_precision=32),
    dict(n_caching_layers=1, total_size=40, main_precision=8),
    dict(n_caching_layers=2, total_size=48, main_precision=32,
         secondary_precision=8, high_agghit_threshold=3),
    dict(n_caching_layers=3, total_size=60, main_precision=8,
         secondary_precision=4, c3_io_batch=4),
    dict(n_caching_layers=3, total_size=60, main_precision=32,
         secondary_precision=8, size_proportion=(40, 40, 20),
         c3_eviction="fifo", c3_io_batch=1, high_agghit_threshold=3),
    dict(n_caching_layers=2, total_size=48, main_precision=32,
         secondary_precision=16, high_agghit_threshold=3),
], ids=["c1-fp32", "c1-int8", "c1c2", "c1c2c3-published", "c1c2c3-fifo",
        "c1c2-16bit"])
def test_assigner_matches_jax(kw):
    tables = _tables(len(kw))
    rng = np.random.default_rng(1)
    alts = [rng.integers(0, len(t), len(t)).astype(np.uint32)
            for t in tables]
    sides = []
    for mod, cfg in ((jax_native, JaxCacheConfig(**kw)),
                     (native, CacheConfig(**kw))):
        eng = mod.NativeTieredCache(cfg, N_TABLES, DIM, n_reader_threads=2)
        eng.load_tables(tables)
        if cfg.n_caching_layers >= 3:
            eng.load_altkeys(alts)
        cap = cfg.tier_capacities()[0]
        sides.append((eng, mod.NativeAssigner(eng, cap, cfg.flush_rate,
                                              cfg.perfect_item_cap)))
    (je, ja), (pe, pa) = sides
    sizes = np.array([len(t) for t in tables])
    zipf = np.random.default_rng(2).zipf(1.3, (30, 8, N_TABLES))
    for batch in (zipf - 1) % sizes:
        ref, got = ja.assign_batch(batch), pa.assign_batch(batch)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
        for a, b in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(a, b)
        if kw.get("secondary_precision") == 16:
            np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=1.2e-7)
        else:
            np.testing.assert_array_equal(got[3], ref[3])
        assert len(set(got[1].tolist())) == len(got[1])   # unique slots
        assert pa.stats() == ja.stats()
        assert pe.stats() == je.stats()
    s = pe.stats()
    if kw["n_caching_layers"] >= 2:
        assert s["c2"]["hit_rate"] > 0
    if kw["n_caching_layers"] >= 3:
        assert s["c3"]["size"] > 0
    pe.close(), je.close()


def test_borrowed_tables_serve_the_callers_buffers():
    tables = _tables(3)
    eng = native.NativeTieredCache(CacheConfig(total_size=1), N_TABLES, DIM)
    eng.borrow_tables(tables)
    asg = native.NativeAssigner(eng, 20)
    idx = np.array([[1, 2, 3, 4, 5]])
    _, _, _, buf = asg.assign_batch(idx)
    np.testing.assert_array_equal(
        buf, np.stack([tables[t][idx[0, t]] for t in range(N_TABLES)]))
    eng.close()


def test_rejections_and_close():
    with pytest.raises(ValueError, match="esv_init rejected"):
        native.NativeTieredCache(CacheConfig(), 65, DIM)
    eng = native.NativeTieredCache(CacheConfig(total_size=1), N_TABLES, DIM)
    eng.load_tables(_tables(4))
    asg = native.NativeAssigner(eng, 20)
    with pytest.raises(ValueError, match=r"2\^40"):
        asg.assign_batch(np.full((1, N_TABLES), -1))
    eng.close()
    eng.close()
    for call in (lambda: asg.assign_batch(np.zeros((1, N_TABLES))),
                 asg.stats, eng.stats,
                 lambda: eng.load_tables(_tables(4))):
        with pytest.raises(RuntimeError, match="closed"):
            call()
