"""The port's serving slice against the JAX package, on the CPU: weights
converted from the JAX pytree, the model forward, the inference driver
through the device C1 cache, and the copied host modules (request streams,
metrics, latency CDF).

Both packages' `run_inference(use_device_cache=True)` serve through their
`NativeDeviceC1Cache` (each with its own copy of the C++ tier engine), at
fp32, at int8 and as the three-tier hybrid with alt keys.

Tolerances: scores rtol 1e-5 (float32, TF32 off; summation order differs
between XLA and PyTorch); metrics atol 1e-6; everything the port copies or
moves (weights, rows, streams, policy counters, cache stats and bytes
shipped) exact.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu import config as jcfg
from evstore_tpu.cache.storage import StorageManager as JaxStorageManager
from evstore_tpu.cache.tiers import AltKeyResolver as JaxAltKeyResolver
from evstore_tpu.data import synthetic as jsyn
from evstore_tpu.drivers.infer import run_inference as jax_run_inference
from evstore_tpu.models.dlrm import dlrm_forward, init_dlrm
from evstore_tpu.models.dlrm import predict as jax_predict
from evstore_tpu.train import metrics as jmetrics
from evstore_tpu.utils.trace import LatencyRecorder as JaxLatencyRecorder
from evstore_tpu_torch import config as pcfg
from evstore_tpu_torch.cache.storage import StorageManager
from evstore_tpu_torch.cache.tiers import AltKeyResolver, altkey_encode
from evstore_tpu_torch.convert import params_from_jax, params_to_numpy
from evstore_tpu_torch.data import synthetic as psyn
from evstore_tpu_torch.data.loader import PrefetchIterator, prefetch
from evstore_tpu_torch.drivers.infer import build_cache, run_inference
from evstore_tpu_torch.models.dlrm import DLRM
from evstore_tpu_torch.train import metrics as pmetrics
from evstore_tpu_torch.utils.trace import LatencyRecorder

NARROW_SIZES = tuple(int(s) for s in
                     np.random.default_rng(11).integers(40, 301, 26))


def _configs(name, **kw):
    if name == "tiny":
        return jcfg.tiny_dlrm_config(**kw), pcfg.tiny_dlrm_config(**kw)
    args = (8, NARROW_SIZES, (16,), (16,))
    return (jcfg.make_dlrm_config(*args, num_dense=13, **kw),
            pcfg.make_dlrm_config(*args, num_dense=13, **kw))


def _models(name, seed=0, **kw):
    """JAX params and the port's DLRM with the same weights (on the CPU)."""
    cj, cp = _configs(name, **kw)
    params = init_dlrm(jax.random.PRNGKey(seed), cj)
    npp = jax.tree_util.tree_map(np.asarray, params)
    state, tables = params_from_jax(npp.dense, npp.sparse, cp, device="cpu")
    model = DLRM(cp, device="cpu")
    model.load_state_dict(state)
    return cj, cp, params, model, tables


def _stream(cfg, n, B=16, seed=5, dist="grouped_zipf"):
    return dict(num_dense=cfg.num_dense_features, table_sizes=cfg.table_sizes,
                batch_size=B, num_batches=n, seed=seed, distribution=dist)


@pytest.mark.parametrize("name", ["tiny", "narrow26"])
def test_run_inference_matches_jax(name):
    """The port's device-cache inference against the JAX driver's default
    host TieredCache (EvLFU C1): same metrics, same perfect hits."""
    cj, cp, params, model, tables = _models(name)
    cap = 60 if name == "tiny" else 400
    kw = dict(policy="evlfu", n_caching_layers=1, total_size=cap,
              main_precision=32)
    sc = _stream(cp, 10)
    ref = jax_run_inference(
        params, cj, jcfg.CacheConfig(**kw),
        jsyn.random_batches(jsyn.RandomDataConfig(**sc)),
        JaxStorageManager("dummy", dim=cj.embedding_dim).load(tables=tables),
        warmup_batches=jsyn.random_batches(
            jsyn.RandomDataConfig(**{**sc, "seed": 6, "num_batches": 2})),
        log_fn=lambda *_: None)
    got = run_inference(
        model, cp, pcfg.CacheConfig(**kw),
        psyn.random_batches(psyn.RandomDataConfig(**sc)),
        StorageManager("dummy", dim=cp.embedding_dim).load(tables=tables),
        warmup_batches=psyn.random_batches(
            psyn.RandomDataConfig(**{**sc, "seed": 6, "num_batches": 2})),
        use_device_cache=True, device="cpu", log_fn=lambda *_: None)
    assert got.requests == ref.requests == 160
    assert set(got.metrics) == set(ref.metrics)
    for k, v in ref.metrics.items():
        np.testing.assert_allclose(got.metrics[k], v, atol=1e-6)
    assert got.cache_stats["perfect_hits"] == ref.cache_stats["perfect_hits"]
    assert got.cache_stats["hit_rate"] == ref.cache_stats["c1"]["hit_rate"]
    assert got.cache_stats["requests"] == 192
    assert got.latency["count"] == 160


@pytest.mark.parametrize("name", ["tiny", "narrow26"])
def test_scores_through_the_cache_match_jax_forward(name):
    cj, cp, params, model, tables = _models(name, seed=1)
    sm = StorageManager("dummy", dim=cp.embedding_dim).load(tables=tables)
    cache = build_cache(pcfg.CacheConfig(total_size=120), cp, sm,
                        use_device_cache=True, device="cpu")
    for dense, idx, _ in psyn.random_batches(
            psyn.RandomDataConfig(**_stream(cp, 4, seed=3))):
        rows = cache.lookup_batch(idx)
        with torch.inference_mode():
            got = torch.sigmoid(model(torch.from_numpy(dense), None,
                                      emb_rows=rows))
        ref = jax.nn.sigmoid(dlrm_forward(params, jnp.asarray(dense),
                                          jnp.asarray(idx), cj,
                                          emb_rows=jnp.asarray(rows.numpy())))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("variant", [
    dict(), dict(interaction_op="cat"), dict(interaction_itself=True),
    dict(use_interaction_kernel=False, use_gather_kernel=False)])
def test_forward_without_cache_matches_jax(variant):
    """emb_rows=None: the model looks its own tables up."""
    cj = jcfg.tiny_dlrm_config(**{k: v for k, v in variant.items()
                                  if not k.startswith("use_")})
    cp = pcfg.tiny_dlrm_config(**variant)
    params = init_dlrm(jax.random.PRNGKey(2), cj)
    npp = jax.tree_util.tree_map(np.asarray, params)
    model = DLRM(cp, device="cpu")
    model.load_state_dict(params_from_jax(npp.dense, npp.sparse, cp,
                                          device="cpu")[0])
    dense, idx, _ = next(psyn.random_batches(
        psyn.RandomDataConfig(**_stream(cp, 1, B=9, dist="uniform"))))
    with torch.inference_mode():
        got = model(torch.from_numpy(dense), torch.from_numpy(idx))
    ref = dlrm_forward(params, jnp.asarray(dense), jnp.asarray(idx), cj)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_predict_clamp_matches_jax():
    cj, cp = _configs("tiny", loss_threshold=0.45)
    params = init_dlrm(jax.random.PRNGKey(3), cj)
    npp = jax.tree_util.tree_map(np.asarray, params)
    model = DLRM(cp, device="cpu")
    model.load_state_dict(params_from_jax(npp.dense, npp.sparse, cp,
                                          device="cpu")[0])
    dense, idx, _ = next(psyn.random_batches(
        psyn.RandomDataConfig(**_stream(cp, 1, B=32, dist="uniform"))))
    with torch.inference_mode():
        got = model.predict(torch.from_numpy(dense), torch.from_numpy(idx))
    ref = jax_predict(params, jnp.asarray(dense), jnp.asarray(idx), cj)
    assert float(got.min()) >= np.float32(0.45)
    assert float(got.max()) <= np.float32(0.55)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


@pytest.mark.parametrize("name", ["tiny", "narrow26"])
def test_params_round_trip_exact(name):
    cj, cp, params, model, tables = _models(name, seed=4)
    npp = jax.tree_util.tree_map(np.asarray, params)
    dense, sparse = params_to_numpy(model)
    flat_ref, tree_ref = jax.tree_util.tree_flatten(
        {"dense": npp.dense, "sparse": npp.sparse})
    flat_got, tree_got = jax.tree_util.tree_flatten(
        {"dense": dense, "sparse": sparse})
    assert tree_got == tree_ref
    for a, b in zip(flat_got, flat_ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for t, tab in enumerate(tables):
        np.testing.assert_array_equal(tab, npp.sparse[f"table_{t}"]
                                      ["kind_plain"])


@pytest.mark.parametrize("dist", ["uniform", "zipf", "grouped_zipf"])
def test_request_stream_matches_jax(dist):
    sizes = (3, 50, 2000, (1 << 20) + 7)
    kw = dict(num_dense=5, table_sizes=sizes, batch_size=64, num_batches=3,
              seed=9, distribution=dist)
    for (dj, ij, yj), (dp, ip, yp) in zip(
            jsyn.random_batches(jsyn.RandomDataConfig(**kw)),
            psyn.random_batches(psyn.RandomDataConfig(**kw))):
        np.testing.assert_array_equal(dp, dj)
        np.testing.assert_array_equal(ip, ij)
        np.testing.assert_array_equal(yp, yj)
        assert ip.dtype == np.int32 and ip.shape == (64, 4)


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    scores = np.round(rng.random(500), 2)           # with ties
    labels = (rng.random(500) < scores).astype(np.float32)
    assert pmetrics.binary_metrics(scores, labels) == \
        jmetrics.binary_metrics(scores, labels)


def test_latency_cdf_matches_jax(tmp_path):
    samples = np.random.default_rng(1).exponential(1e-3, 5000)
    pr, jr = LatencyRecorder(), JaxLatencyRecorder()
    for s in samples:
        pr.record(s)
        jr.record(s)
    assert pr.summary() == jr.summary()
    pr.write_cdf(str(tmp_path / "p.csv"), method="m")
    jr.write_cdf(str(tmp_path / "j.csv"), method="m")
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "j.csv").read_text()


def test_latency_recorder_start_stop_percentile():
    """start/stop time a span into the samples; percentile is numpy's, as
    in the JAX recorder, and nan with no samples."""
    got, want = LatencyRecorder(), JaxLatencyRecorder()
    assert np.isnan(got.percentile(50)) and np.isnan(want.percentile(50))
    got.start()
    got.stop()
    assert len(got.samples) == 1 and 0 <= got.samples[0] < 1.0
    for v in np.random.default_rng(0).exponential(1e-3, 500):
        got.record(float(v))
        want.record(float(v))
    want.samples.insert(0, got.samples[0])
    for q in (50, 90, 99):
        assert got.percentile(q) == want.percentile(q)


def test_lookup_only_and_cdf(tmp_path):
    cj, cp, params, model, tables = _models("tiny")
    cdf = tmp_path / "cdf.csv"
    res = run_inference(
        model, cp, pcfg.CacheConfig(total_size=60),
        psyn.random_batches(psyn.RandomDataConfig(**_stream(cp, 3))),
        StorageManager("dummy", dim=cp.embedding_dim).load(tables=tables),
        ev_lookup_only=True, cdf_path=str(cdf), use_device_cache=True,
        device="cpu", log_fn=lambda *_: None)
    assert res.metrics == {} and res.requests == 48
    assert res.cache_stats["requests"] == 48
    text = cdf.read_text().splitlines()
    assert text[0] == "# method=fenced batch-time/B approximation"
    assert text[1] == "latency_s,cdf" and len(text) == 2 + 48


def test_unported_driver_options_raise():
    """What the driver still refuses: options beside the device cache that
    the JAX driver ignores (use_native, the lfu and lru policies; the
    device cache runs its own engine and EvLFU), 16- and 4-bit rows in the
    device cache (as JAX's), a store that is not a loaded dummy one behind
    the device cache or the engine (as JAX's), the facade's `native`
    backend (as JAX's), and a request stream of no known distribution
    (the gaussian stream is ported and lives in
    tests/test_torch_synthetic_dist.py)."""
    cj, cp, params, model, tables = _models("tiny")
    sm = StorageManager("dummy", dim=cp.embedding_dim).load(tables=tables)
    batches = psyn.random_batches(psyn.RandomDataConfig(**_stream(cp, 1)))
    with pytest.raises(ValueError, match="exclusive"):
        run_inference(model, cp, pcfg.CacheConfig(), batches, sm,
                      use_native=True, use_device_cache=True, device="cpu")
    for policy in ("lfu", "lru"):
        with pytest.raises(ValueError, match="runs EvLFU"):
            build_cache(pcfg.CacheConfig(policy=policy), cp, sm,
                        use_device_cache=True, device="cpu")
    for p in (16, 4):
        with pytest.raises(ValueError, match="fp32 or int8"):
            build_cache(pcfg.CacheConfig(main_precision=p), cp, sm,
                        use_device_cache=True, device="cpu")
    for kw in (dict(use_device_cache=True, device="cpu"),
               dict(use_native=True)):
        with pytest.raises(ValueError, match="dummy store"):
            build_cache(pcfg.CacheConfig(), cp,
                        StorageManager("dummy", dim=cp.embedding_dim), **kw)
    with pytest.raises(ValueError, match="native engine"):
        StorageManager("native").load(bin_dir=".", table_sizes=[1])
    with pytest.raises(ValueError, match="pareto"):
        next(psyn.random_batches(psyn.RandomDataConfig(
            distribution="pareto")))


NATIVE = {
    "fp32": dict(n_caching_layers=1, total_size=400, main_precision=32),
    "int8": dict(n_caching_layers=1, total_size=400, main_precision=8),
    # the published C1+C2+C3 shape: int8 C1, 4-bit C2, alt-key C3, 48-48-4
    "c1c2c3": dict(n_caching_layers=3, total_size=900, main_precision=8,
                   secondary_precision=4, size_proportion=(48, 48, 4),
                   c3_io_batch=10),
}


def _altkeys(sizes, seed=12):
    """One uniform row of the same table per row, as alt keys (a stand-in
    for the offline kNN product)."""
    rng = np.random.default_rng(seed)
    return [altkey_encode(t, rng.integers(0, n, n))
            for t, n in enumerate(sizes)]


@pytest.mark.parametrize("name", list(NATIVE))
def test_run_inference_through_the_native_cache_matches_jax(name):
    """Both drivers serve through NativeDeviceC1Cache on the same stream:
    metrics within atol 1e-6; requests, perfect hits, hit rate, bytes
    shipped and the C2/C3 stats equal."""
    cj, cp, params, model, tables = _models("narrow26", seed=2)
    kw = dict(policy="evlfu", **NATIVE[name])
    sc = _stream(cp, 10, B=32)
    warm = {**sc, "seed": 6, "num_batches": 2}
    alts = _altkeys(cp.table_sizes)
    ref = jax_run_inference(
        params, cj, jcfg.CacheConfig(**kw),
        jsyn.random_batches(jsyn.RandomDataConfig(**sc)),
        JaxStorageManager("dummy", dim=cj.embedding_dim).load(tables=tables),
        altkey_resolver=JaxAltKeyResolver(alts),
        warmup_batches=jsyn.random_batches(jsyn.RandomDataConfig(**warm)),
        use_device_cache=True, log_fn=lambda *_: None)
    got = run_inference(
        model, cp, pcfg.CacheConfig(**kw),
        psyn.random_batches(psyn.RandomDataConfig(**sc)),
        StorageManager("dummy", dim=cp.embedding_dim).load(tables=tables),
        altkey_resolver=AltKeyResolver(alts),
        warmup_batches=psyn.random_batches(psyn.RandomDataConfig(**warm)),
        use_device_cache=True, device="cpu", log_fn=lambda *_: None)
    assert got.requests == ref.requests == 320
    assert set(got.metrics) == set(ref.metrics)
    for k, v in ref.metrics.items():
        np.testing.assert_allclose(got.metrics[k], v, atol=1e-6, err_msg=k)
    assert got.cache_stats == ref.cache_stats
    assert got.cache_stats["requests"] == 384
    if name == "c1c2c3":
        assert got.cache_stats["c2"]["hit_rate"] > 0
        assert got.cache_stats["c3"]["size"] > 0


@pytest.mark.parametrize("name", ["int8", "c1c2c3"])
def test_scores_through_the_native_cache_match_jax_forward(name):
    cj, cp, params, model, tables = _models("narrow26", seed=1)
    sm = StorageManager("dummy", dim=cp.embedding_dim).load(tables=tables)
    cache = build_cache(pcfg.CacheConfig(**NATIVE[name]), cp, sm,
                        AltKeyResolver(_altkeys(cp.table_sizes)),
                        use_device_cache=True, device="cpu")
    for dense, idx, _ in psyn.random_batches(
            psyn.RandomDataConfig(**_stream(cp, 4, seed=3))):
        rows = cache.lookup_batch(idx)
        with torch.inference_mode():
            got = torch.sigmoid(model(torch.from_numpy(dense), None,
                                      emb_rows=rows))
        ref = jax.nn.sigmoid(dlrm_forward(params, jnp.asarray(dense),
                                          jnp.asarray(idx), cj,
                                          emb_rows=jnp.asarray(rows.numpy())))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    cache.close()


def _threads():
    return set(threading.enumerate())


@pytest.mark.parametrize("name", list(NATIVE))
def test_pipelined_run_equals_sequential(name):
    """pipeline_depth=2 runs the lookups on a prefetch thread: the same
    scores and stats as pipeline_depth=0, and the thread is joined."""
    cj, cp, params, model, tables = _models("narrow26", seed=3)
    sc = _stream(cp, 8, B=32, seed=7)
    before = _threads()
    res = {}
    for depth in (0, 2):
        res[depth] = run_inference(
            model, cp, pcfg.CacheConfig(**NATIVE[name]),
            psyn.random_batches(psyn.RandomDataConfig(**sc)),
            StorageManager("dummy", dim=cp.embedding_dim).load(tables=tables),
            altkey_resolver=AltKeyResolver(_altkeys(cp.table_sizes)),
            use_device_cache=True, pipeline_depth=depth, device="cpu",
            log_fn=lambda *_: None)
        assert _threads() == before
    np.testing.assert_array_equal(res[2].scores, res[0].scores)
    assert res[2].cache_stats == res[0].cache_stats
    assert res[2].metrics == res[0].metrics


@pytest.mark.parametrize("depth", [0, 2])
def test_a_failing_run_leaves_no_thread(depth):
    """A batch iterator that raises, and an id outside its table: the error
    reaches the caller, and the prefetch thread is joined."""
    cj, cp, params, model, tables = _models("tiny")
    sm = StorageManager("dummy", dim=cp.embedding_dim).load(tables=tables)
    good = list(psyn.random_batches(psyn.RandomDataConfig(**_stream(cp, 3))))

    def failing():
        yield from good[:2]
        raise RuntimeError("the stream broke")

    before = _threads()
    with pytest.raises(RuntimeError, match="the stream broke"):
        run_inference(model, cp, pcfg.CacheConfig(total_size=60), failing(),
                      sm, use_device_cache=True, pipeline_depth=depth,
                      device="cpu", log_fn=lambda *_: None)
    assert _threads() == before
    dense, idx, y = good[2]
    idx = idx.copy()
    idx[3, 1] = cp.table_sizes[1]
    with pytest.raises(ValueError, match="table 1 is outside"):
        run_inference(model, cp, pcfg.CacheConfig(total_size=60),
                      good[:2] + [(dense, idx, y)], sm,
                      use_device_cache=True, pipeline_depth=depth,
                      device="cpu", log_fn=lambda *_: None)
    assert _threads() == before


def test_the_caller_owns_a_cache_it_passes():
    """run_inference closes a cache it built; a cache passed in stays open
    for the caller to look into, and the caller closes it."""
    cj, cp, params, model, tables = _models("tiny")
    sm = StorageManager("dummy", dim=cp.embedding_dim).load(tables=tables)
    batches = list(psyn.random_batches(psyn.RandomDataConfig(
        **_stream(cp, 3))))
    cache = build_cache(pcfg.CacheConfig(total_size=60), cp, sm,
                        use_device_cache=True, device="cpu")
    res = run_inference(model, cp, pcfg.CacheConfig(total_size=60),
                        batches[:2], sm, cache=cache, device="cpu",
                        log_fn=lambda *_: None)
    assert res.cache_stats == cache.stats()        # still open
    assert res.cache_stats["requests"] == 32
    rows = cache.lookup_batch(batches[2][1])
    np.testing.assert_array_equal(
        rows.numpy(), np.stack([tables[t][batches[2][1][:, t]]
                                for t in range(cp.num_tables)], axis=1))
    cache.close()
    with pytest.raises(RuntimeError, match="closed"):
        cache.lookup_batch(batches[2][1])


def test_prefetch_iterator():
    """Batches in order, moved to the device; an error after the batches
    before it; close() joins the worker even when the consumer stops
    early."""
    before = _threads()
    data = [(np.arange(3) + i, np.ones((2, 2), np.float32)) for i in range(5)]
    with prefetch(data, depth=2, to_device="cpu") as it:
        got = list(it)
    assert [int(a[0]) for a, _ in got] == [0, 1, 2, 3, 4]
    assert all(isinstance(a, torch.Tensor) for pair in got for a in pair)

    def failing():
        yield from data[:2]
        raise KeyError("boom")

    it = PrefetchIterator(failing(), depth=1)
    assert next(it) is data[0] and next(it) is data[1]
    with pytest.raises(KeyError, match="boom"):
        next(it)
    it.close()
    endless = PrefetchIterator(iter(lambda: data[0], None), depth=2,
                               transform=lambda b: b[0])
    assert int(next(endless)[0]) == 0
    endless.close()
    assert _threads() == before


def test_bf16_forward_matches_jax():
    """compute_dtype=bfloat16 at the Kaggle MLP widths (4 tables of
    200-1,000 rows, B=256, PRNGKey(0)): the matmuls sum exact products of
    bf16 operands in float32, as JAX's preferred_element_type=float32 does.
    Tolerance 1e-5 (1 + |ref|) on the logits: the summation order differs,
    and a bf16 rounding between layers may still land on the other side of
    a boundary.  A bf16 matmul, which rounds every output to bf16, missed
    by 3.4e-4."""
    kw = dict(compute_dtype="bfloat16", use_interaction_kernel=False)
    args = (36, (200, 450, 700, 1000), (512, 256, 64), (512, 256))
    cj = jcfg.make_dlrm_config(*args, compute_dtype="bfloat16")
    cp = pcfg.make_dlrm_config(*args, **kw)
    params = init_dlrm(jax.random.PRNGKey(0), cj)
    npp = jax.tree_util.tree_map(np.asarray, params)
    model = DLRM(cp, device="cpu")
    model.load_state_dict(params_from_jax(npp.dense, npp.sparse, cp,
                                          device="cpu")[0])
    dense, idx, _ = next(psyn.random_batches(
        psyn.RandomDataConfig(**_stream(cp, 1, B=256, dist="uniform"))))
    with torch.inference_mode():
        got = model(torch.from_numpy(dense), torch.from_numpy(idx)).numpy()
    ref = np.asarray(dlrm_forward(params, jnp.asarray(dense),
                                  jnp.asarray(idx), cj))
    assert np.all(np.abs(got - ref) <= 1e-5 * (1 + np.abs(ref))), \
        float(np.abs(got - ref).max())


# ------------------------------------------------------------ host tiers

HOST = {
    "evlfu-32": dict(total_size=400),
    "evlfu-16": dict(total_size=400, main_precision=16),
    "evlfu-8": dict(total_size=400, main_precision=8),
    "evlfu-4": dict(total_size=400, main_precision=4),
    "evlfu-approx": dict(total_size=400, approx_emb_threshold=20),
    "c1c2-8-4": dict(n_caching_layers=2, total_size=600, main_precision=8,
                     secondary_precision=4, size_proportion=(50, 50, 0)),
    "c1c2c3-8-4": NATIVE["c1c2c3"],
    "lfu": dict(policy="lfu", total_size=400),
    "lru": dict(policy="lru", total_size=400),
}
NATIVE_HOST = ["evlfu-32", "evlfu-8", "c1c2-8-4", "c1c2c3-8-4", "lfu", "lru"]


def _serve_both(kw, *, port_sm=None, jax_sm=None, seed=4, n=10, B=32,
                port_kw=None, jax_kw=None):
    """The port's and the JAX package's run_inference on the same model,
    stream, warm-up, alt keys and tables; returns (port, jax) results."""
    cj, cp, params, model, tables = _models("narrow26", seed=seed)
    kw = {"policy": "evlfu", **kw}
    sc = _stream(cp, n, B=B, seed=seed + 10)
    warm = {**sc, "seed": seed + 20, "num_batches": 2}
    alts = _altkeys(cp.table_sizes)
    ref = jax_run_inference(
        params, cj, jcfg.CacheConfig(**kw),
        jsyn.random_batches(jsyn.RandomDataConfig(**sc)),
        jax_sm(tables) if jax_sm else JaxStorageManager(
            "dummy", dim=cj.embedding_dim).load(tables=tables),
        altkey_resolver=JaxAltKeyResolver(alts),
        warmup_batches=jsyn.random_batches(jsyn.RandomDataConfig(**warm)),
        log_fn=lambda *_: None, **(jax_kw or {}))
    got = run_inference(
        model, cp, pcfg.CacheConfig(**kw),
        psyn.random_batches(psyn.RandomDataConfig(**sc)),
        port_sm(tables) if port_sm else StorageManager(
            "dummy", dim=cp.embedding_dim).load(tables=tables),
        altkey_resolver=AltKeyResolver(alts),
        warmup_batches=psyn.random_batches(psyn.RandomDataConfig(**warm)),
        device="cpu", log_fn=lambda *_: None, **(port_kw or {}))
    y = np.concatenate([b[2] for b in psyn.random_batches(
        psyn.RandomDataConfig(**sc))]) > 0.5
    got.pair_weight = 1.0 / max(int(y.sum()) * int((~y).sum()), 1)
    return got, ref


def _assert_same_run(got, ref, n_req=320):
    """Requests and every cache stat equal; metrics within atol 1e-6, the
    AUC within one pair's weight 1 / (n_pos n_neg) more.  The forwards
    agree within 1 f32 ulp, and two scores that tie in the jitted JAX
    forward and not in the port's move the AUC by half a pair's weight
    (1.95e-5 measured on the stream of `evlfu-32`, where the AUC of eager
    JAX's scores equals the port's)."""
    assert got.requests == ref.requests == n_req
    assert set(got.metrics) == set(ref.metrics)
    for k, v in ref.metrics.items():
        extra = got.pair_weight if k == "auc" else 0.0
        np.testing.assert_allclose(got.metrics[k], v, atol=1e-6 + extra,
                                   rtol=0, err_msg=k)
    assert got.cache_stats == ref.cache_stats


@pytest.mark.parametrize("name", list(HOST))
def test_run_inference_on_the_host_tiers_matches_jax(name):
    """use_device_cache=False: the Python TieredCache at 1-3 tiers and
    32/16/8/4 bits, with the approximate-embedding short-circuit, and the
    LFU/LRU baselines, against the JAX driver on the same stream."""
    got, ref = _serve_both(HOST[name])
    _assert_same_run(got, ref)
    assert got.cache_stats["requests"] == 384
    assert set(got.host_s) == {"lookup", "copy", "forward"}
    if name == "c1c2c3-8-4":
        assert got.cache_stats["c3"]["hits"] > 0


@pytest.mark.parametrize("name", NATIVE_HOST)
def test_run_inference_through_the_engine_host_path_matches_jax(name):
    """use_native=True: the port's engine against JAX's engine, EvLFU, LFU
    and LRU, one to three tiers."""
    got, ref = _serve_both(HOST[name], port_kw=dict(use_native=True),
                           jax_kw=dict(use_native=True))
    _assert_same_run(got, ref)
    assert got.cache_stats["requests"] == 384


@pytest.mark.parametrize("backend", ["file", "mmap", "sqlite", "logkv"])
def test_file_backed_stores_behind_the_host_tiers_match_jax(backend,
                                                           tmp_path):
    """The tiers over each file-backed store, C1 at 8 bits over fp32
    files, against the JAX driver over its own store of the same files."""
    sizes = list(NARROW_SIZES)

    def make(mod, db):
        def load(tables):
            bins = tmp_path / "bins"
            if not bins.exists():
                from evstore_tpu.cache.storage import write_ev_tables_binary
                write_ev_tables_binary(tables, str(bins))
            return mod(backend, dim=8).load(
                bin_dir=str(bins), table_sizes=sizes,
                db_path=str(tmp_path / db))
        return load

    got, ref = _serve_both(HOST["evlfu-8"],
                           port_sm=make(StorageManager, "p.db"),
                           jax_sm=make(JaxStorageManager, "j.db"))
    _assert_same_run(got, ref)


@pytest.mark.parametrize("kind", ["native", "device"])
def test_the_engine_serves_from_files_as_from_tables(kind, tmp_path):
    """A cache whose engine reads the .bin files (`open_table_files`),
    passed as `cache=`, against the JAX driver's engine over the same
    tables in RAM: the JAX driver refuses a file store behind the engine,
    as the port's does."""
    from evstore_tpu.cache.storage import write_ev_tables_binary
    from evstore_tpu_torch.cache.device_cache import NativeDeviceC1Cache
    from evstore_tpu_torch.native import NativeTieredCache
    cj, cp, params, model, tables = _models("narrow26", seed=4)
    write_ev_tables_binary(tables, str(tmp_path))
    kw = dict(NATIVE["c1c2c3"])
    ccfg = pcfg.CacheConfig(**kw)
    if kind == "native":
        cache = NativeTieredCache(ccfg, cp.num_tables, cp.embedding_dim)
        flag = dict(use_native=True)
    else:
        cache = NativeDeviceC1Cache(ccfg, cp.num_tables, cp.embedding_dim,
                                    device="cpu")
        flag = dict(use_device_cache=True)
    cache.open_table_files(str(tmp_path), cp.table_sizes)
    cache.load_altkeys(_altkeys(cp.table_sizes))
    try:
        got, ref = _serve_both(kw, port_kw=dict(cache=cache, **flag),
                               jax_kw=flag)
        _assert_same_run(got, ref)
    finally:
        cache.close()
    fsm = JaxStorageManager("file", dim=8).load(
        bin_dir=str(tmp_path), table_sizes=cp.table_sizes)
    with pytest.raises(ValueError, match="file mode"):
        jax_run_inference(params, cj, jcfg.CacheConfig(**kw), [], fsm,
                          log_fn=lambda *_: None, **flag)
    psm = StorageManager("file", dim=8).load(
        bin_dir=str(tmp_path), table_sizes=cp.table_sizes)
    with pytest.raises(ValueError, match="file mode"):
        run_inference(model, cp, ccfg, [], psm, device="cpu",
                      log_fn=lambda *_: None, **flag)


def test_trace_files_match_jax(tmp_path):
    got, ref = _serve_both(HOST["evlfu-32"],
                           port_kw=dict(trace_dir=str(tmp_path / "p")),
                           jax_kw=dict(trace_dir=str(tmp_path / "j")))
    _assert_same_run(got, ref)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "p").iterdir())
    assert len(names) == 26 and "trace-table-1.csv" in names
    for n in names:
        text = (tmp_path / "p" / n).read_text()
        assert text == (tmp_path / "j" / n).read_text()
        assert len(text.splitlines()) == 320


def test_bs1_cdf_is_true_per_request(tmp_path):
    """At batch size 1 each request is timed alone, fenced by a real
    transfer, and the CDF file's header says so, as the JAX driver's does;
    with a prefetch thread it is the batch-time approximation."""
    cdf = {k: tmp_path / f"{k}.csv" for k in ("p", "j", "p2")}
    got, ref = _serve_both(HOST["evlfu-32"], n=24, B=1,
                           port_kw=dict(cdf_path=str(cdf["p"])),
                           jax_kw=dict(cdf_path=str(cdf["j"])))
    _assert_same_run(got, ref, n_req=24)
    head = cdf["p"].read_text().splitlines()[0]
    assert head == cdf["j"].read_text().splitlines()[0]
    assert head == "# method=true-per-request (bs=1, fenced transfer)"
    assert got.latency["count"] == 24
    got2, _ = _serve_both(HOST["evlfu-32"], n=24, B=1,
                          port_kw=dict(cdf_path=str(cdf["p2"]),
                                       pipeline_depth=2))
    assert cdf["p2"].read_text().splitlines()[0] == \
        "# method=fenced batch-time/B approximation"
    np.testing.assert_array_equal(got2.scores, got.scores)


@pytest.mark.parametrize("name", ["evlfu-8", "lru"])
def test_lookup_only_on_host_caches_matches_jax(name):
    got, ref = _serve_both(HOST[name], port_kw=dict(ev_lookup_only=True),
                           jax_kw=dict(ev_lookup_only=True))
    assert got.metrics == ref.metrics == {} and got.scores is None
    assert got.cache_stats == ref.cache_stats
    assert got.latency["count"] == 320


@pytest.mark.parametrize("name,flag", [("c1c2c3-8-4", {}),
                                       ("lfu", {}),
                                       ("c1c2c3-8-4", {"use_native": True})],
                         ids=["tiers", "lfu", "native"])
def test_host_pipelined_run_equals_sequential(name, flag):
    """pipeline_depth=2 on a host cache: the lookup and the rows' copy run
    on the prefetch thread; scores and stats equal depth 0's, and the
    thread is joined."""
    before = _threads()
    runs = [_serve_both(HOST[name], port_kw=dict(pipeline_depth=d, **flag),
                        jax_kw=flag)[0] for d in (0, 2)]
    assert _threads() == before
    np.testing.assert_array_equal(runs[1].scores, runs[0].scores)
    assert runs[1].cache_stats == runs[0].cache_stats
