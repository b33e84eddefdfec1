"""The port's serving slice against the JAX package, on the CPU: weights
converted from the JAX pytree, the model forward, the inference driver
through the device C1 cache, and the copied host modules (request streams,
metrics, latency CDF).

Tolerances: scores rtol 1e-5 (float32, TF32 off; summation order differs
between XLA and PyTorch); metrics atol 1e-6; everything the port copies or
moves (weights, rows, streams, policy counters) exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu import config as jcfg
from evstore_tpu.cache.storage import StorageManager as JaxStorageManager
from evstore_tpu.data import synthetic as jsyn
from evstore_tpu.drivers.infer import run_inference as jax_run_inference
from evstore_tpu.models.dlrm import dlrm_forward, init_dlrm
from evstore_tpu.models.dlrm import predict as jax_predict
from evstore_tpu.train import metrics as jmetrics
from evstore_tpu.utils.trace import LatencyRecorder as JaxLatencyRecorder
from evstore_tpu_torch import config as pcfg
from evstore_tpu_torch.cache.storage import StorageManager
from evstore_tpu_torch.convert import params_from_jax, params_to_numpy
from evstore_tpu_torch.data import synthetic as psyn
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
    cj, cp, params, model, tables = _models("tiny")
    sm = StorageManager("dummy", dim=cp.embedding_dim).load(tables=tables)
    batches = psyn.random_batches(psyn.RandomDataConfig(**_stream(cp, 1)))
    with pytest.raises(NotImplementedError, match="pipeline_depth"):
        run_inference(model, cp, pcfg.CacheConfig(), batches, sm,
                      use_device_cache=True, pipeline_depth=2, device="cpu")
    with pytest.raises(NotImplementedError, match="TieredCache"):
        run_inference(model, cp, pcfg.CacheConfig(), batches, sm,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="EvLFU over C1"):
        build_cache(pcfg.CacheConfig(n_caching_layers=2), cp, sm,
                    use_device_cache=True, device="cpu")
    with pytest.raises(NotImplementedError, match="gaussian"):
        next(psyn.random_batches(psyn.RandomDataConfig(
            distribution="gaussian")))
