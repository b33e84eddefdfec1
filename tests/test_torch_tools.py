"""The port's offline tools (`evstore_tpu_torch/tools/`) against the JAX
package's (`evstore_tpu/tools/`), on the CPU, on the same numpy inputs.

Every tool case of tests/test_tools.py (:19-96, :112-190) and
tests/test_service.py::test_export_stablehlo_roundtrip, each with the JAX
test's own assertions and held to the JAX tool:
- `gen_altkeys` (the kNN with `device="cpu"`): alt keys equal, the
  neighbour lists of a 5,000 x 36 table equal, the big-endian files
  byte-equal and read back by both packages' `AltKeyResolver`, the
  workload frequencies equal;
- `reduce_precision`: files byte-equal at 16, 8 and 4 bits, the float
  check's CSVs and the preconditioned files too, the CLI's printed paths;
- `plot_cdf`: the readings equal, the PNG written, and without
  matplotlib the JAX tool's ASCII lines after a line that says so;
- `visualize`: each analysis within 1e-6 relative of JAX's (cluster labels
  and counts equal), the CLI's report.json the same and its PNGs written;
  without matplotlib, sklearn and umap the fallbacks run, say so, and give
  JAX's fallback analyses;
- `export_model`: the loaded program's scores equal JAX's `predict` on the
  converted weights (rtol 1e-5), its graph holds the K1 custom op once
  (none with the interaction kernel off), and `truncate_tables` cuts the
  plain tables.
The alt-key kNN without a card and without `device="cpu"` raises.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu.tools import gen_altkeys as jgen
from evstore_tpu.tools import plot_cdf as jplot
from evstore_tpu.tools import reduce_precision as jred
from evstore_tpu.tools import visualize as jviz
from evstore_tpu_torch.tools import gen_altkeys as pgen
from evstore_tpu_torch.tools import plot_cdf as pplot
from evstore_tpu_torch.tools import reduce_precision as pred
from evstore_tpu_torch.tools import visualize as pviz


@pytest.fixture
def tables(rng):
    return [rng.uniform(-0.9, 0.9, (30, 8)).astype(np.float32)
            for _ in range(3)]


def _same_alts(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            _same_dirs(pa, pb)
            continue
        with open(pa, "rb") as f, open(pb, "rb") as g:
            assert f.read() == g.read(), n


# ------------------------------------------------------------- gen_altkeys

def test_altkeys_nearest_neighbor(tables):
    tables[1][7] = tables[0][5] + 1e-4
    alts = pgen.generate_altkeys(tables, n_neighbors=3, device="cpu")
    _same_alts(alts, jgen.generate_altkeys(tables, n_neighbors=3))
    assert len(alts) == 3 and all(len(a) == 30 for a in alts)
    assert int(alts[0][5]) == 2 + 100 * 7
    assert int(alts[1][7]) == 1 + 100 * 5


def test_altkeys_popularity_pick(tables):
    freq = [np.zeros(30), np.zeros(30), np.zeros(30)]
    freq[2][3] = 1e6
    alts = pgen.generate_altkeys(tables, workload_freq=freq, n_neighbors=89,
                                 device="cpu")
    _same_alts(alts, jgen.generate_altkeys(tables, workload_freq=freq,
                                           n_neighbors=89))
    assert sum(int(a) == 3 + 100 * 3 for a in np.concatenate(alts)) == 89


@pytest.mark.parametrize("block", [2048, 777])
def test_knn_neighbours_equal_jax(rng, block):
    rows = rng.normal(size=(5000, 36)).astype(np.float32)
    got = pgen._topk_neighbors_blocked(rows, 10, block, device="cpu")
    np.testing.assert_array_equal(
        got, jgen._topk_neighbors_blocked(rows, 10, block))


def test_altkeys_binary_bigendian(tables, tmp_path):
    from evstore_tpu.cache.tiers import AltKeyResolver as JResolver
    from evstore_tpu_torch.cache.tiers import AltKeyResolver
    alts = pgen.generate_altkeys(tables, n_neighbors=2, device="cpu")
    paths = pgen.write_altkeys_binary(alts, str(tmp_path / "p"))
    jgen.write_altkeys_binary(jgen.generate_altkeys(tables, n_neighbors=2),
                              str(tmp_path / "j"))
    _same_dirs(tmp_path / "p", tmp_path / "j")
    np.testing.assert_array_equal(np.fromfile(paths[0], dtype=">u4"),
                                  alts[0])
    for cls in (AltKeyResolver, JResolver):
        r = cls(bin_dir=str(tmp_path / "p"), table_sizes=[30, 30, 30])
        assert r([(0, 5)])[0] == int(alts[0][5])


def test_workload_frequencies(tmp_path):
    d = tmp_path / "trace"
    d.mkdir()
    (d / "trace-table-1.csv").write_text("1\n1\n2\n")
    (d / "trace-table-2.csv").write_text("0\n40\n")
    f = pgen.workload_frequencies(str(d), [30, 30, 30])
    for a, b in zip(f, jgen.workload_frequencies(str(d), [30, 30, 30])):
        np.testing.assert_array_equal(a, b)
    assert f[0][1] == 2 and f[0][2] == 1 and f[1][0] == 1
    assert f[2].sum() == 0


def test_gen_altkeys_needs_a_card_or_cpu(tables):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pgen.generate_altkeys(tables)


# -------------------------------------------------------- reduce_precision

@pytest.mark.parametrize("bits", [16, 8, 4])
def test_reduce_precision_pipeline(tables, tmp_path, bits):
    from evstore_tpu_torch.cache.storage import (FileStore,
                                                 write_ev_tables_binary)
    write_ev_tables_binary(tables, str(tmp_path / "ev32"), 32)
    pred.reduce_tables(str(tmp_path / "ev32"), str(tmp_path / "p"),
                       [30, 30, 30], 8, new_precision=bits,
                       also_float_check=True)
    jred.reduce_tables(str(tmp_path / "ev32"), str(tmp_path / "j"),
                       [30, 30, 30], 8, new_precision=bits,
                       also_float_check=True)
    _same_dirs(tmp_path / "p", tmp_path / "j")
    if bits == 8:
        fs = FileStore(str(tmp_path / "p"), [30, 30, 30], 8, precision=8)
        assert np.max(np.abs(fs.get(1, 3) - tables[1][3])) < 0.01
        fs.close()


def test_preconditioning_add(tables, tmp_path):
    from evstore_tpu_torch.cache.storage import (FileStore,
                                                 write_ev_tables_binary)
    write_ev_tables_binary(tables, str(tmp_path / "a"), 32)
    pred.apply_preconditioning_add_x(str(tmp_path / "a"), str(tmp_path / "p"),
                                     [30, 30, 30], 8, 0.05)
    jred.apply_preconditioning_add_x(str(tmp_path / "a"), str(tmp_path / "j"),
                                     [30, 30, 30], 8, 0.05)
    _same_dirs(tmp_path / "p", tmp_path / "j")
    fs = FileStore(str(tmp_path / "p"), [30, 30, 30], 8)
    np.testing.assert_allclose(fs.get(0, 0), tables[0][0] + 0.05, rtol=1e-5)
    fs.close()


def test_reduce_precision_cli(tables, tmp_path, capsys):
    from evstore_tpu_torch.cache.storage import write_ev_tables_binary
    write_ev_tables_binary(tables, str(tmp_path / "ev32"), 32)
    printed = []
    for side, main in (("p", pred.main), ("j", jred.main)):
        rc = main(["--in-dir", str(tmp_path / "ev32"), "--out-dir",
                   str(tmp_path / side), "--table-sizes", "30-30-30",
                   "--dim", "8", "--new-precision", "4",
                   "--precondition-add", "0.01"])
        assert rc == 0
        printed.append(capsys.readouterr().out.replace(f"/{side}/", "/"))
    assert printed[0] == printed[1] and "ev-table-1.bin" in printed[0]
    _same_dirs(tmp_path / "p", tmp_path / "j")


# --------------------------------------------------------------- plot_cdf

def _cdf(tmp_path):
    from evstore_tpu_torch.utils.trace import LatencyRecorder
    lat = LatencyRecorder()
    for i in range(200):
        lat.record(0.001 + (i % 37) * 1e-5)
    p = tmp_path / "cdf.csv"
    lat.write_cdf(str(p))
    return p


def test_plot_cdf_tool(tmp_path, capsys):
    p = _cdf(tmp_path)
    lats, qs = pplot.read_cdf(str(p))
    assert (lats, qs) == jplot.read_cdf(str(p))
    assert len(lats) == len(qs) > 10 and qs[-1] == 1.0
    assert pplot.main([str(p), "--out", str(tmp_path / "cdf.png")]) == 0
    assert (tmp_path / "cdf.png").exists()
    assert capsys.readouterr().out == f"wrote {tmp_path / 'cdf.png'}\n"


def test_plot_cdf_without_matplotlib(tmp_path, capsys, monkeypatch):
    p = _cdf(tmp_path)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    argv = [str(p), str(p), "--out", str(tmp_path / "cdf.png"),
            "--unit", "us"]
    assert jplot.main(argv) == 0
    ref = capsys.readouterr().out
    assert pplot.main(argv) == 0
    got = capsys.readouterr().out
    note, rest = got.split("\n", 1)
    assert "matplotlib is not installed" in note and "ASCII" in note
    assert rest == ref and ref.count("p99=") == 2
    assert not (tmp_path / "cdf.png").exists()


# -------------------------------------------------------------- visualize

def _close(a, b, what=""):
    """Numbers within 1e-6 relative, structures equal (JSON-like)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _close(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _close(x, y, what)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), rtol=1e-6,
                                   atol=1e-12, err_msg=what)
    elif isinstance(a, float) or isinstance(b, float):
        if np.isnan(b):
            assert np.isnan(a), what
        else:
            assert abs(a - b) <= 1e-6 * abs(b) + 1e-12, (what, a, b)
    else:
        assert a == b, what


def _blobs(rng):
    return np.concatenate([rng.normal(0, 0.1, (60, 8)),
                           rng.normal(5, 0.1, (60, 8))]).astype(np.float32)


def test_visualize_analyses(rng):
    blob = _blobs(rng)
    pts = pviz.project_embeddings(blob, method="pca")
    assert pts.shape == (120, 2)
    _close(pts, jviz.project_embeddings(blob, method="pca"))
    labels = pviz.density_cluster(blob, min_cluster_size=10)
    np.testing.assert_array_equal(
        labels, jviz.density_cluster(blob, min_cluster_size=10))
    summ = pviz.cluster_summary(labels)
    assert summ == jviz.cluster_summary(labels) and summ["n_clusters"] >= 2
    np.testing.assert_array_equal(pviz.kmeans(blob, 4),
                                  jviz.kmeans(blob, 4))

    heavy = rng.zipf(2.0, 5000) % 100
    light = rng.integers(0, 100, 5000)
    idx = np.stack([heavy, light], axis=1)
    cc = pviz.categorical_counts(idx, [100, 100])
    _close(cc, jviz.categorical_counts(idx, [100, 100]))
    assert cc[0]["zipf_alpha"] > cc[1]["zipf_alpha"]
    assert cc[0]["rows_for_90pct"] < cc[1]["rows_for_90pct"]

    scores = rng.uniform(0, 1, 120)
    y = (rng.uniform(0, 1, 120) < scores).astype(np.float32)
    rep = pviz.analyze_model_data(scores, y, features=blob)
    _close(rep, jviz.analyze_model_data(scores, y, features=blob))
    assert rep["calibration"]["ece"] < 0.2
    assert rep["score_stats"]["pos_mean"] > rep["score_stats"]["neg_mean"]

    stats = pviz.embedding_norm_stats(blob)
    _close(stats, jviz.embedding_norm_stats(blob))
    assert stats["max"] >= stats["p99"] >= stats["p50"] >= stats["min"]
    nb = pviz.neighbor_similarity(blob, sample=40)
    _close(nb, jviz.neighbor_similarity(blob, sample=40))
    assert nb["nn1_mean"] < nb["row_distance_scale"]


def _viz_inputs(tmp_path, rng):
    from evstore_tpu_torch.cache.storage import write_ev_tables_binary
    sizes = [40, 30]
    tabs = [rng.normal(size=(s, 8)).astype(np.float32) for s in sizes]
    write_ev_tables_binary(tabs, str(tmp_path))
    idx = np.stack([rng.integers(0, 40, 500), rng.integers(0, 30, 500)], 1)
    scores = rng.uniform(0, 1, 500)
    labs = (scores > 0.5).astype(np.float32)
    np.savez(tmp_path / "trace.npz", idx=idx, scores=scores, labels=labs)
    return ["--ev-table-path", str(tmp_path), "--dim", "8",
            "--table-sizes", "40-30", "--project", "pca",
            "--trace-npz", str(tmp_path / "trace.npz"), "--sample", "40"]


def _report(d):
    return json.loads((d / "report.json").read_text())


def test_visualize_cli(tmp_path, rng, capsys):
    argv = _viz_inputs(tmp_path, rng)
    for side, main in (("p", pviz.main), ("j", jviz.main)):
        assert main(argv + ["--out-dir", str(tmp_path / side)]) == 0
    assert "not installed" not in capsys.readouterr().out
    rep = _report(tmp_path / "p")
    _close(rep, _report(tmp_path / "j"))
    assert "norms" in rep and "categorical" in rep and "model" in rep
    for png in ("table0_projection.png", "count_ranks.png",
                "calibration.png"):
        assert (tmp_path / "p" / png).exists()


def test_visualize_fallbacks(tmp_path, rng, capsys, monkeypatch):
    """Without matplotlib, sklearn and umap (the card's machine): the
    CLI writes the report alone and says which fallbacks ran; the
    fallback analyses equal JAX's under the same imports."""
    argv = _viz_inputs(tmp_path, rng)
    blob = _blobs(rng)
    for m in ("matplotlib", "sklearn", "umap", "hdbscan"):
        monkeypatch.setitem(sys.modules, m, None)
    assert pviz.main(argv[:-6] + ["--project", "auto", "--sample", "40",
                                  "--out-dir", str(tmp_path / "p")]) == 0
    out = capsys.readouterr().out
    for note in ("matplotlib is not installed", "sklearn is not installed",
                 "the PCA projection"):
        assert note in out, note
    rep = _report(tmp_path / "p")
    assert set(rep) == {"norms", "neighbors"}
    assert not list((tmp_path / "p").glob("*.png"))
    _close(pviz.neighbor_similarity(blob, sample=40),
           jviz.neighbor_similarity(blob, sample=40))
    _close(pviz.project_embeddings(blob), jviz.project_embeddings(blob))
    np.testing.assert_array_equal(pviz.density_cluster(blob, 10),
                                  jviz.density_cluster(blob, 10))
    assert pviz.plot_calibration({"bins": [], "ece": 0.0},
                                 str(tmp_path / "c.png")) is None


# ------------------------------------------------------------ export_model

def _export_model(cfg_args=None, interaction_kernel=True):
    import dataclasses
    from evstore_tpu.config import tiny_dlrm_config
    from evstore_tpu.models.dlrm import init_dlrm
    from evstore_tpu_torch import config as pcfg
    from evstore_tpu_torch.convert import params_from_jax
    from evstore_tpu_torch.models.dlrm import DLRM
    cj = tiny_dlrm_config()
    params = init_dlrm(jax.random.PRNGKey(0), cj)
    cp = dataclasses.replace(pcfg.tiny_dlrm_config(),
                             use_interaction_kernel=interaction_kernel)
    state, _ = params_from_jax(
        jax.tree_util.tree_map(np.asarray, params.dense),
        jax.tree_util.tree_map(np.asarray, params.sparse), cp, device="cpu")
    model = DLRM(cp, device="cpu")
    model.load_state_dict(state)
    return cj, params, model


def test_export_roundtrip(tmp_path):
    """test_service.py::test_export_stablehlo_roundtrip on the port."""
    from evstore_tpu.models.dlrm import predict
    from evstore_tpu_torch.tools.export_model import (export_program,
                                                      load_exported,
                                                      truncate_tables)
    cj, params, model = _export_model()
    path = export_program(model, 4, str(tmp_path / "dlrm.pt2"))
    fn = load_exported(path)
    rng = np.random.default_rng(0)
    dense = rng.random((4, cj.num_dense_features)).astype(np.float32)
    idx = rng.integers(0, 20, (4, cj.num_tables)).astype(np.int32)
    got = fn(torch.from_numpy(dense), torch.from_numpy(idx)).numpy()
    expect = np.asarray(predict(params, jnp.asarray(dense),
                                jnp.asarray(idx), cj))
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    tp = truncate_tables(model, 10)
    assert tp.tables[0].shape[0] == 10 and tp.cfg.table_sizes[0] == 10
    assert torch.equal(tp.tables[1], model.tables[1][:10])
    assert torch.equal(tp.top[0].weight, model.top[0].weight)


@pytest.mark.parametrize("kernel", [True, False])
def test_export_carries_the_interaction_op(tmp_path, kernel):
    from evstore_tpu_torch.tools.export_model import (export_program,
                                                      load_exported)
    _, _, model = _export_model(interaction_kernel=kernel)
    path = export_program(model, 8, str(tmp_path / "dlrm.pt2"))
    code = torch.export.load(path).graph_module.code
    assert code.count("evstore.dot_interaction") == int(kernel)
    idx = torch.tensor([[0, 1, 2]] * 7 + [[99, -1, 5]], dtype=torch.int32)
    dense = torch.ones((8, model.cfg.num_dense_features))
    with torch.no_grad():
        ref = model.predict(dense, idx.clamp(0, 19))
    got = load_exported(path)(dense, idx)
    torch.testing.assert_close(got[:7], ref[:7], rtol=0, atol=0)
    # ids outside their table read a zero row, as the port's gathers do
    rows = torch.stack([model.tables[0][0] * 0, model.tables[1][0] * 0,
                        model.tables[2][5]])[None]
    with torch.no_grad():
        last = model.predict(dense[7:], emb_rows=rows)
    torch.testing.assert_close(got[7:], last, rtol=0, atol=0)
