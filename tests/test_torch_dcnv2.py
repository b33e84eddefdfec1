"""MLPerf's DLRM-DCNv2 in the port against its plain reference, on the CPU
at a small size: T = 4 tables with bags of 1, 3, 7 and 2 ids, D = 8, two
cross layers of rank 4, B = 64, seeded weights (the cross network's b drawn
nonzero, so that its gradient is tested).

The port and the benchmark's plain reference (`evbench/reference/
dcnv2.py`) compute the same float32 functions in another order: the bags'
sums (`torch.segment_reduce` against `index_add`), the row-wise update's
run sums (the kernel's plain version in float64 against the reference's
float64 `index_add`).  Tolerances:
logits rtol 1e-5, atol 1e-6 (a few roundings of float32 sums of at most
7 rows and of products over 40 and 16 terms); losses rtol 1e-5; weights,
rows and optimizer sums after three row-wise Adagrad steps rtol 1e-4,
atol 1e-6, as `test_torch_train.py` holds three steps to JAX (a first
step moves each weight by about lr sign(g), so a gradient within rounding
of 0 may take either sign on the two sides: the MLPs' and the cross
network's sums catch that).  The JAX package has no cross network and no
bags of a length per table, so the reference stands in for it here.
"""

import os

import numpy as np
import pytest
import torch

from evstore_tpu_torch import config as pcfg
from evstore_tpu_torch.models import dlrm as pdlrm
from evstore_tpu_torch.models import embedding as pemb
from evstore_tpu_torch.models.embedding import check_ids, pool_columns
from evstore_tpu_torch.ops.cuda_cross import (LowRankCross,
                                              cross_layer_bwd,
                                              cross_layer_fwd)
from evstore_tpu_torch.train.train_loop import (evaluate, init_opt_state,
                                                make_train_step, train)
from evbench.reference import dcnv2 as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAGS = (1, 3, 7, 2)
SIZES = (50, 40, 30, 20)
B = 64
LOGIT_TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = dict(rtol=1e-4, atol=1e-6)


def small_config(**kw):
    kw = {"multi_hot_sizes": BAGS, "interaction_op": "dcn",
          "dcn_num_layers": 2, "dcn_low_rank_dim": 4, **kw}
    return pcfg.make_dlrm_config(8, SIZES, (16,), (16,), num_dense=5, **kw)


def model_and_weights(cfg, seed=1):
    """The port's model from `seed` with b drawn nonzero, and the same
    weights and tables for the reference."""
    m = pdlrm.DLRM(cfg, device="cpu", seed=seed)
    rng = np.random.default_rng(seed + 100)
    with torch.no_grad():
        for b in m.cross.b:
            b.copy_(torch.from_numpy(rng.normal(0.0, 0.1, b.shape)))
    w = {"bot": [(l.weight.detach().clone(), l.bias.detach().clone())
                 for l in m.bot],
         "top": [(l.weight.detach().clone(), l.bias.detach().clone())
                 for l in m.top],
         "cross": [tuple(p.detach().clone() for p in layer)
                   for layer in m.cross.layers()]}
    return m, w, [t.detach().clone() for t in m.tables]


def bag_batch(seed, repeat=True):
    """(dense, ids [B, 13], labels); with `repeat` every sample's bag of
    table 1 holds its first id twice and table 2's first id repeats across
    samples."""
    r = np.random.default_rng(seed)
    ids = np.concatenate([r.integers(0, SIZES[t], (B, BAGS[t]))
                          for t in range(4)], axis=1).astype(np.int32)
    if repeat:
        ids[:, 2] = ids[:, 1]
        ids[: B // 2, 4] = 7
    return (r.random((B, 5), dtype=np.float32), ids,
            r.integers(0, 2, B).astype(np.float32))


def as_torch(batch):
    return tuple(torch.from_numpy(a) for a in batch)


def test_logits_match_the_reference():
    cfg = small_config()
    m, w, tabs = model_and_weights(cfg)
    d, i, _ = as_torch(bag_batch(0))
    got = m(d, i)
    want = ref.forward(w, d, ref.pool(ref.gather(tabs, i, BAGS), BAGS),
                       "dcn")
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **LOGIT_TOL)
    assert got.shape == (B,)


@pytest.mark.parametrize("update_kernel", [True, False])
def test_three_rwsadagrad_steps_match_the_reference(update_kernel):
    """Losses, the MLPs, the cross network, every table's rows and the
    optimizer's dense and row sums after each of three steps."""
    cfg = small_config()
    m, w, tabs = model_and_weights(cfg)
    batches = [bag_batch(k) for k in range(3)]
    tcfg = pcfg.TrainConfig(learning_rate=0.05, optimizer="rwsadagrad",
                            use_update_kernel=update_kernel)
    st = init_opt_state(m, tcfg)
    step = make_train_step(cfg, tcfg)
    want_l, want = ref.rwsadagrad_steps(
        w, tabs, [as_torch(b) for b in batches], BAGS, 0.05, "dcn",
        keep=(0, 1, 2))
    names = [n for n, p in m.named_parameters() if p.requires_grad]
    assert [n for n in names if n.startswith("cross")] == [
        "cross.V.0", "cross.V.1", "cross.W.0", "cross.W.1", "cross.b.0",
        "cross.b.1"]
    for k, b in enumerate(batches):
        loss = float(step(m, st, *b))
        np.testing.assert_allclose(loss, want_l[k], rtol=1e-5)
        ws = want[k]
        leaves = [t for part in ("bot", "top") for lin in getattr(m, part)
                  for t in (lin.weight, lin.bias)] + [
            p for layer in m.cross.layers() for p in layer]
        sums = [st.dense[n] for n in
                [f"{part}.{i}.{k2}" for part in ("bot", "top")
                 for i in range(len(getattr(m, part)))
                 for k2 in ("weight", "bias")]
                + [f"cross.{k2}.{i}" for i in range(2) for k2 in "VWb"]]
        for got, exp in zip(leaves, ws["leaves"]):
            np.testing.assert_allclose(got.detach().numpy(), exp.numpy(),
                                       **STATE_TOL)
        for got, exp in zip(sums, ws["dense_sums"]):
            np.testing.assert_allclose(got.numpy(), exp.numpy(), **STATE_TOL)
        for t in range(4):
            np.testing.assert_allclose(m.tables[t].detach().numpy(),
                                       ws["tables"][t].numpy(), **STATE_TOL)
            np.testing.assert_allclose(st.sparse[f"tables.{t}"].numpy(),
                                       ws["row_sums"][t].numpy(),
                                       **STATE_TOL)


def test_train_and_evaluate_take_the_bag_layout():
    cfg = small_config()
    m, _, _ = model_and_weights(cfg)
    batches = [bag_batch(k, repeat=False) for k in range(4)]
    tcfg = pcfg.TrainConfig(learning_rate=0.01, optimizer="rwsadagrad",
                            print_freq=2)
    _, st, hist = train(m, cfg, tcfg, batches, test_batches=batches[:2],
                        log_fn=lambda *a: None)
    assert st.step == 4 and len(hist["loss"]) == 2
    assert 0.0 <= hist["eval"]["auc"] <= 1.0
    metrics = evaluate(m, cfg, batches[:2])
    assert metrics == hist["eval"]


def test_bag_weights_weigh_each_slot():
    cfg = small_config()
    m, w, tabs = model_and_weights(cfg)
    d, i, _ = as_torch(bag_batch(3))
    bw = torch.from_numpy(np.random.default_rng(4).uniform(
        0.2, 2.0, i.shape).astype(np.float32))
    got = m(d, i, bag_weights=bw)
    slots = ref.gather(tabs, i, BAGS) * bw[..., None]
    want = ref.forward(w, d, ref.pool(slots, BAGS), "dcn")
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **LOGIT_TOL)


def test_the_gather_takes_exactly_the_slots(monkeypatch):
    """B x sum L_t rows gathered, in one grouped call, for the train step,
    the eval step and the forward alike."""
    seen = []
    real = pemb.gather_rows_grouped

    def counting(tables, idx):
        seen.append((len(tables), idx.numel()))
        return real(tables, idx)

    monkeypatch.setattr(pemb, "gather_rows_grouped", counting)
    cfg = small_config()
    m, _, _ = model_and_weights(cfg)
    batch = bag_batch(5)
    tcfg = pcfg.TrainConfig(optimizer="rwsadagrad")
    make_train_step(cfg, tcfg)(m, init_opt_state(m, tcfg), *batch)
    evaluate(m, cfg, [batch])
    assert seen == [(sum(BAGS), B * sum(BAGS))] * 2


def test_a_repeated_id_pools_twice_and_moves_its_state_once():
    """Bag [r, r] of table 1 pools row r twice; the row's entries from both
    slots, and from other samples' bags, sum into one gradient before its
    one state update: the state after a step is mean(G^2) of that sum."""
    cfg = small_config(multi_hot_sizes=(1, 2, 1, 1))
    m, _, _ = model_and_weights(cfg)
    r = np.random.default_rng(9)
    ids = np.stack([r.integers(0, 50, 8), np.full(8, 5), np.full(8, 5),
                    r.integers(0, 30, 8), r.integers(0, 20, 8)],
                   axis=1).astype(np.int32)
    dense = r.random((8, 5), dtype=np.float32)
    y = r.integers(0, 2, 8).astype(np.float32)
    pooled = pemb.sparse_arch_lookup(m.entries(), torch.from_numpy(ids), cfg)
    np.testing.assert_array_equal(pooled[:, 1].numpy(),
                                  (2 * m.tables[1][5]).expand(8, -1)
                                  .detach().numpy())
    # the row's gradient: every slot of every bag that reads it, summed
    rows = pemb.sparse_arch_lookup(m.entries(), torch.from_numpy(ids), cfg)
    rows = rows.detach().requires_grad_(True)
    loss = pdlrm.dlrm_loss(m(torch.from_numpy(dense), None, emb_rows=rows),
                           torch.from_numpy(y))
    G = 2 * torch.autograd.grad(loss, rows)[0][:, 1].sum(0)
    tcfg = pcfg.TrainConfig(learning_rate=0.05, optimizer="rwsadagrad")
    st = init_opt_state(m, tcfg)
    before = m.tables[1].detach().clone()
    make_train_step(cfg, tcfg)(m, st, dense, ids, y)
    state = st.sparse["tables.1"]
    np.testing.assert_allclose(float(state[5]), float((G * G).mean()),
                               rtol=1e-5)
    assert int((state != 0).sum()) == 1
    np.testing.assert_allclose(
        (before[5] - m.tables[1][5]).detach().numpy(),
        (0.05 * G / (torch.sqrt(state[5]) + 1e-10)).detach().numpy(),
        rtol=1e-5, atol=1e-8)


def test_an_id_outside_its_own_table_raises_and_names_it():
    cfg = small_config()
    m, _, _ = model_and_weights(cfg)
    _, ids, _ = bag_batch(6)
    # column 11 is table 3's (20 rows); 25 is inside table 2 (30 rows)
    bad = ids.copy()
    bad[17, 11] = 25
    with pytest.raises(ValueError, match=r"row id 25 of table 3 is outside "
                                         r"\[0, 20\)"):
        check_ids(bad, SIZES, BAGS)
    tcfg = pcfg.TrainConfig(optimizer="rwsadagrad")
    st = init_opt_state(m, tcfg)
    before = [t.detach().clone() for t in m.tables]
    d, _, y = bag_batch(6)
    with pytest.raises(ValueError, match="table 3"):
        make_train_step(cfg, tcfg)(m, st, d, bad, y)
    for a, b in zip(before, m.tables):
        assert torch.equal(a, b)
    bad[0, 0] = -1
    with pytest.raises(ValueError, match="row id -1 of table 0"):
        check_ids(bad, SIZES, BAGS)
    check_ids(ids, SIZES, BAGS)
    check_ids(ids.astype(np.int64), SIZES, BAGS)
    with pytest.raises(ValueError, match="13 ids a sample"):
        check_ids(ids[:, :12], SIZES, BAGS)
    with pytest.raises(ValueError, match="13 ids a sample"):
        make_train_step(cfg, tcfg)(m, st, d, ids[:, :12], y)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_the_unsigned_fold_holds_each_column_to_its_own_limit(dtype):
    """`_unsigned_in_range` with a limit a column: the largest id a column
    may hold passes, one more fails, in every column, for rows folded
    in runs (B past `_RUN` ids) and for a view that is not contiguous."""
    sizes = np.array([3, 50, 7, 1000])
    cols = np.repeat(np.arange(4), [2, 1, 3, 4])
    lim = sizes[cols]
    idx = np.zeros((700, cols.size), dtype)
    idx[-1] = lim - 1
    assert pemb._unsigned_in_range(idx, lim)
    assert pemb._unsigned_in_range(np.asfortranarray(idx), lim)
    for c in range(cols.size):
        bad = idx.copy()
        bad[350, c] = lim[c]
        assert not pemb._unsigned_in_range(bad, lim)
        assert not pemb._unsigned_in_range(np.asfortranarray(bad), lim)


def test_pooling_sums_each_tables_consecutive_slots():
    rows = torch.randn(5, sum(BAGS), 3, dtype=torch.float64,
                       requires_grad=True)
    got = pool_columns(rows, BAGS)
    want = torch.stack([rows[:, 0], rows[:, 1:4].sum(1), rows[:, 4:11].sum(1),
                        rows[:, 11:13].sum(1)], dim=1)
    assert torch.allclose(got, want)
    g = torch.randn_like(got)
    (gr,) = torch.autograd.grad(got, rows, g)
    assert torch.equal(gr, g[:, [0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 3, 3]])
    ones = torch.randn(5, 4, 3)
    assert pool_columns(ones, (1, 1, 1, 1)) is ones


def test_the_cross_networks_gradients_pass_gradcheck():
    """K8's plain version (`cross_layer_fwd_ref`, `cross_layer_bwd_ref`),
    through the whole network's Function, in float64."""
    g = torch.Generator().manual_seed(3)
    N, r, B_ = 6, 2, 5
    x0 = torch.randn(B_, N, generator=g, dtype=torch.float64,
                     requires_grad=True)
    params = []
    for _ in range(3):
        params += [torch.randn(r, N, generator=g, dtype=torch.float64),
                   torch.randn(N, r, generator=g, dtype=torch.float64),
                   torch.randn(N, generator=g, dtype=torch.float64)]
    params = [p.requires_grad_(True) for p in params]
    assert torch.autograd.gradcheck(
        lambda x, *ps: LowRankCross.apply(x, None, True, *ps),
        (x0, *params))


def test_the_cross_network_is_the_reference_and_its_compute_dtype_rule():
    """The Function against the plain composition of the reference, in
    float32; under bf16 compute, against the same composition with every
    product's operands cast as `_apply_mlp` casts them (the gradients
    rounded by autograd through the casts)."""
    g = torch.Generator().manual_seed(4)
    N, r = 12, 3
    x0 = torch.randn(7, N, generator=g)
    layers = [(torch.randn(r, N, generator=g), torch.randn(N, r, generator=g),
               torch.randn(N, generator=g)) for _ in range(2)]
    for cdt in (torch.float32, torch.bfloat16):
        def rd(t):
            return t.to(cdt).float()
        xs = x0.clone().requires_grad_(True)
        ps = [p.clone().requires_grad_(True) for layer in layers
              for p in layer]
        y = LowRankCross.apply(xs, cdt, True, *ps)
        gy = torch.randn(y.shape, generator=g)
        got = torch.autograd.grad(y, [xs, *ps], gy)
        xw = x0.clone().requires_grad_(True)
        pw = [p.clone().requires_grad_(True) for layer in layers
              for p in layer]
        z = xw
        for k in range(2):
            V, W, b = pw[3 * k:3 * k + 3]
            z = xw * (rd(rd(z) @ rd(V).t()) @ rd(W).t() + b) + z \
                if cdt == torch.bfloat16 else \
                xw * ((z @ V.t()) @ W.t() + b) + z
        want = torch.autograd.grad(z, [xw, *pw], gy)
        assert torch.allclose(y, z, rtol=1e-6, atol=1e-6)
        for a, b in zip(got, want):
            assert torch.allclose(a, b, rtol=1e-5, atol=1e-5), cdt


def test_k8_wrappers_take_the_plain_version_on_the_cpu_and_refuse_others():
    x = torch.randn(3, 8)
    b = torch.randn(8)
    y = cross_layer_fwd(x, x, b, x)
    assert torch.equal(y, x * (x + b) + x)
    acc = torch.zeros(3, 8)
    gu, gb, gx = cross_layer_bwd(x, x, x, b, acc, residual=True)
    assert gx is acc and torch.equal(gb, (x * x).sum(0))
    m = torch.empty(3, 8, device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        cross_layer_fwd(m, m, torch.empty(8, device="meta"), m)
    assert cross_layer_fwd.launches == 0 and cross_layer_bwd.launches == 0


def test_config_validates_the_cross_widths_and_the_bags():
    cfg = small_config()
    assert cfg.top_mlp_input_dim() == 5 * 8 and cfg.mlp_top == (40, 16, 1)
    assert cfg.bag_columns() == (0, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 3, 3)
    for kw, msg in (({"dcn_num_layers": 0}, "at least one layer"),
                    ({"dcn_low_rank_dim": 0}, "rank at least 1"),
                    ({"multi_hot_sizes": (1, 2, 3)}, "each of the 4"),
                    ({"multi_hot_sizes": (1, 0, 1, 1)}, "at least 1"),
                    ({"weighted_pooling": "learned"}, "plain tables")):
        with pytest.raises(ValueError, match=msg):
            small_config(**kw)
    with pytest.raises(ValueError, match="top MLP input dim"):
        pcfg.DLRMConfig(embedding_dim=8, table_sizes=SIZES,
                        mlp_bot=(5, 16, 8), mlp_top=(36, 1),
                        interaction_op="dcn").validate()
    assert pcfg.from_json(pcfg.DLRMConfig, pcfg.to_json(cfg)) == cfg


def test_the_mlperf_preset_has_the_recipes_widths():
    cfg = pcfg.mlperf_dcnv2_config()
    assert cfg.embedding_dim == 128 and cfg.mlp_bot == (13, 512, 256, 128)
    assert cfg.mlp_top == (3456, 1024, 1024, 512, 256, 1)
    assert (cfg.interaction_op, cfg.dcn_num_layers,
            cfg.dcn_low_rank_dim) == ("dcn", 3, 512)
    assert sum(cfg.multi_hot_sizes) == 214
    assert sum(cfg.table_sizes) == 204_184_588
    held = [s // 4 if s == 40_000_000 else s for s in cfg.table_sizes]
    chip = pcfg.mlperf_dcnv2_config(table_sizes=held)
    assert sum(chip.table_sizes) == 54_184_588
    # the cross layers are 66% of a sample's multiply-adds
    N, r = 3456, 512
    mlp = sum(m * n for w in (cfg.mlp_bot, cfg.mlp_top)
              for m, n in zip(w[:-1], w[1:]))
    assert round(3 * 2 * N * r / (mlp + 3 * 2 * N * r), 2) == 0.66


def test_one_hot_and_padded_bags_keep_their_path():
    """A config without `multi_hot_sizes` takes [B, T] and [B, T, L] ids
    as before, and a [B, T] batch under bags of one id each is the same
    lookup."""
    base = pcfg.make_dlrm_config(8, SIZES, (16,), (16,), num_dense=5)
    ones = pcfg.make_dlrm_config(8, SIZES, (16,), (16,), num_dense=5,
                                 multi_hot_sizes=(1, 1, 1, 1))
    m = pdlrm.DLRM(base, device="cpu", seed=2)
    r = np.random.default_rng(2)
    idx = torch.from_numpy(np.stack([r.integers(0, n, 9) for n in SIZES], 1)
                           .astype(np.int32))
    a = pemb.sparse_arch_lookup(m.entries(), idx, base)
    b = pemb.sparse_arch_lookup(m.entries(), idx, ones)
    assert torch.equal(a, b)
    bags = idx[:, :, None].expand(-1, -1, 2)
    c = pemb.sparse_arch_lookup(m.entries(), bags, base)
    assert torch.equal(c, 2 * a)


@pytest.mark.parametrize("path", ["evbench/reference/dcnv2.py",
                                  "evbench/reference/dlrm.py"])
def test_the_references_import_nothing_of_the_program_or_jax(path):
    import ast
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "typing", "torch", "evbench"}, names


def test_cached_training_refuses_bags_of_a_length_per_table():
    """The trainable cache's steps take one id a table: a config with
    `multi_hot_sizes` raises before anything is built."""
    from evstore_tpu_torch.cache.trainable import TrainableDeviceCache
    cfg = small_config()
    tables = [np.zeros((n, 8), np.float32) for n in SIZES]
    with pytest.raises(ValueError, match="bags of a length per table"):
        TrainableDeviceCache(cfg, pcfg.TrainConfig(optimizer="rwsadagrad"),
                             pcfg.CacheConfig(total_size=16), tables,
                             device="cpu")


def test_k8s_c_entry_points_take_pointers_and_a_64_bit_batch():
    """ctypes passes a pointer declared c_int as 32 bits, cutting it: every
    pointer of K8's two entry points is c_void_p, B is c_int64."""
    import ctypes
    from evstore_tpu_torch import _build
    P, I64, I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    assert _build.SIGNATURES["dcn_cross_fwd"] == (P,) * 5 + (I64,) + \
        (I,) * 3 + (P,)
    assert _build.SIGNATURES["dcn_cross_bwd"] == (P,) * 8 + (I64,) + \
        (I,) * 5 + (P,)
