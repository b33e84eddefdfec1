"""The port's dot interaction and its VJP (plain versions, kernel wrappers
and the autograd Function) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs the Pallas kernels `dot_interaction_blocked` and
`_blocked_bwd_impl` in interpret mode, the XLA `dot_interaction` and
`jax.vjp` of it.  On CPU tensors the port's kernel wrappers take their plain
versions; the CUDA kernels themselves are held to those plain versions on
the card by chip_smoke.py.  The VJP is held to `jax.vjp` of the XLA form for
both values of self_interaction, and to the Pallas backward only without
it: the Pallas backward carries a diagonal pair's cotangent once, half the
true gradient of f_i . f_i.

Tolerances: float32 |got - ref| <= 1e-5 * (1 + |ref|), the tolerance
chip_smoke.py holds the CUDA kernel to: the summation order differs, and
a result near zero that cancels 36 unit-size products carries an absolute
error of a few 1e-6 (1.8e-6 measured against XLA on the CPU);
bfloat16 one bf16 ulp of the reference plus the same 1e-5 float32
allowance (the f32 gram is rounded to bf16 once, and a different summation
order can move it across a rounding boundary; on a result that cancels to
~5e-5 the f32 summation error alone is 2 bf16 ulps there).  The VJP uses
the same two rules against the Pallas backward and against a float64 numpy
VJP of the bf16-rounded inputs, since the port rounds once, at the end.

The per-sample Gram op (`DotInteractionGram`, the port of
`dot_interaction_pallas`) is held to the Pallas kernel in interpret mode,
forward and backward, by the same two rules: its backward is the plain
VJP, as the reference's is plain XLA, and both compute the true VJP, so
they agree with self-interaction too.
Against `jax.vjp` in bf16 it is held to 2^-6 of the sum of the absolute
terms, plus that rule: XLA's bf16 VJP rounds each of up to four partial
results (the x row, both operands of the ly gram, the passthrough sum) to
bf16, each within half an ulp of the largest term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu.ops import interaction as jax_inter
from evstore_tpu.ops.pallas_interaction import (_blocked_bwd_impl,
                                                _row_selectors,
                                                dot_interaction_blocked,
                                                dot_interaction_pallas)
from evstore_tpu_torch.ops import interaction as port_inter
from evstore_tpu_torch.ops import cuda_interaction as ci
from evstore_tpu_torch.ops.cuda_interaction import (
    DotInteraction, DotInteractionGram, dot_interaction_bwd_kernel,
    dot_interaction_bwd_ref, dot_interaction_gram_kernel,
    dot_interaction_kernel, dot_interaction_ref, gram_geometry,
    gram_pair_table, interaction_geometry)

JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(B, T, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    ly = rng.normal(size=(B, T, D)).astype(np.float32)
    jx, jly = (jnp.asarray(a, JAX_DT[dtype]) for a in (x, ly))
    tx, tly = (torch.from_numpy(a).to(TORCH_DT[dtype]) for a in (x, ly))
    return jx, jly, tx, tly


def _assert_close(got: torch.Tensor, ref, dtype):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    else:
        mag = np.maximum(np.abs(ref), np.float32(2.0 ** -126))
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
        excess = np.abs(got - ref) - (ulp + 1e-5)
        assert np.all(excess <= 0), float(np.max(excess))


@pytest.mark.parametrize("T,D", [(3, 4), (26, 36)])
@pytest.mark.parametrize("self_interaction", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_interaction_matches_jax(T, D, self_interaction, dtype):
    """B a multiple of the JAX tile: against both the Pallas kernel
    (interpret mode) and the XLA form."""
    jx, jly, tx, tly = _inputs(32, T, D, dtype)
    ref_pallas = dot_interaction_blocked(jx, jly, self_interaction, 16, 4,
                                         True)
    ref_xla = jax_inter.dot_interaction(jx, jly, self_interaction)
    for got in (port_inter.dot_interaction(tx, tly, self_interaction),
                dot_interaction_kernel(tx, tly, self_interaction)):
        assert got.dtype == TORCH_DT[dtype]
        _assert_close(got, ref_pallas, dtype)
        _assert_close(got, ref_xla, dtype)


@pytest.mark.parametrize("B", [1, 13])
@pytest.mark.parametrize("self_interaction", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_interaction_ragged_batch_matches_xla(B, self_interaction, dtype):
    """A batch the TPU kernel does not take: against the XLA form only."""
    jx, jly, tx, tly = _inputs(B, 26, 36, dtype, seed=B)
    ref = jax_inter.dot_interaction(jx, jly, self_interaction)
    _assert_close(dot_interaction_kernel(tx, tly, self_interaction), ref,
                  dtype)


def test_cat_interaction_matches_jax():
    jx, jly, tx, tly = _inputs(5, 3, 4, "float32")
    np.testing.assert_array_equal(
        port_inter.cat_interaction(tx, tly).numpy(),
        np.asarray(jax_inter.cat_interaction(jx, jly)))


@pytest.mark.parametrize("F", [2, 4, 27])
@pytest.mark.parametrize("self_interaction", [False, True])
def test_tril_order_matches_jax(F, self_interaction):
    li, lj = port_inter._tril_indices(F, self_interaction)
    ji, jj = jax_inter._tril_indices(F, self_interaction)
    np.testing.assert_array_equal(li, ji)
    np.testing.assert_array_equal(lj, jj)
    assert port_inter.num_pairs(F, self_interaction) == len(ji)


def test_plain_version_is_the_reference():
    assert dot_interaction_ref is port_inter.dot_interaction
    assert dot_interaction_bwd_ref is port_inter.dot_interaction_bwd


@pytest.mark.parametrize("F,D,expected", [(27, 36, 8), (27, 64, 4),
                                          (27, 128, 2), (4, 4, 8)])
def test_samples_per_block_fits_shared_memory(F, D, expected):
    """K1 at a large batch: groups of up to 8 samples whose two-stage ring
    of the x span and the samples' ly regions, and output span, fit
    SMEM_TARGET (three blocks an SM); one more sample would not."""
    geo = interaction_geometry(65536, F, D)
    assert geo.samples_per_group == expected and geo.stage_out
    assert geo.smem_bytes <= ci.SMEM_TARGET
    span = (lambda n: (n + 15) // 16 * 16 + 16)
    W = D + port_inter.num_pairs(F, False)
    sample = span((F - 1) * D * 4)
    sample += 0 if sample // 16 % 2 else 16     # an odd number of units
    assert geo.smem_bytes == 2 * (span(expected * D * 4) + expected * sample) \
        + span(expected * W * 4)
    if expected < ci.MAX_SAMPLES_PER_GROUP:
        assert ci.smem_bytes(expected + 1, F, D, 4, False, False) \
            > ci.SMEM_TARGET
    assert geo.blocks == 132 * min(2048 // ci.THREADS, ci.SMEM_PER_SM
                                   // (geo.smem_bytes + 1024))


@pytest.mark.parametrize("F,D,expected", [(27, 36, 5), (27, 64, 3),
                                          (27, 128, 2), (4, 4, 8)])
def test_backward_samples_per_block_fits_shared_memory(F, D, expected):
    """K4 at a large batch stages the x, ly and cotangent spans twice, and
    each sample's f32 S at a row stride of F rounded up to 4 once."""
    geo = interaction_geometry(65536, F, D, backward=True)
    assert geo.samples_per_group == expected
    assert geo.smem_bytes <= ci.SMEM_TARGET
    span = (lambda n: (n + 15) // 16 * 16 + 16)
    W = D + port_inter.num_pairs(F, False)
    x, ly = span(expected * D * 4), span(expected * (F - 1) * D * 4)
    Fp = (F + 3) // 4 * 4
    assert geo.smem_bytes == 2 * (x + ly + span(expected * W * 4)) \
        + expected * F * Fp * 4
    if expected < ci.MAX_SAMPLES_PER_GROUP:
        assert ci.smem_bytes(expected + 1, F, D, 4, False, True) \
            > ci.SMEM_TARGET


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B,spg,blocks", [(1, 1, 1), (3, 1, 3),
                                          (127, 1, 127), (128, 1, 128),
                                          (129, 1, 129), (2048, None, None),
                                          (2049, None, None),
                                          (65536, None, 396)])
def test_geometry_gives_every_sm_work(B, spg, blocks, backward):
    """At the train batch (128) a group is one sample and every sample has
    a block; at the serve batch (2048) the groups still outnumber the SMs;
    at 65,536 the grid is three blocks on each of the 132 SMs.  The groups
    cover the batch exactly, the last one ragged where B asks for it."""
    geo = interaction_geometry(B, 27, 36, 4, False, backward)
    s = geo.samples_per_group
    if spg is not None:
        assert s == spg
    if blocks is not None:
        assert geo.blocks == blocks
    assert geo.groups == -(-B // s) and (geo.groups - 1) * s < B
    assert geo.blocks <= geo.groups
    assert geo.blocks >= min(geo.groups, 132)
    if B >= 2048:
        assert geo.groups >= 132


@pytest.mark.parametrize("D", [1, 4, 7, 36, 128])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("backward", [False, True])
def test_every_accepted_shape_fits_one_block(D, itemsize, backward):
    """The widest F the wrappers take at each D (the rule they keep from
    the first design) fits one block, at B=1 and at B=65,536; the forward
    stores pairs straight to global memory when its output row would not
    fit."""
    F = 2
    while ci._sample_bytes(F + 1, D, backward) <= ci._SMEM_BYTES:
        F += 1
    for si in (False, True):
        for B in (1, 65536):
            geo = interaction_geometry(B, F, D, itemsize, si, backward)
            assert geo.smem_bytes <= ci.SMEM_MAX
            assert geo.samples_per_group >= 1
            if backward:
                assert geo.stage_out


@pytest.mark.parametrize("F", [2, 3, 4, 5, 27, 28, 33])
@pytest.mark.parametrize("self_interaction", [False, True])
def test_forward_tiles_cover_each_pair_once(F, self_interaction):
    """K1's tile plan: tiles t = 0.. of the lower triangle of the
    ceil(F/4)-square tile grid; a tile's pair (i, j) is stored when i < F
    and j < i (j <= i with self_interaction), at its tril column.  Every
    pair of np.tril_indices is stored exactly once, at its own column."""
    nti = -(-F // ci.TILE)
    li, lj = port_inter._tril_indices(F, self_interaction)
    seen = np.zeros(len(li), np.int64)
    for t in range(nti * (nti + 1) // 2):
        ti, tj = ci.tile_of(t)
        assert 0 <= tj <= ti < nti
        assert t == ti * (ti + 1) // 2 + tj
        for a in range(ci.TILE):
            for c in range(ci.TILE):
                i, j = ti * ci.TILE + a, tj * ci.TILE + c
                if i < F and (j < i or (self_interaction and j == i)):
                    col = ci.pair_column(i, j, self_interaction)
                    assert (li[col], lj[col]) == (i, j)
                    seen[col] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("F", [2, 4, 27])
@pytest.mark.parametrize("self_interaction", [False, True])
def test_backward_cotangent_lookup_is_sym_select(F, self_interaction):
    """K4's S[f, j] lookup is the Pallas backward's symmetric selector
    `_sym_select`, with the diagonal doubled (the true VJP)."""
    from evstore_tpu.ops.pallas_interaction import _sym_select
    sel = _sym_select(F, self_interaction)            # [P, F*F]
    for f in range(F):
        for j in range(F):
            p, scale = ci.cotangent_index(f, j, self_interaction)
            col = sel[:, f * F + j]
            if scale == 0.0:
                assert p == -1 and not col.any()
                continue
            assert np.flatnonzero(col).tolist() == [p]
            assert scale == (2.0 if f == j else 1.0)


def _emulate_fwd(x, ly, self_interaction):
    """K1's work split in numpy: groups of the geometry's samples, items
    w = tile * samples + sample, clamped tile rows, pairs stored at their
    column; each pair one f32 sum in d order."""
    B, D = x.shape
    T = ly.shape[1]
    F = T + 1
    P = port_inter.num_pairs(F, self_interaction)
    geo = interaction_geometry(B, F, D, 4, self_interaction, False)
    feats = np.concatenate([x[:, None], ly], axis=1).astype(np.float32)
    out = np.full((B, D + P), np.nan, np.float32)
    nti = -(-F // ci.TILE)
    for g in range(geo.groups):
        b0 = g * geo.samples_per_group
        ns = min(B, b0 + geo.samples_per_group) - b0
        out[b0:b0 + ns, :D] = x[b0:b0 + ns]
        for w in range(ns * nti * (nti + 1) // 2):
            t, b = divmod(w, ns)
            b += b0
            ti, tj = ci.tile_of(t)
            rows = [min(ti * ci.TILE + a, F - 1) for a in range(4)]
            cols = [min(tj * ci.TILE + c, F - 1) for c in range(4)]
            acc = np.zeros((4, 4), np.float32)
            for d in range(D):
                acc += np.outer(feats[b, rows, d], feats[b, cols, d])
            for a in range(4):
                for c in range(4):
                    i, j = ti * 4 + a, tj * 4 + c
                    if i < F and (j < i or (self_interaction
                                            and j == i)):
                        out[b, D + ci.pair_column(
                            i, j, self_interaction)] = acc[a, c]
    return out


def _emulate_bwd(x, ly, g, self_interaction):
    """K4's work split in numpy: S built through `cotangent_index`, then
    (sample, 6 rows f, 4 columns d) items with clamped rows, one sum over
    j = 0..F-1 each."""
    B, D = x.shape
    F = ly.shape[1] + 1
    feats = np.concatenate([x[:, None], ly], axis=1).astype(np.float32)
    dF = np.full((B, F, D), np.nan, np.float32)
    R = ci.ROWS_PER_THREAD
    for b in range(B):
        gp = g[b, D:]
        for ft in range(-(-F // R)):
            fs = [min(ft * R + a, F - 1) for a in range(R)]
            acc = np.zeros((R, D), np.float32)
            for j in range(F):
                s = np.zeros(R, np.float32)
                for a, f in enumerate(fs):
                    p, scale = ci.cotangent_index(f, j, self_interaction)
                    s[a] = scale * gp[p] if p >= 0 else 0.0
                acc += s[:, None] * feats[b, j][None, :]
            for a in range(R):
                if ft * R + a < F:
                    dF[b, ft * R + a] = acc[a]
    return g[:, :D] + dF[:, 0], dF[:, 1:]


@pytest.mark.parametrize("B,T,D", [(3, 26, 36), (2, 5, 4), (5, 4, 7)])
@pytest.mark.parametrize("self_interaction", [False, True])
def test_kernel_work_split_matches_plain(B, T, D, self_interaction):
    """The emulated K1 and K4 (their index arithmetic, not their bits)
    against the plain forward and VJP, with the forward's tolerance."""
    _, _, jg, tx, tly, tg = _bwd_inputs(B, T, D, "float32",
                                        self_interaction, seed=B + D)
    del jg
    x, ly, g = tx.numpy(), tly.numpy(), tg.numpy()
    np.testing.assert_allclose(
        _emulate_fwd(x, ly, self_interaction),
        dot_interaction_ref(tx, tly, self_interaction).numpy(),
        rtol=1e-5, atol=1e-5)
    for got, ref in zip(_emulate_bwd(x, ly, g, self_interaction),
                        dot_interaction_bwd_ref(tx, tly, tg,
                                                self_interaction)):
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5)


def test_kernel_wrapper_refuses_what_it_cannot_take():
    x = torch.zeros(4, 8, device="meta")
    ly = torch.zeros(4, 3, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        dot_interaction_kernel(x, ly)
    with pytest.raises(ValueError, match="CUDA device"):
        dot_interaction_kernel(torch.zeros(4, 8), ly)
    g = torch.zeros(4, 8 + 6, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        dot_interaction_bwd_kernel(x, ly, g)
    with pytest.raises(ValueError, match="CUDA device"):
        dot_interaction_bwd_kernel(torch.zeros(4, 8), torch.zeros(4, 3, 8),
                                   g)


def _bwd_inputs(B, T, D, dtype, self_interaction, seed=0):
    jx, jly, tx, tly = _inputs(B, T, D, dtype, seed)
    P = port_inter.num_pairs(T + 1, self_interaction)
    g = np.random.default_rng(seed + 100).normal(size=(B, D + P))
    jg = jnp.asarray(g.astype(np.float32), JAX_DT[dtype])
    tg = torch.from_numpy(g.astype(np.float32)).to(TORCH_DT[dtype])
    return jx, jly, jg, tx, tly, tg


def _port_vjps(tx, tly, tg, self_interaction):
    """(dx, dly) of the plain version, the kernel wrapper and the autograd
    Function on the port's side."""
    a = tx.clone().requires_grad_(True)
    b = tly.clone().requires_grad_(True)
    DotInteraction.apply(a, b, self_interaction).backward(tg)
    return [port_inter.dot_interaction_bwd(tx, tly, tg, self_interaction),
            dot_interaction_bwd_kernel(tx, tly, tg, self_interaction),
            (a.grad, b.grad)]


def _numpy_vjp(tx, tly, tg, self_interaction):
    """float64 VJP of the (rounded) inputs, and the sum of the absolute
    terms of each output."""
    x, ly, g = (t.double().numpy() for t in (tx, tly, tg))
    B, D = x.shape
    F = ly.shape[1] + 1
    feats = np.concatenate([x[:, None], ly], axis=1)
    li, lj = port_inter._tril_indices(F, self_interaction)
    dG = np.zeros((B, F, F))
    dG[:, li, lj] = g[:, D:]
    S = dG + dG.transpose(0, 2, 1)
    dF = S @ feats
    mag = np.abs(S) @ np.abs(feats)
    return ((g[:, :D] + dF[:, 0], dF[:, 1:]),
            (np.abs(g[:, :D]) + mag[:, 0], mag[:, 1:]))


@pytest.mark.parametrize("T,D", [(3, 4), (26, 36)])
@pytest.mark.parametrize("self_interaction", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_interaction_vjp_matches_xla(T, D, self_interaction, dtype):
    """The plain VJP, the kernel wrapper and the autograd Function against
    jax.vjp of the XLA dot_interaction (the true VJP, diagonal included)
    and against a float64 numpy VJP."""
    jx, jly, jg, tx, tly, tg = _bwd_inputs(16, T, D, dtype, self_interaction)
    _, vjp = jax.vjp(lambda a, b: jax_inter.dot_interaction(
        a, b, self_interaction), jx, jly)
    refs = vjp(jg)
    exact, terms = _numpy_vjp(tx, tly, tg, self_interaction)
    for got in _port_vjps(tx, tly, tg, self_interaction):
        for out, ref, ex, mag in zip(got, refs, exact, terms):
            assert out.dtype == TORCH_DT[dtype]
            _assert_close(out, ex.astype(np.float32), dtype)
            if dtype == "float32":
                _assert_close(out, ref, dtype)
            else:
                ref = np.asarray(jnp.asarray(ref, jnp.float32))
                mag_r = np.maximum(np.abs(ref), np.float32(2.0 ** -126))
                ulp = 2.0 ** (np.floor(np.log2(mag_r)) - 7)
                allow = 2.0 ** -6 * mag + ulp + 1e-5 * (1 + np.abs(ref))
                assert np.all(np.abs(out.float().numpy() - ref) <= allow)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dot_interaction_vjp_matches_pallas_backward(dtype):
    """Without self-interaction, against the Pallas backward kernel in
    interpret mode."""
    jx, jly, jg, tx, tly, tg = _bwd_inputs(32, 26, 36, dtype, False, seed=3)
    refs = _blocked_bwd_impl(jx, jly, jg, False, 16, 4, True)
    for got in _port_vjps(tx, tly, tg, False):
        for out, ref in zip(got, refs):
            _assert_close(out, ref, dtype)


def test_self_interaction_diagonal_counts_twice():
    """d(f . f)/df = 2 f: with only the diagonal pair of feature 0 carrying
    a cotangent, dx is the passthrough plus 2 g x."""
    x = torch.tensor([[1.0, 2.0]])
    ly = torch.tensor([[[3.0, 4.0]]])
    g = torch.zeros(1, 2 + 3)
    g[0, :2] = torch.tensor([0.5, -0.5])
    g[0, 2] = 1.5                     # pair 0 is (0, 0)
    dx, dly = dot_interaction_bwd_kernel(x, ly, g, True)
    np.testing.assert_allclose(dx.numpy(), [[0.5 + 3.0, -0.5 + 6.0]])
    np.testing.assert_allclose(dly.numpy(), [[[0.0, 0.0]]])


# ------------------------------------- the per-sample Gram op (K6's port)

@pytest.mark.parametrize("B,T,D", [(128, 26, 36), (10, 26, 36), (16, 3, 4)])
@pytest.mark.parametrize("self_interaction", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_op_matches_pallas_interaction(B, T, D, self_interaction,
                                            dtype):
    """The op and its kernel wrapper (the plain version on the CPU) against
    `dot_interaction_pallas` in interpret mode; B=10 is below the TPU's
    tile of 128, which the Pallas op then shrinks to."""
    jx, jly, tx, tly = _inputs(B, T, D, dtype, seed=B)
    ref = dot_interaction_pallas(jx, jly, self_interaction, 128, True)
    assert ref.dtype == JAX_DT[dtype]
    for got in (DotInteractionGram.apply(tx, tly, self_interaction),
                dot_interaction_gram_kernel(tx, tly, self_interaction)):
        assert got.dtype == TORCH_DT[dtype]
        _assert_close(got, ref, dtype)


@pytest.mark.parametrize("B", [128, 10])
@pytest.mark.parametrize("self_interaction", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_op_gradients_match_jax_grad(B, self_interaction, dtype):
    """jax.grad through `dot_interaction_pallas` (its XLA backward) against
    autograd through `DotInteractionGram`, for sum(out * g) with g from
    numpy: both backward passes get the same cotangent, in the op's
    dtype."""
    T, D = 26, 36
    jx, jly, tx, tly = _inputs(B, T, D, dtype, seed=B + 1)
    P = port_inter.num_pairs(T + 1, self_interaction)
    g = np.random.default_rng(B + 2).normal(size=(B, D + P)).astype(
        np.float32)
    refs = jax.grad(lambda a, b: jnp.sum(dot_interaction_pallas(
        a, b, self_interaction, 128, True).astype(jnp.float32)
        * jnp.asarray(g)), argnums=(0, 1))(jx, jly)
    a = tx.clone().requires_grad_(True)
    b = tly.clone().requires_grad_(True)
    (DotInteractionGram.apply(a, b, self_interaction).float()
     * torch.from_numpy(g)).sum().backward()
    for got, ref in zip((a.grad, b.grad), refs):
        assert got.dtype == TORCH_DT[dtype]
        _assert_close(got, ref, dtype)


@pytest.mark.parametrize("F", [2, 4, 27])
@pytest.mark.parametrize("self_interaction", [False, True])
def test_gram_pair_table_is_the_selectors(F, self_interaction):
    """Pair p reads the packed lower-triangle entry (li, lj) that the
    Pallas kernel's selector M[li][lj, p] picks."""
    sel = _row_selectors(F, self_interaction)
    tab = gram_pair_table(F, self_interaction)
    assert tab.dtype == np.int32 and len(tab) == sel.shape[2]
    li, lj = np.nonzero(sel.transpose(2, 0, 1))[1:]
    np.testing.assert_array_equal(tab, li * (li + 1) // 2 + lj)
    assert len(set(tab.tolist())) == len(tab)
    assert tab.max() < F * (F + 1) // 2


def _gram_smem(spg, F, D, itemsize, si):
    """K6's shared memory, from its C launcher's rule: two stages of the x
    span and of each sample's ly region (an odd number of 16-byte units),
    then each sample's packed f32 triangle at an odd stride and the int32
    pair table."""
    span = (lambda n: (n + 15) // 16 * 16 + 16)
    sample = span((F - 1) * D * itemsize)
    sample += 0 if sample // 16 % 2 else 16
    tri = F * (F + 1) // 2
    tri += 0 if tri % 2 else 1
    return 2 * (span(spg * D * itemsize) + spg * sample) + spg * tri * 4 \
        + 4 * port_inter.num_pairs(F, si)


@pytest.mark.parametrize("F,D,si,expected", [(27, 36, False, 8),
                                             (27, 36, True, 8),
                                             (27, 64, False, 4),
                                             (27, 128, False, 2),
                                             (4, 4, False, 8)])
def test_gram_samples_per_block_fits_shared_memory(F, D, si, expected):
    """K6 at a large batch: groups of up to 8 samples whose ring, packed
    triangles and pair table fit SMEM_TARGET (three blocks an SM), one more
    would not; self_interaction only lengthens the pair table."""
    geo = gram_geometry(65536, F, D, 4, si)
    assert geo.samples_per_group == expected and not geo.stage_out
    assert geo.smem_bytes == _gram_smem(expected, F, D, 4, si) \
        == ci.gram_smem_bytes(expected, F, D, 4, si) <= ci.SMEM_TARGET
    if expected < ci.MAX_SAMPLES_PER_GROUP:
        assert _gram_smem(expected + 1, F, D, 4, si) > ci.SMEM_TARGET
    assert geo.blocks == 132 * min(ci.GRAM_BLOCKS_PER_SM, ci.SMEM_PER_SM
                                   // (geo.smem_bytes + 1024))
    assert gram_pair_table(F, si).max() < ci.gram_stride(F)


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,spg,blocks", [(1, 1, 1), (3, 1, 3),
                                          (127, 1, 127), (128, 1, 128),
                                          (129, 1, 129), (2048, 8, 256),
                                          (2049, 8, 257),
                                          (65536, 8, 396)])
def test_gram_geometry_gives_every_sm_work(B, spg, blocks, itemsize):
    """K6 at the train batch has a block a sample (the first design had 16
    blocks of 8 at B=128); at the serve batch its groups outnumber the 132
    SMs; at 65,536 the grid is three blocks on each SM, at bf16 too (its
    registers hold no more).  The groups cover the batch exactly and the
    block stays within its shared memory."""
    geo = gram_geometry(B, 27, 36, itemsize)
    assert (geo.samples_per_group, geo.blocks) == (spg, blocks)
    assert geo.groups == -(-B // spg) and (geo.groups - 1) * spg < B
    assert geo.smem_bytes == _gram_smem(spg, 27, 36, itemsize, False) \
        <= ci.SMEM_TARGET
    assert geo.blocks >= min(geo.groups, 132)


def _first_gram_takes(F, D, si):
    """The shapes the first design of K6 took: one sample's features (odd
    stride), its packed triangle and the pair table within 48 KB."""
    dp = D + 1 if D % 2 == 0 else D
    P = port_inter.num_pairs(F, si)
    return 4 * (P + F * dp + F * (F + 1) // 2) <= 48 * 1024


@pytest.mark.parametrize("D", [1, 4, 7, 36, 128])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_gram_takes_every_shape_it_took(D, itemsize):
    """Every shape the first design took still fits one block, at B=1 and
    at B=65,536; the wrapper refuses only a shape whose one sample's ring
    and triangle exceed SMEM_MAX (K1's unstaged case, F=600 at D=4)."""
    for si in (False, True):
        widest = max(F for F in range(2, 400) if _first_gram_takes(F, D, si))
        for F in (2, 3, 27, widest):
            for B in (1, 65536):
                geo = gram_geometry(B, F, D, itemsize, si)
                assert geo is not None and geo.samples_per_group >= 1
                assert geo.smem_bytes <= ci.SMEM_MAX
        assert gram_geometry(130, 600, 4, itemsize, si) is None
        assert ci.gram_smem_bytes(1, 600, 4, itemsize, si) > ci.SMEM_MAX


@pytest.mark.parametrize("F", [2, 3, 4, 5, 27, 28, 33])
def test_gram_tiles_cover_the_triangle_once(F):
    """K6's stage 1: the tiles of the ceil(F/4)-square tile grid's lower
    triangle store their entries (i, j) with i < F and j <= i at
    i (i + 1) / 2 + j; every entry of the packed triangle is stored exactly
    once, and the pair table reads only stored entries."""
    nti = -(-F // ci.TILE)
    seen = np.zeros(F * (F + 1) // 2, np.int64)
    for t in range(nti * (nti + 1) // 2):
        ti, tj = ci.tile_of(t)
        for a in range(ci.TILE):
            for c in range(ci.TILE):
                i, j = ti * ci.TILE + a, tj * ci.TILE + c
                if i < F and j <= i:
                    seen[i * (i + 1) // 2 + j] += 1
    assert np.all(seen == 1)
    for si in (False, True):
        assert np.all(seen[gram_pair_table(F, si)] == 1)


def _split_span(phase, n, itemsize):
    """common.cuh's split_span: (head, units, first tail element) of n
    elements whose first lies `phase` bytes past a 16-byte boundary."""
    head = min(n, ((16 - phase) % 16) // itemsize)
    units = (n - head) * itemsize // 16
    return head, units, head + units * 16 // itemsize


def _emulate_gram(x, ly, self_interaction, itemsize=4):
    """K6's work split in numpy: groups of `gram_geometry`'s samples; stage
    1 fills each sample's packed triangle (stride `gram_stride`) tile by
    tile, items w = tile * samples + sample, rows clamped; stage 2 writes
    the group's output span as 16-byte units (one division a unit finds the
    sample) after an element-wise head, and an element-wise tail, each value
    from x or from the triangle through the pair table.  The output starts
    16-byte aligned, so group g's span starts at g spg W itemsize."""
    B, D = x.shape
    F = ly.shape[1] + 1
    P = port_inter.num_pairs(F, self_interaction)
    W = D + P
    geo = gram_geometry(B, F, D, itemsize, self_interaction)
    spg, gs = geo.samples_per_group, ci.gram_stride(F)
    tab = gram_pair_table(F, self_interaction)
    feats = np.concatenate([x[:, None], ly], axis=1).astype(np.float32)
    out = np.full(B * W, np.nan, np.float32)
    written = np.zeros(B * W, np.int64)
    nti = -(-F // ci.TILE)
    for g in range(geo.groups):
        b0 = g * spg
        ns = min(B, b0 + spg) - b0
        gram = np.full(spg * gs, np.nan, np.float32)
        for w in range(ns * nti * (nti + 1) // 2):
            t, q = divmod(w, ns)
            ti, tj = ci.tile_of(t)
            rows = [min(ti * ci.TILE + a, F - 1) for a in range(4)]
            cols = [min(tj * ci.TILE + c, F - 1) for c in range(4)]
            acc = np.zeros((4, 4), np.float32)
            for d in range(D):
                acc += np.outer(feats[b0 + q, rows, d],
                                feats[b0 + q, cols, d])
            for a in range(4):
                for c in range(4):
                    i, j = ti * 4 + a, tj * 4 + c
                    if i < F and j <= i:
                        gram[q * gs + i * (i + 1) // 2 + j] = acc[a, c]

        def fill(e0, cnt):
            q, c = divmod(e0, W)
            vals = []
            for _ in range(cnt):
                vals.append(x[b0 + q, c] if c < D
                            else gram[q * gs + tab[c - D]])
                c += 1
                if c == W:
                    q, c = q + 1, 0
            return vals

        n, U = ns * W, 16 // itemsize
        head, units, tail0 = _split_span(b0 * W * itemsize % 16, n, itemsize)
        pieces = [(e, 1) for e in range(head)]
        pieces += [(head + u * U, U) for u in range(units)]
        pieces += [(e, 1) for e in range(tail0, n)]
        for e0, cnt in pieces:
            out[b0 * W + e0: b0 * W + e0 + cnt] = fill(e0, cnt)
            written[b0 * W + e0: b0 * W + e0 + cnt] += 1
    assert np.all(written == 1)
    return out.reshape(B, W)


@pytest.mark.parametrize("B,T,D", [(3, 26, 36), (2, 5, 4), (5, 4, 7),
                                   (17, 3, 4)])
@pytest.mark.parametrize("self_interaction", [False, True])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_gram_work_split_matches_plain_and_k1(B, T, D, self_interaction,
                                              itemsize):
    """The emulated K6 writes every output element once, equals the plain
    forward within its tolerance and the emulated K1 bit for bit (the same
    sums in the same order).  itemsize 2 moves the 16-byte units and the
    spans' phases as bf16 does."""
    _, _, tx, tly = _inputs(B, T, D, "float32", seed=B + T)
    x, ly = tx.numpy(), tly.numpy()
    got = _emulate_gram(x, ly, self_interaction, itemsize)
    np.testing.assert_allclose(
        got, dot_interaction_ref(tx, tly, self_interaction).numpy(),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, _emulate_fwd(x, ly,
                                                    self_interaction))


def test_gram_wrapper_refuses_what_it_cannot_take():
    x = torch.zeros(4, 8, device="meta")
    ly = torch.zeros(4, 3, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        dot_interaction_gram_kernel(x, ly)
    with pytest.raises(ValueError, match="CUDA device"):
        dot_interaction_gram_kernel(torch.zeros(4, 8), ly)
