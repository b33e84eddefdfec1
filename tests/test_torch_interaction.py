"""The port's dot interaction (plain version and kernel wrapper) against the
JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs the Pallas kernel `dot_interaction_blocked` in interpret mode
and the XLA `dot_interaction`.  On CPU tensors the port's kernel wrapper
takes its plain version; the CUDA kernel itself is held to that plain
version on the card by chip_smoke.py.

Tolerances: float32 |got - ref| <= 1e-5 * (1 + |ref|), the tolerance
chip_smoke.py holds the CUDA kernel to: the summation order differs, and
a result near zero that cancels 36 unit-size products carries an absolute
error of a few 1e-6 (1.8e-6 measured against XLA on the CPU);
bfloat16 one bf16 ulp of the reference plus the same 1e-5 float32
allowance (the f32 gram is rounded to bf16 once, and a different summation
order can move it across a rounding boundary; on a result that cancels to
~5e-5 the f32 summation error alone is 2 bf16 ulps there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu.ops import interaction as jax_inter
from evstore_tpu.ops.pallas_interaction import dot_interaction_blocked
from evstore_tpu_torch.ops import interaction as port_inter
from evstore_tpu_torch.ops.cuda_interaction import (dot_interaction_kernel,
                                                    dot_interaction_ref,
                                                    samples_per_block)

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


@pytest.mark.parametrize("F,D,expected", [(27, 36, 8), (27, 64, 7),
                                          (27, 128, 3), (4, 4, 8)])
def test_samples_per_block_fits_shared_memory(F, D, expected):
    spb = samples_per_block(F, D)
    assert spb == expected
    padded = D + 1 if D % 2 == 0 else D
    assert spb * F * padded * 4 <= 48 * 1024


def test_kernel_wrapper_refuses_what_it_cannot_take():
    x = torch.zeros(4, 8, device="meta")
    ly = torch.zeros(4, 3, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        dot_interaction_kernel(x, ly)
    with pytest.raises(ValueError, match="CUDA device"):
        dot_interaction_kernel(torch.zeros(4, 8), ly)
