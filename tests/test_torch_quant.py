"""The port's embedding codecs (`evstore_tpu_torch/ops/quant.py`) against
the JAX package's, on the CPU.

Inputs are made with numpy from a seed, plus the codecs' edge values
(0, ±0.65, the 4-bit brackets, ±1), and handed to both packages.

Tolerances: codes equal exactly, from the torch and numpy encoders alike.
Decodes over every code equal the JAX package's numpy twins and its eager
jnp codecs bit for bit: both compute one IEEE operation at a time.  Against
the jitted jnp decoders they are held to one float32 ulp of
max(|ref|, 1.3): XLA contracts `(v / 65000) * 1.3 - 0.65` and
`(v / 254) * 2 - 1` into an FMA, which skips the rounding of the product
(up to 1.3 in the 16-bit dense range), and it computes the outliers'
`(v - 65000) / 100` otherwise than by a division; 1 ulp of that size is the
largest gap measured on every code.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evstore_tpu.ops import quant as jq
from evstore_tpu_torch.ops import quant as pq

EDGES = np.array([0.0, -0.0, 0.65, -0.65, 0.6500001, -0.6500001, 1.0, -1.0,
                  0.8, 0.6, 0.4, 0.25, 0.015, 0.00025, -0.00025, -0.015,
                  -0.25, -0.4, -0.6, -0.8, 1e-7, -1e-7, 0.99, -0.99],
                 np.float32)
ALL_CODES = {16: np.arange(65536, dtype=np.uint16),
             8: np.arange(256, dtype=np.uint8),
             4: np.arange(15, dtype=np.uint8)}


def _values(seed=0, n=4000):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-1, 1, n).astype(np.float32),
                           EDGES]).reshape(-1, 4)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_codes_match_jax(bits):
    x = _values(bits)
    want = np.asarray(jq.quantize(jnp.asarray(x), bits))
    np_want = {16: jq.np_quantize_ushort, 8: jq.np_quantize_int8,
               4: jq.np_quantize_int4}[bits](x)
    got = pq.quantize(torch.from_numpy(x), bits).numpy()
    np_got = {16: pq.np_quantize_ushort, 8: pq.np_quantize_int8,
              4: pq.np_quantize_int4}[bits](x)
    np.testing.assert_array_equal(np_want, want)
    for g in (got, np_got):
        assert g.dtype == want.dtype
        np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_decodes_match_jax_eager_and_numpy(bits):
    """Every code, bit for bit: the port's torch and numpy decoders against
    the JAX package's numpy twin and its eager jnp decoder."""
    codes = ALL_CODES[bits]
    np_want = {16: jq.np_dequantize_ushort, 8: jq.np_dequantize_int8,
               4: jq.np_dequantize_int4}[bits](codes)
    eager = {16: jq.dequantize_ushort, 8: jq.dequantize_int8,
             4: jq.dequantize_int4}[bits]
    with jax.disable_jit():
        eager_want = np.asarray(eager(jnp.asarray(codes)))
    got = pq.dequantize(torch.from_numpy(codes), bits).numpy()
    np_got = {16: pq.np_dequantize_ushort, 8: pq.np_dequantize_int8,
              4: pq.np_dequantize_int4}[bits](codes)
    np.testing.assert_array_equal(_bits(eager_want), _bits(np_want))
    for g in (got, np_got):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(_bits(g), _bits(np_want))


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_decodes_within_one_ulp_of_jitted_jax(bits):
    codes = ALL_CODES[bits]
    jitted = np.asarray(jax.jit(lambda v: jq.dequantize(v, bits))(
        jnp.asarray(codes)))
    got = pq.dequantize(torch.from_numpy(codes), bits).numpy()
    ulp = np.spacing(np.maximum(np.abs(jitted), np.float32(1.3)))
    assert np.all(np.abs(got - jitted) <= ulp)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_round_trip_error_matches_jax(bits):
    """decode(encode(x)) equals the JAX package's round trip bit for bit
    (numpy twins on both sides, the host tiers' path)."""
    x = _values(10 + bits)
    enc_j = {16: jq.np_quantize_ushort, 8: jq.np_quantize_int8,
             4: jq.np_quantize_int4}[bits]
    dec_j = {16: jq.np_dequantize_ushort, 8: jq.np_dequantize_int8,
             4: jq.np_dequantize_int4}[bits]
    enc_p = {16: pq.np_quantize_ushort, 8: pq.np_quantize_int8,
             4: pq.np_quantize_int4}[bits]
    dec_p = {16: pq.np_dequantize_ushort, 8: pq.np_dequantize_int8,
             4: pq.np_dequantize_int4}[bits]
    np.testing.assert_array_equal(_bits(dec_p(enc_p(x))),
                                  _bits(dec_j(enc_j(x))))


def test_dispatch():
    x = torch.from_numpy(_values(3))
    assert pq.quantize(x, 32).dtype == torch.float32
    assert torch.equal(pq.dequantize(pq.quantize(x, 32), 32), x)
    assert pq.quantize(x, 16).dtype == torch.uint16
    assert pq.quantize(x, 8).dtype == torch.uint8
    assert pq.quantize(x, 4).dtype == torch.uint8
    assert int(pq.quantize(x, 4).max()) <= 14
    assert float(pq.dequantize(pq.quantize(torch.zeros(3), 4), 4).abs()
                 .max()) == 0.0
    for bad in (12, 2):
        with pytest.raises(ValueError, match="unsupported precision"):
            pq.quantize(x, bad)
        with pytest.raises(ValueError, match="unsupported precision"):
            pq.dequantize(x, bad)
