"""Parity of the port's int8 quantizers with the JAX package's.

The same float32 inputs and the same noise (the JAX package's own uniforms) go
through ``dgll_tpu.ops.quantize`` and ``dgll_tpu_torch.ops.quantize``. Tolerance:
none. The int8 values are equal and the scales bit-equal, for ``quantize_int8`` in
both modes and for ``quantize_int8_pallas`` in interpret mode (the counterpart of
``quantize_int8_stochastic``). On the CPU the port runs K8's plain version and counts
no launch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.ops import quantize as jq
from dgll_tpu_torch.ops import quantize as tq
from dgll_tpu_torch.ops.cuda import quantize as k8
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)


def _x(shape, seed=0):
    x = np.random.default_rng(seed).normal(0, 2.0, size=shape).astype(np.float32)
    if shape[1] > 3:
        x[:, 3] = 0.0  # an all-zero column: scale 1e-12 / 127
    return x


SHAPES = [(300, 64), (257, 100), (1, 1), (40, 7)]


def _same(got: tq.QuantizedFeatures, want):
    assert got.values.dtype == torch.int8
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy().view(np.uint32),
                                  np.asarray(want.scale).view(np.uint32))
    assert (got.n, got.d) == (want.n, want.d)


@pytest.mark.parametrize("shape", SHAPES)
def test_deterministic_matches_jax(shape):
    x = _x(shape)
    before = k8.launches
    _same(tq.quantize_int8(x), jq.quantize_int8(x))
    _same(tq.quantize_int8(torch.from_numpy(x)), jq.quantize_int8(x))
    assert k8.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("shape", SHAPES)
def test_stochastic_matches_jax_with_its_noise(shape):
    x = _x(shape, seed=1)
    u = np.array(jax.random.uniform(jax.random.key(5), shape, minval=-0.5, maxval=0.5))
    _same(tq.quantize_int8(x, stochastic=True, noise=torch.from_numpy(u)),
          jq.quantize_int8(x, stochastic=True, seed=5))


@pytest.mark.parametrize("shape", SHAPES)
def test_pallas_interpret_matches_with_its_noise(shape):
    """The interpret path feeds the kernel ``uniform(key(seed), (n_pad, d))``; its
    first n rows are the noise of the n real rows."""
    x = _x(shape, seed=2)
    n, d = shape
    n_pad = -(-n // 256) * 256
    u = np.array(jax.random.uniform(jax.random.key(3), (n_pad, d), minval=-0.5,
                                      maxval=0.5))[:n]
    _same(tq.quantize_int8_stochastic(x, noise=torch.from_numpy(u)),
          jq.quantize_int8_pallas(jnp.asarray(x), seed=3, interpret=True))


def test_philox_noise_is_seeded_uniform_and_within_one_step():
    x = _x((300, 64), seed=3)
    a = tq.quantize_int8_stochastic(x, seed=11)
    b = tq.quantize_int8_stochastic(x, seed=11)
    c = tq.quantize_int8_stochastic(x, seed=12)
    assert torch.equal(a.values, b.values) and not torch.equal(a.values, c.values)
    det = jq.quantize_int8(x)
    diff = np.abs(a.values.numpy().astype(np.int32) - np.asarray(det.values, np.int32))
    assert diff.max() <= 1
    assert tq.quantization_error(x, a) < 0.02
    s = tq.quantize_int8(x, stochastic=True, seed=4)
    assert np.abs(s.values.numpy().astype(np.int32)
                  - np.asarray(det.values, np.int32)).max() <= 1
    u = tq.philox_uniform(1000, 37, seed=9)
    assert u.dtype == np.float32 and u.min() >= -0.5 and u.max() < 0.5
    assert abs(float(u.mean())) < 0.01 and abs(float(u.var()) - 1 / 12) < 0.005


def test_philox_matches_the_random123_known_answer():
    """Philox4x32-10 of counter 0 and key 0, the first known-answer vector of the
    Random123 distribution (``kat_vectors``: 6627e8d5 e169c58d bc57ac4c 9b00dbd8)."""
    u = tq.philox_uniform(1, 4, seed=0)
    bits = np.array([0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8], np.uint64)
    want = (bits >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24) - 0.5
    np.testing.assert_array_equal(u[0], want)


@pytest.mark.parametrize("mode", tq.MODES)
def test_reference_rounding_ties(mode):
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, 127.0, -127.0, 0.0]])
    scale = torch.ones(8)
    got = tq.quantize_int8_reference(x, scale, mode).tolist()[0]
    if mode == "xla":   # half to even
        assert got == [0, 2, 2, 0, -2, 127, -127, 0]
    else:               # floor(y + 0.5): half up
        assert got == [1, 2, 3, 0, -1, 127, -127, 0]


def test_binarize_and_error_match_jax():
    x = _x((300, 64), seed=4)
    s_t, sc_t = tq.binarize(x)
    s_j, sc_j = jq.binarize(x)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), rtol=1e-6)
    qt, qj = tq.quantize_int8(x), jq.quantize_int8(x)
    assert abs(tq.quantization_error(x, qt) - jq.quantization_error(x, qj)) < 1e-6
    assert tq.quantization_error(x, qt) < 0.01


def test_gather_and_dequantize_match_jax():
    x = _x((300, 64), seed=5)
    qt, qj = tq.quantize_int8(x), jq.quantize_int8(x)
    ids = np.array([5, 0, 299, 100, 5])
    np.testing.assert_allclose(qt.gather(torch.from_numpy(ids)).numpy(),
                               np.asarray(qj.gather(jnp.asarray(ids))), rtol=1e-6)
    np.testing.assert_allclose(qt.dequantize().numpy(), np.asarray(qj.dequantize()),
                               rtol=1e-6)
