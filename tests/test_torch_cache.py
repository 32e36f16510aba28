"""Parity of the port's device feature cache with the JAX package's.

The cases of the JAX package's own cache tests, run on both packages (the port's
cache on the CPU, ``device="cpu"``): the capacity model, the top-degree policy,
fetches that merge hits and misses, the counters, the memory-budget probe, and the
int8 cache. Tolerance: none for float32 rows (a fetch copies them) and for the int8
cache's dequantised rows (the same int8 values times the same scales, one float32
product each). On the CPU the int8 fill runs K8's plain version and counts no launch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.cache import HBMFeatureCache as JaxCache
from dgll_tpu_torch.cache import HBMFeatureCache
from dgll_tpu_torch.ops.cuda import quantize as k8


def _both(feats, **kw):
    return HBMFeatureCache(feats, device="cpu", **kw), JaxCache(feats, **kw)


def _feats(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def test_capacity_model():
    for c in _both(_feats(100, 16, 0)):
        assert c.capacity_for_budget(16 * 4 * 10) == 10
        assert c.capacity_for_budget(0) == 0


def test_auto_cache_picks_top_degree():
    feats = np.arange(20, dtype=np.float32).reshape(20, 1).repeat(4, 1)
    deg = np.arange(20)  # node 19 hottest
    for c in _both(feats):
        assert c.auto_cache(deg, budget_bytes=4 * 4 * 5) == 5  # room for 5 rows
        assert set(np.nonzero(c.cache_pos >= 0)[0]) == {15, 16, 17, 18, 19}
    t, j = _both(_feats(300, 8, 1))
    scores = np.random.default_rng(2).integers(0, 50, 300)  # ties
    assert t.auto_cache(scores, 8 * 4 * 70) == j.auto_cache(scores, 8 * 4 * 70) == 70
    np.testing.assert_array_equal(t.cache_pos, j.cache_pos)
    assert t.auto_cache(scores, 0) == 0


@pytest.mark.parametrize("ids", [[3, 30, 7, 45, 24, 25], [30, 30, 1, 49, 30, 1, 26]])
def test_fetch_merges_hits_and_misses(ids):
    feats = _feats(50, 8, 1)
    t, j = _both(feats)
    for c in (t, j):
        c.fill(np.arange(0, 25))  # cache the first half
    ids = np.array(ids)
    out = t.fetch(ids)
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    np.testing.assert_array_equal(out.numpy(), feats[ids])
    np.testing.assert_array_equal(out.numpy(), np.asarray(j.fetch(ids)))
    assert t.miss_rate() == j.miss_rate()
    rate, lookups, misses = t.miss_rate()
    assert lookups == len(ids) and misses == int((ids >= 25).sum())
    assert abs(rate - misses / lookups) < 1e-12
    t.reset_counters()
    assert t.miss_rate() == (0.0, 0, 0)
    np.testing.assert_array_equal(t.fetch(torch.from_numpy(ids)).numpy(), feats[ids])


def test_fetch_all_hits_and_whole_graph():
    feats = _feats(10, 4, 2)
    t, j = _both(feats)
    for c in (t, j):
        c.fill(np.arange(10))
        assert c.cached_whole_graph
    ids = np.array([9, 0, 5])
    np.testing.assert_array_equal(t.fetch(ids).numpy(), np.asarray(j.fetch(ids)))
    assert t.miss_rate()[2] == j.miss_rate()[2] == 0


def test_fetch_without_cache_falls_back_to_host():
    feats = _feats(10, 4, 3)
    t, j = _both(feats)
    ids = np.array([1, 2])
    np.testing.assert_array_equal(t.fetch(ids).numpy(), np.asarray(j.fetch(ids)))
    assert t.miss_rate() == j.miss_rate() == (1.0, 2, 2)


def test_device_budget_probe():
    """The CPU has no memory counts: no budget, and auto_cache_from_device caches
    nothing, as the JAX package does on a backend without memory stats."""
    feats = _feats(64, 16, 0)
    c = HBMFeatureCache(feats, device="cpu")
    assert c.device_budget_bytes(reserve_bytes=0) is None
    assert c.auto_cache_from_device(np.arange(64), reserve_bytes=0) == 0
    assert c.k == 0 and c.cache is None
    assert HBMFeatureCache(feats).device.type == "cuda"  # the card unless asked


def test_quantized_cache_roundtrip():
    feats = _feats(64, 16, 0)
    c = HBMFeatureCache(feats, device="cpu", quantize=True)
    assert c.capacity_for_budget(16 * 16) == 16  # four times the float32 rows
    before = k8.launches
    c.fill(np.arange(32))
    assert k8.launches == before
    out = c.fetch(np.array([3, 40, 10])).numpy()
    # cached rows come back dequantised (about 1% error); misses exact
    assert np.abs(out[0] - feats[3]).mean() < 0.05
    np.testing.assert_array_equal(out[1], feats[40])


def test_int8_fetch_matches_jax():
    feats = _feats(200, 24, 4)
    t, j = _both(feats, quantize=True)
    order = np.random.default_rng(5).permutation(200)[:90]
    for c in (t, j):
        c.fill(order)
    np.testing.assert_array_equal(t.cache.values.numpy(), np.asarray(j.cache.values))
    np.testing.assert_array_equal(t.cache.scale.numpy(), np.asarray(j.cache.scale))
    ids = np.random.default_rng(6).integers(0, 200, 150)
    got, want = t.fetch(ids), np.asarray(j.fetch(jnp.asarray(ids)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert t.miss_rate() == j.miss_rate()
