"""Parity of the port's segment ops (``dgll_tpu_torch/ops/segment.py``) with the
JAX package's (``dgll_tpu/ops/segment.py``), on inputs made with numpy.

The segments include empty ones and one large segment (a hub). Tolerance (f32):
atol 1e-5 x max|ref| on values and on gradients; the two sides sum in different
orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.ops import segment as jseg
from dgll_tpu_torch.ops import segment as tseg


def _close(got, want, scale=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=scale * max(np.abs(want).max(), 1e-30))


def _segments(seed, n_seg=40, e=600, h=3):
    """Ids with a hub segment (0), every fifth segment empty, and [e, h] data."""
    rng = np.random.default_rng(seed)
    p = (np.arange(n_seg) + 1.0) ** -1.0
    p[::5][1:] = 0.0
    ids = rng.choice(n_seg, size=e, p=p / p.sum())
    data = (rng.normal(size=(e, h)) * 3).astype(np.float32)
    return ids, data, rng


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_segment_sum_matches_jax(index_dtype):
    ids, data, _ = _segments(0)
    want = jseg.segment_sum(jnp.asarray(data), jnp.asarray(ids), 40)
    got = tseg.segment_sum(torch.from_numpy(data), torch.from_numpy(ids).to(index_dtype), 40)
    _close(got.numpy(), want)
    empty = np.setdiff1d(np.arange(40), ids)
    assert len(empty) >= 7 and (got[empty] == 0).all()


@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_segment_softmax_matches_jax(index_dtype):
    ids, data, rng = _segments(1)
    cot = rng.normal(size=data.shape).astype(np.float32)

    def jloss(x):
        out = jseg.segment_softmax(x, jnp.asarray(ids), 40)
        return jnp.sum(out * cot), out

    (_, want), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(data))
    x = torch.tensor(data, requires_grad=True)
    tids = torch.from_numpy(ids).to(index_dtype)
    got = tseg.segment_softmax(x, tids, 40)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach().numpy(), want)
    _close(x.grad.numpy(), jgrad)
    # each non-empty segment's weights sum to 1
    sums = tseg.segment_sum(got.detach(), tids, 40)[np.unique(ids)]
    assert ((sums - 1).abs() < 1e-5).all()
