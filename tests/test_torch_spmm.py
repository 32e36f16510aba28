"""Parity of the port's SpMM ops with the JAX package's.

* ``spmm_chunked`` (the kernel's wrapper; on CPU tensors it runs the plain version)
  against JAX ``spmm_chunked(interpret=True)``, forward and gradients, at F=128;
  and against JAX ``spmm_coo`` + bias + ReLU at F=16, where the JAX kernel does not
  apply (it needs F % 128 == 0).
* bf16 against f32 math on bf16-quantised inputs.
* ``spmm_coo``, untiled and feature-tiled.

Tolerances (f32): rtol/atol 1e-5 forward and 1e-4 for gradients. The two sides sum
in different orders, and nothing else differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.ops.chunked import build_chunked_pair as jax_build_chunked_pair
from dgll_tpu.ops.pallas.segment_matmul import spmm_chunked as jax_spmm_chunked
from dgll_tpu.ops.spmm import spmm_coo as jax_spmm_coo
from dgll_tpu_torch.ops import build_chunked_pair, spmm_chunked_reference
from dgll_tpu_torch.ops import spmm as torch_spmm
from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked, spmm_csr_cuda

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _power_law_coo(n_rows, n_cols, e, seed=0):
    """Power-law destinations with rows 128..255 left without edges, so one whole
    128-row block is empty."""
    rng = np.random.default_rng(seed)
    p = (np.arange(n_rows) + 1.0) ** -1.2
    p /= p.sum()
    dst = rng.choice(n_rows, size=e, p=p)
    dst[(dst >= 128) & (dst < 256)] -= 128
    src = rng.integers(0, n_cols, e)
    w = (rng.random(e) / 4).astype(np.float32)
    return src, dst, w, rng


def _dense(src, dst, w, x, n_rows):
    a = np.zeros((n_rows, x.shape[0]), np.float64)
    np.add.at(a, (dst, src), w)
    return a @ x.astype(np.float64)


@pytest.mark.parametrize("n_rows,n_cols", [(600, 600), (300, 520)])
@pytest.mark.parametrize("activation", [None, "relu"])
def test_spmm_chunked_matches_jax_kernel(n_rows, n_cols, activation):
    src, dst, w, rng = _power_law_coo(n_rows, n_cols, 5000)
    f = 128
    x = rng.normal(size=(n_cols, f)).astype(np.float32)
    bias = rng.normal(size=f).astype(np.float32) if activation else None
    cot = rng.normal(size=(n_rows, f)).astype(np.float32)

    jc, jct = jax_build_chunked_pair(src, dst, n_rows, n_cols, w, eb=128)

    def jax_loss(x_, b_):
        out = jax_spmm_chunked(jc, jct, x_, b_, activation, interpret=True)[:n_rows]
        return jnp.sum(out * cot), out

    jb = None if bias is None else jnp.asarray(bias)
    (_, jout), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jb)

    c, ct = build_chunked_pair(src, dst, n_rows, n_cols, w)
    xt = torch.tensor(x, requires_grad=True)
    bt = None if bias is None else torch.tensor(bias, requires_grad=True)
    out = spmm_chunked(c, ct, xt, bt, activation)
    assert out.shape == (c.n_rows, f) and c.n_rows % 128 == 0
    (out[:n_rows] * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(out[:n_rows].detach().numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrads[0]), **GRAD)
    if bias is not None:
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jgrads[1]), **GRAD)


@pytest.mark.parametrize("activation", [None, "relu"])
def test_spmm_chunked_narrow_matches_jax_coo(activation):
    """F=16 goes through the port's kernel path; the JAX reference is spmm_coo."""
    n = 600
    src, dst, w, rng = _power_law_coo(n, n, 5000, seed=1)
    f = 16
    x = rng.normal(size=(n, f)).astype(np.float32)
    bias = rng.normal(size=f).astype(np.float32)
    cot = rng.normal(size=(n, f)).astype(np.float32)

    def jax_loss(x_, b_):
        out = jax_spmm_coo(jnp.asarray(src), jnp.asarray(dst), x_, n, jnp.asarray(w)) + b_
        if activation == "relu":
            out = jax.nn.relu(out)
        return jnp.sum(out * cot), out

    (_, jout), (jdx, jdb) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(bias))

    c, ct = build_chunked_pair(src, dst, n, n, w)
    xt = torch.tensor(x, requires_grad=True)
    bt = torch.tensor(bias, requires_grad=True)
    out = spmm_chunked(c, ct, xt, bt, activation)
    (out[:n] * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out[:n].detach().numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **GRAD)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jdb), **GRAD)


@pytest.mark.parametrize("activation", [None, "relu"])
def test_padded_and_edgeless_rows_are_act_bias(activation):
    n = 300
    src, dst, w, rng = _power_law_coo(n, n, 3000, seed=2)
    c, ct = build_chunked_pair(src, dst, n, n, w)
    bias = torch.from_numpy(rng.normal(size=32).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(n, 32)).astype(np.float32))
    out = spmm_chunked(c, ct, x, bias, activation)
    expect = torch.relu(bias) if activation else bias
    edgeless = np.setdiff1d(np.arange(c.n_rows), dst)
    assert len(edgeless) >= 128 + (c.n_rows - n)
    torch.testing.assert_close(out[edgeless], expect.expand(len(edgeless), -1),
                               rtol=0, atol=0)


@pytest.mark.parametrize("msg_dtype", [None, torch.bfloat16])
def test_spmm_chunked_bf16(msg_dtype):
    """bf16 messages with f32 accumulation. The oracle is f32 math on bf16-quantised
    inputs (the layout's weights stay f32), so what is left is the final store's
    rounding: atol 1e-2 relative to max(|expect|, 1)."""
    n, f = 600, 128
    src, dst, w, rng = _power_law_coo(n, n, 5000, seed=3)
    c, ct = build_chunked_pair(src, dst, n, n, w)
    x32 = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    x = x32.to(torch.bfloat16) if msg_dtype is None else x32.clone()
    x.requires_grad_(True)
    out = spmm_chunked(c, ct, x, None, "relu", msg_dtype=msg_dtype)
    assert out.dtype == x.dtype

    xq = x32.to(torch.bfloat16).float().numpy()
    expect = np.maximum(_dense(src, dst, w, xq, n), 0.0)
    scale = np.maximum(np.abs(expect), 1.0)
    got = out[:n].detach().float().numpy()
    np.testing.assert_allclose(got / scale, expect / scale, atol=1e-2, rtol=0)

    cot = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32))
    (out[:n].float() * cot).sum().backward()
    assert x.grad.dtype == x.dtype
    # backward oracle from the forward's own ReLU mask: dx = A^T (mask * g)
    g = (cot * (out[:n].detach().float() > 0)).to(torch.bfloat16).float().numpy()
    dx = _dense(dst, src, w, g, n)
    dscale = np.maximum(np.abs(dx), 1.0)
    np.testing.assert_allclose(x.grad.float().numpy() / dscale, dx / dscale, atol=1e-2,
                               rtol=0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
def test_spmm_coo_matches_jax(monkeypatch, weighted, tiled):
    if tiled:  # lowers the port's tiling threshold only; the JAX side stays untiled
        monkeypatch.setattr(torch_spmm, "_MSG_TILE_BYTES", 1024)
    rng = np.random.default_rng(4)
    n_src, n_dst, e, f = 90, 70, 700, 300
    src, dst = rng.integers(0, n_src, e), rng.integers(0, n_dst, e)
    w = rng.random(e).astype(np.float32) if weighted else None
    x = rng.normal(size=(n_src, f)).astype(np.float32)
    cot = rng.normal(size=(n_dst, f)).astype(np.float32)
    assert (torch_spmm._msg_f_tiles(torch.from_numpy(src), f, 4) is not None) == tiled

    def jax_loss(x_):
        out = jax_spmm_coo(jnp.asarray(src), jnp.asarray(dst), x_, n_dst,
                           None if w is None else jnp.asarray(w))
        return jnp.sum(out * cot), out

    (_, jout), jdx = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = torch_spmm.spmm_coo(torch.from_numpy(src), torch.from_numpy(dst), xt, n_dst,
                              None if w is None else torch.from_numpy(w))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **GRAD)


def test_reference_matches_dense():
    n = 400
    src, dst, w, rng = _power_law_coo(n, n, 4000, seed=5)
    c, _ = build_chunked_pair(src, dst, n, n, w)
    x = rng.normal(size=(n, 40)).astype(np.float32)
    out = spmm_chunked_reference(c, torch.from_numpy(x))
    np.testing.assert_allclose(out[:n].numpy(), _dense(src, dst, w, x, n), **FWD)
    assert (out[n:] == 0).all()


def test_wrapper_takes_cpu_or_cuda_only():
    """A CPU tensor takes the plain version; the kernel launcher refuses anything but
    a CUDA tensor, and other devices raise rather than fall back."""
    c, ct = build_chunked_pair(np.array([0, 1]), np.array([1, 0]), 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        spmm_csr_cuda(c, torch.ones(2, 4))
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmm_chunked(c, ct, torch.ones(2, 4, device="meta"))


def test_layout_rows_match_indptr():
    """Each edge's stored destination row is the row its ``indptr`` span gives."""
    n = 400
    src, dst, w, _ = _power_law_coo(n, 300, 3000, seed=6)
    for lay in build_chunked_pair(src, dst, n, 300, w):
        counts = (lay.indptr[1:] - lay.indptr[:-1]).long()
        want = torch.repeat_interleave(torch.arange(lay.n_rows), counts)
        assert lay.rows.dtype == torch.int32
        assert torch.equal(lay.rows.long(), want)


def test_restrict_rows_keeps_hubs_and_caps_rows():
    """The hub-row probe's layouts: only the chosen rows, or every row cut to its
    first ``cap`` edges, each edge keeping its source and weight."""
    from dgll_tpu_torch.tools.profile_slice import restrict_rows

    n = 400
    src, dst, w, rng = _power_law_coo(n, n, 4000, seed=7)
    c, _ = build_chunked_pair(src, dst, n, n, w)
    degree = np.diff(c.indptr.numpy())
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    full = spmm_chunked_reference(c, x)

    hubs = restrict_rows(c, keep_row=degree > 50)
    assert (degree > 50).sum() > 0
    np.testing.assert_array_equal(np.diff(hubs.indptr.numpy()),
                                  np.where(degree > 50, degree, 0))
    out = spmm_chunked_reference(hubs, x)
    np.testing.assert_allclose(out[degree > 50].numpy(), full[degree > 50].numpy(), **FWD)
    assert (out[degree <= 50] == 0).all()

    capped = restrict_rows(c, cap=5)
    np.testing.assert_array_equal(np.diff(capped.indptr.numpy()), np.minimum(degree, 5))
    starts = c.indptr.numpy()[:-1]
    for r in np.flatnonzero(degree)[:20]:
        a, b = capped.indptr[r].item(), capped.indptr[r + 1].item()
        np.testing.assert_array_equal(capped.src[a:b].numpy(),
                                      c.src[starts[r]:starts[r] + b - a].numpy())
