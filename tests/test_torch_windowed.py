"""Parity of the port's windowed layout and hybrid SpMM with the JAX package's.

* The partition of edges into windowed and residual, for A and A^T: the residual
  edge indices, ``windowed_fraction`` and every sub-chunk cut equal those of JAX's
  ``build_windowed`` at ``eb`` 512 and 1024 (the partition does not depend on
  ``eb``).
* ``spmm_windowed_reference`` against ``spmm_windowed_xla``, and the CPU
  ``spmm_hybrid`` (the same autograd op that launches K2 and K1 on the card, here
  through their plain versions) against JAX's ``spmm_hybrid(..., interpret=True)``,
  forward and gradients (``dx``, ``db``), with and without bias + ReLU.
* A 2-layer GCN on a relabelled clustered graph carrying the windowed layouts, with
  the parameters of a flax ``GCN`` (``params_from_flax``): logits and gradients.

Tolerances: f32 within 1e-5 * max|ref| (the two sides sum in different orders); bf16
within 1e-2 relative to max(|ref|, 1), against f32 math on bf16-quantised inputs.
"""
import functools

import dgll_tpu.native as jax_native
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.data import gcn_normalize as jax_gcn_normalize
from dgll_tpu.graph import Graph as JaxGraph
from dgll_tpu.nn import GCN as JaxGCN
from dgll_tpu.ops.pallas.spmm_windowed import spmm_hybrid as jax_spmm_hybrid
from dgll_tpu.ops.spmm import spmm_coo as jax_spmm_coo
from dgll_tpu.ops.windowed import WIN_ROWS as JAX_WIN_ROWS
from dgll_tpu.ops.windowed import build_hybrid_pair as jax_build_hybrid_pair
from dgll_tpu.ops.windowed import build_windowed as jax_build_windowed
from dgll_tpu.ops.windowed import spmm_windowed_xla
from dgll_tpu.train.metrics import masked_nll_loss as jax_nll
from dgll_tpu_torch import native
from dgll_tpu_torch.data import gcn_normalize
from dgll_tpu_torch.graph import Graph
from dgll_tpu_torch.nn import GCN, params_from_flax
from dgll_tpu_torch.ops.chunked import R_BLOCK
from dgll_tpu_torch.ops.cuda.segment_matmul import _vector_width
from dgll_tpu_torch.ops.cuda.spmm_windowed import (
    MAX_VEC,
    spmm_hybrid,
    spmm_windowed_cuda,
)
from dgll_tpu_torch.ops.windowed import (
    SUB,
    WIN_ROWS,
    build_hybrid_pair,
    build_windowed,
    spmm_windowed_reference,
)
from dgll_tpu_torch.train import masked_nll_loss


def clustered_coo(n, deg, n_comm, intra, seed):
    """Most sources inside the destination's community block (as
    ``tests/test_pallas_spmm_windowed.py`` builds them)."""
    rng = np.random.default_rng(seed)
    e = n * deg
    dst = rng.integers(0, n, e)
    csize = n // n_comm
    local = rng.random(e) < intra
    src = np.where(local, (dst // csize) * csize + rng.integers(0, csize, e),
                   rng.integers(0, n, e)) % n
    w = rng.random(e).astype(np.float32) + 0.5
    return src.astype(np.int64), dst.astype(np.int64), w


def expander_coo(n=2048, deg=8, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, n * deg), rng.integers(0, n, n * deg),
            (rng.random(n * deg) + 0.5).astype(np.float32))


def empty_block_coo():
    """Clustered, with no edge into or out of rows 256..383: a 128-row block with
    no edges in A and in A^T."""
    src, dst, w = clustered_coo(1024, 8, 4, 0.9, seed=6)
    keep = ~(((dst >= 256) & (dst < 384)) | ((src >= 256) & (src < 384)))
    return src[keep], dst[keep], w[keep]


GRAPHS = {
    "clustered_0.95": (1536, lambda: clustered_coo(1536, 9, 6, 0.95, seed=4)),
    "clustered_0.7": (1536, lambda: clustered_coo(1536, 9, 6, 0.7, seed=4)),
    "expander": (2048, expander_coo),
    "empty_block": (1024, empty_block_coo),
    # every edge windowed: the hybrid has no residual and K2 fuses bias and ReLU
    "all_windowed": (1024, lambda: clustered_coo(1024, 8, 4, 1.0, seed=7)),
}


@functools.cache
def graph(name):
    n, make = GRAPHS[name]
    src, dst, w = make()
    return n, src, dst, w


def jax_sub_chunks(c):
    """(row block, first x row, edge count) of each non-empty JAX sub-chunk, in
    kernel order."""
    out = []
    sl = np.asarray(c.src_local)
    for ci in range(c.n_chunk):
        for k in range(c.n_sub):
            m = int((sl[k, ci] >= 0).sum())
            if m:
                x0 = int(c.win_block[ci]) * JAX_WIN_ROWS + int(c.sub_off[ci, k])
                out.append((int(c.row_block[ci]), x0, m))
    return out


def port_sub_chunks(c):
    blk_ptr, sub_ptr = c.blk_ptr.numpy(), c.sub_ptr.numpy()
    blk = np.repeat(np.arange(c.n_row_blocks), np.diff(blk_ptr))
    return [(int(b), int(x0), int(m)) for b, x0, m in
            zip(blk, c.sub_x0.numpy(), np.diff(sub_ptr))]


@pytest.mark.parametrize("eb", [512, 1024])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_partition_matches_jax(name, eb):
    n, src, dst, w = graph(name)
    for s, d in ((src, dst), (dst, src)):  # A, then A^T
        jc, jres = jax_build_windowed(s, d, n, n, w, eb=eb)
        c, res = build_windowed(s, d, n, n, w)
        assert (jres is None) == (res is None)
        if res is not None:
            np.testing.assert_array_equal(res, jres)
        assert port_sub_chunks(c) == jax_sub_chunks(jc)
    jh, jht = jax_build_hybrid_pair(src, dst, n, n, w, eb=eb)
    h, ht = build_hybrid_pair(src, dst, n, n, w)
    assert (h.windowed_fraction, ht.windowed_fraction) == (
        jh.windowed_fraction, jht.windowed_fraction)
    assert (h.res is None) == (jh.res is None)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_partition_does_not_depend_on_eb(name):
    n, src, dst, w = graph(name)
    _, r512 = jax_build_windowed(src, dst, n, n, w, eb=512)
    _, r1024 = jax_build_windowed(src, dst, n, n, w, eb=1024)
    if r512 is None:
        assert r1024 is None
    else:
        np.testing.assert_array_equal(r512, r1024)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_layout_invariants(name):
    """Every edge once, windowed or residual; each sub-chunk's edges sorted by
    (destination, source), inside one row block and inside its staged rows."""
    n, src, dst, w = graph(name)
    h, _ = build_hybrid_pair(src, dst, n, n, w)
    c = h.win
    got = list(zip(c.src.tolist(), c.rows.tolist(), c.weight.tolist()))
    if h.res is not None:
        got += list(zip(h.res.src.tolist(), h.res.rows.tolist(), h.res.weight.tolist()))
    assert sorted(got) == sorted(zip(src.tolist(), dst.tolist(), w.tolist()))

    sub_ptr, x0, nx = c.sub_ptr.numpy(), c.sub_x0.numpy(), c.sub_nx.numpy()
    blk_ptr = c.blk_ptr.numpy()
    assert c.n_rows % R_BLOCK == 0 and len(blk_ptr) == c.n_rows // R_BLOCK + 1
    assert blk_ptr[0] == 0 and blk_ptr[-1] == c.n_sub and (np.diff(blk_ptr) >= 0).all()
    assert (np.diff(sub_ptr) >= 1).all() and (np.diff(sub_ptr) <= SUB).all()
    assert ((nx >= 1) & (nx <= SUB)).all() and (x0 + nx <= n).all()
    s, r = c.src.numpy(), c.rows.numpy()
    for b in range(c.n_row_blocks):
        for k in range(blk_ptr[b], blk_ptr[b + 1]):
            e0, e1 = sub_ptr[k], sub_ptr[k + 1]
            assert ((r[e0:e1] // R_BLOCK) == b).all()
            assert ((s[e0:e1] >= x0[k]) & (s[e0:e1] < x0[k] + nx[k])).all()
            assert (s[e0:e1] // WIN_ROWS == x0[k] // WIN_ROWS).all()
            key = r[e0:e1].astype(np.int64) * n + s[e0:e1]
            assert (np.diff(key) >= 0).all()
    if name == "empty_block":
        assert blk_ptr[2] == blk_ptr[3]  # rows 256..383: no sub-chunk


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_windowed_reference_matches_jax_xla(name):
    n, src, dst, w = graph(name)
    rng = np.random.default_rng(1)
    jc, _ = jax_build_windowed(src, dst, n, n, w)
    c, _ = build_windowed(src, dst, n, n, w)
    x = rng.standard_normal((jc.n_cols, 128)).astype(np.float32)
    want = np.asarray(spmm_windowed_xla(jc, jnp.asarray(x)))
    got = spmm_windowed_reference(c, torch.from_numpy(x[:n])).numpy()
    assert got.shape == want.shape == (c.n_rows, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


def _jax_hybrid(n, src, dst, w, x, bias, activation, cot):
    jh, jht = jax_build_hybrid_pair(src, dst, n, n, w)

    def loss(x_, b_):
        out = jax_spmm_hybrid(jh, jht, x_, b_, activation, interpret=True)[:n]
        return jnp.sum(out * cot), out

    b = None if bias is None else jnp.asarray(bias)
    argnums = (0,) if bias is None else (0, 1)
    (_, out), grads = jax.value_and_grad(loss, argnums=argnums, has_aux=True)(
        jnp.asarray(x), b)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("name,f,activation", [
    ("clustered_0.95", 128, None),
    ("clustered_0.95", 128, "relu"),
    ("clustered_0.7", 128, "relu"),
    ("empty_block", 128, "relu"),
    ("all_windowed", 128, "relu"),
    ("clustered_0.7", 256, None),
])
def test_spmm_hybrid_matches_jax(name, f, activation):
    n, src, dst, w = graph(name)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((n, f)).astype(np.float32)
    bias = rng.standard_normal(f).astype(np.float32) if activation else None
    cot = rng.standard_normal((n, f)).astype(np.float32)
    jout, jgrads = _jax_hybrid(n, src, dst, w, x, bias, activation, cot)

    h, ht = build_hybrid_pair(src, dst, n, n, w)
    assert (h.res is None) == (name == "all_windowed")
    xt = torch.tensor(x, requires_grad=True)
    bt = None if bias is None else torch.tensor(bias, requires_grad=True)
    out = spmm_hybrid(h, ht, xt, bt, activation)
    assert out.shape == (h.win.n_rows, f) and out.dtype == torch.float32
    (out[:n] * torch.from_numpy(cot)).sum().backward()
    _close(out[:n].detach(), jout, "out")
    _close(xt.grad, jgrads[0], "dx")
    if bias is not None:
        _close(bt.grad, jgrads[1], "db")
        if name == "empty_block":  # rows without edges come out as act(bias)
            want = np.maximum(bias, 0)
            np.testing.assert_array_equal(out[256:384].detach().numpy(),
                                          np.broadcast_to(want, (128, f)))


def test_spmm_hybrid_narrow_matches_jax_coo():
    """F=16 (no JAX kernel below 128 columns): against JAX ``spmm_coo`` + bias + ReLU."""
    n, src, dst, w = graph("clustered_0.7")
    f = 16
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, f)).astype(np.float32)
    bias = rng.standard_normal(f).astype(np.float32)
    cot = rng.standard_normal((n, f)).astype(np.float32)

    def loss(x_, b_):
        out = jax.nn.relu(jax_spmm_coo(jnp.asarray(src), jnp.asarray(dst), x_, n,
                                       jnp.asarray(w)) + b_)
        return jnp.sum(out * cot), out

    (_, jout), (jdx, jdb) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(bias))
    h, ht = build_hybrid_pair(src, dst, n, n, w)
    xt = torch.tensor(x, requires_grad=True)
    bt = torch.tensor(bias, requires_grad=True)
    out = spmm_hybrid(h, ht, xt, bt, "relu")
    (out[:n] * torch.from_numpy(cot)).sum().backward()
    _close(out[:n].detach(), jout, "out")
    _close(xt.grad, jdx, "dx")
    _close(bt.grad, jdb, "db")


@pytest.mark.parametrize("msg_dtype", [None, torch.bfloat16])
def test_spmm_hybrid_bf16(msg_dtype):
    """bf16 input (``msg_dtype=None``: the output is bf16 too) or f32 input with bf16
    messages (the output stays f32), against JAX in f32 on the bf16-quantised
    input and cotangent (the backward sums the cotangent in bf16): within 1e-2 of
    max(|ref|, 1), forward and dx."""
    n, src, dst, w = graph("clustered_0.7")
    f = 128
    rng = np.random.default_rng(4)
    x32 = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    xq = x32.to(torch.bfloat16)
    cot = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    cot = cot.to(torch.bfloat16).float().numpy()
    jout, (jdx,) = _jax_hybrid(n, src, dst, w, xq.float().numpy(), None, "relu", cot)

    h, ht = build_hybrid_pair(src, dst, n, n, w)
    x = (xq if msg_dtype is None else x32).clone().requires_grad_(True)
    out = spmm_hybrid(h, ht, x, None, "relu", msg_dtype=msg_dtype)
    assert out.dtype == x.dtype
    (out[:n].float() * torch.from_numpy(cot)).sum().backward()
    assert x.grad.dtype == x.dtype
    for got, want in ((out[:n].detach(), jout), (x.grad, jdx)):
        scale = np.maximum(np.abs(want), 1.0)
        np.testing.assert_allclose(got.float().numpy() / scale, want / scale, rtol=0,
                                   atol=1e-2)


def test_wrapper_takes_cpu_or_cuda_only():
    """A CPU tensor takes the plain versions; the launcher refuses anything but a
    CUDA tensor, and other devices raise rather than fall back."""
    n, src, dst, w = graph("all_windowed")
    h, ht = build_hybrid_pair(src, dst, n, n, w)
    with pytest.raises(ValueError, match="CUDA"):
        spmm_windowed_cuda(h.win, torch.ones(n, 4))
    with pytest.raises(ValueError, match="cpu or cuda"):
        spmm_hybrid(h, ht, torch.ones(n, 4, device="meta"))


@pytest.mark.parametrize("dtype,f,want", [
    (torch.float32, 128, 4), (torch.float32, 256, 4), (torch.float32, 16, 1),
    (torch.float32, 33, 1), (torch.bfloat16, 128, 4), (torch.bfloat16, 64, 2),
])
def test_vector_width(dtype, f, want):
    """K2's loads: up to 4 columns a lane, dividing F, with 32 busy lanes where F
    allows."""
    x = torch.zeros(4, f, dtype=dtype)
    assert _vector_width(x, f, MAX_VEC, full_warp=True) == want


def test_graph_to_moves_the_windowed_layouts():
    n, src, dst, w = graph("clustered_0.7")
    g = Graph.from_edges(src, dst, n, edge_weight=w).with_windowed()
    assert g.hybrid is not None and g.hybrid.res is not None
    g = g.replace(node_perm=torch.arange(n)).to("meta")
    for t in (g.hybrid.win.src, g.hybrid.win.sub_x0, g.hybrid.res.src,
              g.hybrid_t.win.blk_ptr, g.node_perm):
        assert t.device.type == "meta"
    assert g.hybrid.windowed_fraction == g.to("meta").hybrid.windowed_fraction


# --- a 2-layer GCN on a relabelled clustered graph carrying the windowed layouts ---

def _shuffled_clustered(n=8192, seed=8):
    """A clustered graph whose ids were shuffled, so that it has the structure but
    not the locality in id space (capture estimate 0.38): ``with_windowed(reorder=
    True)`` relabels it by communities (estimate 0.86), then attaches."""
    src, dst, _ = clustered_coo(n, 3, 8, 0.95, seed=seed)
    rng = np.random.default_rng(seed)
    relabel = rng.permutation(n)
    feat = rng.standard_normal((n, 32)).astype(np.float32)
    labels = rng.integers(0, 128, n).astype(np.int32)
    mask = rng.random(n) < 0.5
    return dict(src=relabel[src], dst=relabel[dst], n_node=n, node_feat=feat,
                labels=labels, train_mask=mask, add_self_loops=True)


@pytest.fixture(scope="module")
def gcn_pair():
    """(JAX graph, port graph, flax GCN, its parameters, port GCN) on the relabelled
    graph. Both sides relabel by the same label propagation: the shared C++ kernel,
    or, where either loader has no library, both numpy fallbacks."""
    args = _shuffled_clustered()
    with pytest.MonkeyPatch.context() as mp:
        if not (native.native_available() and jax_native.native_available()):
            mp.setattr(jax_native, "label_propagation_native", lambda *a: False)
            mp.setattr(native, "label_propagation", lambda *a: False)
        gj = jax_gcn_normalize(JaxGraph.from_edges(**args)).with_windowed(reorder=True)
        gt = gcn_normalize(Graph.from_edges(**args)).with_windowed(reorder=True)
    assert gj.hybrid is not None and gj.node_perm is not None
    assert gt.hybrid is not None and gt.node_perm is not None
    np.testing.assert_array_equal(gt.node_perm.numpy(), np.asarray(gj.node_perm))
    gj = jax.tree.map(jnp.asarray, gj)
    mj = JaxGCN(hidden=128, n_class=128, dropout=0.0)
    params = mj.init(jax.random.key(0), gj, gj.node_feat)["params"]
    mt = GCN(32, hidden=128, n_class=128, dropout=0.0)
    mt.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    mt.eval()
    return gj, gt, mj, params, mt


def test_gcn_on_reordered_windowed_graph_logits_match_jax(gcn_pair):
    gj, gt, mj, params, mt = gcn_pair
    want = np.asarray(mj.apply({"params": params}, gj, gj.node_feat))
    with torch.no_grad():
        got = mt(gt, gt.node_feat).numpy()
    _close(got, want, "log-probs")


def test_gcn_on_reordered_windowed_graph_grads_match_jax(gcn_pair):
    gj, gt, mj, params, mt = gcn_pair

    def loss_of(p):
        return jax_nll(mj.apply({"params": p}, gj, gj.node_feat), gj.labels, gj.train_mask)

    lj, gradj = jax.value_and_grad(loss_of)(params)
    mt.zero_grad()
    loss = masked_nll_loss(mt(gt, gt.node_feat), gt.labels, gt.train_mask)
    loss.backward()
    _close(float(loss.detach()), float(lj), "loss")
    for i, conv in enumerate(mt.convs):
        gl = gradj[f"GCNConv_{i}"]
        _close(conv.linear.weight.grad.numpy().T, gl["weight"]["kernel"], f"W{i}")
        _close(conv.bias.grad.numpy(), gl["bias"], f"b{i}")
