"""Parity of the round-4 GAT path's edge<->row kernels with the JAX package, on the CPU.

The same inputs, made with numpy, go through the JAX functions (their Pallas kernels
in interpret mode, on layouts with 128-slot chunks, as ``tests/test_torch_gat.py``
runs them) and through the port, whose kernel wrappers run their plain PyTorch
versions on CPU tensors:

* each kernel's plain version: K6 max (``_e2r_max_multi_d``), K6′
  (``_rows_to_edges_multi_impl``), K10 (``rows_to_edges`` and ``_edges_to_rows`` in
  its sum, sum_all and max modes), K9 (``sddmm_chunked_pallas``), and the oracles
  ``sddmm_coo``, ``segment_max``, ``segment_min`` and ``segment_mean``;
* the differentiable ops of ``ops/edge_ops.py``, forward and VJP, and the
  segment-op softmaxes of ``ops/sddmm.py``;
* that on CPU tensors no launch counter moves, and that the launchers take CUDA
  tensors only.

The test graph (``test_torch_gat.layouts``) has a hub row wider than a chunk, an
edgeless 128-row block and duplicate edges. JAX slots map to the port's edge order
by (source, destination).

A caveat of the comparison: the JAX kernels count a slot as an edge where its weight
is nonzero ("valid = weight != 0"), while the port's layouts hold real edges only and
never read the weights on this path. The two agree because every real edge has a
nonzero weight: these layouts are unweighted (weight 1), and ``gcn_normalize`` gives
positive weights. A real edge of weight 0 would be dropped by the JAX path and kept
by the port's (ROADMAP Queue 3).

Tolerances (f32): maxima and copies exact; sums and dot products 1e-5 x max|ref|;
gradients 1e-4 x max|ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.ops import segment as jseg
from dgll_tpu.ops.pallas import edge_ops as je
from dgll_tpu.ops.pallas import sddmm as jsd
from dgll_tpu.ops.spmm import sddmm_coo as jax_sddmm_coo
from dgll_tpu_torch.ops import edge_ops as te
from dgll_tpu_torch.ops import gat_csr, segment, sddmm, spmm
from dgll_tpu_torch.ops.cuda import edge_ops as tk
from dgll_tpu_torch.ops.cuda import gat_fused as tgf
from test_torch_gat import _close, _to_slots, layouts  # noqa: F401 (fixture)

HEADS = [1, 8]


@pytest.fixture(scope="module", autouse=True)
def _thread_pool():
    """Start torch's CPU thread pool before any comparison: the first multi-threaded
    op of a process has been seen to disturb the vector op running beside it (one
    exp in ten thousand off by 1e-4), which the exact and 1e-5 comparisons here
    would catch. The other parity files that compare exactly import it, since any
    of them can be a test worker's first file."""
    torch.exp(torch.randn(1 << 22)).sum()


def _edges(c, heads, seed):
    """Per-edge values ``[nnz, heads]`` with repeats, so that maxima tie."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(c.src.numel(), heads)).astype(np.float32)
    v[::7] = v[1::7][: len(v[::7])]
    return v


def _rows(c, shape, seed):
    return np.random.default_rng(seed).normal(size=(c.n_rows, *shape)).astype(np.float32)


def _meta(jc, slots, v):
    """Single-head port values ``[nnz]`` as JAX's ``[n_chunk_meta, EB]`` slots."""
    return _to_slots(jc, slots, v).reshape(jc.n_chunk_meta, jc.eb)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------ the plain versions

@pytest.mark.parametrize("heads", HEADS)
def test_edges_to_rows_max_matches_jax(layouts, heads):
    """K6, max mode, exact; ``NEG`` on every row without edges."""
    jc, _, c, _, slots = layouts
    v = _edges(c, heads, 1)
    want = np.asarray(je._e2r_max_multi_d(True, jc, _to_slots(jc, slots, v)))
    got = tk.edges_to_rows_max(c, _t(v))
    np.testing.assert_array_equal(got.numpy(), want)
    empty = np.diff(c.indptr.numpy()) == 0
    assert empty.sum() >= 128 and (got[empty] == gat_csr.NEG).all()


@pytest.mark.parametrize("op", ["sum", "sum_all", "max"])
def test_single_head_edges_to_rows_matches_jax(layouts, op):
    """K10's row reduction in each mode (``sum_all`` is the sum: no padding slots)."""
    jc, _, c, _, slots = layouts
    v = _edges(c, 1, 2)[:, 0]
    want = np.asarray(je._edges_to_rows(jc, _meta(jc, slots, v), op, True))
    got = tk.edges_to_rows(c, _t(v), op)
    if op == "max":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got, want)
    with pytest.raises(ValueError, match="op"):
        tk.edges_to_rows(c, _t(v), "min")


@pytest.mark.parametrize("heads", HEADS)
def test_rows_to_edges_multi_matches_jax(layouts, heads):
    """K6′, exact."""
    jc, _, c, _, slots = layouts
    v = _rows(c, (heads,), 3)
    want = np.asarray(je._rows_to_edges_multi_impl(jc, jnp.asarray(v), True))
    got = tk.rows_to_edges_multi(c, _t(v))
    np.testing.assert_array_equal(got.numpy(), want[slots])


def test_single_head_rows_to_edges_matches_jax(layouts):
    """K10's rows-to-edges, exact; a 2-D argument is the multi-head op's."""
    jc, _, c, _, slots = layouts
    v = _rows(c, (), 4)
    want = np.asarray(je.rows_to_edges(jc, jnp.asarray(v), interpret=True))
    got = tk.rows_to_edges(c, _t(v))
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1)[slots])
    with pytest.raises(ValueError, match="1-D"):
        tk.rows_to_edges(c, _t(v)[:, None])


@pytest.mark.parametrize("f", [16, 64])
def test_sddmm_matches_jax(layouts, f):
    """K9 against ``sddmm_chunked_pallas``, ``sddmm_chunked_xla`` and ``sddmm_coo``."""
    jc, _, c, _, slots = layouts
    rng = np.random.default_rng(5)
    a = rng.normal(size=(c.n_rows, f)).astype(np.float32)
    msg = rng.normal(size=(c.src.numel(), f)).astype(np.float32)
    jmsg = _to_slots(jc, slots, msg)[: jc.n_chunk * jc.eb]
    want = np.asarray(jsd.sddmm_chunked_pallas(jc, jnp.asarray(a), jmsg, interpret=True))
    got = sddmm.sddmm_chunked(c, _t(a), _t(msg))
    _close(got, want.reshape(-1)[slots])
    _close(sddmm.sddmm_chunked_reference(c, _t(a), _t(msg)),
           np.asarray(jsd.sddmm_chunked_xla(jc, jnp.asarray(a), jmsg)).reshape(-1)[slots])
    # with msg = x[src], as both callers have it, K9 is the COO sddmm over A's edges
    x = rng.normal(size=(c.n_cols, f)).astype(np.float32)
    src, dst = c.src.numpy(), c.rows.numpy()
    coo = np.asarray(jax_sddmm_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(a),
                                   jnp.asarray(x)))
    _close(spmm.sddmm_coo(c.src, c.rows, _t(a), _t(x)), coo)
    _close(sddmm.sddmm_chunked(c, _t(a), _t(x[src])), coo)


@pytest.mark.parametrize("name", ["segment_max", "segment_min", "segment_mean",
                                  "segment_sum"])
def test_segment_ops_match_jax(name):
    """The segment oracles, with empty segments (0 in every op) and [E] or [E, H]."""
    rng = np.random.default_rng(6)
    ids = rng.integers(0, 40, 500)
    ids[ids >= 30] -= 10                      # segments 30..39 are empty
    for shape in ((500,), (500, 3)):
        data = rng.normal(size=shape).astype(np.float32)
        want = np.asarray(getattr(jseg, name)(jnp.asarray(data), jnp.asarray(ids), 40))
        got = getattr(segment, name)(_t(data), torch.from_numpy(ids), 40)
        assert got.shape == want.shape
        _close(got, want, err_msg=f"{name} {shape}")
        assert (got[30:] == 0).all()


# ------------------------------------------------------- the differentiable ops

def _vjp(jfn, x, cot):
    out, pull = jax.vjp(jfn, jnp.asarray(x))
    return np.asarray(out), np.asarray(pull(cot)[0])


def _torch_vjp(fn, x, cot):
    xt = _t(x).requires_grad_(True)
    out = fn(xt)
    out.backward(_t(cot))
    return out.detach(), xt.grad


def test_rows_to_edges_d_matches_jax(layouts):
    """``[n_rows] -> [nnz]``; the VJP is K10's ``sum_all``."""
    jc, _, c, _, slots = layouts
    v = _rows(c, (), 7)
    cot = np.random.default_rng(8).normal(size=c.src.numel()).astype(np.float32)
    want, jgrad = _vjp(lambda x: je.rows_to_edges_d(jc, x, True), v, _meta(jc, slots, cot))
    out, grad = _torch_vjp(lambda x: te.rows_to_edges_d(c, x), v, cot)
    np.testing.assert_array_equal(out.numpy(), want.reshape(-1)[slots])
    _close(grad, jgrad, 1e-4)


@pytest.mark.parametrize("heads", HEADS)
def test_rows_to_edges_multi_vjp_matches_jax(layouts, heads):
    """``[n_rows, H] -> [nnz, H]`` (K6′); the VJP is K6's ``sum_all``."""
    jc, _, c, _, slots = layouts
    v = _rows(c, (heads,), 9)
    cot = _edges(c, heads, 10)
    want, jgrad = _vjp(lambda x: je.rows_to_edges_multi(jc, x, True), v,
                       _to_slots(jc, slots, cot))
    out, grad = _torch_vjp(lambda x: te.rows_to_edges_multi(c, x), v, cot)
    np.testing.assert_array_equal(out.numpy(), want[slots])
    _close(grad, jgrad, 1e-4)


@pytest.mark.parametrize("heads", HEADS)
def test_edges_to_rows_sum_matches_jax(layouts, heads):
    """Row sums and their VJP: ``[nnz]`` (K10) for one head, ``[nnz, H]`` (K6,
    ``_e2r_sum_multi_d``) for eight."""
    jc, _, c, _, slots = layouts
    e = _edges(c, heads, 11)
    cot = _rows(c, (heads,), 12)
    if heads == 1:
        e, cot = e[:, 0], cot[:, 0]
        want, jgrad = _vjp(lambda x: je.edges_to_rows_sum(jc, x, True),
                           _meta(jc, slots, e), cot)
    else:
        want, jgrad = _vjp(lambda x: je._e2r_sum_multi_d(True, jc, x),
                           _to_slots(jc, slots, e), cot)
    out, grad = _torch_vjp(lambda x: te.edges_to_rows_sum(c, x), e, cot)
    _close(out, want)
    _close(grad, jgrad.reshape(-1, *cot.shape[1:])[slots], 1e-4)


@pytest.mark.parametrize("heads", HEADS)
def test_edges_to_rows_max_passes_no_gradient(layouts, heads):
    """The JAX op defines the max's gradient as zero; here none flows through it."""
    jc, _, c, _, slots = layouts
    e = _edges(c, heads, 13)
    if heads == 1:
        e = e[:, 0]
        want, jgrad = _vjp(lambda x: je.edges_to_rows_max(jc, x, True),
                           _meta(jc, slots, e), _rows(c, (), 14))
    else:
        want, jgrad = _vjp(lambda x: je._e2r_max_multi_d(True, jc, x),
                           _to_slots(jc, slots, e), _rows(c, (heads,), 14))
    assert not jgrad.any()
    out = te.edges_to_rows_max(c, _t(e).requires_grad_(True))
    np.testing.assert_array_equal(out.numpy(), want)
    assert not out.requires_grad


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("kind", ["fast", "multi"])
def test_edge_softmax_matches_jax(layouts, kind, heads):
    """The per-destination softmax from the kernels, per head (``fast``: K10) or
    all heads per launch (``multi``: K6 max, K6′, K6 sum), forward and VJP, against
    JAX's and against the plain segment-op version."""
    jc, _, c, _, slots = layouts
    s = _edges(c, heads, 15) * 3
    cot = _edges(c, heads, 16)
    jfn = getattr(je, f"edge_softmax_chunked_{kind}")
    tfn = getattr(te, f"edge_softmax_chunked_{kind}")
    want, jgrad = _vjp(lambda x: jfn(jc, x, True), _to_slots(jc, slots, s),
                       _to_slots(jc, slots, cot))
    out, grad = _torch_vjp(lambda x: tfn(c, x), s, cot)
    _close(out, want[slots])
    _close(grad, jgrad[slots], 1e-4)
    _close(out, sddmm.edge_softmax_chunked_heads(c, _t(s)).numpy())


def test_segment_softmax_versions_match_jax(layouts):
    """``edge_softmax_chunked`` ([nnz]) and ``edge_softmax_chunked_heads`` ([nnz, H]),
    the plain oracles of the kernel softmaxes."""
    jc, _, c, _, slots = layouts
    s = _edges(c, 8, 17) * 3
    want = np.asarray(jsd.edge_softmax_chunked_heads(jc, _to_slots(jc, slots, s)))
    _close(sddmm.edge_softmax_chunked_heads(c, _t(s)), want[slots])
    want1 = np.asarray(jsd.edge_softmax_chunked(jc, _meta(jc, slots, s[:, 0])))
    _close(sddmm.edge_softmax_chunked(c, _t(s[:, 0])), want1.reshape(-1)[slots])


# ------------------------------------------------------------- dispatch rules

def test_cpu_tensors_count_no_launch(layouts):
    """Every wrapper of this path runs its plain version on CPU tensors and counts
    nothing; the launchers refuse CPU tensors and another device raises."""
    _, _, c, _, _ = layouts
    e, v = torch.ones(c.src.numel(), 8), torch.ones(c.n_rows, 8)
    before = (dict(tk.launches), dict(tgf.launches))
    tk.edges_to_rows_max(c, e)
    tk.rows_to_edges_multi(c, v)
    tk.rows_to_edges(c, v[:, 0].contiguous())
    tk.edges_to_rows(c, e[:, 0].contiguous(), "max")
    tk.sddmm_edges(c, v, e)
    te.edge_softmax_chunked_multi(c, e.requires_grad_(True)).sum().backward()
    assert (dict(tk.launches), dict(tgf.launches)) == before
    with pytest.raises(ValueError, match="CUDA"):
        tk.edges_to_rows_max_cuda(c, e)
    with pytest.raises(ValueError, match="CUDA"):
        tk.sddmm_cuda(c, v, e)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tk.edges_to_rows_max(c, e.detach().to("meta"))


@pytest.mark.parametrize("fv,lanes", [(1, 1), (4, 4), (6, 4), (16, 16), (32, 32),
                                      (33, 32), (64, 32)])
def test_sddmm_lanes_per_edge(fv, lanes):
    """K9 gives each edge the largest power of two of lanes up to 32 and up to the
    row's load units, so that no lane is without work."""
    assert tk._lanes(fv) == lanes
