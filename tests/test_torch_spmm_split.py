"""K1's split of long rows: the segment schedule, and the two-pass sum it drives.

* ``split_schedule`` / ``ChunkedCSR.split`` on a graph with planted rows of degree
  0, 1, T-1, T, T+1, 2T, 2T+1 and 10T+3, an edgeless 128-row block and short random
  rows, for A and A^T of ``build_chunked_pair``: every edge lies in exactly one work
  item (a whole row or a segment), segments are contiguous, in edge order, at most T
  long, and rows of at most T edges are left whole.
* A plain PyTorch two-pass sum that follows the schedule as the kernel does (whole
  rows summed directly, each segment into an f32 partial row, the partials of a
  split row added in segment order, then bias and ReLU), against
  ``spmm_chunked_reference`` and the JAX package: ``spmm_chunked(interpret=True)``
  at F=128, ``spmm_coo`` + bias + ReLU at F=16 (where the JAX kernel does not
  apply), as ``tests/test_torch_spmm.py`` runs them; with the layout's columns,
  identity columns over edge-ordered messages and ``t_slot_perm`` columns on A^T.
* K1's lanes: the load width and the lane groups that narrow F uses.

Tolerance (f32): rtol 1e-5 and atol 1e-5 x max|ref|. The sides sum in different
orders and nothing else differs; the planted rows sum up to 5,123 terms, whose
rounding a fixed atol of 1e-5 (``tests/test_torch_spmm.py``'s, for rows of at most a
few hundred edges) does not cover where a sum cancels. The kernel is held to
1e-4 x max|ref| on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.ops.chunked import build_chunked_pair as jax_build_chunked_pair
from dgll_tpu.ops.pallas.segment_matmul import spmm_chunked as jax_spmm_chunked
from dgll_tpu.ops.spmm import spmm_coo as jax_spmm_coo
from dgll_tpu_torch.ops import build_chunked_pair, spmm_chunked_reference
from dgll_tpu_torch.ops.chunked import SPLIT_EDGES, split_schedule
from dgll_tpu_torch.ops.cuda.segment_matmul import _lane_groups, _vector_width

N = 600  # nodes; the layouts pad the row space to 640


def assert_close(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def planted_degrees(t: int) -> list:
    return [0, 1, t - 1, t, t + 1, 2 * t, 2 * t + 1, 10 * t + 3]


def planted_graph(t: int, seed: int = 0):
    """A's rows 0..7 have the planted in-degrees; half of row i's edges come from
    node N-1-i (so A^T has long rows too), half from nodes 256..399. Rows 300..591
    get short random rows from nodes 256..399, so rows 128..255 of A and of A^T have
    no edges. Returns (src, dst, weight) in a shuffled order."""
    rng = np.random.default_rng(seed)
    deg = planted_degrees(t)
    dst = np.repeat(np.arange(len(deg)), deg)
    src = np.where(np.arange(len(dst)) % 2 == 0, N - 1 - dst,
                   rng.integers(256, 400, len(dst)))
    extra = 3 * 292
    dst = np.concatenate([dst, rng.integers(300, N - 8, extra)])
    src = np.concatenate([src, rng.integers(256, 400, extra)])
    order = rng.permutation(len(dst))
    w = (rng.random(len(dst)) / 4).astype(np.float32)
    return src[order], dst[order], w[order]


def layouts(t: int):
    src, dst, w = planted_graph(t)
    return src, dst, w, build_chunked_pair(src, dst, N, N, w)


@pytest.mark.parametrize("t", [8, SPLIT_EDGES])
@pytest.mark.parametrize("which", ["A", "A^T"])
def test_schedule_covers_every_edge_once(t, which):
    _, _, _, (a, at) = layouts(t)
    lay = a if which == "A" else at
    sc = lay.split if t == SPLIT_EDGES else split_schedule(lay.indptr, t)
    indptr = lay.indptr.numpy().astype(np.int64)
    deg = np.diff(indptr)
    if which == "A":
        np.testing.assert_array_equal(deg[:8], planted_degrees(t))
    assert (deg[128:256] == 0).all()
    assert sc.max_edges == t and sc.n_seg >= 2 and (deg <= t).any()
    for name in ("seg_beg", "seg_end", "split_row", "split_ptr"):
        assert getattr(sc, name).dtype == torch.int32

    split_row = sc.split_row.numpy()
    np.testing.assert_array_equal(split_row, np.flatnonzero(deg > t))
    ptr = sc.split_ptr.numpy()
    beg, end = sc.seg_beg.numpy(), sc.seg_end.numpy()
    assert ptr[0] == 0 and ptr[-1] == sc.n_seg == len(beg) == len(end)
    np.testing.assert_array_equal(np.diff(ptr), -(-deg[split_row] // t))
    assert ((end - beg >= 1) & (end - beg <= t)).all()
    for i, r in enumerate(split_row):
        b, e = beg[ptr[i]:ptr[i + 1]], end[ptr[i]:ptr[i + 1]]
        # contiguous, in edge order, from the row's first edge to its last
        assert b[0] == indptr[r] and e[-1] == indptr[r + 1]
        np.testing.assert_array_equal(b[1:], e[:-1])
        assert (e[:-1] - b[:-1] == t).all()

    covered = np.zeros(lay.src.numel(), np.int64)
    for r in np.flatnonzero(deg <= t):  # whole rows
        covered[indptr[r]:indptr[r + 1]] += 1
    for b, e in zip(beg, end):
        covered[b:e] += 1
    assert (covered == 1).all()


def test_schedule_is_built_once_per_layout():
    """``ChunkedCSR.split`` is cached on the layout; a moved layout builds its own on
    its device, from the same ``indptr``."""
    _, _, _, (a, _) = layouts(8)
    assert a.split is a.split and a.split.max_edges == SPLIT_EDGES
    moved = a.to("cpu")
    assert moved.split is not a.split
    for name in ("seg_beg", "seg_end", "split_row", "split_ptr"):
        assert torch.equal(getattr(moved.split, name), getattr(a.split, name))


def two_pass_reference(c, x, sc, bias=None, activation=None, cols=None, weights=None):
    """The kernel's algorithm in plain PyTorch, f32: rows of at most ``sc.max_edges``
    edges summed directly, each segment into an f32 partial row, each split row's
    partials added in segment order, then the bias and ReLU."""
    cols = c.src if cols is None else cols
    weights = c.weight if weights is None else weights
    msg = x.index_select(0, cols).float() * weights[:, None]
    deg = (c.indptr[1:] - c.indptr[:-1]).long()
    rows = c.rows.long()
    whole = (deg <= sc.max_edges)[rows]
    out = torch.zeros(c.n_rows, x.shape[1]).index_add(0, rows[whole], msg[whole])
    lens = (sc.seg_end - sc.seg_beg).long()
    seg_of_edge = torch.repeat_interleave(torch.arange(sc.n_seg), lens)
    first = torch.repeat_interleave(sc.seg_beg.long(), lens)
    offset = torch.arange(len(first)) - torch.repeat_interleave(
        torch.cumsum(lens, 0) - lens, lens)
    partial = torch.zeros(sc.n_seg, x.shape[1]).index_add(0, seg_of_edge,
                                                           msg[first + offset])
    ptr = sc.split_ptr.tolist()
    for i, r in enumerate(sc.split_row.tolist()):
        acc = torch.zeros(x.shape[1])
        for p in range(ptr[i], ptr[i + 1]):
            acc = acc + partial[p]
        out[r] = acc
    if bias is not None:
        out = out + bias
    return torch.relu(out) if activation == "relu" else out


def jax_sum(src, dst, w, n_rows, n_cols, x, bias, activation):
    """The JAX package's ``act(A @ x + bias)`` for the COO edges (src -> dst, weight
    w): its chunked kernel in interpret mode where F % 128 == 0, else ``spmm_coo``."""
    f = x.shape[1]
    jb = None if bias is None else jnp.asarray(bias)
    if f % 128 == 0:
        jc, jct = jax_build_chunked_pair(src, dst, n_rows, n_cols, w, eb=128)
        out = jax_spmm_chunked(jc, jct, jnp.asarray(x), jb, activation, interpret=True)
        return np.asarray(out)[:n_rows]
    out = jax_spmm_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(x), n_rows,
                       jnp.asarray(w))
    if jb is not None:
        out = out + jb
    if activation == "relu":
        out = jnp.maximum(out, 0.0)
    return np.asarray(out)


@pytest.mark.parametrize("t", [8, SPLIT_EDGES])
@pytest.mark.parametrize("f", [16, 128])
@pytest.mark.parametrize("activation", [None, "relu"])
@pytest.mark.parametrize("columns", ["layout", "identity", "t_slot_perm"])
def test_two_pass_sum_matches_reference_and_jax(t, f, activation, columns):
    src, dst, w, (a, at) = layouts(t)
    rng = np.random.default_rng(f + t)
    bias = rng.normal(size=f).astype(np.float32) if activation else None
    tb = None if bias is None else torch.from_numpy(bias)
    if columns == "t_slot_perm":
        # per-edge messages in A's edge order summed onto A^T's rows with unit
        # weights (the GAT backward's scatter): edge e of A lands on its source
        c, sc = at, split_schedule(at.indptr, t)
        msg = rng.normal(size=(a.src.numel(), f)).astype(np.float32)
        kw = dict(cols=a.t_slot_perm, weights=at.unit_weight)
        jsrc, jdst = np.arange(a.src.numel()), a.src.numpy()
        jw, n_cols = np.ones(a.src.numel(), np.float32), a.src.numel()
    else:
        c, sc = a, split_schedule(a.indptr, t)
        x = rng.normal(size=(N, f)).astype(np.float32)
        jsrc, jdst, jw, n_cols = src, dst, w, N
        if columns == "identity":  # x's rows gathered into A's edge order
            msg = x[a.src.numpy()]
            kw = dict(cols=a.edge_ids, weights=a.weight)
        else:
            msg, kw = x, {}
    got = two_pass_reference(c, torch.from_numpy(msg), sc, tb, activation, **kw)
    ref = spmm_chunked_reference(c, torch.from_numpy(msg), tb, activation, **kw)
    assert got.shape == ref.shape == (c.n_rows, f)
    assert_close(got.numpy(), ref.numpy())
    # padded and edgeless rows are act(bias) exactly
    expect = torch.zeros(f) if tb is None else (torch.relu(tb) if activation else tb)
    assert torch.equal(got[128:256], expect.expand(128, f))
    jx = x if columns != "t_slot_perm" else msg
    want = jax_sum(jsrc, jdst, jw, N, n_cols, jx, bias, activation)
    assert_close(got[:N].numpy(), want)


@pytest.mark.parametrize("dtype,f,vec,log_g", [
    (torch.float32, 128, 4, 5), (torch.float32, 256, 4, 5), (torch.float32, 64, 4, 4),
    (torch.float32, 48, 4, 4), (torch.float32, 16, 4, 2), (torch.float32, 33, 1, 5),
    (torch.bfloat16, 128, 8, 4), (torch.bfloat16, 16, 8, 1),
])
def test_lane_groups(dtype, f, vec, log_g):
    """K1's loads are 16 bytes where F and the pointer allow, whatever F; a group of
    2^log_g lanes covers F / vec columns (at most a warp), so at F=16 in f32 a warp
    sums 8 edges at a time on 4 lanes each."""
    x = torch.zeros(4, f, dtype=dtype)
    assert _vector_width(x, f) == vec
    assert _lane_groups(f, vec) == log_g
