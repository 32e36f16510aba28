"""K1's bfloat16 route on the CPU: its plan, its route choice, and its mapping.

The route's kernel (``csrc/segment_matmul.cu``, ``spmm_bf16_kernel``) runs only on
the card, where ``chip_smoke.py`` phase 23 holds it against its plain version and
the float64 sum. Here, on a power-law graph with hub rows above 512 edges (split
into segments), an edgeless 128-row block and the padded rows:

* ``item_schedule`` / ``ChunkedCSR.items`` with ``split_schedule``: every row lies in
  one run or is split, and every edge in exactly one work item (a run or a segment),
  in the layout's order; a run holds at most ``max_rows`` rows and fewer than
  ``window + max_edges`` edges; at the layout's own settings and at small ones
  (window 16, 8 rows a run), where runs end at every kind of boundary.
* a Python model of the kernel's mapping, fed the plan (a warp's item cut into
  32 / G equal sub-ranges, each group's walk in edge order storing the rows it holds
  whole, the fragments of a row that crosses sub-ranges added in sub-range order by
  the group where it ends, the segments' partials added in order by pass 2), for
  every lane grouping (G = 1 .. 32) with identity columns, ``t_slot_perm`` columns on
  A^T and the layout's own columns and weights: every edge summed once and every row
  stored once; every row's summation depth at most ``min(n, 512) + n_seg``, the depth
  that phase 23's ``_bf16_sum_bound`` allows; the sums within that depth's bound of
  the float64 sum, and within rtol 1e-5, atol 1e-5 x max|ref| of
  ``spmm_chunked_reference`` (f32 sums in another order).
* ``k1_route``: the kernel, the load width, the lane groups and the column and
  weight kinds for each dtype, width (16, 64, 12), alignment and kind.
* ``ChunkedCSR.to`` carries the schedules it has built.
"""
import numpy as np
import pytest
import torch

from dgll_tpu_torch.ops import build_chunked_pair, spmm_chunked_reference
from dgll_tpu_torch.ops.chunked import (ITEM_EDGES, ITEM_ROWS, SPLIT_EDGES, ChunkedCSR,
                                        item_schedule)
from dgll_tpu_torch.ops.cuda.segment_matmul import K1Route, _lane_groups, k1_route

N = 1500     # nodes; the layouts pad the row space to 1536
EDGES = 20_000
F = 16
U = 2.0 ** -24  # float32's unit roundoff


def power_law_graph(seed: int = 0):
    """In-degrees falling as 1 / (rank + 1), so rows 0.. hold up to ~2,500 edges
    (several above 512); half the sources likewise from node N-1 down, so that A^T
    has such rows too; rows 512..639 of A have no edges. (src, dst, weight)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / (np.arange(N) + 1.0)
    dst = rng.choice(N, size=EDGES, p=p / p.sum())
    src = np.where(rng.random(EDGES) < 0.5, N - 1 - rng.choice(N, size=EDGES, p=p / p.sum()),
                   rng.integers(0, N, EDGES))
    keep = ~((dst >= 512) & (dst < 640))
    w = rng.random(EDGES).astype(np.float32)
    return src[keep], dst[keep], w[keep]


@pytest.fixture(scope="module")
def layouts():
    src, dst, w = power_law_graph()
    return build_chunked_pair(src, dst, N, N, w)


def with_plan(c: ChunkedCSR, window: int, max_rows: int) -> ChunkedCSR:
    """A copy of ``c`` whose runs are cut at ``window`` edges and ``max_rows`` rows."""
    lay = ChunkedCSR(c.indptr, c.src, c.weight, c.rows, c.n_rows, c.n_cols, c.t_slot_perm)
    lay.items = item_schedule(lay.indptr, lay.split.max_edges, window, max_rows)
    return lay


PLANS = {"layout's": None, "small": (16, 8)}


def plan_layout(c, plan):
    return c if PLANS[plan] is None else with_plan(c, *PLANS[plan])


# ------------------------------------------------------------------ the plan

@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("which", ["A", "A^T"])
def test_plan_covers_every_edge_once(layouts, plan, which):
    lay = plan_layout(layouts[0] if which == "A" else layouts[1], plan)
    window, max_rows = PLANS[plan] or (ITEM_EDGES, ITEM_ROWS)
    ip = lay.indptr.numpy().astype(np.int64)
    deg = np.diff(ip)
    sc, it = lay.split, lay.items
    assert (deg > SPLIT_EDGES).sum() >= 2 and (deg == 0).sum() >= (
        128 + 36 if which == "A" else 36)
    assert it.max_rows == max_rows <= ITEM_ROWS
    beg, end = it.item_beg.numpy().astype(np.int64), it.item_end.numpy().astype(np.int64)
    split_row = sc.split_row.numpy().astype(np.int64)
    # runs in row order, none empty, none holding a split row, at most max_rows rows
    assert (beg < end).all() and (end[:-1] <= beg[1:]).all()
    assert (end - beg <= max_rows).all()
    rows = np.zeros(lay.n_rows, np.int64)
    for b, e in zip(beg, end):
        rows[b:e] += 1
        assert ip[e] - ip[b] < window + SPLIT_EDGES
        assert len(set(ip[b:e] // window)) == 1  # the run's rows begin in one window
    rows[split_row] += 1
    np.testing.assert_array_equal(rows, 1)
    # work items' edge ranges, segments first as in the kernel's grid, then the runs
    ranges = [(int(b), int(e)) for b, e in zip(sc.seg_beg.numpy(), sc.seg_end.numpy())]
    ranges += [(int(ip[b]), int(ip[e])) for b, e in zip(beg, end)]
    edges = np.zeros(ip[-1], np.int64)
    for b, e in ranges:
        edges[b:e] += 1
    np.testing.assert_array_equal(edges, 1)
    if plan == "small":  # runs end at a window, at max_rows rows and before split rows
        full = end - beg == max_rows
        assert full.any() and (~full).sum() > len(split_row)


def test_plan_is_built_once_per_layout(layouts):
    c = layouts[0]
    assert c.items is c.items
    moved = c.to("cpu")
    assert "items" in moved.__dict__ and "split" in moved.__dict__
    for got, want in ((moved.items.item_beg, c.items.item_beg),
                      (moved.items.item_end, c.items.item_end),
                      (moved.split.seg_beg, c.split.seg_beg)):
        assert torch.equal(got, want)
    fresh = ChunkedCSR(c.indptr, c.src, c.weight, c.rows, c.n_rows, c.n_cols)
    assert "items" not in fresh.to("cpu").__dict__


# ------------------------------------------------------------------ the mapping

def _add(s, ds, v, dv):
    """``s + v`` in float32 with its summation depth (roundings on the longest path
    from a term; a sum of no terms has depth -1, and adding to it is exact)."""
    return (s + v).astype(np.float32), dv if ds < 0 else max(ds, dv) + 1


def mapping_model(c: ChunkedCSR, x: np.ndarray, log_g: int, cols=None, weights=None):
    """The bfloat16 route's sums as the kernel forms them on ``c``'s plan:
    ``(sums [n_rows, F] float32 before bias and activation, depth [n_rows], the times
    each edge was summed, the times each row was stored)``."""
    ip = c.indptr.numpy().astype(np.int64)
    nnz, n_rows, f = int(ip[-1]), c.n_rows, x.shape[1]
    src = np.arange(nnz) if cols is None else cols.numpy().astype(np.int64)
    w = np.ones(nnz, np.float32) if weights is None else weights.numpy()
    vals = (w[:, None] * x[src]).astype(np.float32)
    groups = 32 >> log_g
    sums = np.zeros((n_rows, f), np.float32)
    depth = np.full(n_rows, -1)
    summed, stored = np.zeros(nnz, np.int64), np.zeros(n_rows, np.int64)
    sc, it = c.split, c.items
    partial, pdepth = np.zeros((sc.n_seg, f), np.float32), np.zeros(sc.n_seg, np.int64)

    def warp(ptr, store):
        n_local, e0, e1 = len(ptr) - 1, ptr[0], ptr[-1]
        for i in range(n_local):  # rows without edges
            if ptr[i] == ptr[i + 1]:
                store(i, np.zeros(f, np.float32), -1)
        span = -(-(e1 - e0) // groups)
        frags, heads = {}, []
        for g in range(groups):
            s0 = min(e0 + g * span, e1)
            s1 = min(s0 + span, e1)
            if s0 >= s1:
                continue
            i = int(np.searchsorted(ptr, s0, side="right")) - 1
            is_open = ptr[i] < s0
            acc, d = np.zeros(f, np.float32), -1
            for e in range(s0, s1):
                acc, d = _add(acc, d, vals[e], 0)
                summed[e] += 1
                if e + 1 == ptr[i + 1]:
                    if is_open:
                        heads.append((g, i, acc, d))
                        is_open = False
                    else:
                        store(i, acc, d)
                    acc, d = np.zeros(f, np.float32), -1
                    i += 1
                    while i < n_local and ptr[i + 1] == ptr[i]:
                        i += 1
            if i < n_local and ptr[i] < s1:
                frags[g] = (acc, d)
        for g, i, head, dh in heads:
            s, d = np.zeros(f, np.float32), -1
            for q in range((ptr[i] - e0) // span, g):
                s, d = _add(s, d, *frags[q])
            store(i, *_add(s, d, head, dh))

    for k, (b, e) in enumerate(zip(sc.seg_beg.numpy(), sc.seg_end.numpy())):
        def seg_store(i, s, d, k=k):
            partial[k], pdepth[k] = s, d
        warp(np.array([b, e], np.int64), seg_store)
    for b, e in zip(it.item_beg.numpy(), it.item_end.numpy()):
        def row_store(i, s, d, b=int(b)):
            sums[b + i], depth[b + i] = s, d
            stored[b + i] += 1
        warp(ip[b:e + 1], row_store)
    split_ptr = sc.split_ptr.numpy()
    for j, r in enumerate(sc.split_row.numpy()):  # pass 2
        s, d = np.zeros(f, np.float32), -1
        for p in range(split_ptr[j], split_ptr[j + 1]):
            s, d = _add(s, d, partial[p], pdepth[p])
        sums[r], depth[r] = s, d
        stored[r] += 1
    return sums, depth, summed, stored


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("log_g", range(6))
@pytest.mark.parametrize("columns", ["identity", "t_slot_perm", "layout"])
def test_mapping_sums_in_bounded_depth(layouts, plan, log_g, columns):
    a, at = layouts
    nnz = a.src.numel()
    rng = np.random.default_rng(log_g)
    msg = torch.from_numpy(rng.normal(size=(nnz, F)).astype(np.float32)).to(torch.bfloat16)
    if columns == "identity":
        lay, cols, weights, x = a, None, None, msg
    elif columns == "t_slot_perm":
        lay, cols, weights, x = at, a.t_slot_perm, None, msg
    else:  # GCN's A under msg_dtype=bf16: the layout's columns and weights
        lay, weights = a, a.weight
        cols, x = a.src, msg[:N]
    lay = plan_layout(lay, plan)
    xf = x.float().numpy()
    sums, depth, summed, stored = mapping_model(lay, xf, log_g, cols, weights)
    np.testing.assert_array_equal(summed, 1)
    np.testing.assert_array_equal(stored, 1)

    ip = lay.indptr.numpy().astype(np.int64)
    deg, t = np.diff(ip), SPLIT_EDGES
    n_seg = np.where(deg > t, -(-deg // t), 0)
    assert (depth <= np.minimum(deg, t) + n_seg).all()

    idx = np.arange(nnz) if cols is None else cols.numpy().astype(np.int64)
    w = np.ones(nnz) if weights is None else weights.numpy().astype(np.float64)
    terms = w[:, None] * xf.astype(np.float64)[idx]
    rows = lay.rows.numpy().astype(np.int64)
    exact, absum = np.zeros((lay.n_rows, F)), np.zeros((lay.n_rows, F))
    np.add.at(exact, rows, terms)
    np.add.at(absum, rows, np.abs(terms))
    # terms w * x round once in the model (the kernel's fmaf rounds its product and
    # sum once): one more rounding a term, except with unit weights, where w * x is x
    extra = 0 if weights is None else 1
    bound = (np.maximum(depth, 0) + extra)[:, None] * 1.0001 * U * absum
    assert (np.abs(sums - exact) <= bound).all()

    want = spmm_chunked_reference(lay, x.float(), cols=cols if cols is not None
                                  else lay.edge_ids,
                                  weights=weights if weights is not None
                                  else lay.unit_weight).numpy()
    np.testing.assert_allclose(sums, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_a_row_crosses_sub_ranges_and_runs(layouts):
    """The small plan's runs and the widest grouping leave rows of the test graph
    that cross several sub-ranges of one warp, and runs whose last sub-ranges are
    empty (fewer edges than groups)."""
    lay = plan_layout(layouts[0], "small")
    ip = lay.indptr.numpy().astype(np.int64)
    it = lay.items
    spans = ip[it.item_end.numpy()] - ip[it.item_beg.numpy()]
    assert (spans < 32).any() and (spans == 0).any()
    crossing = 0
    for b, e in zip(it.item_beg.numpy(), it.item_end.numpy()):
        e0, e1 = ip[b], ip[e]
        span = -(-(e1 - e0) // 32)
        if span:
            first, last = (ip[b:e] - e0) // span, (ip[b + 1:e + 1] - 1 - e0) // span
            crossing = max(crossing, int((last - first).max()))
    assert crossing >= 2


# ------------------------------------------------------------------ the route

BF16 = torch.bfloat16


@pytest.mark.parametrize("dtype,f,offset,identity,unit,want", [
    (torch.float32, 16, 0, True, True, K1Route("float32", 4, 2, False, False)),
    (torch.float32, 64, 0, False, False, K1Route("float32", 4, 4, False, False)),
    (torch.float32, 12, 0, True, True, K1Route("float32", 4, 2, False, False)),
    (torch.float32, 16, 1, False, False, K1Route("float32", 1, 4, False, False)),
    (BF16, 16, 0, True, True, K1Route("bfloat16", 8, 1, True, True)),
    (BF16, 64, 0, True, True, K1Route("bfloat16", 8, 3, True, True)),
    (BF16, 12, 0, True, True, K1Route("bfloat16", 4, 2, True, True)),
    (BF16, 16, 1, True, True, K1Route("bfloat16", 1, 4, True, True)),
    (BF16, 64, 1, False, True, K1Route("bfloat16", 1, 5, False, True)),
    (BF16, 16, 4, True, False, K1Route("bfloat16", 4, 2, True, False)),
    (BF16, 128, 0, False, False, K1Route("bfloat16", 8, 4, False, False)),
    (BF16, 256, 2, False, False, K1Route("bfloat16", 2, 5, False, False)),
])
def test_k1_route(dtype, f, offset, identity, unit, want):
    """16 bytes a lane where F and the pointer allow, else narrower; bfloat16 input
    takes its own route, with the caller's column and weight kinds as its cases; the
    float32 route loads them."""
    x = torch.empty(64 * f + offset, dtype=dtype)[offset:].view(64, f)
    got = k1_route(x, identity, unit)
    assert got == want
    assert got.log_g == _lane_groups(f, got.vec)


def test_k1_route_refuses_other_dtypes():
    with pytest.raises(ValueError, match="dtype"):
        k1_route(torch.empty(4, 16, dtype=torch.float16))
