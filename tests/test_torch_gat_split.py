"""K3's and K5's split of long rows and their lane mapping, on the CPU.

The kernels (``csrc/gat_csr.cu``) take the layout's split schedule (``c.split``, the
one K1 runs on): a lane group a row of at most T edges and a lane group a segment of
a longer row; a second pass combines a split row's per-segment partials in segment
order.
For H a power of two up to 32 a group of lanes (``item_lanes``) reads a row's
``[deg, H]`` block its width of floats at a time, lane j holding head j % H; other H
take a warp an item and one pass a head.

* Plain PyTorch versions of K3 and K5 that follow the schedule and the lanes as the
  kernels do (each lane's values in edge order, the xor-shuffle tree, K3's segment
  maxima combined and their sums rescaled to the row's max, K5's partials added in
  segment order), on the planted graph of ``tests/test_torch_spmm_split.py`` (rows of
  degree 0, 1, T-1, T, T+1, 2T, 2T+1 and 10T+3, an edgeless 128-row block) at T=8
  and T=512, H in {1, 3, 8}, against ``gat_stats_reference`` /
  ``gat_bwd_softmax_reference`` and JAX's ``gat_stats`` / ``gat_bwd_softmax`` in
  interpret mode (128-slot chunks, as ``tests/test_torch_gat.py`` runs them).
* ``heads_across_lanes`` and ``item_lanes``, the wrappers' choice of lane mapping.

Tolerance (f32): the row max m is exact (a max does not round); den, dz and dsd
within rtol 1e-5 and atol 1e-5 x max|ref| (the sides sum in different orders, over up
to 5,123 terms a row). The kernels are held to the same on the card by
``chip_smoke.py`` (1e-4 x max|ref|, m exact).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.ops.chunked import R_BLOCK
from dgll_tpu.ops.chunked import build_chunked_pair as jax_build_chunked_pair
from dgll_tpu.ops.pallas.gat_fused import gat_bwd_softmax, gat_stats
from dgll_tpu_torch.ops import build_chunked_pair, gat_csr
from dgll_tpu_torch.ops.chunked import SPLIT_EDGES, split_schedule
from dgll_tpu_torch.ops.cuda import gat_fused as tgf
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)
from test_torch_gat import _to_slots
from test_torch_spmm_split import N, assert_close, planted_degrees, planted_graph

HEADS = [1, 3, 8]
SLOPE = 0.2


@functools.cache
def graph(t: int):
    """(JAX layout, port layout, slots) of the planted graph, unweighted: JAX slot
    ``slots[k]`` holds the port's edge ``k``."""
    src, dst, _ = planted_graph(t)
    jc, c, slots = layouts_of(src, dst)
    np.testing.assert_array_equal(np.diff(c.indptr.numpy())[:8], planted_degrees(t))
    return jc, c, slots


def layouts_of(src, dst):
    """(JAX layout, port layout, slots) of the unweighted edges ``src -> dst`` over
    ``N`` nodes."""
    jc, _ = jax_build_chunked_pair(src, dst, N, N, None, eb=128)
    c, _ = build_chunked_pair(src, dst, N, N)
    nc = jc.n_chunk
    dst_g = (np.asarray(jc.row_block)[:nc, None] * R_BLOCK
             + np.asarray(jc.dst_local)[:nc]).reshape(-1)
    src_g = np.asarray(jc.src)[:nc].reshape(-1)
    valid = np.flatnonzero(np.asarray(jc.weight)[:nc].reshape(-1) != 0)
    slots = valid[np.lexsort((src_g[valid], dst_g[valid]))]
    np.testing.assert_array_equal(c.rows.numpy(), dst_g[slots])
    np.testing.assert_array_equal(c.src.numpy(), src_g[slots])
    return jc, c, slots


def group_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """One lane group's max or sum of an item's ``[deg, H]`` block as the kernels take
    it: ``[H]``. Heads across lanes, in a group of L = ``item_lanes(H)`` lanes: lane j
    holds the block's flat values j, j + L, ... (head j % H, as L is a multiple of H)
    and reduces them in order; the xor-shuffles with offsets L/2 down to H meet a
    head's lanes, and lanes 0..H-1 hold heads 0..H-1. Otherwise a warp, a pass a
    head: lane j holds edges j, j + 32, ..., and offsets 16 down to 1 meet the warp in
    lane 0."""
    heads = x.shape[1]
    ident, comb = (gat_csr.NEG, torch.maximum) if op == "max" else (0.0, torch.add)
    across = tgf.heads_across_lanes(heads)
    group = tgf.item_lanes(heads)
    passes = [x.reshape(-1)] if across else [x[:, h] for h in range(heads)]
    span = heads if across else 1
    out = []
    for v in passes:
        lanes = torch.cat([v, v.new_full((-v.numel() % group,), ident)]).view(-1, group)
        acc = torch.full((group,), ident)
        for step in lanes:
            acc = comb(acc, step)
        o = group // 2
        while o >= span:
            acc = comb(acc, acc[torch.arange(group) ^ o])
            o >>= 1
        out.append(acc[:span])
    return torch.cat(out)


def items(c, sp):
    """Pass 1's work items as ``(segment or None, row, beg, end)``: the segments,
    then the rows of at most ``sp.max_edges`` edges."""
    indptr, rows = c.indptr.tolist(), c.rows.tolist()
    for s, (b, e) in enumerate(zip(sp.seg_beg.tolist(), sp.seg_end.tolist())):
        yield s, rows[b], b, e
    for r in range(c.n_rows):
        if indptr[r + 1] - indptr[r] <= sp.max_edges:
            yield None, r, indptr[r], indptr[r + 1]


def split_rows(sp):
    ptr = sp.split_ptr.tolist()
    return [(r, range(ptr[i], ptr[i + 1])) for i, r in enumerate(sp.split_row.tolist())]


def stats_split(c, sp, sc_src, s_dst):
    """K3 as the kernel computes it: ``(m, den)``."""
    h = sc_src.shape[1]
    e = gat_csr.leaky_relu(sc_src + s_dst.index_select(0, c.rows), SLOPE)
    m, den = torch.empty(c.n_rows, h), torch.empty(c.n_rows, h)
    m_seg, den_seg = torch.empty(sp.n_seg, h), torch.empty(sp.n_seg, h)
    for seg, row, b, end in items(c, sp):
        mx = group_reduce(e[b:end], "max")
        s = group_reduce(torch.exp(e[b:end] - mx), "sum")
        if seg is None:
            m[row], den[row] = mx, s
        else:
            m_seg[seg], den_seg[seg] = mx, s
    for row, segs in split_rows(sp):  # pass 2: rescaled to the row's max, in order
        mx = m_seg[segs.start:segs.stop].amax(0)
        s = torch.zeros(h)
        for p in segs:
            s = s + den_seg[p] * torch.exp(m_seg[p] - mx)
        m[row], den[row] = mx, s
    return m, den


def bwd_softmax_split(c, sp, alpha, dalpha, lgrad, s_row):
    """K5 as the kernel computes it: ``(dz, dsd)``."""
    h = alpha.shape[1]
    dz = alpha * (dalpha - s_row.index_select(0, c.rows)) * lgrad
    dsd, partial = torch.empty(c.n_rows, h), torch.empty(sp.n_seg, h)
    for seg, row, b, end in items(c, sp):
        if seg is None:
            dsd[row] = group_reduce(dz[b:end], "sum")
        else:
            partial[seg] = group_reduce(dz[b:end], "sum")
    for row, segs in split_rows(sp):  # pass 2: the partials in segment order
        s = torch.zeros(h)
        for p in segs:
            s = s + partial[p]
        dsd[row] = s
    return dz, dsd


def schedule(c, t):
    sp = c.split if t == SPLIT_EDGES else split_schedule(c.indptr, t)
    assert sp.max_edges == t and sp.n_seg > sp.n_split >= 4
    return sp


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("t", [8, SPLIT_EDGES])
def test_stats_split_matches_reference_and_jax(t, heads):
    jc, c, slots = graph(t)
    rng = np.random.default_rng(t + heads)
    sc = (rng.normal(size=(c.src.numel(), heads)) * 2).astype(np.float32)
    sd = (rng.normal(size=(c.n_rows, heads)) * 2).astype(np.float32)
    m, den = stats_split(c, schedule(c, t), torch.from_numpy(sc), torch.from_numpy(sd))
    m_ref, den_ref = gat_csr.gat_stats_reference(c, torch.from_numpy(sc),
                                                 torch.from_numpy(sd), SLOPE)
    assert torch.equal(m, m_ref)
    assert_close(den.numpy(), den_ref.numpy())
    jm, jden = gat_stats(jc, _to_slots(jc, slots, sc), jnp.asarray(sd), SLOPE,
                         interpret=True)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert_close(den.numpy(), np.asarray(jden))
    # rows without edges, the planted degree-0 row among them
    empty = np.diff(c.indptr.numpy()) == 0
    assert empty[0] and empty[128:256].all()
    assert (m[empty] == gat_csr.NEG).all() and (den[empty] == 0).all()


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("t", [8, SPLIT_EDGES])
def test_bwd_softmax_split_matches_reference_and_jax(t, heads):
    jc, c, slots = graph(t)
    rng = np.random.default_rng(10 + t + heads)
    nnz = c.src.numel()
    alpha = (np.abs(rng.normal(size=(nnz, heads))) / 4).astype(np.float32)
    dalpha = rng.normal(size=(nnz, heads)).astype(np.float32)
    lgrad = np.where(rng.random((nnz, heads)) > 0.5, 1.0, SLOPE).astype(np.float32)
    s = rng.normal(size=(c.n_rows, heads)).astype(np.float32)
    args = tuple(map(torch.from_numpy, (alpha, dalpha, lgrad, s)))
    dz, dsd = bwd_softmax_split(c, schedule(c, t), *args)
    dz_ref, dsd_ref = gat_csr.gat_bwd_softmax_reference(c, *args)
    assert torch.equal(dz, dz_ref)  # per edge, the same arithmetic
    assert_close(dsd.numpy(), dsd_ref.numpy())
    jdz, jdsd = gat_bwd_softmax(jc, *(_to_slots(jc, slots, x) for x in (alpha, dalpha, lgrad)),
                                jnp.asarray(s), interpret=True)
    assert_close(dz.numpy(), np.asarray(jdz)[slots])
    assert_close(dsd.numpy(), np.asarray(jdsd))
    assert (dsd[np.diff(c.indptr.numpy()) == 0] == 0).all()


@pytest.mark.parametrize("heads,across,lanes", [
    (1, True, 8), (2, True, 16), (3, False, 32), (4, True, 32), (6, False, 32),
    (8, True, 32), (16, True, 32), (32, True, 32), (64, False, 32),
])
def test_heads_across_lanes(heads, across, lanes):
    """Heads across lanes where a lane group holds whole heads (H a power of two up
    to 32: a lane's head stays j % H from one step to the next), in groups of 8 edges
    a step; a warp an item, one pass a head, otherwise."""
    assert tgf.heads_across_lanes(heads) is across
    assert tgf.item_lanes(heads) == lanes


@pytest.mark.parametrize("heads", [2, 8])
def test_lanes_of_one_head_hold_one_head(heads):
    """The kernels' across mapping: lane j reads head j % H in every step of a row's
    block, so after the xor-shuffles lane h < H holds head h alone; an empty item
    gives the identity."""
    c = torch.arange(5 * heads, dtype=torch.float32).view(5, heads)
    onehot = (torch.arange(heads)[None, :] == 1).float().expand(7, -1)
    assert torch.equal(group_reduce(onehot, "sum"), 7 * (torch.arange(heads) == 1).float())
    assert torch.equal(group_reduce(c, "max"), c[-1])
    assert torch.equal(group_reduce(c[:0], "max"), torch.full((heads,), gat_csr.NEG))


def test_launchers_take_cuda_tensors_only():
    """A CPU tensor never reaches a launcher: it raises, and the wrappers run the
    plain version without counting a launch."""
    _, c, _ = graph(8)
    sc, rows = torch.ones(c.src.numel(), 8), torch.ones(c.n_rows, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tgf.gat_stats_cuda(c, sc, rows)
    with pytest.raises(ValueError, match="CUDA"):
        tgf.gat_bwd_softmax_cuda(c, sc, sc, sc, rows)
    before = dict(tgf.launches)
    tgf.gat_stats(c, sc, rows)
    tgf.gat_bwd_softmax(c, sc, sc, sc, rows)
    assert tgf.launches == before


def test_with_split_cuts_only_the_copy():
    """The profiling tool's threshold sweep: a copy of the layout whose own schedule
    cuts at T, built from the same indptr; the layout it copies keeps its schedule."""
    from dgll_tpu_torch.tools.profile_slice import with_split

    _, c, _ = graph(8)
    lay = with_split(c, 8)
    assert lay is not c and lay.indptr is c.indptr
    assert lay.split.max_edges == 8 and c.split.max_edges == SPLIT_EDGES
    want = split_schedule(c.indptr, 8)
    for name in ("seg_beg", "seg_end", "split_row", "split_ptr"):
        assert torch.equal(getattr(lay.split, name), getattr(want, name))
