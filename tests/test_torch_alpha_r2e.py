"""K4 (``gat_alpha``) and K6′ (``rows_to_edges_multi``) on their edge-major mapping,
on the CPU.

Both kernels (``csrc/gat_csr.cu``: ``edges_heads4_kernel``, ``edges_quads_kernel``,
``edges_one_kernel``, with K4's ``AlphaOp`` or K6′'s ``GatherOp``) carry per-row
values ``[n_rows, H]`` out to the edges ``[nnz, H]`` through the layout's rows. The
wrappers pick the variant with ``gat_fused.edge_plan``: float4 units of 4 heads of
an edge (H % 4 == 0, per-edge and per-row arrays 16-byte aligned), of 4 edges at
H = 1 (rows and per-edge arrays aligned; block 0 takes the last nnz % 4 edges), or
an edge a unit; consecutive threads take consecutive units, and the grid strides
over them.

* A plain Python model of those loops, fed the wrapper's own variant choice, for H
  in {1, 2, 3, 4, 8, 16}, nnz % 4 in {0, 1, 2, 3}, every pointer aligned or one of
  them misaligned, and forced small grids (so that the stride loops turn): every
  (edge, head) is computed exactly once, and a thread loads the row ids of its
  units once.
* K4's plain version against JAX's ``gat_alpha`` in interpret mode (as
  ``tests/test_torch_gat.py`` runs it) at H in {1, 3, 8} on the planted graph of
  ``tests/test_torch_spmm_split.py`` (rows of up to 5,123 edges, an edgeless 128-row
  block), both given JAX's ``gat_stats`` of the same scores: alpha within rtol 1e-6
  and atol 1e-6 x max|ref| (each side takes one exp and one reciprocal a value; the
  sides' exp may differ by an ulp), lgrad exactly equal (a compare and a select on
  the same float32 sum).
* K6′'s plain version against JAX's ``rows_to_edges_multi`` (interpret) at H in
  {2, 3, 8}, exactly equal (a copy).
* The launchers take CUDA tensors only; on CPU tensors the dispatching wrappers run
  the plain versions and count no launch.

The kernels are held on the card by ``chip_smoke.py``: K4 within 1e-4 x max|ref|
with lgrad exactly equal, K6′ exactly equal, both bitwise repeatable.
"""
import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.ops.pallas import edge_ops as je
from dgll_tpu.ops.pallas.gat_fused import gat_alpha as jax_gat_alpha
from dgll_tpu.ops.pallas.gat_fused import gat_stats as jax_gat_stats
from dgll_tpu_torch.ops import gat_csr
from dgll_tpu_torch.ops.chunked import SPLIT_EDGES
from dgll_tpu_torch.ops.cuda import edge_ops as tk
from dgll_tpu_torch.ops.cuda import gat_fused as tgf
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)
from test_torch_gat import _to_slots
from test_torch_gat_split import SLOPE, graph

MAP_HEADS = [1, 2, 3, 4, 8, 16]
N_ROWS = 37


def thread_values(nnz: int, heads: int, plan: tgf.EdgePlan):
    """Each thread of the plan's grid as the kernels run it: ``(values, loads)``, the
    (edge, head) pairs it computes in order and the edges whose row id it loads."""
    threads = plan.grid * tgf.EDGE_THREADS
    if plan.vec == 4 and heads == 1:      # edges_quads_kernel: 4 edges a unit
        units = nnz // 4

        def unit(u):
            return [(4 * u + k, 0) for k in range(4)]
    elif plan.vec == 4:                   # edges_heads4_kernel: heads 4j..4j+3 of u // G
        g = heads // 4
        units = nnz * g

        def unit(u):
            return [(u // g, 4 * (u % g) + k) for k in range(4)]
    else:                                 # edges_one_kernel: an edge, all heads
        units = nnz

        def unit(u):
            return [(u, h) for h in range(heads)]
    out = []
    for t in range(threads):
        values, loads = [], []
        for u in range(t, units, threads):
            values += unit(u)
            loads += sorted({e for e, _ in unit(u)})  # the unit's row ids, once
        if plan.vec == 4 and heads == 1 and t < nnz % 4:  # block 0: the last edges
            values.append((4 * units + t, 0))
            loads.append(4 * units + t)
        out.append((values, loads))
    return out


def _tensor(shape, dtype, misaligned: bool) -> torch.Tensor:
    """A contiguous tensor; ``misaligned`` puts its first element 4 bytes past a
    16-byte boundary."""
    n = int(np.prod(shape))
    flat = torch.empty(n + 1, dtype=dtype)
    t = flat[1:] if misaligned else flat[:n]
    assert (t.data_ptr() % 16 != 0) == misaligned
    return t.view(shape)


@pytest.mark.parametrize("misaligned", [None, "rows", "per_edge", "per_row"])
@pytest.mark.parametrize("rem", [0, 1, 2, 3])
@pytest.mark.parametrize("heads", MAP_HEADS)
def test_edge_mapping_covers_every_value_once(heads, rem, misaligned, monkeypatch):
    full = tgf.EDGE_BLOCKS
    for nnz in (rem, 4 + rem, 4 * 97 + rem):
        if nnz == 0 and misaligned:  # an empty tensor has no address to misalign
            continue
        rows = _tensor((nnz,), torch.int32, misaligned == "rows")
        # K4's arrays as gat_alpha_cuda passes them: sc_src, alpha, lgrad per edge
        per_edge = [_tensor((nnz, heads), torch.float32,
                            misaligned == "per_edge" and i == 2) for i in range(3)]
        per_row = [_tensor((N_ROWS, heads), torch.float32,
                           misaligned == "per_row" and i == 1) for i in range(3)]
        if heads == 1:
            vec = 1 if misaligned in ("rows", "per_edge") else 4
        elif heads % 4 == 0:
            vec = 1 if misaligned in ("per_edge", "per_row") else 4
        else:
            vec = 1
        for max_blocks in (full, 1, 2):  # 1 and 2 blocks: the stride loops turn
            monkeypatch.setattr(tgf, "EDGE_BLOCKS", max_blocks)
            plan = tgf.edge_plan(nnz, heads, rows, per_edge, per_row)
            assert plan.vec == vec and 1 <= plan.grid <= max_blocks
            seen = collections.Counter()
            for values, loads in thread_values(nnz, heads, plan):
                seen.update(values)
                assert loads == sorted(set(loads)) == sorted({e for e, _ in values})
            want = {(e, h): 1 for e in range(nnz) for h in range(heads)}
            assert seen == want, (nnz, heads, plan)


def _scores(c, heads, seed):
    rng = np.random.default_rng(seed)
    sc = (rng.normal(size=(c.src.numel(), heads)) * 2).astype(np.float32)
    sd = (rng.normal(size=(c.n_rows, heads)) * 2).astype(np.float32)
    return sc, sd


@pytest.mark.parametrize("heads", [1, 3, 8])
def test_gat_alpha_plain_matches_jax(heads):
    jc, c, slots = graph(SPLIT_EDGES)
    sc, sd = _scores(c, heads, 40 + heads)
    jsc = _to_slots(jc, slots, sc)
    jm, jden = jax_gat_stats(jc, jsc, jnp.asarray(sd), SLOPE, interpret=True)
    ja, jl = jax_gat_alpha(jc, jsc, jnp.asarray(sd), jm, jden, SLOPE, interpret=True)
    alpha, lgrad = tgf.gat_alpha(c, torch.from_numpy(sc), torch.from_numpy(sd),
                                 torch.tensor(np.asarray(jm)),
                                 torch.tensor(np.asarray(jden)), SLOPE)
    want = np.asarray(ja)[slots]
    np.testing.assert_allclose(alpha.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(lgrad.numpy(), np.asarray(jl)[slots])
    assert set(np.unique(lgrad.numpy())) == {np.float32(SLOPE), np.float32(1.0)}


@pytest.mark.parametrize("heads", [2, 3, 8])
def test_rows_to_edges_multi_plain_matches_jax(heads):
    jc, c, slots = graph(SPLIT_EDGES)
    v = np.random.default_rng(50 + heads).normal(size=(c.n_rows, heads)).astype(np.float32)
    want = np.asarray(je.rows_to_edges_multi(jc, jnp.asarray(v), True))[slots]
    got = tk.rows_to_edges_multi(c, torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, gat_csr.rows_to_edges_reference(c, torch.from_numpy(v)))


def test_launchers_take_cuda_tensors_only():
    """A CPU tensor never reaches K4's or K6′'s launcher; the dispatching wrappers
    run the plain versions and count no launch."""
    _, c, _ = graph(8)
    sc, rows8 = torch.zeros(c.src.numel(), 8), torch.ones(c.n_rows, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tgf.gat_alpha_cuda(c, sc, rows8, rows8, rows8)
    with pytest.raises(ValueError, match="CUDA"):
        tk.rows_to_edges_multi_cuda(c, rows8)
    before = (dict(tk.launches), dict(tgf.launches))
    alpha, lgrad = tgf.gat_alpha(c, sc, rows8, rows8, rows8)
    want = gat_csr.gat_alpha_reference(c, sc, rows8, rows8, rows8)
    assert torch.equal(alpha, want[0]) and torch.equal(lgrad, want[1])
    assert torch.equal(tk.rows_to_edges_multi(c, rows8), torch.ones(c.src.numel(), 8))
    assert (dict(tk.launches), dict(tgf.launches)) == before
