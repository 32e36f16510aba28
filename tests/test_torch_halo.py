"""Parity of the port's halo exchange (``dgll_tpu_torch/parallel/halo.py``) with the JAX
package's, on the CPU.

The plan (``send_ids``, ``send_mask``, ``src_remap``, ``halo_size``) equals JAX's
``build_halo_plan`` element for element, on the contiguous, BFS and range partitions
of the power-law test graph, at 2, 3 and 4 shards, and on a graph with no remote edge
(``H`` 8, no slot used). The exchange's volumes and ``make_partitioned_spmm``'s
choice equal JAX's on the power-law graph and on the scaling bench's clustered graph
(range: halo; contiguous: all-gather).

In two ranks over gloo (``tests/_torch_halo_child.py``, which imports no JAX), against
the JAX functions on a 2-device virtual mesh: ``make_halo_spmm``'s forward and its
gradient for a random cotangent (``jax.vjp``: the counterpart of
``tests/test_parallel.py:141,159``), within 1e-5 x max|ref| (float32 sums in another
order; the JAX package's own test allows 1e-4), and its forward against the port's
all-gather SpMM (``gp.make_sharded_spmm``) within the same bar; the windowed halo
SpMM's ``windowed_fraction`` exactly equal to JAX's ``build_shard_windowed``'s (above
0.3 on BFS shards, as ``tests/test_parallel.py:420`` asserts), its forward against
JAX's ``make_halo_spmm_windowed`` (Pallas interpret mode) and its gradient against
the port's ``make_halo_spmm``, within 1e-5 x max|ref|, also on a planted graph whose
second shard has no local edge (no windowed layout) and whose first has no remote
edge.

And the repair of ``gp.shard_partitioned_graph``: without a device it runs on the
rank's card, and raises where there is none.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dgll_tpu.graph import Graph as JaxGraph
from dgll_tpu.parallel import make_mesh as jax_make_mesh
from dgll_tpu.parallel import partition_graph as jax_partition_graph
from dgll_tpu.parallel import shard_partitioned_graph as jax_shard
from dgll_tpu.parallel import halo as jhalo
from dgll_tpu_torch.parallel import halo, launch_local
from dgll_tpu_torch.parallel.mesh import Mesh
from dgll_tpu_torch.parallel.partition import PartitionedGraph
from test_torch_dp import data  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(REPO, "tests", "_torch_halo_child.py")
D = 2
LIMIT_S = 120  # each multi-rank run's time limit
TOL = 1e-5     # x max|ref|
PG_FIELDS = ("src", "dst_local", "edge_weight", "node_feat", "labels", "train_mask",
             "val_mask", "test_mask", "perm")
PG_INTS = ("n_shard", "rows_per_shard", "e_shard", "n_real_node")


def port_pg(jpg) -> PartitionedGraph:
    """The port's ``PartitionedGraph`` of the JAX package's arrays."""
    fields = {f: None if getattr(jpg, f) is None else np.asarray(getattr(jpg, f))
              for f in PG_FIELDS}
    return PartitionedGraph(**fields, **{f: int(getattr(jpg, f)) for f in PG_INTS})


def pg_inputs(pg: PartitionedGraph) -> dict:
    out = {f"pg:{f}": getattr(pg, f) for f in PG_FIELDS if getattr(pg, f) is not None}
    return {**out, **{f"pg:{f}": getattr(pg, f) for f in PG_INTS}}


def run_ranks(mode, inputs, tmp_path, limit=LIMIT_S):
    """``mode`` of the child script in ``D`` ranks; each rank's outputs."""
    path = str(tmp_path / f"{mode}_in.npz")
    np.savez(path, **inputs)
    launch_local(D, [sys.executable, CHILD, mode, path, str(tmp_path)],
                 env={"OMP_NUM_THREADS": "1"}, timeout=limit)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(D)]


def close(name, got, want, bar=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=bar * np.abs(want).max(),
                               err_msg=name)


def _jax_mesh(d=D):
    return jax_make_mesh(("data",), devices=jax.devices()[:d])


def planted_graph():
    """512 nodes in two ranges of 256: the first's rows take 16 in-edges each from
    sources in the same 64-row stretch (local, windowed), the second's 3 each from the
    first range only (remote, so its shard has no local edge)."""
    rng = np.random.default_rng(11)
    n, half = 512, 256
    dst0 = np.repeat(np.arange(half), 16)
    src0 = (dst0 // 64) * 64 + rng.integers(0, 64, len(dst0))
    dst1 = np.repeat(np.arange(half, n), 3)
    src1 = rng.integers(0, half, len(dst1))
    src, dst = np.r_[src0, src1], np.r_[dst0, dst1]
    w = rng.random(len(src)).astype(np.float32) + 0.1
    feat = rng.normal(size=(n, 8)).astype(np.float32)
    labels = rng.integers(0, 3, n)
    return JaxGraph.from_edges(src, dst, n, edge_weight=w, node_feat=feat, labels=labels,
                               train_mask=rng.random(n) < 0.5)


def disconnected_graph():
    """Two halves of 200 nodes with no edge between them."""
    rng = np.random.default_rng(12)
    src = rng.integers(0, 200, 1600)
    dst = rng.integers(0, 200, 1600)
    src, dst = np.r_[src, src + 200], np.r_[dst, dst + 200]
    return JaxGraph.from_edges(src, dst, 400, node_feat=rng.normal(size=(400, 4)))


@pytest.mark.parametrize("n_shard", [2, 3, 4])
@pytest.mark.parametrize("strategy", ["contiguous", "bfs", "range"])
def test_halo_plan_equals_jax(data, strategy, n_shard):
    _, gj = data
    jpg = jax_partition_graph(gj, n_shard, strategy=strategy)
    want = jhalo.build_halo_plan(jpg)
    got = halo.build_halo_plan(port_pg(jpg))
    assert got.halo_size == want.halo_size and got.halo_size % 8 == 0
    for f in ("send_ids", "send_mask", "src_remap"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), f)


def test_halo_plan_without_remote_edges_equals_jax():
    jpg = jax_partition_graph(disconnected_graph(), 2, strategy="range")
    want = jhalo.build_halo_plan(jpg)
    got = halo.build_halo_plan(port_pg(jpg))
    assert got.halo_size == want.halo_size == 8 and not got.send_mask.any()
    for f in ("send_ids", "send_mask", "src_remap"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), f)


def _clustered():
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    from scaling_bench import clustered_graph

    return clustered_graph(8000, 8, 16, n_cluster=8, seed=1)


@pytest.mark.parametrize("graph,strategy,chosen", [
    ("power_law", "contiguous", None), ("power_law", "bfs", None),
    ("clustered", "range", "halo"), ("clustered", "contiguous", "allgather")])
def test_volumes_and_auto_choice_equal_jax(data, graph, strategy, chosen):
    gj = data[1] if graph == "power_law" else _clustered()
    d = 4
    jpg = jax_partition_graph(gj, d, strategy=strategy)
    pg = port_pg(jpg)
    jplan, plan = jhalo.build_halo_plan(jpg), halo.build_halo_plan(pg)
    for f in (16, 128):
        assert (halo.halo_volume_bytes(pg, plan, f)
                == jhalo.halo_volume_bytes(jpg, jplan, f))
        assert halo.allgather_volume_bytes(pg, f) == jhalo.allgather_volume_bytes(jpg, f)
    _, want = jhalo.make_partitioned_spmm(_jax_mesh(d), jpg, 16, strategy="auto")
    # the choice is taken on the host; rank 0 of a mesh of d builds it on the CPU
    _, got = halo.make_partitioned_spmm(Mesh(("data",), d, 0), pg, 16, "auto", "cpu")
    assert got == want
    if chosen is not None:
        assert got == chosen


def _jax_halo(jpg, cot, windowed):
    mesh = _jax_mesh()
    pgs = jax_shard(jpg, mesh)
    plan = jhalo.build_halo_plan(jpg)
    if windowed:
        sw = jhalo.build_shard_windowed(jpg)
        spmm = jax.jit(jhalo.make_halo_spmm_windowed(mesh, pgs, plan, sw))
        return np.asarray(spmm(pgs.node_feat)), sw.windowed_fraction
    spmm = jhalo.make_halo_spmm(mesh, pgs, plan)
    out, vjp = jax.vjp(spmm, pgs.node_feat)
    (dx,) = vjp(jnp.asarray(cot))
    return np.asarray(out), np.asarray(dx)


@pytest.mark.parametrize("graph", ["contiguous", "bfs", "planted"])
def test_halo_spmm_in_two_ranks_matches_jax(data, tmp_path, graph):
    if graph == "planted":
        jpg = jax_partition_graph(planted_graph(), D, strategy="range")
    else:
        jpg = jax_partition_graph(data[1], D, strategy=graph)
    pg = port_pg(jpg)
    cot = np.random.default_rng(7).normal(size=pg.node_feat.shape).astype(np.float32)
    out, dx = _jax_halo(jpg, cot, windowed=False)
    out_win, fraction = _jax_halo(jpg, cot, windowed=True)
    ranks = run_ranks("halo", {**pg_inputs(pg), "cot": cot}, tmp_path)

    def stacked(k):
        return np.concatenate([r[k] for r in ranks])

    close("halo out", stacked("out"), out)
    close("halo dx", stacked("dx"), dx)
    close("halo out against the all-gather", stacked("out"), stacked("out_ag"))
    close("windowed halo out", stacked("out_win"), out_win)
    close("windowed halo dx against the halo SpMM's", stacked("dx_win"), stacked("dx"))
    for r in ranks:
        assert float(r["windowed_fraction"]) == fraction
        assert int(r["halo_size"]) == jhalo.build_halo_plan(jpg).halo_size
    if graph == "bfs":
        assert fraction > 0.3, fraction
    if graph == "planted":
        # the first shard's local edges are windowed, the second shard has none
        assert [bool(r["captured"]) for r in ranks] == [True, False]
        assert not jhalo.build_halo_plan(jpg).send_mask[:, 0].any()  # shard 0 reads none


def test_shard_without_a_device_runs_on_the_card_or_raises(data, monkeypatch):
    import torch

    from dgll_tpu_torch.parallel import gp, partition_graph

    pg = partition_graph(data[0], 1)
    mesh = Mesh(("data",), 1, 0)
    assert gp.shard_partitioned_graph(pg, mesh, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gp.shard_partitioned_graph(pg, mesh)
