"""The operation and byte counters against hand counts on a graph of a few dozen
edges, and the rooflines' readers: they change with the widths and the edge count,
and not with the port's layout (its row padding or its split schedule)."""
from types import SimpleNamespace

import pytest
import torch

from gnnbench import catalog, counts, traffic
from gnnbench.reference import gat, graphsage
from gnnbench.trace import Trace

N, E = 7, 30  # a graph of 7 nodes and 30 edges
SAGE = {"n_layers": 2, "hidden": 3, "dropout": 0.0}
GAT = {"n_layers": 2, "heads": 2, "hidden": 3, "dropout": 0.0, "negative_slope": 0.2}


def test_edge_sum_bytes_by_hand():
    # 30 messages of 4 floats, 8 row pointers, 7 output rows of 4 floats
    assert counts.edge_sum_bytes(N, E, 4, False) == 30 * 16 + 8 * 4 + 7 * 16
    assert counts.edge_sum_bytes(N, E, 4, True) == 30 * 16 + 8 * 4 + 7 * 16 + 30 * 4


def test_attention_bytes_by_hand():
    h, w = 2, 6
    eh, nh, ptr = E * h * 4, N * h * 4, (N + 1) * 4
    k3 = eh + nh + 2 * nh + ptr
    k4 = eh + 3 * nh + 2 * eh + ptr
    k7 = N * w * 4 + E * w * 4 + ptr
    k6 = eh + nh + ptr
    k5 = 3 * eh + nh + eh + nh + ptr
    assert counts.attention_bytes(N, E, h, w) == k3 + k4 + k7 + k6 + k5 == 3712


def test_sage_flops_by_hand():
    # layers (5 -> 3, concat 6) and (6 -> 2, concat 4), out_proj 4 -> 2; full graph
    rows = [(N, N, E)] * 2
    fwd = (2 * 2 * N * 5 * 3 + E * 5) + (2 * 2 * N * 6 * 2 + E * 6) + 2 * N * 4 * 2
    assert graphsage.train_flops(SAGE, 5, 2, rows) == 3 * fwd


def test_gat_flops_by_hand():
    rows = [(N, N, E)] * 2
    l1 = 2 * N * 5 * 6 + 2 * 2 * N * 6 + 2 * E * 6   # 2 heads x 3 from 5 features
    l2 = 2 * N * 6 * 4 + 2 * 2 * N * 4 + 2 * E * 4   # 1 head x 4 classes
    assert gat.train_flops(GAT, 5, 4, rows) == 3 * (l1 + l2)


def test_flops_grow_with_width_and_edges():
    rows = [(N, N, E)] * 2
    more = [(N, N, 2 * E)] * 2
    assert graphsage.train_flops(SAGE, 5, 2, more) > graphsage.train_flops(SAGE, 5, 2, rows)
    assert gat.train_flops(GAT, 5, 4, more) > gat.train_flops(GAT, 5, 4, rows)
    wide = dict(GAT, hidden=6)
    assert gat.train_flops(wide, 5, 4, rows) > gat.train_flops(GAT, 5, 4, rows)


def _fake_run(n_edge, hidden, layout):
    """What the roofline readers see of a traced full-batch GAT run: one step, K1's
    four launches and K3's two, one millisecond of K1 and of K3-K7."""
    ops = {"void (anonymous namespace)::spmm_csr_kernel<float, float, 4>(int const*)": 1e-3,
           "(anonymous namespace)::gat_stats_kernel(int const*)": 1e-3,
           "void at::native::elementwise_kernel<128, 4>(int, float)": 2e-3}
    tr = Trace(window_s=5e-3, busy_s=4e-3, ops=ops, gaps={},
               counters={"segment_matmul": {"k1": 4}, "gat_csr": {"gat_stats": 2}})
    mix = traffic.Traffic(name="t", mode="full", n_node=N, n_pair=0, n_feat=5, n_class=4,
                          n_train=1)
    return SimpleNamespace(trace=tr, peaks=counts.PEAKS["H100"], traffic=mix, ref=gat,
                           cfg=dict(GAT, hidden=hidden), data=SimpleNamespace(n_edge=n_edge),
                           graph=layout)


def _layout(pad_rows, split):
    from dgll_tpu_torch.ops import chunked

    src = torch.randint(0, N, (E,), generator=torch.Generator().manual_seed(0))
    dst = torch.randint(0, N, (E,), generator=torch.Generator().manual_seed(1))
    c = chunked.build_chunked(src.numpy(), dst.numpy(), N + pad_rows, N)
    c.__dict__["split"] = chunked.split_schedule(c.indptr, split)
    return c


@pytest.mark.parametrize("metric", ["k1_roofline_pct.full", "gat_kernels_roofline_pct.full"])
def test_roofline_follows_the_work_not_the_layout(metric):
    read = catalog.metric(metric).read
    base = read(_fake_run(E, 3, _layout(0, 512)))
    assert base is not None and base > 0
    for pad_rows, split in ((121, 512), (0, 4), (300, 2)):
        assert read(_fake_run(E, 3, _layout(pad_rows, split))) == base
    assert read(_fake_run(2 * E, 3, None)) > base
    assert read(_fake_run(E, 6, None)) > base


def test_roofline_silent_where_the_kernel_did_not_run():
    run = _fake_run(E, 3, None)
    run.trace.counters = {"segment_matmul": {"k1": 0}, "gat_csr": {"gat_stats": 0}}
    assert catalog.metric("k1_roofline_pct.full").read(run) is None
    assert catalog.metric("gat_kernels_roofline_pct.full").read(run) is None


@pytest.mark.parametrize("metric", ["k1_roofline_pct.full", "gat_kernels_roofline_pct.full",
                                    "torch_ops_busy_pct.full"])
def test_kernel_launched_under_an_unknown_name_fails(metric):
    """A family whose counters launched while the trace names none of its kernels (a
    kernel renamed by the program) fails the read, not reads as no time of its own."""
    run = _fake_run(E, 3, None)
    ops = run.trace.ops
    run.trace.ops = {k.replace("spmm_csr_kernel", "spmm_rows_kernel")
                     .replace("gat_stats_kernel", "gat_rowstats_kernel"): v
                     for k, v in ops.items()}
    with pytest.raises(RuntimeError, match="does not know"):
        catalog.metric(metric).read(run)
    with pytest.raises(RuntimeError, match="does not know"):
        run.trace.check_port()
    run.trace.ops = ops
    run.trace.check_port()
    assert catalog.metric(metric).read(run) > 0


def test_torch_ops_share_by_hand():
    # busy 4 ms, of which K1 1 ms and K3 1 ms are the port's own
    assert catalog.metric("torch_ops_busy_pct.full").read(_fake_run(E, 3, None)) == 50.0


def test_k1_bytes_by_hand():
    run = _fake_run(E, 3, None)
    # layer 1: 2 heads x 3 = width 6, layer 2: width 4; each a forward and a permuted sum
    per_step = sum(counts.edge_sum_bytes(N, E, w, p) for w in (6, 4) for p in (False, True))
    want = 100.0 * per_step / 3.35e12 / 1e-3
    assert catalog.metric("k1_roofline_pct.full").read(run) == pytest.approx(want)


def test_block_rows():
    assert counts.block_rows(1024, [15, 10]) == [(11264, 11264 * 15), (1024, 10240)]
