"""GCNII (``dgll_tpu_torch.nn.GCNII``, ``GCN2Conv``) against the benchmark's plain
reference (``gnnbench/reference/gcnii.py``), which imports nothing of the port, on the
CPU at a small size. GCNII is the port's own model: the JAX package has none, so the
plain reference is what it is held to.

The port and the reference get the same seeded weights (``gnnbench.weights``) and
dropout generators of one seed, and must agree in log-probabilities, loss and every
leaf's gradient at 2, 8 and 64 layers. ``Graph.chunked_pair("gcn")`` (the layouts of
``P = D^-1/2 (A + I) D^-1/2`` that K1 sums over) carries ``gcn_normalize``'s weights on the
real edges, 0 on padded ones, and refuses a graph without self-loops. The CLI trains
``--Model GCNII --samp_type full`` and refuses its other paths; under the tracer a step
makes one ``dgll.conv.identity_map`` span, its backward and one
``conv.aggregate_gcn`` count a layer, at a width
of either design of the fused layer's kernels; the benchmark's ``identity_map_ms.full``
reader divides the spans' device time by the steps. Every layer runs the fused layer
(``ops/cuda/gcnii_fused.py``, its plain version here).
"""
import functools
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dgll_tpu_torch import run as torch_run
from dgll_tpu_torch.data import gcn_normalize
from dgll_tpu_torch.graph import Graph, pad_graph
from dgll_tpu_torch.nn import GCN2Conv, GCNII
from dgll_tpu_torch.nn.models import gcnii_beta
from dgll_tpu_torch.sampling import HostGraph, NeighborSampler
from dgll_tpu_torch.train import create_train_state, make_full_batch_step, masked_nll_loss
from dgll_tpu_torch.utils import profiling
from gnnbench import catalog, reference, spans, weights
from gnnbench.reference import gcnii as ref

N, FEAT, CLASSES = 90, 12, 5


def _cfg(n_layers: int, hidden: int, dropout: float = 0.6) -> dict:
    return {"n_layers": n_layers, "hidden": hidden, "alpha": 0.1, "lamda": 0.5,
            "dropout": dropout, "lr": 0.01, "weight_decay": 0.01}


def _graph(n: int = N, seed: int = 0, self_loops: bool = True) -> Graph:
    """A power-law graph stored both ways, with duplicate pairs, a self-loop a node
    where ``self_loops`` says so, features, labels and a train mask."""
    rng = np.random.default_rng(seed)
    e = 4 * n
    dst = (rng.pareto(1.0, e) * 4).astype(np.int64) % n
    src = rng.integers(0, n, e)
    keep = src != dst
    src, dst = np.concatenate([src[keep], dst[keep]]), np.concatenate([dst[keep], src[keep]])
    src, dst = np.concatenate([src, [3, 3]]), np.concatenate([dst, [7, 7]])  # duplicates
    feats = rng.standard_normal((n, FEAT)).astype(np.float32)
    return Graph.from_edges(src, dst, n, node_feat=feats,
                            labels=rng.integers(0, CLASSES, n),
                            train_mask=rng.random(n) < 0.6, add_self_loops=self_loops)


@functools.lru_cache(maxsize=None)
def _shared_graph() -> Graph:
    return _graph()


def _pair(cfg: dict, seed: int = 5):
    """The port's GCNII with the reference's weights, and those weights."""
    g = _shared_graph()
    p = weights.make(ref.specs(cfg, FEAT, CLASSES), seed, "cpu")
    model = GCNII(FEAT, cfg["hidden"], CLASSES, n_layers=cfg["n_layers"],
                  alpha=cfg["alpha"], lamda=cfg["lamda"], dropout=cfg["dropout"])
    weights.load_into(model, p)
    return g, model, p


def _ref_graph(g: Graph):
    return SimpleNamespace(src=g.src.long(), dst=g.dst.long(), n_node=g.n_node)


@pytest.mark.parametrize("n_layers, hidden", [(2, 16), (8, 16), (64, 8), (64, 16)])
def test_port_equals_the_plain_reference(n_layers, hidden):
    """Log-probabilities, the masked loss and every leaf's gradient, with the same
    dropout masks (generators of one seed, masks drawn in the model's order). Both
    sum each row's edges in float32 in another order (K1's plain version in the
    layout's order, the reference's ``index_add`` in the graph's) and mix the
    residual by another formula (``lerp``, ``addmm`` against the written-out sums),
    so they agree to float32 rounding, which 64 layers do not amplify past 1e-5 of
    the largest value."""
    cfg = _cfg(n_layers, hidden)
    g, model, p = _pair(cfg)
    x, y, m = g.node_feat, g.labels, g.train_mask
    model.train()
    logp = model(g, x, generator=torch.Generator().manual_seed(11))
    loss = masked_nll_loss(logp, y, m)
    loss.backward()
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    want = ref.forward_full(cfg, leaves, _ref_graph(g), x, torch.Generator().manual_seed(11))
    want_loss = reference.nll(want, y, m)
    want_loss.backward()
    scale = want.abs().max().item()
    assert (logp - want).abs().max().item() <= 1e-5 * scale
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    params = dict(model.named_parameters())
    assert set(params) == set(leaves)
    for k, leaf in leaves.items():
        got, g_ref = params[k].grad, leaf.grad
        assert (got - g_ref).abs().max().item() <= 1e-5 * g_ref.abs().max().item(), k


def test_eval_mode_draws_no_mask():
    cfg = _cfg(8, 16)
    g, model, p = _pair(cfg)
    model.eval()
    gen = torch.Generator().manual_seed(3)
    state = gen.get_state()
    with torch.no_grad():
        got = model(g, g.node_feat, generator=gen)
        want = ref.forward_full(dict(cfg, dropout=0.0), p, _ref_graph(g), g.node_feat, None)
    assert torch.equal(gen.get_state(), state)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_beta_per_layer():
    cfg = _cfg(64, 8)
    model = GCNII(FEAT, 8, CLASSES, n_layers=64, alpha=0.1, lamda=0.5)
    for layer, conv in enumerate(model.convs, start=1):
        assert conv.beta == gcnii_beta(0.5, layer) == ref.beta(cfg, layer)
        assert conv.beta == math.log(0.5 / layer + 1) and conv.alpha == 0.1
    assert model.convs[0].beta == pytest.approx(0.4054651081081644)
    assert model.convs[63].beta == pytest.approx(0.0077821404420549489)


def _edges_by_value(rows, cols, w):
    order = np.lexsort((w, cols, rows))
    return rows[order], cols[order], w[order]


@pytest.mark.parametrize("padded", [False, True])
def test_gcn_chunked_carries_gcn_normalize_weights(padded):
    """A's edges and weights are ``gcn_normalize``'s, A^T its transpose; a padded
    graph's padded edges weigh 0, the degrees counting the real edges alone."""
    g = _graph(seed=2)
    if padded:
        g = pad_graph(g)
        assert g.n_edge > g.n_real_edge
    want = gcn_normalize(g).edge_weight.numpy()
    a, at = g.chunked_pair("gcn")
    assert g.chunked_pair("gcn") is not None and g.chunked_pair("gcn")[0] is a  # kept
    src, dst = g.src.numpy().astype(np.int64), g.dst.numpy().astype(np.int64)
    for lay, rows, cols in ((a, dst, src), (at, src, dst)):
        got = _edges_by_value(lay.rows.numpy(), lay.src.numpy(), lay.weight.numpy())
        exp = _edges_by_value(rows, cols, want)
        for have, need in zip(got, exp):
            np.testing.assert_array_equal(have, need)
    real = np.arange(g.n_edge) < g.n_real_edge
    assert (want[~real] == 0).all() and (want[real] > 0).all()
    perm = a.t_slot_perm.long()
    assert torch.equal(a.weight[perm], at.weight)


def test_gcn_chunked_refuses_a_graph_without_self_loops():
    g = _graph(self_loops=False)
    with pytest.raises(ValueError, match="self-loops"):
        g.chunked_pair("gcn")
    with pytest.raises(ValueError, match="self-loops"):
        gcn_normalize(g)


def test_blocks_are_refused():
    g = _shared_graph()
    _, _, blocks = NeighborSampler([3, 3], seed=0).sample(
        HostGraph.from_graph(g), np.arange(8), pad_to=8)
    conv = GCN2Conv(4, 0.1, 0.4)
    x = torch.zeros(blocks[0].src_ids.shape[0], 4)
    with pytest.raises(ValueError, match="full Graph"):
        conv(blocks[0], x, x)
    model = GCNII(FEAT, 4, CLASSES, n_layers=2)
    with pytest.raises(ValueError, match="full Graph"):
        model(blocks, torch.zeros(blocks[0].src_ids.shape[0], FEAT))


CLI = ["--Model", "GCNII", "--n_node", "400", "--n_layers", "4", "--nhid", "16",
       "--device", "cpu"]


def test_cli_trains_gcnii_full_batch():
    out = torch_run.main(CLI + ["--samp_type", "full", "--n_epochs", "2", "--alpha", "0.2",
                                "--lamda", "1.0", "--dropout", "0.6"])
    trial = out["trials"][0]
    assert out["config"]["alpha"] == 0.2 and out["config"]["lamda"] == 1.0
    assert len(trial["epoch_loss"]) == 2 and all(map(math.isfinite, trial["epoch_loss"]))
    assert 0.0 <= trial["test_acc"] <= 1.0
    assert "spmm_kernel" not in trial  # no layout attached: its layers build their own


@pytest.mark.parametrize("extra", [["--samp_type", "neighbor"],
                                   ["--samp_type", "full", "--dtype", "bfloat16"]])
def test_cli_refuses_gcnii_off_its_path(extra):
    with pytest.raises(ValueError, match="GCNII"):
        torch_run.main(CLI + extra + ["--n_epochs", "1"])


def test_cli_attaches_no_layout():
    cfg = SimpleNamespace(model="GCNII", nhid=4, n_layers=2, alpha=0.1, lamda=0.5,
                          dropout=0.0)
    g = _shared_graph()
    model = torch_run.build_model(cfg, CLASSES, FEAT)
    assert torch_run.attach_kernel_layouts(model, g) == (g, {})


@pytest.fixture
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


@pytest.mark.parametrize("width", [8, 16])
def test_traced_step_spans_each_layer(fresh_tracer, width):
    layers, steps = 5, 2
    cfg = _cfg(layers, width)  # a tiled width of the fused layer's kernels, and a whole one
    g, model, _ = _pair(cfg)
    state = create_train_state(model, functools.partial(torch.optim.Adam, lr=1e-2))
    step = make_full_batch_step()
    gen = torch.Generator().manual_seed(0)
    with profiling.tracing():
        for _ in range(steps):
            state, loss = step(state, g, g.node_feat, g.labels, g.train_mask, gen)
    assert math.isfinite(float(loss))
    rep = profiling.report()
    assert rep["counters"] == {"step.full_batch": steps,
                               "conv.aggregate_gcn": steps * layers}
    for name in ("dgll.conv.identity_map", "dgll.conv.identity_map_bwd",
                 "dgll.conv.aggregate", "dgll.conv.aggregate_bwd"):
        assert rep["spans"][name]["count"] == steps * layers, name


def test_identity_map_reader(monkeypatch):
    """``identity_map_ms.full``: the device ms of both spans over the steps; nothing on
    a minibatch run, before a traced slice, or where the program has no such span
    (a program without GCNII)."""
    metric = catalog.metric("identity_map_ms.full")
    assert (metric.UNIT, metric.SOURCE, metric.MOVES) == ("ms/step", "program_span",
                                                         "full_epoch_ms")
    rep = {"spans": {"dgll.conv.identity_map": {"device_ms": 6.0},
                     "dgll.conv.identity_map_bwd": {"device_ms": 9.0},
                     "dgll.conv.aggregate": {"device_ms": 40.0}},
           "counters": {"step.full_batch": 5}}
    monkeypatch.setattr(spans, "report", lambda run: None if run.trace is None else rep)
    full = SimpleNamespace(traffic=SimpleNamespace(mode="full"), trace=object())
    assert metric.read(full) == pytest.approx(3.0)
    assert metric.read(SimpleNamespace(traffic=SimpleNamespace(mode="minibatch"),
                                       trace=object())) is None
    assert metric.read(SimpleNamespace(traffic=SimpleNamespace(mode="full"),
                                       trace=None)) is None
    rep = {"spans": {"dgll.conv.aggregate": {"device_ms": 40.0}},
           "counters": {"step.full_batch": 5}}
    assert metric.read(full) is None
