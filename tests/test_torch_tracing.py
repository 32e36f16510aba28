"""The port's tracer (``dgll_tpu_torch.utils.profiling``) on the CPU, and one test on
the card.

Off (no profiler recording, outside ``tracing()``), a full-batch step opens no
``record_function`` range and makes no span, and the registry stays empty. Under a
profiler, N full-batch steps give each ``dgll.step.*`` span N instances and each
layer's ``dgll.conv.aggregate`` N more, its ``_bwd`` too where the aggregation's
input needs a gradient (a first layer that aggregates the input features, as
GraphSAGE's, has no backward), each backward span inside the step's backward; the
Chrome trace names the spans, and ``profile_slice`` counts no span's range as device
work. Timing events go back to the tracer's pool only once no pending span or gap
holds them (a fake event, whose time is its record's rank). The DP runner's
``collective_ms`` reads the traced all-reduces of an eager CPU epoch.

The card test (marker ``card``; this file imports no JAX, so it runs on the machine
with the card, where ``tests/conftest.py`` cannot load):
``python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_tracing.py``.
"""
import functools
import json
import math
import os

import pytest
import torch

from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu_torch.nn import GAT, GCN, GraphSAGE
from dgll_tpu_torch.parallel.mesh import make_mesh
from dgll_tpu_torch.sampling import DeviceCSR
from dgll_tpu_torch.train import (
    GRAPH_ADAM,
    DeviceDPEpochRunner,
    DeviceEpochRunner,
    create_train_state,
    make_full_batch_step,
)
from dgll_tpu_torch.utils import profiling

GRAPH = dict(n_node=300, avg_degree=5, n_class=3, feat_dim=8, seed=1, train_frac=0.5)
STEPS = 3
LAYERS = 2
STEP_SPANS = ("dgll.step.forward", "dgll.step.backward", "dgll.step.optimizer")
# model, graph with the kernel layouts, layers whose aggregation has a backward
MODELS = {
    "sage": (lambda: GraphSAGE(8, 8, 3, n_layers=LAYERS, dropout=0.5), False, LAYERS - 1),
    "gcn": (lambda: GCN(8, 8, 3, n_layers=LAYERS), True, LAYERS),
    "gat_fused": (lambda: GAT(8, 4, 3, num_heads=2, n_layers=LAYERS), True, LAYERS),
    "gat_coo": (lambda: GAT(8, 4, 3, num_heads=2, n_layers=LAYERS), False, LAYERS),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the machine with the H100")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


@functools.lru_cache(maxsize=None)
def _graph(chunked: bool):
    g = gcn_normalize(synthetic_classification_graph(**GRAPH))
    return g.with_chunked() if chunked else g


def _steps(name: str, n: int = STEPS):
    build, chunked, _ = MODELS[name]
    g = _graph(chunked)
    torch.manual_seed(0)
    state = create_train_state(build(), functools.partial(torch.optim.Adam, lr=1e-2))
    step = make_full_batch_step()
    gen = torch.Generator().manual_seed(0)
    for _ in range(n):
        state, loss = step(state, g, g.node_feat, g.labels, g.train_mask, gen)
    assert math.isfinite(float(loss))


@pytest.mark.parametrize("name", ["sage", "gat_fused"])
def test_off_a_step_makes_no_span_and_no_range(name, monkeypatch):
    """PyTorch's own ranges (the optimizer's) stay; the port opens none."""
    original = torch.profiler.record_function

    def refuse(*args, **kwargs):
        raise AssertionError("a span site did more than check whether tracing is on")

    def record_function(name, *args, **kwargs):
        if name.startswith("dgll."):
            refuse()
        return original(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", record_function)
    monkeypatch.setattr(profiling, "_range", refuse)
    monkeypatch.setattr(profiling._Span, "__init__", refuse)
    monkeypatch.setattr(profiling.TRACER, "count", refuse)
    assert not profiling.enabled()
    _steps(name)
    rep = profiling.report()
    assert rep["spans"] == {} and rep["counters"] == {}


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_profiled_steps_count_their_spans(name):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        _steps(name)
    rep = profiling.report()
    spans, with_bwd = rep["spans"], MODELS[name][2]
    counters = {"step.full_batch": STEPS}
    if name == "sage":  # a SAGE mean on a full Graph runs K1, a count a layer
        counters["conv.aggregate_k1"] = STEPS * LAYERS
    assert rep["counters"] == counters
    for s in STEP_SPANS:
        assert spans[s]["count"] == STEPS and spans[s]["host_s"] > 0
        assert spans[s]["device_ms"] is None  # no CUDA stream to time on
    assert spans["dgll.conv.aggregate"]["count"] == STEPS * LAYERS
    assert spans["dgll.conv.aggregate_bwd"]["count"] == STEPS * with_bwd
    events = list(prof.events())
    steps = [e for e in events if e.name == "dgll.step.backward"]
    bwd = [e for e in events if e.name == "dgll.conv.aggregate_bwd"]
    fwd = [e for e in events if e.name == "dgll.conv.aggregate"]
    assert len(steps) == STEPS and len(bwd) == STEPS * with_bwd
    assert all(any(_inside(b, s) for s in steps) for b in bwd)
    assert len(fwd) == STEPS * LAYERS
    assert all(any(_inside(f, e) for e in events if e.name == "dgll.step.forward")
               for f in fwd)


# autograd nodes of the dense layers and the self branch around an aggregation
DENSE_NODES = {"AddmmBackward0", "MmBackward0", "TBackward0", "SliceBackward0",
               "CatBackward0", "ReluBackward0", "EluBackward0"}


@pytest.mark.parametrize("name", ["sage", "gcn", "gat_coo"])
def test_backward_span_holds_only_the_aggregation(name):
    """Autograd reaches the nodes made after an aggregation (GraphSAGE's self branch
    ``x[:n_dst]`` and its linear layer) before the aggregation's output, so no dense
    layer's node runs inside ``dgll.conv.aggregate_bwd``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _steps(name, 1)
    events = list(prof.events())
    nodes = [e for e in events if e.name.startswith("autograd::engine::evaluate_function: ")]
    spans = [e for e in events if e.name == "dgll.conv.aggregate_bwd"]
    assert len(spans) == MODELS[name][2]
    for s in spans:
        inside = {e.name.split(": ", 1)[1] for e in nodes
                  if s.time_range.start <= e.time_range.start <= s.time_range.end}
        assert inside - {"ViewBackward0"}  # the aggregation's own nodes
        assert not inside & DENSE_NODES, inside


def test_device_trace_names_the_spans(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        _steps("gat_fused", 1)
    (path,) = [tmp_path / f for f in os.listdir(tmp_path)]
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"dgll.step.forward", "dgll.step.backward", "dgll.step.optimizer",
            "dgll.conv.aggregate", "dgll.conv.aggregate_bwd"} <= names


def test_profile_slice_counts_no_range_as_device_work():
    """``profile_slice``'s busy time sums kernels only: the device images of the
    spans' ranges (user annotations, or names also on the host) are left out."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    from dgll_tpu_torch.tools.profile_slice import device_ops

    def avg(key, dev, ms, user=False, count=1):
        return SimpleNamespace(key=key, device_type=dev, count=count,
                               self_device_time_total=1e3 * ms, is_user_annotation=user)

    averages = [avg("dgll.runner.replay", DeviceType.CPU, 0.0, user=True, count=193),
                avg("dgll.runner.replay", DeviceType.CUDA, 130.0, user=True, count=193),
                avg("dgll.runner.epoch", DeviceType.CPU, 0.0),
                avg("dgll.runner.epoch", DeviceType.CUDA, 140.0),  # no annotation flag
                avg("aten::mm", DeviceType.CPU, 0.0),
                avg("void gemm_kernel<128>(float*)", DeviceType.CUDA, 2.5, count=386),
                avg("Memcpy DtoD (Device -> Device)", DeviceType.CUDA, 0.5, count=2),
                avg("void idle_kernel()", DeviceType.CUDA, 0.0)]
    ops = device_ops(averages)
    assert ops == {"void gemm_kernel<128>(float*)": {"ms": 2.5, "count": 386},
                   "Memcpy DtoD (Device -> Device)": {"ms": 0.5, "count": 2}}


class _FakeEvent:
    """A timing event whose time is the rank of its last record."""
    clock = 0

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self, stream=None):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return float(other.t - self.t)


def test_pooled_events_are_reused_only_when_nothing_holds_them(monkeypatch):
    """Replays inside an epoch span, a gap between them, kept every 2 spans:
    every replay and every gap reads 1 (its two events recorded one after the
    other), the epoch all of them; a recycled event still held would read otherwise."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(profiling, "_stream", lambda where: "stream")
    monkeypatch.setattr(profiling, "RESOLVE_AT", 2)
    profiling.reset()
    n, epochs = 7, 3
    with profiling.tracing():
        for _ in range(epochs):
            with profiling.span("dgll.runner.epoch", "stream"):
                replay = profiling.span("dgll.runner.replay", "stream",
                                        gap="dgll.runner.between_replays")
                for _ in range(n):  # one span entered again, as run_epoch's
                    with replay:
                        pass
    rep = profiling.report()["spans"]
    assert len(profiling.TRACER.pool) > 0
    assert rep["dgll.runner.replay"]["count"] == n * epochs
    assert rep["dgll.runner.replay"]["device_ms"] == n * epochs
    assert rep["dgll.runner.between_replays"]["count"] == n * epochs - 1
    # a gap within an epoch is 1; across epochs it holds the epoch span's two events
    assert rep["dgll.runner.between_replays"]["device_ms"] == (n - 1) * epochs + 3 * (
        epochs - 1)
    assert rep["dgll.runner.epoch"]["device_ms"] == epochs * (2 * n + 1)


def test_backward_span_keeps_no_input_alive():
    """A traced span's backward hooks hold its device, not its input: an input that
    nothing else keeps (a deep model's dropped-out activations) is freed after the
    forward, as it is untraced, and the backward span still records."""
    import gc
    import weakref

    x = torch.randn(64, 8, requires_grad=True)
    with profiling.tracing():
        h = torch.relu(x)
        alive = weakref.ref(h)
        out = profiling.spanned("dgll.test.span", lambda t: t * 2.0, h)
        del h
        gc.collect()
        assert alive() is None
        out.sum().backward()
    assert profiling.report()["spans"]["dgll.test.span_bwd"]["count"] == 1


def test_capture_records_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "_stream", lambda where: False)
    with profiling.tracing():
        with profiling.span("dgll.step.forward", "stream"):
            pass
        out = profiling.spanned("dgll.conv.aggregate", torch.neg, torch.ones(2))
    assert out.sum() == -2
    assert profiling.report()["spans"] == {}


def test_phase_timer_keeps_host_totals_and_spans_only_when_on():
    timer = profiling.PhaseTimer()
    with timer.phase("train"):
        pass
    assert profiling.report()["spans"] == {}
    with profiling.tracing():
        with timer.phase("train"):
            pass
    assert timer.counts["train"] == 2 and timer.totals["train"] > 0
    assert profiling.report()["spans"]["dgll.phase.train"]["count"] == 1


def _sage_runner(runner_cls, device, **kw):
    g = _graph(False)
    csr = DeviceCSR.from_graph(g, device)
    model = GraphSAGE(8, 8, 3, dropout=0.5, generator=torch.Generator().manual_seed(0))
    opt = functools.partial(torch.optim.Adam, lr=1e-2,
                            **(GRAPH_ADAM if device.type == "cuda" else {}))
    runner = runner_cls(model, opt, csr, [4, 3], 32, g.get_train_nodes(), seed=0, **kw)
    return runner, runner.init_state(), g.node_feat.to(device), g.labels.to(device)


def test_dp_runner_collective_ms_reads_an_eager_cpu_epoch():
    runner, state, feats, labels = _sage_runner(DeviceDPEpochRunner, torch.device("cpu"),
                                                mesh=make_mesh())
    runner.run_epoch(state, feats, labels)
    assert runner.collective_ms() == 0.0  # nothing traced
    with profiling.tracing():
        _, loss = runner.run_epoch(state, feats, labels)
    assert math.isfinite(float(loss))
    ms = runner.collective_ms()
    assert math.isfinite(ms) and ms > 0
    assert profiling.report()["spans"]["dgll.dp.all_reduce"]["count"] == runner.n_batches


def test_runner_epoch_spans_on_the_cpu():
    runner, state, feats, labels = _sage_runner(DeviceEpochRunner, torch.device("cpu"))
    with profiling.tracing():
        for _ in range(2):
            runner.run_epoch(state, feats, labels)
    rep = profiling.report()
    assert rep["spans"]["dgll.runner.epoch"]["count"] == 2
    assert rep["spans"]["dgll.runner.load_epoch"]["count"] == 2
    assert "dgll.runner.replay" not in rep["spans"]  # the eager step replays nothing
    assert rep["counters"] == {}


@pytest.mark.card
def test_runner_replays_and_gaps_on_the_card(card):
    runner, state, feats, labels = _sage_runner(DeviceEpochRunner, card)
    float(runner.run_epoch(state, feats, labels)[1])  # captures the step
    graph = runner._graph
    profiling.reset()
    with profiling.tracing():
        for _ in range(2):
            _, loss = runner.run_epoch(state, feats, labels)
        float(loss)
    rep = profiling.report()
    assert runner._graph is graph  # replayed, not captured again
    assert rep["counters"]["runner.replay"] == 2 * runner.n_batches
    replay = rep["spans"]["dgll.runner.replay"]
    gaps = rep["spans"]["dgll.runner.between_replays"]
    assert replay["count"] == 2 * runner.n_batches and replay["device_ms"] > 0
    assert gaps["count"] == 2 * runner.n_batches - 1
    assert math.isfinite(gaps["device_ms"]) and gaps["device_ms"] >= 0
    epoch = rep["spans"]["dgll.runner.epoch"]["device_ms"]
    assert replay["device_ms"] + gaps["device_ms"] <= epoch * (1 + 1e-3)
