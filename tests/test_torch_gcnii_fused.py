"""GCNII's fused layer (``dgll_tpu_torch/ops/cuda/gcnii_fused.py``): everything between
two K1 sums of a GCNII layer (the initial residual, the identity mapping, the ReLU and
the next layer's dropout) as one autograd function, whose forward and backward are
kernels on the card and their plain versions here.

On the CPU the function runs ``gcnii_layer_reference`` and
``gcnii_layer_backward_reference``, so the hand-written gradient formulas are held to
autograd of the composition the function replaces (``lerp``, ``addmm``, ``relu`` and
``models._dropout``): the output exactly (the same operations), ``g_agg`` (over K1's
padded row space, its padded rows 0), ``g_h0`` and ``dW`` to float32 rounding, at dropout
0.6 and 0, in eval mode, at widths 16, 32 and 64 and row counts that are not a multiple
of the kernels' tiles, and with a NaN in K1's sum (kept, with its gradient, as
``torch.relu`` keeps it). The masks are ``_dropout``'s for the same generator state, and
the model draws them in the same order: the model and the composition written out give
the same log-probabilities and leave the generator in the same state, at every width
and at a dropout that keeps nothing, each layer counting one
``conv.identity_map_fused``.

The card tests (marker ``card``; this file imports no JAX, so it runs on the machine
with the card, where ``tests/conftest.py`` cannot load):
``python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_gcnii_fused.py``.
"""
import math

import numpy as np
import pytest
import torch

from dgll_tpu_torch.graph import Graph
from dgll_tpu_torch.nn import GCNII
from dgll_tpu_torch.nn.models import _dropout, gcnii_beta
from dgll_tpu_torch.ops.chunked import R_BLOCK
from dgll_tpu_torch.ops.cuda import gcnii_fused as gf
from dgll_tpu_torch.ops.cuda.segment_matmul import spmm_chunked
from dgll_tpu_torch.utils import profiling

ALPHA = 0.1


def _inputs(n: int, width: int, seed: int, device="cpu"):
    """K1's output over its padded row space, h0, W and a cotangent of the output."""
    gen = torch.Generator().manual_seed(seed)
    n_rows = -(-n // R_BLOCK) * R_BLOCK
    agg = torch.randn(n_rows, width, generator=gen)
    h0 = torch.relu(torch.randn(n, width, generator=gen))
    w = (torch.rand(width, width, generator=gen) * 2 - 1) / math.sqrt(width)
    cot = torch.randn(n, width, generator=gen)
    return [t.to(device) for t in (agg, h0, w, cot)]


def _composition(agg, h0, w, beta, rate, gen, training):
    """What GCNII computed between two K1 sums before the fused layer: ``GCN2Conv``'s
    initial residual and identity mapping, the model's ReLU and the next dropout."""
    s = torch.lerp(agg[: h0.shape[0]], h0, ALPHA)
    h = torch.relu(torch.addmm(s, s, w, beta=1.0 - beta, alpha=beta))
    return _dropout(h, rate, gen) if training else h


def _fused(agg, h0, w, beta, rate, gen, training):
    """The fused layer with its uniforms drawn as the model draws them."""
    drop = training and rate > 0.0
    u = torch.rand(h0.shape, generator=gen, device=h0.device) if drop else None
    return gf.gcnii_layer(agg, h0, w, u, ALPHA, beta, 1.0 - rate if drop else 1.0)


# (dropout, training, width, rows): rows not a multiple of a tile (64, 128 or 256 rows
# at widths 64, 32, 16) nor of K1's row blocks, and one that is
CASES = [(0.6, True, 64, 300), (0.6, True, 16, 300), (0.6, True, 32, 129),
         (0.0, True, 64, 300), (0.6, False, 64, 300), (0.6, True, 64, 256)]


def _assert_close(have, want, tol, name):
    """Within ``tol``, NaN where ``want`` is NaN and nowhere else."""
    assert torch.equal(have.isnan(), want.isnan()), name
    gap = (have - want).nan_to_num(0.0).abs().max().item()
    assert gap <= tol, name


@pytest.mark.parametrize("rate, training, width, n", CASES)
def test_plain_function_against_autograd_of_the_composition(rate, training, width, n):
    agg, h0, w, cot = _inputs(n, width, seed=width + n)
    _against_the_composition(agg, h0, w, cot, rate, training)


@pytest.mark.parametrize("rate", [0.6, 0.0])
def test_a_nan_stays_a_nan(rate):
    """A NaN in K1's sum makes its row of z NaN: the output keeps it where the mask
    keeps it, and relu's backward passes its gradient on, as autograd of the
    composition does."""
    n, width = 300, 16
    agg, h0, w, cot = _inputs(n, width, seed=5)
    agg[7, 3] = float("nan")
    got = _against_the_composition(agg, h0, w, cot, rate, True)
    assert got[7].isnan().any() and not got[:7].isnan().any()


def _against_the_composition(agg, h0, w, cot, rate, training):
    n = h0.shape[0]
    beta = gcnii_beta(0.5, 1)
    want_leaves = [t.clone().requires_grad_(True) for t in (agg, h0, w)]
    want = _composition(*want_leaves, beta, rate, torch.Generator().manual_seed(7), training)
    want.backward(cot)
    got_leaves = [t.clone().requires_grad_(True) for t in (agg, h0, w)]
    got = _fused(*got_leaves, beta, rate, torch.Generator().manual_seed(7), training)
    got.backward(cot)
    _assert_close(got, want, 0.0, "out")
    for name, have, leaf in zip(("g_agg", "g_h0", "dW"), got_leaves, want_leaves):
        assert have.grad.shape == leaf.grad.shape, name
        # the same formulas as autograd's; a product may sum in another order
        tol = 1e-6 * leaf.grad.nan_to_num(0.0).abs().max().item()
        _assert_close(have.grad, leaf.grad, tol, name)
    assert not got_leaves[0].grad[n:].any()  # K1's padded rows take no gradient
    return got.detach()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_are_dropouts(seed):
    """The uniforms the model draws for the fused layer keep exactly what ``_dropout``
    keeps from the same generator state, and the flags are ``~(z <= 0) & kept``."""
    n, width, rate = 300, 64, 0.6
    agg, h0, w, _ = _inputs(n, width, seed)
    u = torch.rand((n, width), generator=torch.Generator().manual_seed(seed))
    mask = _dropout(torch.ones(n, width), rate, torch.Generator().manual_seed(seed)) != 0
    assert torch.equal(u < 1.0 - rate, mask)
    beta = gcnii_beta(0.5, 3)
    out, s, flags = gf.gcnii_layer_reference(agg, h0, w, u, ALPHA, beta, 1.0 - rate)
    z = torch.addmm(s, s, w, beta=1.0 - beta, alpha=beta)
    assert flags.dtype == torch.bool and torch.equal(flags, ~(z <= 0) & mask)
    assert torch.equal(out != 0, flags)


def _graph(n: int = 200, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n)
    keep = src != dst
    src, dst = np.concatenate([src[keep], dst[keep]]), np.concatenate([dst[keep], src[keep]])
    feats = rng.standard_normal((n, 12)).astype(np.float32)
    return Graph.from_edges(src, dst, n, node_feat=feats, add_self_loops=True)


def _composed(model, g, x, gen):
    """GCNII's forward as the composition of PyTorch operations the fused layer
    replaces: ``_dropout`` before each layer and the head, K1's sum, ``lerp``,
    ``addmm`` and ``relu``."""
    def drop(t):
        return _dropout(t, model.dropout, gen) if model.training else t

    h0 = torch.relu(model.fcs[0](drop(x)))
    h = h0
    for conv in model.convs:
        agg = spmm_chunked(*g.gcn_chunked, drop(h).contiguous())[: g.n_node]
        s = torch.lerp(agg, h0, conv.alpha)
        h = torch.relu(torch.addmm(s, s, conv.weight, beta=1.0 - conv.beta, alpha=conv.beta))
    return torch.log_softmax(model.fcs[1](drop(h)), dim=-1)


def _model_run(g, hidden, dropout, training, fused, layers=6):
    """Log-probabilities, the generator's state after the step, the gradients and the
    traced counters of one step of a GCNII, through the model (``fused``) or the
    composition written out."""
    model = GCNII(12, hidden, 5, n_layers=layers, dropout=dropout,
                  generator=torch.Generator().manual_seed(3))
    model.train(training)
    gen = torch.Generator().manual_seed(11)
    profiling.reset()
    with profiling.tracing():
        logp = (model(g, g.node_feat, generator=gen) if fused
                else _composed(model, g, g.node_feat, gen))
        logp[:, 0].sum().backward()
    counters = profiling.report()["counters"]
    profiling.reset()
    # at dropout 1 nothing before the head takes a gradient
    grads = [torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for p in model.parameters()]
    return logp.detach(), gen.get_state(), grads, counters


@pytest.mark.parametrize("hidden, dropout, training",
                         [(16, 0.6, True), (16, 0.0, True), (16, 0.6, False),
                          (8, 0.6, True), (48, 0.6, True), (10, 0.6, True), (16, 1.0, True)])
def test_model_equals_the_composition(hidden, dropout, training):
    """Every width (on the CPU, one not a multiple of 4 too) and a dropout that keeps
    nothing (``_dropout`` then draws no mask) take the fused layer."""
    layers = 6
    g = _graph()
    got = _model_run(g, hidden, dropout, training, True, layers)
    want = _model_run(g, hidden, dropout, training, False, layers)
    assert torch.isfinite(got[0]).all()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])  # the same draws, in the same order
    for a, b in zip(got[2], want[2]):
        assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item()
    assert got[3]["conv.identity_map_fused"] == got[3]["conv.aggregate_gcn"] == layers
    assert "conv.identity_map_fused" not in want[3]


def test_the_kernels_take_a_width_that_is_a_multiple_of_4():
    """Checked before anything reaches the card: a width the kernels cannot take
    raises instead of running another route."""
    agg, h0, w, cot = _inputs(70, 10, seed=0)
    with pytest.raises(ValueError, match="multiple of 4"):
        gf.gcnii_fused_fwd_cuda(agg, h0, w, None, ALPHA, 0.4, 1.0)
    with pytest.raises(ValueError, match="multiple of 4"):
        gf.gcnii_fused_bwd_cuda(cot, cot > 0, h0, w, agg.shape[0], ALPHA, 0.4, None)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the machine with the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_against_the_plain_version(agg, h0, w, cot, u, rate):
    n = h0.shape[0]
    keep, beta = 1.0 - rate, gcnii_beta(0.5, 2)
    fwd, bwd = gf.launches_fwd, gf.launches_bwd
    got = gf.gcnii_fused_fwd_cuda(agg, h0, w, u, ALPHA, beta, keep)
    assert all(torch.equal(a, b) or torch.equal(a.isnan(), b.isnan()) for a, b in
               zip(got, gf.gcnii_fused_fwd_cuda(agg, h0, w, u, ALPHA, beta, keep)))
    want = gf.gcnii_layer_reference(agg, h0, w, u, ALPHA, beta, keep)
    for name, have, ref in zip(("out", "s"), got[:2], want[:2]):
        _assert_close(have, ref, 1e-5 * ref.nan_to_num(0.0).abs().max().item(), name)
    s = got[1]
    z = torch.addmm(s, s, w, beta=1.0 - beta, alpha=beta)
    edge = z.abs() <= 1e-6 * z.nan_to_num(0.0).abs().max()
    assert torch.equal(got[2] | edge, want[2] | edge)
    args = (cot, got[2], s, w, agg.shape[0], ALPHA, beta, keep if rate else None)
    grads = gf.gcnii_fused_bwd_cuda(*args)
    assert all(torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
               for a, b in zip(grads, gf.gcnii_fused_bwd_cuda(*args)))
    for name, have, ref in zip(("g_agg", "g_h0", "dW"), grads,
                               gf.gcnii_layer_backward_reference(*args)):
        _assert_close(have, ref, 1e-5 * ref.nan_to_num(0.0).abs().max().item(), name)
    assert not grads[0][n:].any()
    # the wrappers alone count nothing; the autograd function counts its launches
    assert (gf.launches_fwd, gf.launches_bwd) == (fwd, bwd)
    return got


@pytest.mark.card
@pytest.mark.parametrize("width", [16, 32, 64, 8, 48, 128, 200, 256])
@pytest.mark.parametrize("rate", [0.6, 0.0])
def test_kernels_against_the_plain_version_on_the_card(card, width, rate):
    """Both kernels, whole (16, 32, 64) and tiled (the other widths, 200 ending in a
    part of a slab), against the plain formulas on the same inputs (the flags the
    kernel's, so that both backwards see one ReLU): out and s within 1e-5 x max|ref|,
    the flags equal but where |z| rounds across 0, the gradients within 1e-5 x
    max|ref|, every output bitwise repeatable."""
    n = 5000
    agg, h0, w, cot = _inputs(n, width, seed=width, device=card)
    u = torch.rand(n, width, device=card) if rate else None
    _card_against_the_plain_version(agg, h0, w, cot, u, rate)


@pytest.mark.card
@pytest.mark.parametrize("width", [16, 128])
def test_kernels_keep_a_nan_on_the_card(card, width):
    n = 3000
    agg, h0, w, cot = _inputs(n, width, seed=1, device=card)
    agg[7, 3] = float("nan")
    got = _card_against_the_plain_version(agg, h0, w, cot, torch.rand(n, width, device=card),
                                          0.6)
    assert got[0][7].isnan().any() and got[2][7].any()


@pytest.mark.card
@pytest.mark.parametrize("width", [64, 128])
def test_a_step_on_the_card_launches_each_kernel_a_layer(card, width):
    layers = 4
    g = _graph(3000).to(card)
    model = GCNII(12, width, 5, n_layers=layers, dropout=0.6, device=card,
                  generator=torch.Generator().manual_seed(0))
    fwd, bwd = gf.launches_fwd, gf.launches_bwd
    logp = model(g, g.node_feat, generator=torch.Generator(device=card).manual_seed(1))
    logp[:, 0].sum().backward()
    torch.cuda.synchronize()
    assert (gf.launches_fwd - fwd, gf.launches_bwd - bwd) == (layers, layers)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.card
def test_a_width_without_kernels_raises_on_the_card(card):
    g = _graph(300).to(card)
    model = GCNII(12, 10, 5, n_layers=2, dropout=0.6, device=card,
                  generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="multiple of 4"):
        model(g, g.node_feat, generator=torch.Generator(device=card).manual_seed(1))
