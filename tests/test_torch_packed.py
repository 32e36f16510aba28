"""Parity of the port's packed host pipeline with the JAX package's: the packed
``DataLoader``, ``blocks_from_packed``, the packed, group and scanned steps,
``stack_batches``, ``run_epoch_packed`` and its link routing (``measure_link``,
``choose_packed_group``).

Both sides sample the same ``(ids, mask)`` buffers (the same C++ sampler and seed
stream, ``test_torch_sampling.py``) and start from the same parameters
(``params_from_flax``). Tolerances, float32 with dropout 0: 1e-5 for one step's loss
and parameters, 1e-4 for the losses and parameters of whole epochs (as
``test_torch_minibatch.py``). Within the port, a group with a padded tail and the
scanned step give exactly the single steps' losses and state (the same kernels in the
same order; the padding's suppression selects exactly). On the CPU every step runs
eagerly, the plain version of the CUDA graphs a CUDA device replays.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.dataloader import DataLoader as JaxDataLoader
from dgll_tpu.nn import GraphSAGE as JaxGraphSAGE
from dgll_tpu.sampling import HostGraph as JaxHostGraph
from dgll_tpu.sampling import NeighborSampler as JaxSampler
from dgll_tpu.train import MiniBatchTrainer as JaxTrainer
from dgll_tpu.train import trainer as jax_trainer
from dgll_tpu.train.trainer import TrainState as JaxTrainState
from dgll_tpu_torch.data import synthetic_classification_graph
from dgll_tpu_torch.dataloader import DataLoader
from dgll_tpu_torch.nn import GraphSAGE, params_from_flax
from dgll_tpu_torch.sampling import HostGraph, NeighborSampler
from dgll_tpu_torch.train import (
    MiniBatchTrainer,
    blocks_from_packed,
    choose_packed_group,
    create_train_state,
    cuda_graph,
    make_block_step,
    make_packed_block_step,
    make_packed_group_step,
    make_scanned_block_step,
    measure_link,
    stack_batches,
    trainer,
)
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)

GRAPH = dict(n_node=300, avg_degree=6, n_class=4, feat_dim=12, seed=11)
FANOUTS = [4, 3]
BATCH = 8  # 30 train nodes: 4 batches, so groups of 3 end in a padded tail

OPTIMIZERS = {
    "sgd": (optax.sgd(0.05), functools.partial(torch.optim.SGD, lr=0.05)),
    "adam": (optax.adam(1e-2), functools.partial(torch.optim.Adam, lr=1e-2)),
}


@pytest.fixture(scope="module")
def data():
    gt, gj = synthetic_classification_graph(**GRAPH), jax_synthetic(**GRAPH)
    np.testing.assert_array_equal(gt.node_feat.numpy(), np.asarray(gj.node_feat))
    return gt, gj, HostGraph.from_graph(gt), JaxHostGraph.from_graph(gj)


@pytest.fixture(scope="module")
def params(data):
    """The JAX GraphSAGE's initial parameters (hidden 8, 4 classes, dropout 0)."""
    _, gj, _, hj = data
    _, _, b0 = JaxSampler(FANOUTS, seed=0).sample(hj, np.arange(BATCH), pad_to=BATCH)
    x0 = jnp.take(jnp.asarray(gj.node_feat), jnp.asarray(b0[0].src_ids), axis=0)
    return JaxGraphSAGE(hidden=8, n_class=4, dropout=0.0).init(
        jax.random.key(3), list(b0), x0)["params"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _model(params, dropout=0.0):
    m = GraphSAGE(12, 8, 4, dropout=dropout)
    m.load_state_dict(params_from_flax(_np(params)))
    return m


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _same_params(model, jax_params, tol):
    want = params_from_flax(_np(jax_params))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k], v, tol, k)


def _packed(data, seeds, seed=0):
    """The port's and JAX's ``sample_packed`` of ``seeds``, padded to ``BATCH``."""
    _, _, ht, hj = data
    return (NeighborSampler(FANOUTS, seed=seed).sample_packed(ht, seeds, pad_to=BATCH),
            JaxSampler(FANOUTS, seed=seed).sample_packed(hj, seeds, pad_to=BATCH))


# ------------------------------------------------------- blocks and the loader

def test_blocks_from_packed_matches_jax_field_by_field(data):
    seeds = np.arange(3, 9)  # 6 seeds padded to 8: masked destinations
    (ids, mask), (ij, mj) = _packed(data, seeds)
    it, mt = torch.from_numpy(ids), torch.from_numpy(mask)
    got = blocks_from_packed(it, mt, FANOUTS)
    want = jax_trainer.blocks_from_packed(jnp.asarray(ij), jnp.asarray(mj), FANOUTS)
    _, _, sampled = NeighborSampler(FANOUTS, seed=0).sample(data[2], seeds, pad_to=BATCH)
    assert len(got) == len(want) == len(sampled) == 2
    for b, w, s in zip(got, want, sampled):
        assert (b.fanout, b.n_dst) == (w.fanout, w.n_dst) == (s.fanout, s.n_dst)
        for f in ("dst_ids", "src_ids", "neigh_mask", "dst_mask"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(w, f)),
                                          err_msg=f)
            np.testing.assert_array_equal(getattr(b, f).numpy(), getattr(s, f).numpy())
        assert b.neigh_mask.dtype == b.dst_mask.dtype == torch.bool
        assert b.src_ids.data_ptr() == it.data_ptr()  # views of the buffers
    assert got[-1].n_dst == BATCH and not got[-1].dst_mask[6:].any()
    # the one cast: both blocks' masks are views of one bool buffer
    assert got[0].dst_mask.data_ptr() == got[1].dst_mask.data_ptr()
    bool_mask = torch.from_numpy(mask.view(bool))
    assert blocks_from_packed(it, bool_mask, FANOUTS)[0].dst_mask.data_ptr() == \
        bool_mask.data_ptr()


@pytest.mark.parametrize("kw", [
    dict(shuffle=False),
    dict(shuffle=True),
    dict(shuffle=True, prefetch=0),
    dict(shuffle=True, drop_last=True, device="cpu"),
])
def test_packed_loader_matches_jax(data, kw):
    gt, gj, _, _ = data
    seeds = gt.get_train_nodes()
    jkw = {k: v for k, v in kw.items() if k != "device"}
    lt = DataLoader(gt, seeds, NeighborSampler(FANOUTS, seed=1), BATCH, seed=2,
                    packed=True, **kw)
    lj = JaxDataLoader(gj, seeds, JaxSampler(FANOUTS, seed=1), BATCH, seed=2,
                       packed=True, **jkw)
    for _ in range(2):  # two epochs: the permutation moves on
        bt, bj = list(lt), list(lj)
        assert len(bt) == len(bj) == len(lt) > 0
        for (it, mt), (ij, mj) in zip(bt, bj):
            if "device" in kw:
                assert isinstance(it, torch.Tensor) and it.device.type == "cpu"
                it, mt = it.numpy(), mt.numpy()
            assert it.dtype == np.int32 and mt.dtype == np.uint8
            np.testing.assert_array_equal(it, ij)
            np.testing.assert_array_equal(mt, mj)


def test_packed_loader_with_producers_yields_every_batch(data):
    gt = data[0]
    seeds = np.arange(100)
    one = DataLoader(gt, seeds, NeighborSampler(FANOUTS, seed=0), 10, shuffle=False,
                     packed=True)
    many = DataLoader(gt, seeds, NeighborSampler(FANOUTS, seed=0), 10, shuffle=False,
                      packed=True, n_producers=3, prefetch=4)
    heads = sorted(tuple(ids[:10]) for ids, _ in many)
    assert heads == sorted(tuple(ids[:10]) for ids, _ in one)
    assert len(heads) == 10


# -------------------------------------------------------------------- steps

@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_packed_step_matches_jax(data, params, opt):
    gt, gj, _, _ = data
    tx, opt_t = OPTIMIZERS[opt]
    (ids, mask), (ij, mj) = _packed(data, gt.get_train_nodes()[:BATCH], seed=4)
    model = _model(params)
    state = create_train_state(model, opt_t)
    step = make_packed_block_step(FANOUTS)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(2):  # the second step reads the first's optimizer state
        state, loss = step(state, ids, mask, gt.node_feat, gt.labels, gen)
        losses.append(float(loss))
    assert state.step == 2
    jstep = jax_trainer.make_packed_block_step(FANOUTS)
    js = JaxTrainState.create(apply_fn=JaxGraphSAGE(hidden=8, n_class=4, dropout=0.0).apply,
                              params=params, tx=tx)
    want = []
    for _ in range(2):
        js, jl = jstep(js, jnp.asarray(ij), jnp.asarray(mj), jnp.asarray(gj.node_feat),
                       jnp.asarray(gj.labels), jax.random.key(0))
        want.append(float(jl))
    _close(losses, want, 1e-5, "losses")
    _same_params(model, js.params, 1e-5)


def _torch_epochs(data, params, group, epochs=3, dropout=0.0, seed=5, opt="adam"):
    gt, _, ht, _ = data
    model = _model(params, dropout)
    tr = MiniBatchTrainer(model, OPTIMIZERS[opt][1], seed=seed, device="cpu")
    state, sampler, losses = tr.init_state(), NeighborSampler(FANOUTS, seed=0), []
    for _ in range(epochs):
        loader = DataLoader(ht, gt.get_train_nodes(), sampler, BATCH, packed=True, seed=7)
        state, loss, secs = tr.run_epoch_packed(state, loader, gt.node_feat, gt.labels,
                                                FANOUTS, group=group)
        assert secs > 0 and tr.last_group == group
        losses.append(loss)
    return losses, model, state


@pytest.mark.parametrize("group", [1, 3])
def test_run_epoch_packed_matches_jax(data, params, group):
    _, gj, _, hj = data
    losses, model, state = _torch_epochs(data, params, group)
    assert state.step == 3 * 4
    tx = OPTIMIZERS["adam"][0]
    mj = JaxGraphSAGE(hidden=8, n_class=4, dropout=0.0)
    tr = JaxTrainer(mj, tx, seed=5)
    js = JaxTrainState.create(apply_fn=mj.apply, params=params, tx=tx)
    sampler, want = JaxSampler(FANOUTS, seed=0), []
    for _ in range(3):
        loader = JaxDataLoader(hj, gj.get_train_nodes(), sampler, BATCH, packed=True,
                               seed=7)
        js, loss, _ = tr.run_epoch_packed(js, loader, gj.node_feat, gj.labels, FANOUTS,
                                          group=group)
        want.append(loss)
    _close(losses, want, 1e-4, "epoch losses")
    _same_params(model, js.params, 1e-4)
    assert losses[-1] < losses[0]


def _optimizer_state(state):
    return [t.clone() for s in state.optimizer.state.values() for t in s.values()
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("dropout,epochs", [(0.0, 3), (0.5, 1)])
def test_group_with_a_padded_tail_matches_group_one(data, params, dropout, epochs):
    """4 batches an epoch in groups of 3: one full group and one of 1 batch and 2
    all-zero-mask ones, whose updates (Adam's moments and step count too) are
    suppressed. The real batches draw their dropout masks from the same generator in
    the same order; the padding draws too, after them, so with dropout the epochs
    that follow a padded group draw other masks (as in the JAX package)."""
    l1, m1, s1 = _torch_epochs(data, params, 1, epochs, dropout=dropout)
    l3, m3, s3 = _torch_epochs(data, params, 3, epochs, dropout=dropout)
    assert l1 == l3 and s1.step == s3.step == 4 * epochs
    for a, b in zip(m1.parameters(), m3.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(_optimizer_state(s1), _optimizer_state(s3)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_group_step_suppresses_all_zero_batches(data, params, opt):
    """A group whose batches are all padding, as the very first step, leaves the
    parameters and gives the optimizer its initial state; a group of one batch and
    one pad equals one packed step."""
    gt = data[0]
    (ids, mask), _ = _packed(data, gt.get_train_nodes()[:BATCH], seed=4)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    zi, zm = torch.zeros_like(ids), torch.zeros_like(mask)
    group = make_packed_group_step(FANOUTS)
    gen = torch.Generator().manual_seed(0)
    model = _model(params)
    before = [p.detach().clone() for p in model.parameters()]
    state = create_train_state(model, OPTIMIZERS[opt][1])
    state, lsum, nvalid = group(state, torch.stack([zi, zi]), torch.stack([zm, zm]),
                                gt.node_feat, gt.labels, gen)
    assert float(lsum) == 0.0 and float(nvalid) == 0.0
    for a, b in zip(model.parameters(), before):
        assert torch.equal(a, b)
    assert all(not t.any() for t in _optimizer_state(state))
    state, lsum, nvalid = group(state, torch.stack([ids, zi]), torch.stack([mask, zm]),
                                gt.node_feat, gt.labels, gen)
    ref = _model(params)
    ref_state = create_train_state(ref, OPTIMIZERS[opt][1])
    ref_state, loss = make_packed_block_step(FANOUTS)(ref_state, ids, mask, gt.node_feat,
                                                      gt.labels, gen)
    assert float(lsum) == float(loss) and float(nvalid) == 1.0
    for a, b in zip(model.parameters(), ref.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(_optimizer_state(state), _optimizer_state(ref_state)):
        assert torch.equal(a, b)


def _batches(data, k, seed=6):
    """``k`` unpacked batches ``(blocks, x, y, mask)`` on both sides."""
    gt, gj, ht, hj = data
    rng = np.random.default_rng(seed)
    st, sj = NeighborSampler(FANOUTS, seed=seed), JaxSampler(FANOUTS, seed=seed)
    out_t, out_j = [], []
    for _ in range(k):
        seeds = rng.choice(gt.n_real_node, BATCH - 1, replace=False)
        _, _, bt = st.sample(ht, seeds, pad_to=BATCH)
        _, _, bj = sj.sample(hj, seeds, pad_to=BATCH)
        x = gt.node_feat.index_select(0, bt[0].src_ids)
        y = gt.labels.index_select(0, bt[-1].dst_ids)
        out_t.append((bt, x, y, bt[-1].dst_mask))
        out_j.append((tuple(bj), jnp.asarray(x.numpy()), jnp.asarray(y.numpy()),
                      jnp.asarray(bj[-1].dst_mask)))
    return out_t, out_j


def test_scanned_step_matches_single_steps_and_jax(data, params):
    batches, jbatches = _batches(data, 3)
    gen = torch.Generator().manual_seed(0)
    scanned = _model(params)
    state = create_train_state(scanned, OPTIMIZERS["adam"][1])
    state, losses = make_scanned_block_step()(state, *stack_batches(batches), gen)
    assert losses.shape == (3,) and state.step == 3
    single = _model(params)
    ref = create_train_state(single, OPTIMIZERS["adam"][1])
    step = make_block_step()
    ref_losses = []
    for blocks, x, y, m in batches:
        ref, loss = step(ref, blocks, x, y, m, gen)
        ref_losses.append(loss)
    assert torch.equal(losses, torch.stack(ref_losses))
    for a, b in zip(scanned.parameters(), single.parameters()):
        assert torch.equal(a, b)
    tx = OPTIMIZERS["adam"][0]
    js = JaxTrainState.create(apply_fn=JaxGraphSAGE(hidden=8, n_class=4, dropout=0.0).apply,
                              params=params, tx=tx)
    js, want = jax_trainer.make_scanned_block_step()(
        js, *jax_trainer.stack_batches(jbatches), jax.random.key(0))
    _close(losses, want, 1e-5, "losses")
    _same_params(scanned, js.params, 1e-5)


def test_stack_batches_matches_jax_and_checks_shapes(data):
    batches, jbatches = _batches(data, 2)
    blocks_k, x_k, y_k, m_k = stack_batches(batches)
    jb, jx, jy, jm = jax_trainer.stack_batches(jbatches)
    for b, w in zip(blocks_k, jb):
        assert (b.fanout, b.n_dst) == (w.fanout, w.n_dst)
        for f in ("dst_ids", "src_ids", "neigh_mask", "dst_mask"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(w, f)))
    for a, b in ((x_k, jx), (y_k, jy), (m_k, jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    other = NeighborSampler([2, 3], seed=0).sample(data[2], np.arange(4), pad_to=BATCH)[2]
    with pytest.raises(ValueError, match="differ in shape"):
        stack_batches([batches[0], (other, *batches[1][1:])])


# ------------------------------------------------------------- link routing

def test_choose_packed_group_matches_jax_on_a_grid():
    payloads = [1_000, 180_224 * 5, 720_000, 8 << 20]
    bandwidths = [1.0, 30e6, 1e9, 10e9, 50e9]
    rtts = [0.0, 1e-5, 1e-4, 0.002, 0.02, 0.05]
    for p in payloads:
        for bw in bandwidths:
            for rtt in rtts:
                for max_group in (4, 8):
                    assert choose_packed_group(p, bw, rtt, max_group) == \
                        jax_trainer.choose_packed_group(p, bw, rtt, max_group), (p, bw, rtt)
    assert choose_packed_group(720_000, 30e6, rtt=0.02) == 1
    assert choose_packed_group(1_000, 10e9, rtt=0.05) == 8


def test_measure_link_is_sane_on_the_cpu():
    bw, rtt = measure_link("cpu", size_bytes=1 << 20)
    assert bw > 1e6 and 0 < rtt < 5.0


def test_measure_link_times_the_copy_alone_a_deviation_from_jax(monkeypatch):
    """The port's bandwidth is the copy's bytes over the copy's own time (CUDA events
    on a card, the host clock here), with no round trip subtracted; the JAX package's
    is ``size / max(t - rtt, 1e-6)``, which reports about 4 TB/s wherever the round
    trip is as long as the copy. A clock that advances 2 ms a reading makes the round
    trip 0.5 ms and the copy 2 ms."""
    ticks = iter(np.arange(0.0, 1.0, 0.002))
    monkeypatch.setattr(trainer.time, "perf_counter", lambda: next(ticks))
    bw, rtt = measure_link("cpu", size_bytes=4 << 20)
    assert rtt == pytest.approx(0.0005) and bw == pytest.approx((4 << 20) / 0.002)


def test_auto_group_routes_by_the_link(data, params):
    gt, _, ht, _ = data
    tr = MiniBatchTrainer(_model(params), OPTIMIZERS["adam"][1], device="cpu")
    state = tr.init_state()
    sampler = NeighborSampler(FANOUTS, seed=0)
    for link, expect in (((30e6, 0.0001), 1), ((10e9, 0.05), 8)):
        tr._link = link  # a slow link, then a fast one with a long round trip
        loader = DataLoader(ht, np.arange(200), sampler, 32, seed=0, packed=True)
        state, loss, _ = tr.run_epoch_packed(state, loader, gt.node_feat, gt.labels,
                                             FANOUTS, group="auto")
        assert tr.last_group == expect and np.isfinite(loss)
    assert set(tr._packed_steps) == {(tuple(FANOUTS), 1), (tuple(FANOUTS), 8)}
    empty = DataLoader(ht, np.arange(0), sampler, 32, packed=True)
    assert tr.run_epoch_packed(state, empty, gt.node_feat, gt.labels, FANOUTS,
                               group="auto")[1:] == (0.0, 0.0)
    assert tr.last_group == 1
    tr._link = None
    tr.run_epoch_packed(state, DataLoader(ht, np.arange(64), sampler, 32, packed=True),
                        gt.node_feat, gt.labels, FANOUTS, group="auto")
    assert tr._link is not None and tr._link[0] > 0  # probed once, on the CPU


def test_a_cuda_graph_needs_a_card_and_a_capturable_optimizer(data, params):
    gt = data[0]
    (ids, mask), _ = _packed(data, np.arange(BATCH))
    state = create_train_state(_model(params), OPTIMIZERS["adam"][1])
    step = make_packed_block_step(FANOUTS, cuda_graph=True)
    with pytest.raises(ValueError, match="CUDA device"):
        step(state, ids, mask, gt.node_feat, gt.labels, torch.Generator())
    with pytest.raises(ValueError, match="capturable"):
        cuda_graph.capture(state, torch.Generator(), lambda: None)
