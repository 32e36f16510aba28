"""Parity of the port's device sampler with the JAX package's.

Both sides read the same CSR and the same uniforms: the JAX package's, drawn from
its key (``uniform(key)`` a layer, or ``split(key)`` into the anchor's and the
slots' in block-window mode; ``fold_in(key, li)`` for layer ``li`` of a multi-layer
sample), which the port takes as ``draws``. The sampled ids and masks, and every
field of every block, must then be identical (no tolerance: integer results of the
same float32 arithmetic). The graphs plant the cases that matter: rows of degree 0,
masked and padded seeds, a hub row spanning several 128-slot windows, rows that
straddle a window edge, the last row ending at ``n_edge``, and a graph with no
edges. The window mode's marginals are checked on the port's own draws, as the JAX
package checks its own (``test_device_sampler.py::test_marginal_uniformity``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu import native as jax_native
from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.graph import pad_graph as jax_pad_graph
from dgll_tpu.sampling import device_sampler as jds
from dgll_tpu_torch import native
from dgll_tpu_torch.data import synthetic_classification_graph
from dgll_tpu_torch.graph import pad_graph
from dgll_tpu_torch.sampling import (
    Block,
    DeviceCSR,
    DeviceNeighborSampler,
    sample_blocks_device,
    sample_layer_device,
)
from dgll_tpu_torch.sampling.device_sampler import WINDOW, layer_sizes


def planted_csr(seed=0):
    """``(indptr, src)``: 700 nodes; node 0 has no in-edge, node 1 is a hub of 300
    in-edges (3+ windows), node 699 (the last) has 9, and the rest 0-20 each, so that
    rows straddle the 128-slot window edges."""
    rng = np.random.default_rng(seed)
    n = 700
    deg = rng.integers(0, 21, n)
    deg[0], deg[1], deg[2], deg[n - 1] = 0, 300, 0, 9
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    src = rng.integers(0, n, int(indptr[-1]))
    return indptr, src


def _pair(indptr, src):
    return (DeviceCSR.from_host_arrays(indptr, src, "cpu"),
            jds.DeviceCSR.from_host_arrays(indptr, src))


def test_planted_graph_has_its_cases():
    indptr, _ = planted_csr()
    starts, ends = indptr[:-1], indptr[1:]
    assert ends[1] - starts[1] > 2 * WINDOW                    # a hub over 3+ windows
    straddle = (starts // WINDOW != (ends - 1) // WINDOW) & (ends > starts)
    assert straddle.sum() > 10
    assert (ends == starts).sum() >= 2 and ends[-1] > starts[-1]


def jax_layer_draws(key, n, fanout, window):
    """The uniforms ``sample_layer_device`` draws from ``key``, as numpy."""
    if window:
        ka, kl = jax.random.split(key)
        return (np.asarray(jax.random.uniform(ka, (n,))),
                np.asarray(jax.random.uniform(kl, (n, fanout))))
    return np.asarray(jax.random.uniform(key, (n, fanout)))


def to_torch(d):
    if isinstance(d, tuple):
        return tuple(torch.from_numpy(np.array(t)) for t in d)
    return torch.from_numpy(np.array(d))


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("fanout", [1, 7])
def test_layer_matches_jax(window, fanout):
    """Every node as a frontier row, plus masked rows (hub, zero-degree, last) and
    padded rows of id 0."""
    indptr, src = planted_csr()
    ct, cj = _pair(indptr, src)
    n_node = len(indptr) - 1
    frontier = np.concatenate([np.arange(n_node), [1, 0, 699, 5], np.zeros(6, int)])
    fmask = np.ones(len(frontier), bool)
    fmask[n_node:] = False
    fmask[np.random.default_rng(1).choice(n_node, 60, replace=False)] = False
    key = jax.random.key(7 + fanout)
    want_s, want_m = jds.sample_layer_device(
        cj, jnp.asarray(frontier, jnp.int32), jnp.asarray(fmask), fanout, key,
        window=window)
    got_s, got_m = sample_layer_device(
        ct, torch.from_numpy(frontier.astype(np.int32)), torch.from_numpy(fmask), fanout,
        draws=to_torch(jax_layer_draws(key, len(frontier), fanout, window)),
        window=window)
    assert got_s.dtype == torch.int32 and got_m.dtype == torch.bool
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    # the cases are really there: a masked hub emits itself, a valid hub its neighbours
    s = got_s.numpy()
    assert (s[n_node + 1] == 0).all() and not got_m[n_node + 1].any()
    nbrs1 = set(src[indptr[1]:indptr[2]].tolist())
    if fmask[1]:
        assert set(s[1].tolist()) <= nbrs1 and got_m[1].all()


@pytest.mark.parametrize("window", [False, True])
def test_graph_without_edges_gives_every_row_its_own_id(window):
    indptr = np.zeros(11, np.int64)
    ct, cj = _pair(indptr, np.zeros(0, np.int64))
    frontier = np.arange(10)
    fmask = np.arange(10) % 3 != 0
    key = jax.random.key(3)
    want = jds.sample_layer_device(cj, jnp.asarray(frontier, jnp.int32),
                                   jnp.asarray(fmask), 4, key, window=window)
    got = sample_layer_device(ct, torch.from_numpy(frontier), torch.from_numpy(fmask), 4,
                              draws=to_torch(jax_layer_draws(key, 10, 4, window)),
                              window=window)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0].numpy() == frontier[:, None]).all() and not got[1].any()


def same_blocks(bt, bj):
    assert len(bt) == len(bj)
    for t, j in zip(bt, bj):
        assert isinstance(t, Block)
        assert (t.fanout, t.n_dst, t.n_src) == (j.fanout, j.n_dst, j.n_src)
        for name in ("dst_ids", "src_ids", "neigh_mask", "dst_mask"):
            a, b = getattr(t, name), np.asarray(getattr(j, name))
            assert a.dtype == {np.dtype(np.int32): torch.int32,
                               np.dtype(bool): torch.bool}[b.dtype], name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def jax_block_draws(key, batch, fanouts, window):
    """Layer ``li``'s uniforms from ``fold_in(key, li)``, innermost layer first."""
    rev = list(reversed(fanouts))
    return [to_torch(jax_layer_draws(jax.random.fold_in(key, li), n, f, window))
            for li, (n, f) in enumerate(zip(layer_sizes(batch, fanouts), rev))]


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("fanouts", [[15, 10], [8, 6], []])
def test_blocks_match_jax(window, fanouts):
    """A batch of 48 seeds, the last 8 padded (id 0, mask 0), the hub and the
    zero-degree and last rows among them."""
    indptr, src = planted_csr(seed=2)
    ct, cj = _pair(indptr, src)
    seeds = np.concatenate([[1, 0, 2, 699], np.random.default_rng(4).integers(0, 700, 36),
                            np.zeros(8, int)]).astype(np.int32)
    mask = np.arange(48) < 40
    key = jax.random.key(11)
    inp_j, out_j, bj = jds.sample_blocks_device(cj, jnp.asarray(seeds), jnp.asarray(mask),
                                                fanouts, key, window=window)
    inp_t, out_t, bt = sample_blocks_device(
        ct, torch.from_numpy(seeds), torch.from_numpy(mask), fanouts,
        draws=jax_block_draws(key, 48, fanouts, window), window=window)
    same_blocks(bt, bj)
    np.testing.assert_array_equal(inp_t.numpy(), np.asarray(inp_j))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    if fanouts:
        assert bt[-1].n_dst == 48 and bt[0].n_src == inp_t.shape[0]
        assert (bt[-1].src_ids[:48].numpy() == seeds).all()     # self at head
    else:
        assert bt == [] and torch.equal(inp_t, torch.from_numpy(seeds))


def test_csr_from_graph_matches_jax():
    """Real nodes and real edges only, on a padded graph."""
    kw = dict(n_node=300, avg_degree=5, n_class=3, feat_dim=4, seed=5)
    gt, gj = pad_graph(synthetic_classification_graph(**kw)), jax_pad_graph(jax_synthetic(**kw))
    assert gt.n_node > gt.n_real_node and gt.n_edge > gt.n_real_edge
    ct, cj = DeviceCSR.from_graph(gt, "cpu"), jds.DeviceCSR.from_graph(gj)
    assert (ct.n_node, ct.n_edge) == (cj.n_node, cj.n_edge) == (300, gt.n_real_edge)
    assert ct.indptr.dtype == ct.src.dtype == torch.int32
    np.testing.assert_array_equal(ct.indptr.numpy(),
                                  np.asarray(cj.indptr_p).reshape(-1)[: ct.n_node + 1])
    np.testing.assert_array_equal(ct.src.numpy(),
                                  np.asarray(cj.src_p).reshape(-1)[: ct.n_edge])


def test_marginal_uniformity():
    """The window mode's draws of one 300-neighbour row, 2,000 rows of 8 draws from
    the port's generator: every neighbour drawn, frequencies within 4x of uniform,
    relative spread under 60% (the JAX package's bounds)."""
    n_nbr = 300
    indptr = np.array([0] + [n_nbr] * (n_nbr + 1), np.int64)
    csr = DeviceCSR.from_host_arrays(indptr, np.arange(1, n_nbr + 1), "cpu")
    reps = 2000
    gen = torch.Generator().manual_seed(0)
    s, m = sample_layer_device(csr, torch.zeros(reps, dtype=torch.int32),
                               torch.ones(reps, dtype=torch.bool), 8, gen, window=True)
    assert m.all()
    counts = np.bincount(s.numpy().reshape(-1), minlength=n_nbr + 2)
    freq = counts[1: n_nbr + 1] / (reps * 8)
    expect = 1.0 / n_nbr
    assert counts[0] == 0 and (counts[1: n_nbr + 1] > 0).all()
    assert freq.max() < 4 * expect and freq.min() > expect / 4
    assert freq.std() / expect < 0.6
    # draws within a row share one window: no row spans more than 128 slots
    rows = s.numpy() - 1
    assert (rows.max(1) // WINDOW - rows.min(1) // WINDOW <= 1).all()


def test_sampler_wrapper_draws_from_its_generator():
    indptr, src = planted_csr()
    csr = DeviceCSR.from_host_arrays(indptr, src, "cpu")
    s = DeviceNeighborSampler([5, 2], window=True)
    runs = [s.sample(csr, np.arange(10), torch.Generator().manual_seed(seed))
            for seed in (3, 3, 4)]
    inp, out, blocks = runs[0]
    assert len(blocks) == 2 and blocks[-1].n_dst == 10 and blocks[0].n_dst == 30
    assert inp.shape[0] == blocks[0].n_src == 180
    assert torch.equal(out, torch.arange(10, dtype=torch.int32))
    assert torch.equal(runs[0][0], runs[1][0]) and not torch.equal(runs[0][0], runs[2][0])


@pytest.mark.parametrize("weighted", [False, True])
def test_build_csr_apply_matches_jax(weighted):
    """The bench's CSR build: the port's binding of its own copy of the host C++
    against the JAX package's, on a graph large enough for the threaded path."""
    rng = np.random.default_rng(0)
    n, e = 5000, 1_500_000
    dst, src = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32) if weighted else None
    got = native.build_csr_apply(dst, src, w, n)
    want = jax_native.build_csr_apply(dst, src, w, n)
    assert got is not None and want is not None
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    order = np.argsort(dst, kind="stable")
    np.testing.assert_array_equal(got[1], src[order])
