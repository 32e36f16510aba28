"""Parity of the port's GAT slice with the JAX package's, on the CPU.

The same inputs, made with numpy, go through the JAX functions (their Pallas
kernels in interpret mode, on layouts with 128-slot chunks, as
``tests/test_gat_fused.py`` runs them) and through the port, whose kernel wrappers
run their plain PyTorch versions on CPU tensors:

* each kernel's plain version: K3 ``gat_stats``, K4 ``gat_alpha``, K5
  ``gat_bwd_softmax``, K6 ``_e2r_sum_multi_d`` (sum mode), K7
  ``expand_rows_chunked``, and K1 with runtime columns and weights (and
  ``spmm_edges``, the layer's entry to it);
* ``t_slot_perm``;
* the layers' rule that only the CPU runs the plain version without the layouts;
* the fused layer against ``gat_attention_chunked_fused``, forward and gradients,
  H in {1, 8}, with and without an attention-dropout mask;
* ``GATConv`` against JAX ``GATConv`` on its chunked and COO branches, and ``GAT``
  with parameters carried across by ``params_from_flax``;
* the CLI's GAT branch.

JAX slots map to the port's edge order by (source, destination); duplicate edges
pair in a fixed order, which both sides see alike. The test graph has a hub row
wider than a chunk, an edgeless 128-row block and duplicate edges.

Tolerance (f32): atol 1e-5 x max|ref| on every compared array of the kernels, the
fused layer and ``GATConv``, and 1e-4 x max|ref| for the two-layer ``GAT`` (as for
``GCN`` in ``test_torch_models.py``): the two sides sum in different orders, and
the output layer's attention gradients are sums over every node whose terms cancel
to about a hundredth of their size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.data import gcn_normalize as jax_gcn_normalize
from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.nn import GAT as JaxGAT
from dgll_tpu.nn.conv import GATConv as JaxGATConv
from dgll_tpu.ops.chunked import R_BLOCK
from dgll_tpu.ops.chunked import build_chunked_pair as jax_build_chunked_pair
from dgll_tpu.ops.pallas.edge_ops import _e2r_sum_multi_d
from dgll_tpu.ops.pallas.expand_rows import expand_rows_chunked
from dgll_tpu.ops.pallas.gat import gat_attention_chunked_fused
from dgll_tpu.ops.pallas.gat_fused import gat_alpha, gat_bwd_softmax, gat_stats
from dgll_tpu.ops.pallas.segment_matmul import spmm_chunked_pallas
from dgll_tpu.run import main as jax_main
from dgll_tpu.train.metrics import masked_nll_loss as jax_nll
from dgll_tpu_torch import run as torch_run
from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu_torch.nn import GAT, GATConv, params_from_flax
from dgll_tpu_torch.nn.conv import kernel_layouts
from dgll_tpu_torch.ops import build_chunked_pair, gat_csr, spmm_chunked_reference
from dgll_tpu_torch.ops.cuda import gat_fused as tgf
from dgll_tpu_torch.ops.cuda import segment_matmul as sm
from dgll_tpu_torch.train import masked_nll_loss

N = 300      # nodes: rows 128..255 have no in-edges; the layouts pad to 384 rows
E = 1500
HEADS = [1, 8]
GRAPH = dict(n_node=200, avg_degree=4, n_class=3, feat_dim=16, power_law=1.0, seed=7)


def _close(got, want, scale=1e-5, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def layouts():
    """(JAX layouts, port layouts, slots): JAX slot ``slots[k]`` holds the port's
    edge ``k``."""
    rng = np.random.default_rng(0)
    p = (np.arange(N) + 1.0) ** -1.0
    dst = rng.choice(N, size=E, p=p / p.sum())
    dst[(dst >= 128) & (dst < 256)] -= 128
    src = rng.integers(0, N, E)
    src[:40], dst[:40] = src[40:80], dst[40:80]          # duplicate edges
    jc, jct = jax_build_chunked_pair(src, dst, N, N, None, eb=128)
    c, ct = build_chunked_pair(src, dst, N, N)
    assert np.bincount(dst).max() > 128                  # a hub row spans chunks

    nc = jc.n_chunk
    dst_g = (np.asarray(jc.row_block)[:nc, None] * R_BLOCK
             + np.asarray(jc.dst_local)[:nc]).reshape(-1)
    src_g = np.asarray(jc.src)[:nc].reshape(-1)
    valid = np.flatnonzero(np.asarray(jc.weight)[:nc].reshape(-1) != 0)
    slots = valid[np.lexsort((src_g[valid], dst_g[valid]))]
    # the port's edges are sorted by (destination, source) already
    np.testing.assert_array_equal(c.rows.numpy(), dst_g[slots])
    np.testing.assert_array_equal(c.src.numpy(), src_g[slots])
    return jc, jct, c, ct, slots


def _to_slots(jc, slots, x):
    """Per-edge port values ``[nnz, ...]`` as a JAX slot array (0 on padding)."""
    out = np.zeros((jc.n_chunk_meta * jc.eb, *x.shape[1:]), np.float32)
    out[slots] = x
    return jnp.asarray(out)


def _edge_inputs(c, heads, seed):
    rng = np.random.default_rng(seed)
    sc = (rng.normal(size=(c.src.numel(), heads)) * 2).astype(np.float32)
    sd = (rng.normal(size=(c.n_rows, heads)) * 2).astype(np.float32)
    return sc, sd, rng


# ------------------------------------------------------------------ the kernels

@pytest.mark.parametrize("heads", HEADS)
def test_gat_stats_matches_jax(layouts, heads):
    jc, _, c, _, slots = layouts
    sc, sd, _ = _edge_inputs(c, heads, 1)
    jm, jden = gat_stats(jc, _to_slots(jc, slots, sc), jnp.asarray(sd), 0.2,
                         interpret=True)
    m, den = tgf.gat_stats(c, torch.from_numpy(sc), torch.from_numpy(sd), 0.2)
    has = np.diff(c.indptr.numpy()) > 0
    _close(m[has], np.asarray(jm)[has])
    _close(den, jden)
    assert (~has).sum() >= 128 + (c.n_rows - N)
    assert (m[~has] == gat_csr.NEG).all() and (den[~has] == 0).all()
    assert (np.asarray(jm)[~has] == gat_csr.NEG).all()


@pytest.mark.parametrize("heads", HEADS)
def test_gat_alpha_matches_jax(layouts, heads):
    jc, _, c, _, slots = layouts
    sc, sd, _ = _edge_inputs(c, heads, 2)
    jsc = _to_slots(jc, slots, sc)
    jm, jden = gat_stats(jc, jsc, jnp.asarray(sd), 0.2, interpret=True)
    ja, jl = gat_alpha(jc, jsc, jnp.asarray(sd), jm, jden, 0.2, interpret=True)
    a, lg = tgf.gat_alpha(c, torch.from_numpy(sc), torch.from_numpy(sd),
                          torch.tensor(np.asarray(jm)), torch.tensor(np.asarray(jden)), 0.2)
    _close(a, np.asarray(ja)[slots])
    np.testing.assert_array_equal(lg.numpy(), np.asarray(jl)[slots])
    # alpha is a softmax over each row's edges
    sums = gat_csr.edges_to_rows_sum_reference(c, a)[np.diff(c.indptr.numpy()) > 0]
    _close(sums, np.ones_like(sums.numpy()))


@pytest.mark.parametrize("heads", HEADS)
def test_edges_to_rows_sum_matches_jax(layouts, heads):
    jc, _, c, _, slots = layouts
    v, _, _ = _edge_inputs(c, heads, 3)
    want = _e2r_sum_multi_d(True, jc, _to_slots(jc, slots, v))
    got = tgf.edges_to_rows_sum(c, torch.from_numpy(v))
    _close(got, want)
    assert (got[np.diff(c.indptr.numpy()) == 0] == 0).all()


@pytest.mark.parametrize("heads", HEADS)
def test_gat_bwd_softmax_matches_jax(layouts, heads):
    jc, _, c, _, slots = layouts
    alpha, s, rng = _edge_inputs(c, heads, 4)
    alpha = np.abs(alpha) / 4
    dalpha = rng.normal(size=alpha.shape).astype(np.float32)
    lgrad = np.where(rng.random(alpha.shape) > 0.5, 1.0, 0.2).astype(np.float32)
    jdz, jdsd = gat_bwd_softmax(jc, *(_to_slots(jc, slots, x) for x in (alpha, dalpha, lgrad)),
                                jnp.asarray(s), interpret=True)
    dz, dsd = tgf.gat_bwd_softmax(c, *map(torch.from_numpy, (alpha, dalpha, lgrad, s)))
    _close(dz, np.asarray(jdz)[slots])
    _close(dsd, jdsd)  # every row, the edgeless ones included (0)
    assert (dsd[np.diff(c.indptr.numpy()) == 0] == 0).all()


def test_expand_rows_matches_jax(layouts):
    jc, _, c, _, slots = layouts
    a = np.random.default_rng(5).normal(size=(c.n_rows, 128)).astype(np.float32)
    want = expand_rows_chunked(jc, jnp.asarray(a), interpret=True)
    got = tgf.expand_rows(c, torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[slots])


def test_t_slot_perm_maps_a_order_to_transpose_order(layouts):
    _, _, c, ct, _ = layouts
    perm = c.t_slot_perm.long()
    assert c.t_slot_perm.dtype == torch.int32
    assert torch.equal(perm.sort().values, torch.arange(c.src.numel()))
    # A's edge (src, dst) is the transpose's (dst of ct = ct.rows, src of ct = ct.src)
    assert torch.equal(c.src[perm], ct.rows) and torch.equal(c.rows[perm], ct.src)
    # duplicate edges pair consistently: distinct weights on them still line up
    rng = np.random.default_rng(6)
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    src[:100], dst[:100] = src[100:200], dst[100:200]
    w = rng.random(400).astype(np.float32)
    a, at = build_chunked_pair(src, dst, 50, 50, w)
    assert torch.equal(a.weight[a.t_slot_perm.long()], at.weight)


@pytest.mark.parametrize("transpose", [False, True])
def test_spmm_runtime_columns_and_weights_match_jax(layouts, transpose):
    """K1 summing per-edge messages with runtime weights: identity columns on A (the
    forward aggregation) and ``t_slot_perm`` columns on A^T (the backward scatter),
    against JAX ``spmm_chunked_pallas(..., weights=...)``."""
    jc, jct, c, ct, slots = layouts
    rng = np.random.default_rng(7)
    msg = rng.normal(size=(c.src.numel(), 128)).astype(np.float32)
    w = rng.random(c.src.numel()).astype(np.float32)
    if transpose:
        jmsg = jnp.concatenate([_to_slots(jc, slots, msg)[: jc.n_chunk * jc.eb],
                                jnp.zeros((1, 128))], axis=0)
        jmsg = jnp.take(jmsg, jc.t_slot_perm, axis=0)
        jw = (jct.weight != 0).astype(jnp.float32)
        want = spmm_chunked_pallas(jct, jmsg, weights=jw, interpret=True)
        got = spmm_chunked_reference(ct, torch.from_numpy(msg), cols=c.t_slot_perm,
                                     weights=torch.ones(ct.src.numel()))
    else:
        jw = _to_slots(jc, slots, w).reshape(jc.n_chunk_meta, jc.eb)
        jmsg = _to_slots(jc, slots, msg)[: jc.n_chunk * jc.eb]
        want = spmm_chunked_pallas(jc, jmsg, weights=jw, interpret=True)
        got = spmm_chunked_reference(c, torch.from_numpy(msg),
                                     cols=torch.arange(c.src.numel(), dtype=torch.int32),
                                     weights=torch.from_numpy(w))
    _close(got, want)


@pytest.mark.parametrize("backward", [False, True])
def test_spmm_edges_sums_edge_messages(layouts, backward):
    """``spmm_edges``, the GAT layer's K1 entry: a unit-weight sum of per-edge
    messages, through identity columns on A or ``t_slot_perm`` columns on A^T; on
    CPU tensors it is the plain version and counts no launch."""
    _, _, c, ct, _ = layouts
    msg = torch.from_numpy(np.random.default_rng(9).normal(
        size=(c.src.numel(), 16)).astype(np.float32))
    lay, cols = (ct, c.t_slot_perm) if backward else (c, None)
    order = msg if cols is None else msg[cols.long()]
    want = torch.zeros(lay.n_rows, 16).index_add(0, lay.rows, order)
    before = (sm.launches_fwd, sm.launches_bwd)
    got = sm.spmm_edges(lay, msg, cols, backward=backward)
    _close(got, want.numpy())
    assert (sm.launches_fwd, sm.launches_bwd) == before
    assert lay.edge_ids is lay.edge_ids and lay.unit_weight is lay.unit_weight
    assert torch.equal(lay.edge_ids, torch.arange(lay.src.numel(), dtype=torch.int32))
    assert torch.equal(lay.unit_weight, torch.ones(lay.src.numel()))


@pytest.mark.parametrize("device", ["cuda", "meta"])
def test_layers_off_the_cpu_need_the_kernel_layouts(device):
    """A GCN or GAT layer runs its plain COO version on the CPU only: on another
    device a graph without the kernel layouts raises instead of falling back."""
    g = gcn_normalize(synthetic_classification_graph(**GRAPH))
    assert kernel_layouts(g, g.n_node, torch.device("cpu")) is None
    with pytest.raises(ValueError, match="with_chunked"):
        kernel_layouts(g, g.n_node, torch.device(device))
    gc = g.with_chunked()
    c, ct = kernel_layouts(gc, gc.n_node, torch.device(device))
    assert c is gc.chunked and ct is gc.chunked_t


def test_kernel_launchers_take_cuda_tensors_only(layouts):
    """On a CPU tensor the wrappers run the plain versions; the launchers refuse it,
    and another device raises rather than falls back."""
    _, _, c, _, _ = layouts
    v = torch.ones(c.src.numel(), 2)
    with pytest.raises(ValueError, match="CUDA"):
        tgf.edges_to_rows_sum_cuda(c, v)
    with pytest.raises(ValueError, match="CUDA"):
        tgf.expand_rows_cuda(c, torch.ones(c.n_rows, 4))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tgf.edges_to_rows_sum(c, v.to("meta"))
    before = dict(tgf.launches)
    tgf.edges_to_rows_sum(c, v)
    assert tgf.launches == before  # the plain version is not a launch


# ---------------------------------------------------------------- the fused layer

def _layer_inputs(c, heads, seed):
    rng = np.random.default_rng(seed)
    f = 128 // heads   # the JAX op needs H*F % 128 == 0
    h = rng.normal(size=(N, heads * f)).astype(np.float32)
    a_src = (rng.normal(size=(heads, f)) * 0.3).astype(np.float32)
    a_dst = (rng.normal(size=(heads, f)) * 0.3).astype(np.float32)
    cot = rng.normal(size=(c.n_rows, heads, f)).astype(np.float32)
    return h, a_src, a_dst, cot, rng


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("heads", HEADS)
def test_fused_layer_matches_jax(layouts, heads, dropout):
    jc, jct, c, ct, slots = layouts
    h, a_src, a_dst, cot, rng = _layer_inputs(c, heads, 8 + heads)
    mask = None
    if dropout:
        mask = ((rng.random((c.src.numel(), heads)) > 0.4) / 0.6).astype(np.float32)
    jmask = None if mask is None else _to_slots(jc, slots, mask)
    hpad = np.pad(h, ((0, c.n_rows - N), (0, 0)))

    def jloss(h_, as_, ad_):
        out = gat_attention_chunked_fused(jc, jct, h_, as_, ad_, 0.2, interpret=True,
                                          drop_mask=jmask)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(hpad), jnp.asarray(a_src), jnp.asarray(a_dst))

    ht, ast, adt = (torch.tensor(x, requires_grad=True) for x in (h, a_src, a_dst))
    out = tgf.gat_attention_fused(c, ct, ht, ast, adt, 0.2,
                                  None if mask is None else torch.from_numpy(mask))
    assert out.shape == (c.n_rows, heads, 128 // heads)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, want, err_msg="out")
    _close(ht.grad, np.asarray(jgrads[0])[:N], err_msg="dh")
    _close(ast.grad, jgrads[1], err_msg="da_src")
    _close(adt.grad, jgrads[2], err_msg="da_dst")


def test_fused_layer_counts_no_launch_on_cpu(layouts):
    _, _, c, ct, _ = layouts
    h, a_src, a_dst, _, _ = _layer_inputs(c, 8, 3)
    before = dict(tgf.launches)
    ht = torch.tensor(h, requires_grad=True)
    tgf.gat_attention_fused(c, ct, ht, torch.from_numpy(a_src),
                            torch.from_numpy(a_dst)).sum().backward()
    assert tgf.launches == before
    with pytest.raises(ValueError, match="drop_mask"):
        tgf.gat_attention_fused(c, ct, ht, torch.from_numpy(a_src),
                                torch.from_numpy(a_dst), drop_mask=torch.ones(3, 8))


# ------------------------------------------------------------ GATConv and GAT

def _graphs(chunked: bool):
    gj = jax_gcn_normalize(jax_synthetic(**GRAPH))
    gt = gcn_normalize(synthetic_classification_graph(**GRAPH))
    if chunked:
        gj, gt = gj.with_chunked(eb=128), gt.with_chunked()
    return jax.tree.map(jnp.asarray, gj), gt


def _strip(state, prefix="convs.0."):
    return {k[len(prefix):]: v for k, v in state.items()}


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("heads", HEADS)
def test_gatconv_matches_jax(chunked, heads):
    """Forward and gradients (x, projection, attn_src, attn_dst) of one layer; H=8
    with 8 features per head is the published hidden layer, which the JAX chunked
    branch zero-pads to 16 features per head."""
    gj, gt = _graphs(chunked)
    f = 8 if heads == 8 else 16
    conv_j = JaxGATConv(features=f, num_heads=heads)
    params = conv_j.init(jax.random.key(1), gj, gj.node_feat)["params"]
    cot = np.random.default_rng(9).normal(size=(GRAPH["n_node"], heads * f)).astype(np.float32)

    def jloss(p, x):
        out = conv_j.apply({"params": p}, gj, x)
        return jnp.sum(out * cot), out

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, gj.node_feat)

    conv = GATConv(GRAPH["feat_dim"], f, heads)
    conv.load_state_dict(_strip(params_from_flax(
        {"GATConv_0": jax.tree.map(np.asarray, params)})))
    x = gt.node_feat.clone().requires_grad_(True)
    out = conv(gt, x)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out, want, err_msg="out")
    _close(x.grad, gx, err_msg="dx")
    _close(conv.linear.weight.grad.T, gp["weight"]["kernel"], err_msg="dW")
    _close(conv.attn_src.grad, gp["attn_src"], err_msg="da_src")
    _close(conv.attn_dst.grad, gp["attn_dst"], err_msg="da_dst")


def _gat_pair(chunked: bool):
    gj, gt = _graphs(chunked)
    mj = JaxGAT(hidden=8, n_class=3, num_heads=8, dropout=0.0)
    params = mj.init(jax.random.key(0), gj, gj.node_feat)["params"]
    mt = GAT(GRAPH["feat_dim"], hidden=8, n_class=3, num_heads=8, dropout=0.0)
    mt.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return gj, gt, mj, params, mt


@pytest.mark.parametrize("chunked", [False, True])
def test_gat_log_probs_and_gradients_match(chunked):
    gj, gt, mj, params, mt = _gat_pair(chunked)

    def loss_of(p):
        logp = mj.apply({"params": p}, gj, gj.node_feat)
        return jax_nll(logp, gj.labels, gj.train_mask), logp

    (lj, want), gradj = jax.value_and_grad(loss_of, has_aux=True)(params)
    mt.eval()
    logp = mt(gt, gt.node_feat)
    loss = masked_nll_loss(logp, gt.labels, gt.train_mask)
    loss.backward()
    _close(logp, want, 1e-4, err_msg="log-probs")
    _close(loss, lj, 1e-4, err_msg="loss")
    for i, conv in enumerate(mt.convs):
        gl = gradj[f"GATConv_{i}"]
        _close(conv.linear.weight.grad.T, gl["weight"]["kernel"], 1e-4, err_msg=f"dW{i}")
        _close(conv.attn_src.grad, gl["attn_src"], 1e-4, err_msg=f"da_src{i}")
        _close(conv.attn_dst.grad, gl["attn_dst"], 1e-4, err_msg=f"da_dst{i}")


def test_params_from_flax_gat_layout():
    _, _, _, params, mt = _gat_pair(False)
    state = params_from_flax(jax.tree.map(np.asarray, params))
    assert set(state) == set(mt.state_dict())
    assert state["convs.0.linear.weight"].shape == (64, GRAPH["feat_dim"])
    assert state["convs.0.attn_src"].shape == (8, 8)
    assert state["convs.1.attn_dst"].shape == (1, 3)
    with pytest.raises(ValueError, match="GAT"):
        params_from_flax({"GATConv_0": params["GATConv_0"], "Dense_1": {}})


def test_gat_init_matches_flax_statistics():
    """LeCun normal projections and Glorot uniform attention vectors, as flax draws
    them; the numbers differ (torch vs JAX generators), so the ranges and moments
    are compared."""
    m = GAT(256, hidden=64, n_class=8, num_heads=8, generator=torch.Generator().manual_seed(0))
    w = m.convs[0].linear.weight.detach().numpy()
    np.testing.assert_allclose(w.var(), 1 / 256, rtol=0.02)
    for conv in m.convs:
        h, f = conv.attn_src.shape
        bound = np.sqrt(6 / (h + f))
        ja = np.asarray(jax.nn.initializers.glorot_uniform()(jax.random.key(0), (h, f)))
        assert np.abs(ja).max() <= bound + 1e-6
        for a in (conv.attn_src, conv.attn_dst):
            assert a.abs().max().item() <= bound + 1e-6
            assert a.abs().max().item() > bound / 2
    m2 = GAT(256, hidden=64, n_class=8, num_heads=8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(m2.convs[1].attn_dst, m.convs[1].attn_dst)


@pytest.mark.parametrize("chunked", [False, True])
def test_gat_dropout_uses_generator(chunked):
    """Feature and attention dropout draw from the generator passed to ``forward``;
    the output layer has no attention dropout, and eval mode none at all."""
    _, gt = _graphs(chunked)
    m = GAT(GRAPH["feat_dim"], hidden=8, n_class=3, num_heads=8, dropout=0.5,
            generator=torch.Generator().manual_seed(0))
    assert m.convs[0].attn_dropout == 0.5 and m.convs[1].attn_dropout == 0.0
    m.train()
    a = m(gt, gt.node_feat, generator=torch.Generator().manual_seed(1))
    b = m(gt, gt.node_feat, generator=torch.Generator().manual_seed(1))
    c = m(gt, gt.node_feat, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    m.eval()
    assert torch.equal(m(gt, gt.node_feat), m(gt, gt.node_feat))


# --------------------------------------------------------------------- the CLI

def test_cli_trains_gat_with_the_jax_cli_keys():
    args = ["--Model", "GAT", "--samp_type", "full", "--n_node", "2000", "--n_epochs", "3",
            "--nhid", "8", "--n_heads", "8", "--dropout", "0.6", "--lr", "0.005",
            "--weight_decay", "0.0005"]
    want = jax_main(args)
    got = torch_run.main(args + ["--device", "cpu"])
    assert set(got["trials"][0]) == set(want["trials"][0]) | {"epoch_loss", "epoch_s"}
    trial = got["trials"][0]
    assert trial["epochs"] == 3 and len(trial["epoch_loss"]) == 3
    assert all(np.isfinite(trial["epoch_loss"]))
    assert trial["test_acc"] > 1 / 16
