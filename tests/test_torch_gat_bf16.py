"""Parity of the port's bfloat16 GAT with the JAX package's, on the CPU.

The same numpy inputs and parameters (carried across by ``params_from_flax``) go
through JAX's ``GATConv``/``GAT`` with ``dtype=bfloat16`` (the fused op's Pallas
kernels in interpret mode, on layouts with 128-slot chunks) and through the port's,
whose kernel wrappers run their plain PyTorch versions on CPU tensors:

* K7's plain version on bfloat16 rows, bitwise equal to JAX's ``expand_rows_chunked``;
  K7's unit choice (16 bytes where F and the pointers allow, else an element);
* K1's plain version with runtime columns on bfloat16 messages, identity columns
  against JAX's ``spmm_chunked_pallas`` and ``t_slot_perm`` columns against a numpy
  float32 sum rounded once, each within 1 bfloat16 ulp;
* ``GATConv`` on its three branches (the fused op on a graph with the layouts, the
  dense block, the COO composition), forward and gradients, H in {1, 8};
* the COO branch's named deviation: JAX returns its float32 message sum, the port
  casts it back to bfloat16;
* the two-layer ``GAT`` on the fused and COO branches;
* exact inference under bfloat16 for GraphSAGE and GIN (features cast first);
* the CLI's bfloat16 GAT branches and ``--exact_eval``.

Tolerance: 1e-2 x max|ref| on forward values and 2e-2 x max|ref| on gradients. A
bfloat16 value carries 8 significant bits (a relative rounding of up to 2^-9), and
the two sides round at the same points but sum in different orders, so results
drift by a few roundings; gradients pass through one more product per layer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.data import gcn_normalize as jax_gcn_normalize
from dgll_tpu.data import synthetic_classification_graph as jax_synthetic
from dgll_tpu.nn import GAT as JaxGAT
from dgll_tpu.nn import GINNode as JaxGIN
from dgll_tpu.nn import GraphSAGE as JaxSAGE
from dgll_tpu.nn.conv import GATConv as JaxGATConv
from dgll_tpu.ops.pallas.expand_rows import expand_rows_chunked
from dgll_tpu.ops.pallas.segment_matmul import spmm_chunked_pallas
from dgll_tpu.run import main as jax_main
from dgll_tpu.sampling.base import Block as JaxBlock
from dgll_tpu.train.exact_infer import make_exact_logits_fn
from dgll_tpu.train.metrics import masked_nll_loss as jax_nll
from dgll_tpu_torch import run as torch_run
from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
from dgll_tpu_torch.nn import GAT, GATConv, GINNode, GraphSAGE, params_from_flax
from dgll_tpu_torch.ops.cuda import gat_fused as tgf
from dgll_tpu_torch.ops.cuda import segment_matmul as sm
from dgll_tpu_torch.sampling.base import Block
from dgll_tpu_torch.train import masked_nll_loss
from dgll_tpu_torch.train.exact_infer import exact_logits
from dgll_tpu_torch.utils import parse_train_config
from test_torch_gat import _strip, _to_slots, layouts  # noqa: F401 (fixture)

BF16 = torch.bfloat16
GRAPH = dict(n_node=200, avg_degree=4, n_class=3, feat_dim=16, power_law=1.0, seed=7)
FWD, GRAD = 1e-2, 2e-2


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, scale, err_msg=""):
    got, want = _f32(got), _f32(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bfloat16 numbers at ``|x|`` (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _within_one_ulp(got: torch.Tensor, want_f32: np.ndarray, what: str):
    err = np.abs(_f32(got) - want_f32)
    bad = err > _bf16_ulp(want_f32)
    assert not bad.any(), f"{what}: {bad.sum()} values beyond 1 bf16 ulp"


# ------------------------------------------------------------------ the kernels

@pytest.mark.parametrize("width", [64, 16])
def test_expand_rows_bf16_equals_jax_bitwise(layouts, width):
    jc, _, c, _, slots = layouts
    a = np.random.default_rng(width).normal(size=(c.n_rows, width)).astype(np.float32)
    at = torch.from_numpy(a).to(BF16)
    # JAX's kernel takes widths of 128 lanes: the fused op pads each head's columns
    a_pad = np.pad(a, ((0, 0), (0, 128 - width)))
    want = expand_rows_chunked(jc, jnp.asarray(a_pad).astype(jnp.bfloat16),
                               interpret=True)[:, :width]
    before = dict(tgf.launches)
    got = tgf.expand_rows(c, at)
    assert got.dtype == BF16 and tgf.launches == before
    np.testing.assert_array_equal(_f32(got), _f32(want)[slots])
    assert torch.equal(got, at.index_select(0, c.rows))


def test_expand_rows_unit_choice():
    """16 bytes a unit (4 float32 or 8 bfloat16) where F is a multiple and the
    pointers are aligned, else one element; the launcher refuses CPU tensors."""
    for dtype, wide in ((torch.float32, 4), (BF16, 8)):
        a = torch.empty(64, 64, dtype=dtype)
        assert tgf.expand_vec(64, a, a) == wide
        assert tgf.expand_vec(12 if dtype == BF16 else 6, a, a) == 1
        off = torch.empty(64 * 64 + 1, dtype=dtype)[1:]
        assert tgf.expand_vec(64, off, a) == 1
    from dgll_tpu_torch.ops import build_chunked_pair

    c, _ = build_chunked_pair([0, 1], [1, 0], 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tgf.expand_rows_cuda(c, torch.ones(c.n_rows, 8, dtype=BF16))


@pytest.mark.parametrize("width", [64, 16, 12])
@pytest.mark.parametrize("transpose", [False, True])
def test_spmm_edges_bf16_matches_jax(layouts, transpose, width):
    """K1 summing bf16 per-edge messages with f32 accumulation into bf16 rows:
    identity columns on A (the GAT forward) and ``t_slot_perm`` columns on A^T (the
    backward scatter), against JAX ``spmm_chunked_pallas`` on the same bf16
    messages and against the float32 sum rounded once (within 1 bf16 ulp)."""
    jc, jct, c, ct, slots = layouts
    msg = np.random.default_rng(width + transpose).normal(size=(c.src.numel(), width))
    msg = torch.from_numpy(msg.astype(np.float32)).to(BF16)
    # JAX's kernel takes widths of 128 lanes: the fused op pads each head's columns
    msg_pad = np.pad(_f32(msg), ((0, 0), (0, 128 - width)))
    jmsg = _to_slots(jc, slots, msg_pad)[: jc.n_chunk * jc.eb]
    before = (sm.launches_fwd, sm.launches_bwd)
    if transpose:
        jmsg = jnp.concatenate([jmsg, jnp.zeros((1, 128))], axis=0)
        jmsg = jnp.take(jmsg, jc.t_slot_perm, axis=0)
        lay, rows = jct, c.src.numpy()
        got = sm.spmm_edges(ct, msg, c.t_slot_perm, backward=True)
    else:
        lay, rows = jc, c.rows.numpy()
        got = sm.spmm_edges(c, msg)
    want = spmm_chunked_pallas(lay, jmsg.astype(jnp.bfloat16),
                               weights=(lay.weight != 0).astype(jnp.float32),
                               interpret=True)[:, :width]
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert (sm.launches_fwd, sm.launches_bwd) == before
    n = min(got.shape[0], want.shape[0])
    np.testing.assert_allclose(_f32(got)[:n], _f32(want)[:n], rtol=2.0 ** -7, atol=0)
    exact = np.zeros((got.shape[0], width), np.float32)
    np.add.at(exact, rows, _f32(msg))
    _within_one_ulp(got, exact, "transpose" if transpose else "identity")


# --------------------------------------------------------------- GATConv, GAT

def _graphs(chunked: bool):
    gj = jax_gcn_normalize(jax_synthetic(**GRAPH))
    gt = gcn_normalize(synthetic_classification_graph(**GRAPH))
    if chunked:
        gj, gt = gj.with_chunked(eb=128), gt.with_chunked()
    return jax.tree.map(jnp.asarray, gj), gt


def _block_pair():
    """A hand-made fanout-dense block, 24 destinations x 4 slots, a quarter masked."""
    rng = np.random.default_rng(5)
    n_dst, fo = 24, 4
    dst_ids = rng.integers(0, 200, n_dst).astype(np.int32)
    src_ids = np.concatenate([dst_ids, rng.integers(0, 200, n_dst * fo)]).astype(np.int32)
    mask = rng.random((n_dst, fo)) < 0.75
    mask[0] = False                                      # a destination with none
    dmask = np.ones(n_dst, bool)
    bt = Block(torch.from_numpy(dst_ids), torch.from_numpy(src_ids),
               torch.from_numpy(mask), torch.from_numpy(dmask), fo, n_dst)
    bj = JaxBlock(jnp.asarray(dst_ids), jnp.asarray(src_ids), jnp.asarray(mask),
                  jnp.asarray(dmask), fo, n_dst)
    x = rng.normal(size=(n_dst * (1 + fo), GRAPH["feat_dim"])).astype(np.float32)
    return bt, bj, x


def _branch_inputs(branch):
    if branch == "dense":
        bt, bj, x = _block_pair()
        return bt, bj, x
    gj, gt = _graphs(branch == "fused")
    return gt, gj, gt.node_feat.numpy()


@pytest.mark.parametrize("heads", [1, 8])
@pytest.mark.parametrize("branch", ["fused", "dense", "coo"])
def test_gatconv_bf16_matches_jax(branch, heads):
    """Forward and gradients (x, projection, attn_src, attn_dst) of one bf16 layer;
    H=8 with 8 features per head is the published hidden layer."""
    gt, gj, x = _branch_inputs(branch)
    f = 8 if heads == 8 else 16
    conv_j = JaxGATConv(features=f, num_heads=heads, dtype=jnp.bfloat16)
    params = conv_j.init(jax.random.key(1), gj, jnp.asarray(x))["params"]
    n_dst = gt.n_dst if branch == "dense" else GRAPH["n_node"]
    cot = np.random.default_rng(9).normal(size=(n_dst, heads * f)).astype(np.float32)

    def jloss(p, xx):
        # the COO branch's float32 sum rounded to bf16, as the port returns it (the
        # other branches return bf16 already)
        out = conv_j.apply({"params": p}, gj, xx).astype(jnp.bfloat16)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, want), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    conv = GATConv(GRAPH["feat_dim"], f, heads, dtype=BF16)
    conv.load_state_dict(_strip(params_from_flax(
        {"GATConv_0": jax.tree.map(np.asarray, params)})))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = conv(gt, xt)
    assert out.dtype == BF16
    (out.float() * torch.from_numpy(cot)).sum().backward()
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in conv.parameters())
    _close(out, want, FWD, "out")
    _close(xt.grad, gx, GRAD, "dx")
    _close(conv.linear.weight.grad.T, gp["weight"]["kernel"], GRAD, "dW")
    _close(conv.attn_src.grad, gp["attn_src"], GRAD, "da_src")
    _close(conv.attn_dst.grad, gp["attn_dst"], GRAD, "da_dst")


def test_coo_branch_casts_back_unlike_jax():
    """The named deviation: on a graph without the layouts JAX's bf16 ``GATConv``
    returns its float32 message sum, the port casts it back to the compute type
    (the dense-block and fused branches return bf16 in both)."""
    gj, gt = _graphs(False)
    conv_j = JaxGATConv(features=8, num_heads=8, dtype=jnp.bfloat16)
    params = conv_j.init(jax.random.key(1), gj, gj.node_feat)["params"]
    want = conv_j.apply({"params": params}, gj, gj.node_feat)
    conv = GATConv(GRAPH["feat_dim"], 8, 8, dtype=BF16)
    conv.load_state_dict(_strip(params_from_flax(
        {"GATConv_0": jax.tree.map(np.asarray, params)})))
    got = conv(gt, gt.node_feat)
    assert want.dtype == jnp.float32 and got.dtype == BF16
    _close(got, want, FWD)
    gcj, _ = _graphs(True)
    assert conv_j.apply({"params": params}, gcj, gcj.node_feat).dtype == jnp.bfloat16


def test_fused_op_keeps_the_types_and_launches_nothing_on_cpu():
    _, gt = _graphs(True)
    c, ct = gt.chunked, gt.chunked_t
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(200, 64)).astype(np.float32)).to(BF16)
    a = torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32) * 0.3)
    before = dict(tgf.launches)
    ht, ast, adt = (t.clone().requires_grad_(True) for t in (h, a.to(BF16), a.to(BF16)))
    out = tgf.gat_attention_fused(c, ct, ht, ast, adt)
    assert out.dtype == BF16
    out.float().sum().backward()
    assert ht.grad.dtype == ast.grad.dtype == adt.grad.dtype == BF16
    assert tgf.launches == before
    with pytest.raises(ValueError, match="h's type"):
        tgf.gat_attention_fused(c, ct, h, a, a)


def _gat_pair(chunked: bool):
    gj, gt = _graphs(chunked)
    mj = JaxGAT(hidden=8, n_class=3, num_heads=8, dropout=0.0, dtype=jnp.bfloat16)
    params = mj.init(jax.random.key(0), gj, gj.node_feat)["params"]
    mt = GAT(GRAPH["feat_dim"], hidden=8, n_class=3, num_heads=8, dropout=0.0, dtype=BF16)
    mt.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return gj, gt, mj, params, mt


@pytest.mark.parametrize("chunked", [False, True])
def test_gat_bf16_log_probs_and_gradients_match(chunked):
    gj, gt, mj, params, mt = _gat_pair(chunked)

    def loss_of(p):
        logp = mj.apply({"params": p}, gj, gj.node_feat)
        return jax_nll(logp.astype(jnp.float32), gj.labels, gj.train_mask), logp

    (lj, want), gradj = jax.value_and_grad(loss_of, has_aux=True)(params)
    mt.eval()
    logp = mt(gt, gt.node_feat)
    assert logp.dtype == BF16
    loss = masked_nll_loss(logp.float(), gt.labels, gt.train_mask)
    loss.backward()
    _close(logp, want, FWD, "log-probs")
    _close(loss, lj, FWD, "loss")
    for i, conv in enumerate(mt.convs):
        assert conv.dtype == BF16
        gl = gradj[f"GATConv_{i}"]
        _close(conv.linear.weight.grad.T, gl["weight"]["kernel"], GRAD, f"dW{i}")
        _close(conv.attn_src.grad, gl["attn_src"], GRAD, f"da_src{i}")
        _close(conv.attn_dst.grad, gl["attn_dst"], GRAD, f"da_dst{i}")


# ------------------------------------------------- exact inference under bf16

@pytest.mark.parametrize("name", ["GraphSAGE", "GIN"])
def test_exact_inference_bf16_matches_jax(name):
    """GraphSAGE and GIN aggregate their input before the first ``Dense`` casts it:
    the features are cast to bf16 first in both packages (``feat_dtype``)."""
    g = dict(GRAPH, n_node=300, n_class=4)
    gj = jax.tree.map(jnp.asarray, jax_gcn_normalize(jax_synthetic(**g)))
    gt = gcn_normalize(synthetic_classification_graph(**g))
    jcls, tcls = {"GraphSAGE": (JaxSAGE, GraphSAGE), "GIN": (JaxGIN, GINNode)}[name]
    mj = jcls(hidden=16, n_class=4, dtype=jnp.bfloat16)
    params = mj.init(jax.random.key(0), gj, gj.node_feat)["params"]
    want = make_exact_logits_fn(mj.apply, jnp.bfloat16)(params, gj, gj.node_feat)
    mt = tcls(GRAPH["feat_dim"], 16, 4, dtype=BF16)
    mt.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    got = exact_logits(mt, gt, gt.node_feat, feat_dtype=BF16)
    assert got.dtype == BF16
    _close(got, want, FWD)
    w = np.sort(_f32(want), axis=1)
    clear = w[:, -1] - w[:, -2] > 2 * FWD * np.abs(w).max()
    np.testing.assert_array_equal(_f32(got).argmax(1)[clear], _f32(want).argmax(1)[clear])


# --------------------------------------------------------------------- the CLI

BASE = ["--n_node", "1000", "--n_epochs", "2", "--nhid", "8", "--dtype", "bfloat16"]
GAT_ARGS = ["--Model", "GAT", "--n_heads", "8", "--dropout", "0.6", "--lr", "0.005"]


@pytest.mark.parametrize("args", [
    GAT_ARGS + ["--samp_type", "full"],
    GAT_ARGS + ["--samp_type", "neighbor", "--batch_size", "128"],
    ["--Model", "GraphSAGE", "--samp_type", "neighbor", "--batch_size", "128",
     "--exact_eval"],
    ["--Model", "GIN", "--samp_type", "neighbor", "--batch_size", "128", "--exact_eval"],
])
def test_cli_bf16_prints_the_jax_cli_keys(args):
    want = jax_main(BASE + args)
    got = torch_run.main(BASE + args + ["--device", "cpu"])
    assert set(got["trials"][0]) == set(want["trials"][0]) | {"epoch_loss", "epoch_s"}
    trial = got["trials"][0]
    assert trial["epochs"] == 2 and np.isfinite(trial["epoch_loss"]).all()
    assert trial["test_acc"] > 1 / 16
    assert trial.get("exact_eval", False) == ("--exact_eval" in args)


@pytest.mark.parametrize("args", [
    ["--samp_type", "neighbor", "--device_sampling", "--batch_size", "128"],
    ["--samp_type", "fastgcn", "--batch_size", "128", "--n_samp", "128"],
    ["--samp_type", "ladies", "--device_sampling", "--batch_size", "128",
     "--n_samp", "128"],
])
def test_cli_bf16_gat_minibatch_branches(args):
    got = torch_run.main(BASE + GAT_ARGS + args + ["--device", "cpu"])
    trial = got["trials"][0]
    assert trial["epochs"] == 2 and np.isfinite(trial["epoch_loss"]).all()
    cfg = parse_train_config(BASE + GAT_ARGS + args)
    model = torch_run.build_model(cfg, 3, 16)
    assert [conv.dtype for conv in model.convs] == [BF16, BF16]
