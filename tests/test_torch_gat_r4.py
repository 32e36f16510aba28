"""Parity of the round-4 GAT attention path with the JAX package, on the CPU.

The same inputs, made with numpy, go through ``dgll_tpu/ops/pallas/gat.py`` (its
Pallas kernels in interpret mode, on layouts with 128-slot chunks) and through the
port's ``ops/gat.py``, whose kernel wrappers run their plain PyTorch versions on CPU
tensors. Compared, forward and gradients:

* the ops ``spmm_msg`` (K1; VJP K7), ``spmm_dyn`` (K1 with runtime weights; VJP K7
  and K9) and ``sddmm`` (K9; VJP K1 with weights and K7);
* both round-4 layers: ``gat_attention_chunked`` (one head) and
  ``gat_attention_chunked_multihead`` (8 heads), in ``h``, ``a_src`` and ``a_dst``;
* the round-4 layers against the port's fused op, the check ``chip_smoke.py`` runs
  on the card, and ``gat_attention_chunked_fused`` as its name.

The JAX ops need ``F`` (``H*F`` for the multi-head layer) a multiple of 128. The
test graph (``test_torch_gat.layouts``) has a hub row wider than a chunk, an edgeless
128-row block and duplicate edges; for the weights caveat see
``tests/test_torch_edge_ops.py``. Tolerances (f32): 1e-5 x max|ref| on outputs,
1e-4 x max|ref| on gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgll_tpu.ops.pallas import gat as jg
from dgll_tpu_torch.ops import build_chunked_pair
from dgll_tpu_torch.ops import gat as tg
from dgll_tpu_torch.ops.cuda import edge_ops as tk
from dgll_tpu_torch.ops.cuda import gat_fused as tgf
from dgll_tpu_torch.ops.cuda import segment_matmul as sm
from test_torch_edge_ops import _thread_pool  # noqa: F401 (fixture)
from test_torch_gat import N, _close, _to_slots, layouts  # noqa: F401 (fixture)

HEADS = [1, 8]


def _t(x, grad=False):
    return torch.from_numpy(np.ascontiguousarray(x)).requires_grad_(grad)


def _counts():
    return dict(tk.launches), dict(tgf.launches), sm.launches_fwd, sm.launches_bwd


# ---------------------------------------------------------------------- the ops

@pytest.mark.parametrize("op", ["spmm_msg", "spmm_dyn", "sddmm"])
def test_attention_ops_match_jax(layouts, op):
    """Forward and the gradient of every differentiable argument, at F=128."""
    jc, jct, c, ct, slots = layouts
    rng = np.random.default_rng(20)
    nnz, f, nc = c.src.numel(), 128, jc.n_chunk * jc.eb
    msg = rng.normal(size=(nnz, f)).astype(np.float32)
    w = rng.random(nnz).astype(np.float32)
    a = rng.normal(size=(c.n_rows, f)).astype(np.float32)
    jmsg = _to_slots(jc, slots, msg)[:nc]
    jw = _to_slots(jc, slots, w).reshape(jc.n_chunk_meta, jc.eb)
    if op == "sddmm":
        cot = rng.normal(size=nnz).astype(np.float32)
        jcot = _to_slots(jc, slots, cot).reshape(jc.n_chunk_meta, jc.eb)
        jargs, targs = (jnp.asarray(a), jmsg), (_t(a, True), _t(msg, True))
        jfn = lambda x, m: jg.sddmm(jc, jct, x, m, interpret=True)      # noqa: E731
        tfn = lambda x, m: tg.sddmm(c, ct, x, m)                        # noqa: E731
    else:
        cot = rng.normal(size=(c.n_rows, f)).astype(np.float32)
        jcot = jnp.asarray(cot)
        if op == "spmm_msg":
            jargs, targs = (jmsg,), (_t(msg, True),)
            jfn = lambda m: jg.spmm_msg(jc, jct, m, interpret=True)     # noqa: E731
            tfn = lambda m: tg.spmm_msg(c, ct, m)                       # noqa: E731
        else:
            jargs, targs = (jmsg, jw), (_t(msg, True), _t(w, True))
            jfn = lambda m, x: jg.spmm_dyn(jc, jct, m, x, interpret=True)  # noqa: E731
            tfn = lambda m, x: tg.spmm_dyn(c, ct, m, x)                 # noqa: E731
    want, pull = jax.vjp(jfn, *jargs)
    jgrads = pull(jcot)
    out = tfn(*targs)
    out.backward(_t(cot))
    if op == "sddmm":
        _close(out, np.asarray(want).reshape(-1)[slots], err_msg="out")
    else:
        _close(out, want, err_msg="out")
    for i, (jgr, targ) in enumerate(zip(jgrads, targs)):
        jgr = np.asarray(jgr)
        if jgr.shape[0] != targ.shape[0]:      # per-edge: JAX slots -> port edges
            jgr = jgr.reshape(-1, *targ.shape[1:])[slots]
        _close(targ.grad, jgr, 1e-4, err_msg=f"grad {i}")


# ------------------------------------------------------------------- the layers

def _layer_inputs(heads, seed):
    rng = np.random.default_rng(seed)
    f = 128 // heads   # the JAX ops need H*F % 128 == 0
    shape = (f,) if heads == 1 else (heads, f)
    h = rng.normal(size=(N, heads * f)).astype(np.float32)
    a_src = (rng.normal(size=shape) * 0.3).astype(np.float32)
    a_dst = (rng.normal(size=shape) * 0.3).astype(np.float32)
    return h, a_src, a_dst, rng


def _port_layer(heads):
    return tg.gat_attention_chunked if heads == 1 else tg.gat_attention_chunked_multihead


@pytest.mark.parametrize("heads", HEADS)
def test_round4_layer_matches_jax(layouts, heads):
    """``gat_attention_chunked`` (one head, F=128) and
    ``gat_attention_chunked_multihead`` (8 x 16): out and d(h, a_src, a_dst)."""
    jc, jct, c, ct, slots = layouts
    h, a_src, a_dst, rng = _layer_inputs(heads, 21 + heads)
    jlayer = jg.gat_attention_chunked if heads == 1 else jg.gat_attention_chunked_multihead
    out_shape = (c.n_rows, 128) if heads == 1 else (c.n_rows, heads, 128 // heads)
    cot = rng.normal(size=out_shape).astype(np.float32)
    hpad = np.pad(h, ((0, c.n_rows - N), (0, 0)))

    def jloss(h_, as_, ad_):
        out = jlayer(jc, jct, h_, as_, ad_, 0.2, interpret=True)
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(hpad), jnp.asarray(a_src), jnp.asarray(a_dst))
    ht, ast, adt = (_t(x, True) for x in (h, a_src, a_dst))
    out = _port_layer(heads)(c, ct, ht, ast, adt, 0.2)
    assert out.shape == out_shape
    (out * _t(cot)).sum().backward()
    _close(out, want, err_msg="out")
    _close(ht.grad, np.asarray(jgrads[0])[:N], 1e-4, err_msg="dh")
    _close(ast.grad, jgrads[1], 1e-4, err_msg="da_src")
    _close(adt.grad, jgrads[2], 1e-4, err_msg="da_dst")


@pytest.mark.parametrize("heads", HEADS)
def test_round4_layer_matches_the_fused_op(layouts, heads):
    """The comparison ``chip_smoke.py`` makes on the card: the round-4 layer and the
    fused op compute one function, forward and gradients. On CPU tensors no launch
    counter moves."""
    _, _, c, ct, _ = layouts
    h, a_src, a_dst, rng = _layer_inputs(heads, 30 + heads)
    cot = _t(rng.normal(size=(c.n_rows, heads, 128 // heads)).astype(np.float32))
    before = _counts()
    grads = []
    for fused in (False, True):
        ht, ast, adt = (_t(x, True) for x in (h, a_src, a_dst))
        if fused:
            out = tg.gat_attention_chunked_fused(c, ct, ht, ast.view(heads, -1),
                                                 adt.view(heads, -1), 0.2)
        else:
            out = _port_layer(heads)(c, ct, ht, ast, adt, 0.2).view(cot.shape)
        (out * cot).sum().backward()
        grads.append((out.detach(), ht.grad, ast.grad, adt.grad))
    for name, got, want in zip(("out", "dh", "da_src", "da_dst"), *grads):
        _close(got, want.numpy(), 1e-5 if name == "out" else 1e-4, err_msg=name)
    assert _counts() == before


def test_round4_layers_check_their_inputs(layouts):
    _, _, c, ct, _ = layouts
    h, a_src, a_dst, _ = _layer_inputs(8, 40)
    with pytest.raises(ValueError, match="h: need"):
        tg.gat_attention_chunked_multihead(c, ct, _t(h[:, :64]), _t(a_src), _t(a_dst))
    with pytest.raises(ValueError, match="h: need"):
        tg.gat_attention_chunked(c, ct, _t(h[:10, :16]), _t(a_src[0]), _t(a_dst[0]))
    src, dst = c.src.numpy(), c.rows.numpy()
    bare, bare_t = build_chunked_pair(src, dst, c.n_rows, c.n_cols)
    bare.t_slot_perm = None
    with pytest.raises(ValueError, match="t_slot_perm"):
        tg.gat_attention_chunked_multihead(bare, bare_t, _t(h), _t(a_src), _t(a_dst))
