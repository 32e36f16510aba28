"""The fused sparse GAT layer and the wrappers of its attention kernels.

Counterpart of ``dgll_tpu/ops/pallas/gat_fused.py:gat_attention_fused`` (with
``edge_ops.py``'s sum mode and ``expand_rows.py``). The kernels are
``csrc/gat_csr.cu``; their plain PyTorch versions are ``ops/gat_csr.py``.

Each wrapper (``gat_stats``, ``gat_alpha``, ``gat_bwd_softmax``,
``edges_to_rows_sum``, ``expand_rows``) runs the plain version on CPU tensors and
launches its kernel on CUDA tensors, or raises; ``launches[name]`` counts the
kernel's launches. The layer's two sums over edges (the forward aggregation and the
backward scatter of the message gradient) are K1 (``csrc/segment_matmul.cu``) with
runtime columns and unit weights, ``segment_matmul.spmm_edges``, which counts them.

Forward: K3 -> K4 -> K1 on A. Backward: K7 -> K6 -> K5 -> K1 on A^T, whose columns
``c.t_slot_perm`` read the message gradient in A's edge order.

The row reductions K3, K5 and K6 run on the layout's split schedule (``c.split``,
the one K1 runs on): a lane group per row of at most ``SPLIT_EDGES`` edges and per
segment of a longer row, whose per-head partials (f32 scratch ``[n_seg, H]`` this
wrapper allocates) a second pass in the same C call combines in segment order: K3
rescales each segment's sum to the row's max, K5 and K6's sum add, K6's max takes the
max. For H a power of two up to 32 (``heads_across_lanes``) a group of
``item_lanes(H)`` lanes reads a row's ``[deg, H]`` block coalesced, heads across lanes
(at H=1 a warp holds 4 rows); other H take a warp a row and one pass a head. They are
bound by their bytes and by the latency of short rows; the launch counters still
count one launch a wrapper call.

K4 runs on an edge-major mapping whose variant ``edge_plan`` picks: float4 units of
4 heads of an edge (H % 4 == 0), or of 4 edges at H = 1, where the pointers are
16-byte aligned, else an edge a unit; a thread a unit. K6′ and K10's
rows-to-edges (``edge_ops.py``) run the same mapping with a gather.

Under bfloat16 the op rounds where the JAX op does: the messages and K1's and K7's
rows are bfloat16 (K1 accumulates in f32), the scores are computed in bfloat16 and
widened, and K3-K6 stay float32.

Deviations from the JAX op, none of which changes the math: per-edge arrays are in
the CSR's edge order (no padding slots), and the per-head products other than the
scores use ``[E, H, F]`` views (the TPU's rank-2 ``head_expand`` matrix avoids a
tile padding the GPU does not have).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from dgll_tpu_torch.ops import gat_csr
from dgll_tpu_torch.ops.chunked import ChunkedCSR, SplitSchedule
from dgll_tpu_torch.ops.cuda.segment_matmul import _check, _launch, _uses_kernel, spmm_edges

launches = dict.fromkeys(
    ("gat_stats", "gat_alpha", "gat_bwd_softmax", "edges_to_rows_sum", "expand_rows"), 0)


def _check_layout(c: ChunkedCSR, dev: torch.device) -> None:
    _check("indptr", c.indptr, torch.int32, dev, c.n_rows + 1)
    _check("rows", c.rows, torch.int32, dev, c.src.numel())


def _check_f32(dev: torch.device, shape, **tensors) -> None:
    for name, t in tensors.items():
        _check(name, t, torch.float32, dev)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def _per_edge(c: ChunkedCSR, t: torch.Tensor) -> Tuple[int, torch.device]:
    """Heads and device of a per-edge ``[nnz, H]`` CUDA tensor."""
    if t.device.type != "cuda" or t.dim() != 2 or t.shape[0] != c.src.numel():
        raise ValueError(f"need a [nnz={c.src.numel()}, H] CUDA tensor, "
                         f"got {tuple(t.shape)} on {t.device}")
    return t.shape[1], t.device


def heads_across_lanes(h: int) -> bool:
    """K3's, K5's and K6's lane mapping for ``h`` heads: True (a lane group reads a row's
    ``[deg, H]`` block its width of consecutive floats at a time, lane j holding head
    j % H) for H a power of two up to 32, else False (a warp a row, one pass a head,
    lanes over edges)."""
    return 0 < h <= 32 and h & (h - 1) == 0


def item_lanes(h: int) -> int:
    """Lanes of K3's, K5's and K6's work item (a row or a segment) for ``h`` heads: with
    heads across lanes, enough for 8 edges a step, at most a warp, so that a warp
    takes 4 rows at a time at H=1 (the fastest width there on the CLI graph, with
    4) and a whole warp at H=8 (which K3 needs); otherwise a warp."""
    return min(32, 8 * h) if heads_across_lanes(h) else 32


def _split_args(sp: SplitSchedule, dev: torch.device, h: int, scratch: int) -> tuple:
    """The schedule's C arguments, with ``scratch`` float32 ``[n_seg, H]`` buffers
    (None where the layout has no split row) between its tensors and its sizes;
    returns ``(args, buffers)``, the buffers kept alive by the caller."""
    for name in ("seg_beg", "seg_end", "split_row", "split_ptr"):
        _check(name, getattr(sp, name), torch.int32, dev)
    bufs = [torch.empty((sp.n_seg, h), device=dev) for _ in range(scratch)]
    ptrs = [b.data_ptr() if sp.n_seg else None for b in bufs]
    args = (sp.seg_beg.data_ptr(), sp.seg_end.data_ptr(), sp.split_row.data_ptr(),
            sp.split_ptr.data_ptr(), *ptrs, sp.n_seg, sp.n_split, sp.max_edges)
    return args, bufs


def gat_stats_cuda(c: ChunkedCSR, sc_src: torch.Tensor, s_dst: torch.Tensor,
                   negative_slope: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 once: ``(m, den)``, each ``[n_rows, H]``."""
    h, dev = _per_edge(c, sc_src)
    _check_layout(c, dev)
    _check_f32(dev, sc_src.shape, sc_src=sc_src)
    _check_f32(dev, (c.n_rows, h), s_dst=s_dst)
    m = torch.empty((c.n_rows, h), device=dev)
    den = torch.empty((c.n_rows, h), device=dev)
    sp_args, _scratch = _split_args(c.split, dev, h, 2)
    _launch("gat_stats", dev, c.indptr.data_ptr(), c.rows.data_ptr(), sc_src.data_ptr(),
            s_dst.data_ptr(), m.data_ptr(), den.data_ptr(), c.n_rows, h,
            int(heads_across_lanes(h)), item_lanes(h), float(negative_slope), *sp_args)
    return m, den


class EdgePlan(NamedTuple):
    """The variant of the edge-major mapping of K4, K6′ and K10's rows-to-edges
    (``csrc/gat_csr.cu``: ``launch_edges``), as its C entries take it."""

    vec: int   # 4: float4 units of 4 heads of an edge, or at H = 1 of 4 edges; 1: an edge
    grid: int  # blocks of EDGE_THREADS threads, striding over the units


EDGE_THREADS = 256  # a block of the edge-major kernels (gat_csr.cu: kThreads)
EDGE_BLOCKS = 2**31 - 1  # the most blocks a grid takes


def _aligned(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def edge_plan(nnz: int, heads: int, rows: torch.Tensor, per_edge, per_row) -> EdgePlan:
    """The variant of the edge-major mapping for per-edge arrays ``per_edge``
    (``[nnz, heads]``, written or read a unit at a time) whose row values come from
    ``per_row`` (``[n_rows, heads]``) through ``rows``: float4 units of 4 heads where
    H % 4 == 0 and ``per_edge`` and ``per_row`` are 16-byte aligned; at H = 1, 4 edges
    a unit where ``rows`` and ``per_edge`` are; otherwise an edge a unit. The grid
    has a thread a unit, at most ``EDGE_BLOCKS`` blocks (the kernels stride beyond):
    on an H100 that was fastest, or within 2% of grids of 1-4 waves."""
    if heads == 1 and _aligned(rows, *per_edge):
        vec, units = 4, nnz // 4
    elif heads % 4 == 0 and _aligned(*per_edge, *per_row):
        vec, units = 4, nnz * (heads // 4)
    else:
        vec, units = 1, nnz
    blocks = -(-units // EDGE_THREADS)
    return EdgePlan(vec, max(1, min(blocks, EDGE_BLOCKS)))


def gat_alpha_cuda(c: ChunkedCSR, sc_src: torch.Tensor, s_dst: torch.Tensor,
                   m: torch.Tensor, den: torch.Tensor, negative_slope: float = 0.2
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 once: ``(alpha, lgrad)``, each ``[nnz, H]``, in the variant of
    ``edge_plan``."""
    h, dev = _per_edge(c, sc_src)
    nnz = c.src.numel()
    _check("rows", c.rows, torch.int32, dev, nnz)  # K4 reads no indptr
    _check_f32(dev, sc_src.shape, sc_src=sc_src)
    _check_f32(dev, (c.n_rows, h), s_dst=s_dst, m=m, den=den)
    alpha = torch.empty_like(sc_src)
    lgrad = torch.empty_like(sc_src)
    plan = edge_plan(nnz, h, c.rows, (sc_src, alpha, lgrad), (s_dst, m, den))
    _launch("gat_alpha", dev, c.rows.data_ptr(), sc_src.data_ptr(), s_dst.data_ptr(),
            m.data_ptr(), den.data_ptr(), alpha.data_ptr(), lgrad.data_ptr(), nnz, h,
            float(negative_slope), *plan)
    return alpha, lgrad


def edges_to_rows_launch(op: str, c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    """Launch K6 once in mode ``op`` ("sum" or "max"): ``[n_rows, H]``."""
    h, dev = _per_edge(c, v)
    _check_layout(c, dev)
    _check_f32(dev, v.shape, v=v)
    out = torch.empty((c.n_rows, h), device=dev)
    sp_args, _scratch = _split_args(c.split, dev, h, 1)
    _launch(f"edges_to_rows_{op}", dev, c.indptr.data_ptr(), c.rows.data_ptr(),
            v.data_ptr(), out.data_ptr(), c.n_rows, h, int(heads_across_lanes(h)),
            item_lanes(h), *sp_args)
    return out


def edges_to_rows_sum_cuda(c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    """Launch K6 (sum mode) once: ``[n_rows, H]``."""
    return edges_to_rows_launch("sum", c, v)


def gat_bwd_softmax_cuda(c: ChunkedCSR, alpha: torch.Tensor, dalpha: torch.Tensor,
                         lgrad: torch.Tensor, s: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K5 once: ``(dz [nnz, H], dsd [n_rows, H])``."""
    h, dev = _per_edge(c, alpha)
    _check_layout(c, dev)
    _check_f32(dev, alpha.shape, alpha=alpha, dalpha=dalpha, lgrad=lgrad)
    _check_f32(dev, (c.n_rows, h), s=s)
    dz = torch.empty_like(alpha)
    dsd = torch.empty((c.n_rows, h), device=dev)
    sp_args, _scratch = _split_args(c.split, dev, h, 1)
    _launch("gat_bwd_softmax", dev, c.indptr.data_ptr(), c.rows.data_ptr(),
            alpha.data_ptr(), dalpha.data_ptr(), lgrad.data_ptr(), s.data_ptr(),
            dz.data_ptr(), dsd.data_ptr(), c.n_rows, h, int(heads_across_lanes(h)),
            item_lanes(h), *sp_args)
    return dz, dsd


_EXPAND_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def expand_vec(f: int, *tensors: torch.Tensor) -> int:
    """K7's unit in elements: 16 bytes (4 float32 or 8 bfloat16) where F is a
    multiple of it and every pointer is 16-byte aligned, else one element."""
    vec = 16 // tensors[0].element_size()
    return vec if f % vec == 0 and _aligned(*tensors) else 1


def expand_rows_cuda(c: ChunkedCSR, a: torch.Tensor) -> torch.Tensor:
    """Launch K7 once: ``out[e] = a[row of e]``, ``[nnz, F]``, float32 or bfloat16
    (a copy: bitwise equal to ``a.index_select(0, c.rows)``)."""
    if a.device.type != "cuda" or a.dim() != 2 or a.shape[0] != c.n_rows:
        raise ValueError(f"a: need a [n_rows={c.n_rows}, F] CUDA tensor, "
                         f"got {tuple(a.shape)} on {a.device}")
    if a.dtype not in _EXPAND_DTYPES:
        raise ValueError(f"a: need float32 or bfloat16, got {a.dtype}")
    dev, f = a.device, a.shape[1]
    _check("rows", c.rows, torch.int32, dev, c.src.numel())
    _check("a", a, a.dtype, dev)
    out = torch.empty((c.src.numel(), f), dtype=a.dtype, device=dev)
    _launch("expand_rows", dev, c.rows.data_ptr(), a.data_ptr(), out.data_ptr(),
            c.src.numel(), f, _EXPAND_DTYPES[a.dtype], expand_vec(f, a, out))
    return out


def _dispatch(counts: dict, name: str, kernel, reference, x: torch.Tensor, *args):
    """``kernel(*args)`` counted in ``counts[name]`` if ``x`` is a CUDA tensor, else
    the plain ``reference(*args)``."""
    if _uses_kernel(x):
        out = kernel(*args)
        counts[name] += 1
        return out
    return reference(*args)


def gat_stats(c, sc_src, s_dst, negative_slope=0.2):
    """K3 (see ``ops/gat_csr.py:gat_stats_reference``)."""
    return _dispatch(launches, "gat_stats", gat_stats_cuda, gat_csr.gat_stats_reference,
                     sc_src, c, sc_src, s_dst, negative_slope)


def gat_alpha(c, sc_src, s_dst, m, den, negative_slope=0.2):
    """K4 (see ``ops/gat_csr.py:gat_alpha_reference``)."""
    return _dispatch(launches, "gat_alpha", gat_alpha_cuda, gat_csr.gat_alpha_reference,
                     sc_src, c, sc_src, s_dst, m, den, negative_slope)


def edges_to_rows_sum(c, v):
    """K6, sum mode (see ``ops/gat_csr.py:edges_to_rows_sum_reference``)."""
    return _dispatch(launches, "edges_to_rows_sum", edges_to_rows_sum_cuda,
                     gat_csr.edges_to_rows_sum_reference, v, c, v)


def gat_bwd_softmax(c, alpha, dalpha, lgrad, s):
    """K5 (see ``ops/gat_csr.py:gat_bwd_softmax_reference``)."""
    return _dispatch(launches, "gat_bwd_softmax", gat_bwd_softmax_cuda,
                     gat_csr.gat_bwd_softmax_reference, alpha, c, alpha, dalpha, lgrad, s)


def expand_rows(c, a):
    """K7 (see ``ops/gat_csr.py:expand_rows_reference``)."""
    return _dispatch(launches, "expand_rows", expand_rows_cuda,
                     gat_csr.expand_rows_reference, a, c, a)


def head_proj(a: torch.Tensor) -> torch.Tensor:
    """``[H, F] -> [H*F, H]``, block-diagonal: ``x @ head_proj(a)`` is the per-head
    dot of ``x [., H*F]`` with ``a``, one matrix product with f32 accumulation in
    ``x``'s type (``dgll_tpu/ops/pallas/gat_fused.py:head_proj``)."""
    heads, f = a.shape
    eye = torch.eye(heads, dtype=a.dtype, device=a.device)
    return (a[:, :, None] * eye[:, None, :]).reshape(heads * f, heads)


class _GatFused(torch.autograd.Function):
    """The rounding points are the JAX op's: the messages ``msg``, ``msg_w`` and
    ``dmsg`` and the gradient ``g`` are in ``h``'s type (K1 and K7 on bfloat16 under
    bfloat16), the scores are computed in it and widened, and K3-K6 read and write
    float32 only. ``a_src`` and ``a_dst`` come in ``h``'s type, and so do their
    gradients (summed in float32)."""

    @staticmethod
    def forward(ctx, h, a_src, a_dst, c, ct, negative_slope, drop_mask):
        heads, f = a_src.shape
        n_in, nnz = h.shape[0], c.src.numel()
        msg = h.index_select(0, c.src)                       # [E, H*F], the one gather
        sc_src = (msg @ head_proj(a_src)).float()            # [E, H]
        s_dst = (h @ head_proj(a_dst)).float()               # [n_in, H]
        s_dst = F.pad(s_dst, (0, 0, 0, c.n_rows - n_in))
        m, den = gat_stats(c, sc_src, s_dst, negative_slope)
        alpha, lgrad = gat_alpha(c, sc_src, s_dst, m, den, negative_slope)
        alpha_d = alpha if drop_mask is None else alpha * drop_mask
        msg_w = (msg.view(nnz, heads, f) * alpha_d.to(h.dtype)[:, :, None]
                 ).view(nnz, heads * f)
        out = spmm_edges(c, msg_w)
        ctx.c, ctx.ct = c, ct
        ctx.save_for_backward(h, a_src, a_dst, msg, alpha, lgrad, drop_mask)
        return out.view(c.n_rows, heads, f)

    @staticmethod
    def backward(ctx, g):
        h, a_src, a_dst, msg, alpha, lgrad, drop_mask = ctx.saved_tensors
        c, ct = ctx.c, ctx.ct
        heads, f = a_src.shape
        n_in, nnz, dt = h.shape[0], msg.shape[0], h.dtype
        msg3 = msg.view(nnz, heads, f)
        # the per-edge destination rows of g (K7)
        g_edges = expand_rows(c, g.to(dt).reshape(c.n_rows, heads * f).contiguous())
        g_edges = g_edges.view(nnz, heads, f)
        alpha_d = alpha if drop_mask is None else alpha * drop_mask
        dmsg = g_edges * alpha_d.to(dt)[:, :, None]
        dalpha = (g_edges * msg3).float().sum(-1)
        del g_edges
        if drop_mask is not None:  # the output used the dropped alpha
            dalpha = dalpha * drop_mask
        # softmax VJP: dz = alpha * (dalpha - S[dst]) * leaky', S = sum_dst alpha*dalpha
        s = edges_to_rows_sum(c, alpha * dalpha)                   # K6
        dz, dsd = gat_bwd_softmax(c, alpha, dalpha, lgrad, s)      # K5
        # score paths: sc_src = <msg, a_src> per head, s_dst = <h, a_dst> per head
        dmsg = dmsg + dz.to(dt)[:, :, None] * a_src
        da_src = (dz[:, :, None] * msg3).sum(0)
        dsd = dsd[:n_in]
        dh = (dsd.to(dt)[:, :, None] * a_dst).reshape(n_in, heads * f)
        da_dst = (dsd[:, :, None] * h.view(n_in, heads, f)).sum(0)
        # dh += the scatter of dmsg by source: K1 on A^T, reading dmsg in A's order
        dh_msg = spmm_edges(ct, dmsg.view(nnz, heads * f), c.t_slot_perm, backward=True)
        if dh_msg.shape[0] < n_in:  # sources past A^T's row space have no out-edges
            dh_msg = F.pad(dh_msg, (0, 0, 0, n_in - dh_msg.shape[0]))
        dh = dh + dh_msg[:n_in]
        return (dh, da_src.to(a_src.dtype), da_dst.to(a_dst.dtype), None, None, None,
                None)


def gat_attention_fused(c: ChunkedCSR, ct: ChunkedCSR, h: torch.Tensor,
                        a_src: torch.Tensor, a_dst: torch.Tensor,
                        negative_slope: float = 0.2,
                        drop_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused multi-head sparse GAT attention, differentiable in ``h``, ``a_src`` and
    ``a_dst``. Returns ``[c.n_rows, H, F]``.

    ``h [n, H*F]`` holds the projected features of a full graph, float32 or
    bfloat16: its rows are both the sources and the destinations, so ``c.n_cols <= n
    <= c.n_rows``. ``a_src`` and ``a_dst`` are ``[H, F]``, in ``h``'s type; the
    output is too. ``c`` is A's layout with ``t_slot_perm`` attached and
    ``ct`` the transpose's (``build_chunked_pair``). ``drop_mask [nnz, H]``, in A's
    edge order, multiplies alpha (attention dropout; the caller scales kept entries
    by ``1/(1-p)``).
    """
    heads, f = a_src.shape
    if h.dim() != 2 or h.shape[1] != heads * f or not c.n_cols <= h.shape[0] <= c.n_rows:
        raise ValueError(f"h: need [n, {heads * f}] with {c.n_cols} <= n <= {c.n_rows}, "
                         f"got {tuple(h.shape)}")
    if c.t_slot_perm is None:
        raise ValueError("the layout has no t_slot_perm: build it with build_chunked_pair")
    if a_src.dtype != h.dtype or a_dst.dtype != h.dtype:
        raise ValueError(f"a_src, a_dst: need h's type {h.dtype}, "
                         f"got {a_src.dtype} and {a_dst.dtype}")
    if drop_mask is not None and tuple(drop_mask.shape) != (c.src.numel(), heads):
        raise ValueError(f"drop_mask: need [{c.src.numel()}, {heads}], "
                         f"got {tuple(drop_mask.shape)}")
    return _GatFused.apply(h.contiguous(), a_src, a_dst, c, ct, float(negative_slope),
                           drop_mask)
