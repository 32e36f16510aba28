"""Wrappers of the kernels of the round-4 GAT attention path.

Counterpart of the launch sites of ``dgll_tpu/ops/pallas/edge_ops.py`` and
``dgll_tpu/ops/pallas/sddmm.py``. The kernels are in ``csrc/gat_csr.cu``; their
plain PyTorch versions are in ``ops/gat_csr.py``. Per-edge arrays are ``[nnz, H]``
(or ``[nnz]``) in the layout's edge order; per-row arrays ``[n_rows, H]`` (or
``[n_rows]``).

Each wrapper runs the plain version on CPU tensors and launches its kernel on CUDA
tensors, or raises; ``launches[name]`` counts the launches:

| Name | TPU kernel it replaces | Kernel launched |
| --- | --- | --- |
| ``edges_to_rows_max`` | K6 ``_e2r_multi_kernel``, max mode | K6, max mode |
| ``rows_to_edges_multi`` | K6′ ``_r2e_multi_kernel`` | K6′ |
| ``rows_to_edges`` | K10 ``_rows_to_edges_kernel`` | K6′ at H = 1 |
| ``edges_to_rows:sum`` | K10 ``_reduce_kernel``, sum and sum_all | K6 sum at H = 1 |
| ``edges_to_rows:max`` | K10 ``_reduce_kernel``, max | K6 max at H = 1 |
| ``sddmm_edges`` | K9 ``_sddmm_kernel`` | K9 |

K6′ runs K4's edge-major mapping (``gat_fused.edge_plan``) with a gather for its
arithmetic. K6's sum and sum_all modes at H heads are
``gat_fused.edges_to_rows_sum``, counted in ``gat_fused.launches``. The rank of the
argument tells the single-head K10 wrappers (``[n_rows]``, ``[nnz]``) from the
multi-head ones, as in the JAX package.
"""
from __future__ import annotations

import torch

from dgll_tpu_torch.ops import gat_csr
from dgll_tpu_torch.ops.chunked import ChunkedCSR
from dgll_tpu_torch.ops.cuda import gat_fused as gf
from dgll_tpu_torch.ops.cuda.segment_matmul import _check

launches = dict.fromkeys(("edges_to_rows_max", "rows_to_edges_multi", "rows_to_edges",
                          "edges_to_rows:sum", "edges_to_rows:max", "sddmm_edges"), 0)

E2R_OPS = ("sum", "sum_all", "max")


def edges_to_rows_max_cuda(c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    """Launch K6 (max mode) once: ``[n_rows, H]``, ``NEG`` on rows without edges."""
    return gf.edges_to_rows_launch("max", c, v)


def _lanes(fv: int) -> int:
    """Lanes per edge in K9: the largest power of two up to 32 and up to ``fv``."""
    return 1 << (min(fv, 32).bit_length() - 1)


def sddmm_cuda(c: ChunkedCSR, a: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """Launch K9 once: ``out[e] = <a[row of e], msg[e]>``, ``[nnz]``."""
    if a.device.type != "cuda" or a.dim() != 2 or a.shape[0] != c.n_rows:
        raise ValueError(f"a: need a [n_rows={c.n_rows}, F] CUDA tensor, "
                         f"got {tuple(a.shape)} on {a.device}")
    dev, f, nnz = a.device, a.shape[1], c.src.numel()
    _check("rows", c.rows, torch.int32, dev, nnz)
    gf._check_f32(dev, a.shape, a=a)
    gf._check_f32(dev, (nnz, f), msg=msg)
    vec = 4 if f % 4 == 0 and a.data_ptr() % 16 == 0 and msg.data_ptr() % 16 == 0 else 1
    out = torch.empty(nnz, device=dev)
    gf._launch("sddmm", dev, c.rows.data_ptr(), a.data_ptr(), msg.data_ptr(),
               out.data_ptr(), nnz, f, vec, _lanes(f // vec))
    return out


def _need_rank(name: str, t: torch.Tensor, rank: int) -> None:
    if t.dim() != rank:
        raise ValueError(f"{name}: need a {rank}-D tensor, got {tuple(t.shape)}")


def edges_to_rows_max(c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    """K6, max mode: ``[nnz, H] -> [n_rows, H]`` (``edges_to_rows_max_reference``)."""
    _need_rank("v", v, 2)
    return gf._dispatch(launches, "edges_to_rows_max", edges_to_rows_max_cuda,
                        gat_csr.edges_to_rows_max_reference, v, c, v)


def _rows_to_edges_launch(c: ChunkedCSR, v: torch.Tensor, heads: int) -> torch.Tensor:
    """Launch K6′'s kernel once on ``v`` (``[n_rows, heads]``, or ``[n_rows]`` at one
    head): ``out[e] = v[row of e]``, in the variant of ``edge_plan``."""
    dev, nnz = v.device, c.src.numel()
    _check("rows", c.rows, torch.int32, dev, nnz)
    _check("v", v, torch.float32, dev)
    out = torch.empty((nnz, heads) if v.dim() == 2 else nnz, device=dev)
    plan = gf.edge_plan(nnz, heads, c.rows, (out,), (v,))
    gf._launch("rows_to_edges_multi", dev, c.rows.data_ptr(), v.data_ptr(), out.data_ptr(),
               nnz, heads, *plan)
    return out


def rows_to_edges_multi_cuda(c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    """Launch K6′ once: ``[n_rows, H] -> [nnz, H]``, ``out[e] = v[row of e]``."""
    if v.device.type != "cuda" or v.dim() != 2 or v.shape[0] != c.n_rows:
        raise ValueError(f"v: need a [n_rows={c.n_rows}, H] CUDA tensor, "
                         f"got {tuple(v.shape)} on {v.device}")
    return _rows_to_edges_launch(c, v, v.shape[1])


def rows_to_edges_multi(c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    """K6′: ``[n_rows, H] -> [nnz, H]``, ``out[e] = v[row of e]``."""
    _need_rank("v", v, 2)
    return gf._dispatch(launches, "rows_to_edges_multi", rows_to_edges_multi_cuda,
                        gat_csr.rows_to_edges_reference, v, c, v)


def rows_to_edges_cuda(c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    """Launch K10's rows-to-edges once: ``[n_rows] -> [nnz]``, K6′'s kernel at one
    head (4 edges a thread, with 16-byte loads of ``c.rows`` where it is 16-byte
    aligned, as a layout's own tensor is)."""
    if v.device.type != "cuda" or v.dim() != 1 or v.shape[0] != c.n_rows:
        raise ValueError(f"v: need a [n_rows={c.n_rows}] CUDA tensor, "
                         f"got {tuple(v.shape)} on {v.device}")
    return _rows_to_edges_launch(c, v, 1)


def rows_to_edges(c: ChunkedCSR, v: torch.Tensor) -> torch.Tensor:
    """K10's rows-to-edges: ``[n_rows] -> [nnz]``, ``out[e] = v[row of e]``."""
    _need_rank("v", v, 1)
    return gf._dispatch(launches, "rows_to_edges", rows_to_edges_cuda,
                        gat_csr.rows_to_edges_reference, v, c, v)


def edges_to_rows_cuda(c: ChunkedCSR, e: torch.Tensor, op: str) -> torch.Tensor:
    """Launch K6's sum or max kernel once at H = 1: ``[nnz] -> [n_rows]``."""
    kernel = edges_to_rows_max_cuda if op == "max" else gf.edges_to_rows_sum_cuda
    return kernel(c, e.view(-1, 1)).view(-1)


def _edges_to_rows_reference(c: ChunkedCSR, e: torch.Tensor, op: str) -> torch.Tensor:
    if op == "max":
        return gat_csr.edges_to_rows_max_reference(c, e)
    return gat_csr.edges_to_rows_sum_reference(c, e)


def edges_to_rows(c: ChunkedCSR, e: torch.Tensor, op: str) -> torch.Tensor:
    """K10's row reduction: ``[nnz] -> [n_rows]``. ``op`` "sum" or "sum_all" (the
    same sum here: this layout has no padding slots) runs K6's sum kernel at H = 1,
    counted in ``launches["edges_to_rows:sum"]``; "max" its max kernel (``NEG`` on
    rows without edges), counted in ``launches["edges_to_rows:max"]``."""
    _need_rank("e", e, 1)
    if op not in E2R_OPS:
        raise ValueError(f"op: one of {E2R_OPS}, got {op!r}")
    name = "edges_to_rows:max" if op == "max" else "edges_to_rows:sum"
    return gf._dispatch(launches, name, edges_to_rows_cuda, _edges_to_rows_reference,
                        e, c, e, op)


def sddmm_edges(c: ChunkedCSR, a: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """K9: ``out[e] = <a[row of e], msg[e]>``, ``[nnz]`` (``sddmm_reference``)."""
    return gf._dispatch(launches, "sddmm_edges", sddmm_cuda, gat_csr.sddmm_reference,
                        a, c, a, msg)
