"""Launchers of the primitive probes P0, P2, P2b, P3 and P4 (``csrc/probes.cu``).

Counterparts of the ``pallas_call`` sites of ``benchmarks/pallas_probe_r4.py``. Each
``*_cuda`` function checks its CUDA tensors, allocates the output and launches its
kernel once, uncounted (for checks and timings); a failed launch raises.
``launch(name, ...)`` is the counted launch that ``ops/probes.py`` dispatches a CUDA
tensor to; ``launches[name]`` counts it.

No launcher checks that its ids lie in their table: P2, P3 and P4 read or write
outside it otherwise (P2b gives a zero row, as the one-hot product does). That check
needs a reduction and a host read, so it is not made in the timed calls;
``check_index`` makes it once, before them.
"""
from __future__ import annotations

from typing import Optional

import torch

from dgll_tpu_torch.ops.cuda.segment_matmul import _check, _launch
from dgll_tpu_torch.ops.probes import OUT_TILE, P4Plan, p4_plan


def _rows(name: str, t: torch.Tensor, align: int = 16, width: int = 4):
    """A contiguous 2-D float32 CUDA table of rows: ``(rows, F, device)``."""
    if t.device.type != "cuda" or t.dim() != 2:
        raise ValueError(f"{name}: need a 2-D CUDA tensor, got {tuple(t.shape)} on {t.device}")
    _check(name, t, torch.float32, t.device)
    rows, f = t.shape
    if f <= 0 or f % width or t.data_ptr() % align:
        raise ValueError(f"{name}: need a width that is a positive multiple of {width} and a "
                         f"{align}-byte aligned pointer, got width {f}")
    return rows, f, t.device


def check_index(name: str, idx: torch.Tensor, rows: int) -> None:
    """Raise unless every id of ``idx`` lies in ``[0, rows)``."""
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= rows):
        raise ValueError(f"{name}: ids in [{int(idx.min())}, {int(idx.max())}] outside a "
                         f"table of {rows} rows")


def _index(name: str, idx: torch.Tensor, dev: torch.device) -> int:
    _check(name, idx, torch.int32, dev)
    return idx.numel()


def p0_copy_cuda(x: torch.Tensor) -> torch.Tensor:
    """P0: a copy of the float32 table ``x``."""
    _rows("x", x)
    out = torch.empty_like(x)
    _launch("probe_copy", x.device, x.data_ptr(), out.data_ptr(), x.numel())
    return out


def p2_dynread_cuda(idx: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """P2: ``win[idx]`` as ``[idx.numel(), F]``, the window staged in shared memory."""
    win_rows, f, dev = _rows("win", win)
    e = _index("idx", idx, dev)
    out = torch.empty((e, f), dtype=torch.float32, device=dev)
    _launch("probe_dynread", dev, idx.data_ptr(), win.data_ptr(), out.data_ptr(), e,
            win_rows, f)
    return out


def p2b_onehot_cuda(idxv: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """P2b: ``onehot(idxv[:, 0]) @ win`` on the tensor cores, ``[E, F]``; WIN a
    multiple of 8 and F of 32. ``win`` is split into three bfloat16 parts (hi, mid,
    lo, each cut toward zero) that sum to it exactly, and the one-hot rows meet each
    part in a bfloat16 ``wgmma`` product with float32 sums: each output row is its
    window row, exactly for values from 2^-103 up in magnitude (and 0), or a zero row
    for an index outside the window."""
    if (idxv.dim() != 2 or idxv.shape[1] != 1 or win.dim() != 2 or win.shape[0] % 8
            or win.shape[1] % 32 or not win.shape[1]):
        raise ValueError(f"p2b_onehot: need idxv [E, 1] and a window of a multiple of 8 "
                         f"rows and 32 columns, got {tuple(idxv.shape)} and "
                         f"{tuple(win.shape)}")
    win_rows, f, dev = _rows("win", win, width=32)
    e = _index("idxv", idxv, dev)
    out = torch.empty((e, f), dtype=torch.float32, device=dev)
    _launch("probe_onehot", dev, idxv.data_ptr(), win.data_ptr(), out.data_ptr(), e,
            win_rows, f)
    return out


def p3_dynacc_cuda(idx: torch.Tensor, msg: torch.Tensor,
                   out_rows: int = OUT_TILE) -> torch.Tensor:
    """P3: ``[out_rows, F]`` zeros plus ``msg[i]`` added at row ``idx[i]``, through L2
    atomics (the sums' order, and so their last bits, change from run to run)."""
    e, f, dev = _rows("msg", msg, width=1)
    if _index("idx", idx, dev) != e:
        raise ValueError(f"idx: need one index a message row ({e}), got {idx.numel()}")
    acc = torch.empty((out_rows, f), dtype=torch.float32, device=dev)
    _launch("probe_dynacc", dev, idx.data_ptr(), msg.data_ptr(), acc.data_ptr(), e,
            out_rows, f)
    return acc


def p4_dma_cuda(idx: torch.Tensor, x: torch.Tensor,
                plan: Optional[P4Plan] = None) -> torch.Tensor:
    """P4: ``x[idx]`` as ``[idx.numel(), F]`` in one C call, by the path of ``plan``
    (``ops.probes.p4_plan(rows, F, E)`` unless given): the direct gather, or the
    bucket pass and then the gather in bucket order, its scratch (the (pos, row)
    pairs and the buckets' cursors) allocated here with the output."""
    rows, f, dev = _rows("x", x)
    e = _index("idx", idx, dev)
    plan = p4_plan(rows, f, e) if plan is None else plan
    out = torch.empty((e, f), dtype=torch.float32, device=dev)
    order = cursor = None
    if plan.bucketed:
        scratch = torch.empty(2 * e + plan.buckets, dtype=torch.int32, device=dev)
        order, cursor = scratch.data_ptr(), scratch.data_ptr() + 8 * e
    _launch("probe_gather", dev, idx.data_ptr(), x.data_ptr(), out.data_ptr(), order, cursor,
            e, rows, f, plan.shift, plan.blocks_per_sm, plan.threads, plan.unroll)
    return out


KERNELS = {"p0_copy": p0_copy_cuda, "p2_dynread": p2_dynread_cuda,
           "p2b_onehot": p2b_onehot_cuda, "p3_dynacc": p3_dynacc_cuda,
           "p4_dma": p4_dma_cuda}
launches = dict.fromkeys(KERNELS, 0)


def launch(name: str, *args) -> torch.Tensor:
    """Launch probe ``name``'s kernel on CUDA tensors and count it."""
    out = KERNELS[name](*args)
    launches[name] += 1
    return out
