"""The primitive probes P0, P2, P2b, P3 and P4. Counterpart of the kernels of
``benchmarks/pallas_probe_r4.py``.

Each probe is one primitive a gather-fused SpMM could be built from, measured on its
own (``tools/probe.py``):

* ``p0_copy(x)``: a streaming copy, the achieved-bandwidth calibration;
* ``p2_dynread(idx, win)``: ``win[idx]`` from a window held on chip;
* ``p2b_onehot(idxv, win)``: the same gather as the product ``onehot(idxv) @ win``;
* ``p3_dynacc(idx, msg)``: the rows of ``msg`` added into an ``[OUT_TILE, F]``
  accumulator at the rows ``idx``;
* ``p4_dma(idx, x)``: ``x[idx]``, the gather of rows from anywhere in a table in
  device memory (``p4_plan`` picks the kernel's path).

The shapes and index layouts are the JAX functions': ``idx`` is ``[E / 512, 512]``
int32 (P2, P3, P4), ``idxv`` is ``[E, 1]`` int32 (P2b), rows are float32. Each returns
its output array (the JAX functions also return its first element, for their relay's
scalar read-back). A CPU tensor runs the plain PyTorch version (``*_reference``); a
CUDA tensor launches the kernel of ``csrc/probes.cu``, counted in
``ops.cuda.probes.launches``, or raises. The kernels do not check that the ids lie in
their table (``ops.cuda.probes.check_index`` does, once, outside a timed loop).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from dgll_tpu_torch.ops.cuda.segment_matmul import _uses_kernel

OUT_TILE = 8192           # P3's accumulator rows (the TPU's VMEM-resident tile)
ONEHOT_BYTES = 1 << 28    # P2b's plain version: largest one-hot block it builds
# P4's plan (``p4_plan``): the bucketed path for a table larger than the direct
# path's limit, of whole 128-byte rows, and at least P4_MIN_DRAWS draws a row
P4_DIRECT_TABLE_BYTES = 32 * 10**6
P4_MIN_DRAWS = 2
P4_BUCKET_BYTES = 1 << 22    # table bytes a bucket holds, at most (a power of two rows)
P4_MAX_BUCKETS = 8192        # the bucket pass's counters in shared memory
P4_SPAN = 4096               # positions a block of the bucket pass sorts (the kernel's)
# the gather's launch: (blocks an SM, threads a block, loads a lane issues at once);
# the bucketed path keeps few warps resident, so that the positions in flight cover
# about one bucket, and many loads a warp; the direct path wants the most in flight
P4_DIRECT_LAUNCH = (4, 256, 4)
P4_BUCKETED_LAUNCH = (2, 128, 16)


@contextlib.contextmanager
def _full_f32_matmul():
    """Float32 products in full float32 (no TF32) inside the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def p0_copy_reference(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def p2_dynread_reference(idx: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    return win[idx.reshape(-1).long()]


def p2b_onehot_reference(idxv: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """``(cols == idxv).astype(f32) @ win`` as the JAX body writes it, in float32 with
    TF32 off, in blocks of rows so that no one-hot block exceeds ``ONEHOT_BYTES``."""
    win_rows = win.shape[0]
    cols = torch.arange(win_rows, dtype=idxv.dtype, device=idxv.device)[None, :]
    step = max(1, ONEHOT_BYTES // (4 * win_rows))
    out = torch.empty((idxv.shape[0], win.shape[1]), dtype=win.dtype, device=win.device)
    with _full_f32_matmul():
        for i in range(0, idxv.shape[0], step):
            g = (cols == idxv[i:i + step]).to(win.dtype)
            torch.matmul(g, win, out=out[i:i + step])
    return out


def p3_dynacc_reference(idx: torch.Tensor, msg: torch.Tensor,
                        out_rows: int = OUT_TILE) -> torch.Tensor:
    acc = torch.zeros((out_rows, msg.shape[1]), dtype=torch.float32, device=msg.device)
    return acc.index_add_(0, idx.reshape(-1).long(), msg.float())


def p4_dma_reference(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x[idx.reshape(-1).long()]


@dataclasses.dataclass(frozen=True)
class P4Plan:
    """How P4's kernel gathers: directly, or bucketed. The bucketed path's bucket pass
    puts the positions in order of their row's bucket (table rows ``r >> shift``, of
    which there are ``buckets``), so that the gather reads the table one slice at a
    time. The gather runs ``blocks_per_sm`` blocks of ``threads`` an SM, each lane
    issuing ``unroll`` loads (4, 8 or 16) before its stores."""
    bucketed: bool
    shift: int = -1
    buckets: int = 0
    blocks_per_sm: int = P4_DIRECT_LAUNCH[0]
    threads: int = P4_DIRECT_LAUNCH[1]
    unroll: int = P4_DIRECT_LAUNCH[2]


def p4_plan(rows: int, f: int, e: int) -> P4Plan:
    """P4's path for ``e`` ids into a float32 table of ``rows`` x ``f``, a pure
    function of the three. The direct path where the table fits the card's L2 with
    room to spare (at most ``P4_DIRECT_TABLE_BYTES``), where the ids draw a row fewer
    than ``P4_MIN_DRAWS`` times on average (few rows are read twice, so the bucket
    pass costs more than it saves), or where a row is not whole 128-byte lines (F % 32:
    scattered rows then share lines, and their partial writes cost more than the
    reuse saves). Else the bucketed path (``p4_bucketed_plan``). The crossovers, as
    ``tools/p4_sweep.py`` measured them on an H100 80GB HBM3 at 700 W (PERF.md): at
    [500000, 128] the bucketed path wins from 2 draws a row; at 8 draws a row it ties
    at a 25.6 MB table and wins from 51.2 MB; at [2400000, 100] it loses at 3."""
    if rows * f * 4 <= P4_DIRECT_TABLE_BYTES or e < P4_MIN_DRAWS * rows or f % 32:
        return P4Plan(bucketed=False)
    return p4_bucketed_plan(rows, f)


def p4_bucketed_plan(rows: int, f: int, bucket_bytes: int = P4_BUCKET_BYTES) -> P4Plan:
    """The bucketed path's buckets: the largest power of two of rows whose bytes fit
    ``bucket_bytes`` (one row at least), coarser where that would make more than
    ``P4_MAX_BUCKETS``; and its gather's launch, ``P4_BUCKETED_LAUNCH``."""
    shift = max(0, (bucket_bytes // (4 * f)).bit_length() - 1)
    while ((rows - 1) >> shift) + 1 > P4_MAX_BUCKETS:
        shift += 1
    return P4Plan(True, shift, ((rows - 1) >> shift) + 1, *P4_BUCKETED_LAUNCH)


def p4_bucket_order(idx: torch.Tensor, plan: P4Plan) -> torch.Tensor:
    """The positions in bucket order, int64 ``[E]``: bucket by bucket, and inside a
    bucket block by block, each run in position order (the kernel's runs may come in
    another order and hold their positions in another order: each output row is
    written once all the same)."""
    flat = idx.reshape(-1).long()
    return torch.argsort(flat >> plan.shift, stable=True)


def p4_bucketed_reference(idx: torch.Tensor, x: torch.Tensor, plan: P4Plan) -> torch.Tensor:
    """The bucketed path's plain version: the rows gathered in bucket order, then put
    back at their positions. Equal to ``p4_dma_reference``."""
    flat = idx.reshape(-1).long()
    order = p4_bucket_order(flat, plan)
    out = torch.empty((flat.numel(), x.shape[1]), dtype=x.dtype, device=x.device)
    out[order] = x[flat[order]]
    return out


def _dispatch(name, plain, t: torch.Tensor, *args):
    if _uses_kernel(t):
        from dgll_tpu_torch.ops.cuda import probes

        return probes.launch(name, *args)
    return plain(*args)


def p0_copy(x: torch.Tensor) -> torch.Tensor:
    """P0: a copy of ``x`` ``[E, F]``."""
    return _dispatch("p0_copy", p0_copy_reference, x, x)


def p2_dynread(idx: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """P2: ``out[c * 512 + e] = win[idx[c, e]]``, ``[idx.numel(), F]``."""
    return _dispatch("p2_dynread", p2_dynread_reference, win, idx, win)


def p2b_onehot(idxv: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """P2b: ``onehot(idxv[:, 0], WIN) @ win``, ``[E, F]``, f32 accumulation."""
    return _dispatch("p2b_onehot", p2b_onehot_reference, win, idxv, win)


def p3_dynacc(idx: torch.Tensor, msg: torch.Tensor, out_rows: int = OUT_TILE) -> torch.Tensor:
    """P3: ``acc[idx[c, e]] += msg[c * 512 + e]`` into zeros ``[out_rows, F]``."""
    return _dispatch("p3_dynacc", p3_dynacc_reference, msg, idx, msg, out_rows)


def p4_dma(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P4: ``out[c * 512 + e] = x[idx[c, e]]``, ``[idx.numel(), F]``."""
    return _dispatch("p4_dma", p4_dma_reference, x, idx, x)
