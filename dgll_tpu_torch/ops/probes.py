"""The primitive probes P0, P2, P2b, P3 and P4. Counterpart of the kernels of
``benchmarks/pallas_probe_r4.py``.

Each probe is one primitive a gather-fused SpMM could be built from, measured on its
own (``tools/probe.py``):

* ``p0_copy(x)``: a streaming copy, the achieved-bandwidth calibration;
* ``p2_dynread(idx, win)``: ``win[idx]`` from a window held on chip;
* ``p2b_onehot(idxv, win)``: the same gather as the product ``onehot(idxv) @ win``;
* ``p3_dynacc(idx, msg)``: the rows of ``msg`` added into an ``[OUT_TILE, F]``
  accumulator at the rows ``idx``;
* ``p4_dma(idx, x)``: ``x[idx]`` by one asynchronous copy a row.

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

import torch

from dgll_tpu_torch.ops.cuda.segment_matmul import _uses_kernel

OUT_TILE = 8192           # P3's accumulator rows (the TPU's VMEM-resident tile)
ONEHOT_BYTES = 1 << 28    # P2b's plain version: largest one-hot block it builds


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
