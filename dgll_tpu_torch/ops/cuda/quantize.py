"""Wrappers of kernel K8, the int8 quantizer (``csrc/quantize.cu``).

Counterpart of the launch site of ``dgll_tpu/ops/quantize.py:quantize_int8_pallas``
and of the per-column scale XLA computes before it. ``quantize_int8_fill`` is the
whole fill, scale and values, that ``ops/quantize.py`` runs: on a CUDA tensor one C
call (``quantize_int8_fill_cuda``), counted in ``launches``; on a CPU tensor the plain
versions (``ops/quantize.py:column_scale`` and ``quantize_int8_reference``).
``quantize_int8_cuda`` is the elementwise pass alone with the scale given, the Pallas
kernel's body, uncounted, for checks and timings.

A call of a few tens of microseconds waits on its host work before the launch, so
each wrapper checks each tensor once, allocates one buffer, and takes the vector path
from ``d`` and the pointers' low bits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from dgll_tpu_torch.ops.cuda.segment_matmul import _launch, _uses_kernel

launches = 0

_MODE = {"xla": 0, "floor": 1}
_NONE, _SUPPLIED, _PHILOX = 0, 1, 2
_VEC = 8   # the flags' vector bit: float4 loads and char4 stores
_SEED_BITS = 0xFFFFFFFFFFFFFFFF


def _f32(name: str, t: torch.Tensor, dev: torch.device, numel: int) -> None:
    if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous() \
            or t.numel() != numel:
        raise ValueError(f"{name}: need a contiguous float32 tensor of {numel} elements on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _args(x: torch.Tensor, mode: str, noise: Optional[torch.Tensor], seed: Optional[int]):
    """``(n, d, device, flags, noise pointer, seed bits, pointer bits)`` of a call, ``x``
    and ``noise`` checked. The flags hold the mode and the noise kind as the C entries
    take them (the caller adds the vector bit); the pointer bits are x's and the
    noise's addresses or-ed, so that ``bits & 15`` is 0 when both are 16-byte
    aligned."""
    if not x.is_cuda or x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x: need a contiguous 2-D float32 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    code = _MODE.get(mode)
    if code is None:
        raise ValueError(f"mode: one of {tuple(_MODE)}, got {mode!r}")
    (n, d), dev = x.shape, x.device
    if not 0 < d < 2**31:
        raise ValueError(f"need 0 < d < 2^31 columns, got {d}")
    if noise is None:
        kind = _NONE if seed is None else _PHILOX
        return n, d, dev, code | kind << 1, None, (seed or 0) & _SEED_BITS, x.data_ptr()
    _f32("noise", noise, dev, n * d)
    ptr = noise.data_ptr()
    return n, d, dev, code | _SUPPLIED << 1, ptr, 0, x.data_ptr() | ptr


def quantize_int8_cuda(x: torch.Tensor, scale: torch.Tensor, mode: str = "xla",
                       noise: Optional[torch.Tensor] = None,
                       seed: Optional[int] = None) -> torch.Tensor:
    """Launch K8's pass once: int8 ``[n, d]`` from ``x`` and the column ``scale``.
    ``noise`` (float32 ``[n, d]``) is read when given; else ``seed`` (not None) draws
    Philox noise in the kernel; else none."""
    n, d, dev, flags, nptr, seed_bits, bits = _args(x, mode, noise, seed)
    _f32("scale", scale, dev, d)
    q = torch.empty(n, d, dtype=torch.int8, device=dev)
    if not (d & 3 or (bits | scale.data_ptr()) & 15):
        flags |= _VEC
    _launch("quantize_int8", dev, x.data_ptr(), scale.data_ptr(), nptr, q.data_ptr(), n, d,
            flags, seed_bits)
    return q


def quantize_int8_fill_cuda(x: torch.Tensor, mode: str = "xla",
                            noise: Optional[torch.Tensor] = None,
                            seed: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole fill in one C call: ``(q, scale)``, int8 ``[n, d]`` and float32
    ``[d]``, the scale ``max(max_i |x[i, j]|, 1e-12) / 127`` computed on the card
    (a NaN in a column makes its scale NaN and its values 0), with the noise of
    ``quantize_int8_cuda``. ``q``, ``scale`` and the kernel's scratch (the column
    maxima and a block count) lie in one buffer."""
    n, d, dev, flags, nptr, seed_bits, bits = _args(x, mode, noise, seed)
    if n == 0:
        raise ValueError("x: a column maximum needs at least one row")
    if not (d & 3 or bits & 15):
        flags |= _VEC
    off = (n * d + 15) & ~15
    buf = torch.empty(off + 8 * d + 4, dtype=torch.int8, device=dev)
    base = buf.data_ptr()
    _launch("quantize_int8_fill", dev, x.data_ptr(), nptr, base, base + off, base + off + 4 * d,
            n, d, flags, seed_bits)
    return (buf.as_strided((n, d), (d, 1)),
            buf.view(torch.float32).as_strided((d,), (1,), off // 4))


def quantize_int8_fill(x: torch.Tensor, mode: str, noise: Optional[torch.Tensor] = None,
                       seed: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, scale)`` of the fill: K8's one C call on a CUDA tensor (one count in
    ``launches``), else the plain versions with the same noise (``philox_uniform``
    where ``seed`` asks for Philox)."""
    global launches
    if _uses_kernel(x):
        out = quantize_int8_fill_cuda(x, mode, noise, seed)
        launches += 1
        return out
    from dgll_tpu_torch.ops.quantize import (column_scale, philox_uniform,
                                             quantize_int8_reference)

    if noise is None and seed is not None:
        noise = torch.from_numpy(philox_uniform(x.shape[0], x.shape[1], seed))
    scale = column_scale(x)
    return quantize_int8_reference(x, scale, mode, noise), scale
