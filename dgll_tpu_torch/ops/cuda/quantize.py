"""Wrapper of kernel K8, the int8 quantizer's elementwise pass (``csrc/quantize.cu``).

Counterpart of the launch site of ``dgll_tpu/ops/quantize.py:quantize_int8_pallas``.
``quantize_int8_values`` runs the plain version (``ops/quantize.py:
quantize_int8_reference``) on a CPU tensor and launches K8 on a CUDA tensor, or
raises; ``launches`` counts its launches. ``quantize_int8_cuda`` is the launch
itself, uncounted, for checks and timings.
"""
from __future__ import annotations

from typing import Optional

import torch

from dgll_tpu_torch.ops.cuda.gat_fused import _launch
from dgll_tpu_torch.ops.cuda.segment_matmul import _check, _uses_kernel

launches = 0

_MODE = {"xla": 0, "floor": 1}
_NONE, _SUPPLIED, _PHILOX = 0, 1, 2


def quantize_int8_cuda(x: torch.Tensor, scale: torch.Tensor, mode: str = "xla",
                       noise: Optional[torch.Tensor] = None,
                       seed: Optional[int] = None) -> torch.Tensor:
    """Launch K8 once: int8 ``[n, d]``. ``noise`` (float32 ``[n, d]``) is read when
    given; else ``seed`` (not None) draws Philox noise in the kernel; else none."""
    if x.device.type != "cuda" or x.dim() != 2:
        raise ValueError(f"x: need a 2-D CUDA tensor, got {tuple(x.shape)} on {x.device}")
    if mode not in _MODE:
        raise ValueError(f"mode: one of {tuple(_MODE)}, got {mode!r}")
    dev, (n, d) = x.device, x.shape
    if d <= 0 or d >= 2**31:
        raise ValueError(f"need 0 < d < 2^31 columns, got {d}")
    _check("x", x, torch.float32, dev)
    _check("scale", scale, torch.float32, dev, d)
    if noise is not None:
        _check("noise", noise, torch.float32, dev, n * d)
    q = torch.empty((n, d), dtype=torch.int8, device=dev)
    kind = _SUPPLIED if noise is not None else _NONE if seed is None else _PHILOX
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, scale, *(() if noise is None
                                                                else (noise,))))
    vec = int(d % 4 == 0 and aligned and q.data_ptr() % 4 == 0)
    _launch("quantize_int8", dev, x.data_ptr(), scale.data_ptr(),
            None if noise is None else noise.data_ptr(), q.data_ptr(), n, d,
            _MODE[mode], kind, vec, (seed or 0) & 0xFFFFFFFFFFFFFFFF)
    return q


def quantize_int8_values(x: torch.Tensor, scale: torch.Tensor, mode: str,
                         noise: Optional[torch.Tensor] = None,
                         seed: Optional[int] = None) -> torch.Tensor:
    """K8 on a CUDA tensor (counted in ``launches``), else its plain version with the
    same noise (``philox_uniform`` where ``seed`` asks for Philox)."""
    global launches
    if _uses_kernel(x):
        q = quantize_int8_cuda(x, scale, mode, noise, seed)
        launches += 1
        return q
    from dgll_tpu_torch.ops.quantize import philox_uniform, quantize_int8_reference

    if noise is None and seed is not None:
        noise = torch.from_numpy(philox_uniform(x.shape[0], x.shape[1], seed))
    return quantize_int8_reference(x, scale, mode, noise)
