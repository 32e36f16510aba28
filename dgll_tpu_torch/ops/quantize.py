"""Feature quantisation and binarisation. Counterpart of ``dgll_tpu/ops/quantize.py``.

Features are stored int8 with per-column scales (``QuantizedFeatures``), which
quadruples the rows a device-memory budget holds (the int8 ``HBMFeatureCache``).

Both quantizers compute the per-column scale ``s = max(max|x|, 1e-12) / 127`` and
then round ``x / s``: in one C call of kernel K8 (``csrc/quantize.cu``) on a CUDA
tensor, which computes the scale on the card with no ``[n, d]`` temporary (XLA fuses
it in one pass in JAX); with the plain versions ``column_scale`` and
``quantize_int8_reference`` on a CPU tensor:

* ``quantize_int8`` (``quantize.py:37-46``): ``rint(x / s [+ u])``, clipped to
  [-127, 127]; ``u`` only with ``stochastic=True``;
* ``quantize_int8_stochastic``, the counterpart of ``quantize_int8_pallas``
  (``quantize.py:67-126``): ``floor(x * (1/s) + 0.5 + u)``, clipped.

The noise ``u`` is a supplied ``[n, d]`` tensor of uniforms in [-0.5, 0.5) (the tests
pass the JAX package's own noise, as its interpret path takes precomputed noise), or
counter-based Philox4x32-10 keyed by ``seed`` (``philox_uniform``): K8 draws it in the
kernel and the plain version reproduces the same bits on the host, so the two agree
exactly. The JAX package draws from threefry (``quantize_int8``) or the TPU's on-core
generator (the Pallas kernel); those bits cannot be matched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

MODES = ("xla", "floor")


@dataclass
class QuantizedFeatures:
    values: torch.Tensor   # [N, D] int8
    scale: torch.Tensor    # [D] float32 (per-column)
    n: int = 0
    d: int = 0

    def gather(self, ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        q = self.values.index_select(0, ids)
        return q.to(dtype) * self.scale.to(dtype)[None, :]

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return self.values.to(dtype) * self.scale.to(dtype)[None, :]


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-12) / 127``. The divisor is a tensor: on a CUDA device PyTorch
    divides by a Python scalar as a product with its reciprocal, which can differ from
    the division in the last bit."""
    amax = torch.clamp_min(amax, 1e-12)
    return amax / torch.full_like(amax, 127.0)


def column_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-column symmetric scale ``max(max|x|, 1e-12) / 127`` (float32 ``[d]``); a NaN
    in a column makes its scale NaN, as in JAX."""
    return _scale_of(x.abs().amax(dim=0))


FILL_TILE_ROWS = 256   # the plain fill's row tiles


def quantize_int8_fill_reference(x: torch.Tensor, mode: str = "xla",
                                 noise: Optional[torch.Tensor] = None,
                                 tile_rows: int = FILL_TILE_ROWS):
    """The fill's plain version, ``(values, scale)``: the column maxima of ``|x|`` over
    tiles of ``tile_rows`` rows and then over the tiles, as K8's fill combines them
    (a max rounds nothing and keeps a NaN, so the scale has ``column_scale``'s bits),
    then ``quantize_int8_reference``."""
    n, d = x.shape
    a = torch.nn.functional.pad(x.abs(), (0, 0, 0, (-n) % tile_rows))
    scale = _scale_of(a.view(-1, tile_rows, d).amax(dim=1).amax(dim=0))
    return quantize_int8_reference(x, scale, mode, noise), scale


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = np.uint64(0xFFFFFFFF)


def philox_uniform(n: int, d: int, seed: int) -> np.ndarray:
    """K8's in-kernel noise as float32 ``[n, d]``: Philox4x32-10 with key ``seed`` and
    counter ``(g mod 2^32, g >> 32, 0, 0)`` for the g-th group of four elements of the
    flat array; word k of the draw gives element ``4g + k`` the uniform
    ``(bits >> 8) * 2^-24 - 0.5`` in [-0.5, 0.5)."""
    total = int(n) * int(d)
    groups = -(-total // 4)
    g = np.arange(groups, dtype=np.uint64)
    c = [g & _U32, g >> np.uint64(32), np.zeros_like(g), np.zeros_like(g)]
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    k0, k1 = seed & 0xFFFFFFFF, seed >> 32
    m0, m1 = np.uint64(_PHILOX_M[0]), np.uint64(_PHILOX_M[1])
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & 0xFFFFFFFF
            k1 = (k1 + _PHILOX_W[1]) & 0xFFFFFFFF
        p0, p1 = m0 * c[0], m1 * c[2]   # 32 x 32 -> 64 bits, exact in uint64
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ np.uint64(k0), p1 & _U32,
             (p0 >> np.uint64(32)) ^ c[3] ^ np.uint64(k1), p0 & _U32]
    bits = np.stack(c, axis=1).reshape(-1)[:total]
    u = (bits >> np.uint64(8)).astype(np.float32) * np.float32(2.0 ** -24) - np.float32(0.5)
    return u.reshape(int(n), int(d))


def quantize_int8_reference(x: torch.Tensor, scale: torch.Tensor, mode: str = "xla",
                            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8's plain version: int8 ``[n, d]`` from float32 ``x`` and the column
    ``scale``. ``mode`` "xla": ``rint(x / s + u)``; "floor": ``floor((x * (1/s) +
    0.5) + u)``; both clipped to [-127, 127]. ``noise`` is ``u`` (none: 0)."""
    if mode not in MODES:
        raise ValueError(f"mode: one of {MODES}, got {mode!r}")
    s = scale[None, :]
    if mode == "xla":
        y = x / s
        if noise is not None:
            y = y + noise
        r = torch.round(y)  # half to even, as jnp.round
    else:
        y = x * (torch.ones_like(s) / s)
        t = y + 0.5
        if noise is not None:
            t = t + noise
        r = torch.floor(t)
    return torch.clamp(r, -127, 127).to(torch.int8)


def _quantize(x, mode: str, noise, seed: Optional[int]) -> QuantizedFeatures:
    """Scale and values: K8's one C call on a CUDA tensor, the plain versions on a CPU
    tensor. ``seed`` (not None) asks for Philox noise where ``noise`` is None."""
    from dgll_tpu_torch.ops.cuda import quantize as k8

    x = torch.as_tensor(x, dtype=torch.float32)
    if x.dim() != 2:
        raise ValueError(f"x: need a 2-D [n, d] tensor, got {tuple(x.shape)}")
    x = x.contiguous()
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=torch.float32, device=x.device).contiguous()
        if noise.shape != x.shape:
            raise ValueError(f"noise: need shape {tuple(x.shape)}, got {tuple(noise.shape)}")
        seed = None
    values, scale = k8.quantize_int8_fill(x, mode, noise, seed)
    return QuantizedFeatures(values=values, scale=scale, n=int(x.shape[0]),
                             d=int(x.shape[1]))


def quantize_int8(x, stochastic: bool = False, seed: int = 0,
                  noise: Optional[torch.Tensor] = None) -> QuantizedFeatures:
    """Per-column symmetric int8 quantisation, ``rint(x / s)``; with
    ``stochastic=True``, ``rint(x / s + u)``, ``u`` from ``noise`` or else Philox
    keyed by ``seed``. A numpy array or a CPU tensor runs on the CPU."""
    if not stochastic:
        noise = None
    return _quantize(x, "xla", noise, seed if stochastic else None)


def quantize_int8_stochastic(x, seed: int = 0,
                             noise: Optional[torch.Tensor] = None) -> QuantizedFeatures:
    """Stochastic-rounding int8 quantizer, the port of ``quantize_int8_pallas``:
    ``floor(x * (1/s) + 0.5 + u)``, ``u`` from ``noise`` or else Philox keyed by
    ``seed``."""
    return _quantize(x, "floor", noise, seed)


def binarize(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sign binarisation with per-column mean-magnitude scale (XNOR-style).

    Returns ``(signs int8 in {-1, +1}, scale [D])``; reconstruct as ``signs * scale``.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    scale = x.abs().mean(dim=0)
    signs = torch.where(x >= 0, 1, -1).to(torch.int8)
    return signs, scale


def quantization_error(x, qf: QuantizedFeatures) -> float:
    """Mean absolute reconstruction error relative to the mean magnitude of ``x``."""
    x = torch.as_tensor(x, dtype=torch.float32, device=qf.values.device)
    err = (qf.dequantize() - x).abs()
    return float(err.mean() / torch.clamp_min(x.abs().mean(), 1e-12))
