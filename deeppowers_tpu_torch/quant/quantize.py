"""Quantize / dequantize primitives, ported from
deeppowers_tpu/quant/quantize.py:43-158.

Weights are (K, N) with K the contraction axis. Symmetric scale = absmax /
qmax per output channel (or per group of K rows), q = clip(round(w / s)).
torch.round, like jnp.round, rounds half to even, and every step runs in
f32 as XLA runs it (it turns the division by the constant qmax into a
product with the f32 reciprocal), so the int data and scales equal the JAX
package's bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import QuantConfig, QuantMode
from .qtypes import INT4_QMAX, INT8_QMAX, QuantizedTensor, pack_int4, unpack_int4


def _qmax(bits: int) -> int:
    return INT8_QMAX if bits == 8 else INT4_QMAX


def _qmin(bits: int) -> int:
    return -128 if bits == 8 else -8


def _recip(q: int) -> torch.Tensor:
    return torch.tensor(1.0 / q, dtype=torch.float32)


def _grouped(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """Reshape (K, N) -> (G, g, N) for per-group reductions."""
    k, n = w.shape
    if k % group_size != 0:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    return w.reshape(k // group_size, group_size, n)


def compute_scales(w: torch.Tensor, *, bits: int = 8, group_size: int = 0,
                   symmetric: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scales, zero_points) for a (K, N) matrix: scales (1, N) per-channel
    or (G, N) per-group, f32; int32 zero points (all zero when symmetric)."""
    w = w.float()
    qmax, qmin = _qmax(bits), _qmin(bits)
    if group_size and group_size > 0:
        wg = _grouped(w, group_size)
        wmax = wg.amax(dim=1)
        wmin = wg.amin(dim=1)
    else:
        wmax = w.amax(dim=0, keepdim=True)
        wmin = w.amin(dim=0, keepdim=True)
    if symmetric:
        absmax = torch.maximum(wmax.abs(), wmin.abs())
        scales = torch.clamp(absmax, min=1e-8) * _recip(qmax)
        zps = torch.zeros_like(scales, dtype=torch.int32)
    else:
        scales = torch.clamp(wmax - wmin, min=1e-8) * _recip(qmax - qmin)
        zps = torch.round(qmin - wmin / scales).to(torch.int32)
    return scales.float(), zps


def _quantize_values(w, scales, zps, *, bits: int, group_size: int) -> torch.Tensor:
    qmax, qmin = _qmax(bits), _qmin(bits)
    if group_size and group_size > 0:
        wg = _grouped(w, group_size)
        q = torch.round(wg / scales[:, None, :]) + zps[:, None, :]
        q = q.reshape(w.shape)
    else:
        q = torch.round(w / scales) + zps
    return torch.clamp(q, qmin, qmax).to(torch.int8)


def quantize(w: torch.Tensor, config: Optional[QuantConfig] = None, *,
             bits: Optional[int] = None, group_size: Optional[int] = None,
             symmetric: Optional[bool] = None) -> QuantizedTensor:
    """Quantize a 2-D (K, N) float matrix to a QuantizedTensor."""
    if config is not None:
        bits = {QuantMode.INT8: 8, QuantMode.INT4: 4}[config.mode]
        group_size = config.group_size
        symmetric = config.symmetric
    bits = int(bits or 8)
    group_size = int(group_size or 0)
    symmetric = True if symmetric is None else bool(symmetric)
    if w.dim() != 2:
        raise ValueError(f"quantize expects 2-D (K, N) weights, got {tuple(w.shape)}")
    if bits == 4 and w.shape[0] % 2 != 0:
        raise ValueError(f"INT4 needs even K for nibble packing, got K={w.shape[0]}")
    w = w.float()
    scales, zps = compute_scales(w, bits=bits, group_size=group_size,
                                 symmetric=symmetric)
    q = _quantize_values(w, scales, zps, bits=bits, group_size=group_size)
    return QuantizedTensor(
        data=pack_int4(q) if bits == 4 else q, scales=scales,
        zero_points=None if symmetric else zps, bits=bits,
        group_size=group_size)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Packed ints -> float (K, N)."""
    q = unpack_int4(qt.data) if qt.bits == 4 else qt.data
    q = q.float()
    zps = qt.zero_points
    if qt.group_size and qt.group_size > 0:
        qg = _grouped(q, qt.group_size)
        if zps is not None:
            qg = qg - zps[:, None, :].float()
        w = (qg * qt.scales[:, None, :]).reshape(qt.shape)
    else:
        if zps is not None:
            q = q - zps.float()
        w = q * qt.scales
    return w.to(dtype)
