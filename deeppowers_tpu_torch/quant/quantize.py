"""Quantize / dequantize primitives, ported from
deeppowers_tpu/quant/quantize.py:43-192 (stacked MoE experts included).

Weights are (K, N) with K the contraction axis. Symmetric scale = absmax /
qmax per output channel (or per group of K rows), q = clip(round(w / s)).
torch.round, like jnp.round, rounds half to even, and every step runs in
f32 as XLA runs it (it turns the division by the constant qmax into a
product with the f32 reciprocal), so the int data and scales equal the JAX
package's bit for bit.

`quantize_rows` is the dynamic per-row int8 activation quantizer of the
W8A8 / W4A8 matmuls (JAX `_w8a8_matmul`, deeppowers_tpu/ops/matmul.py:57-59).
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


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per row of x (..., K): (q int8 (..., K), f32 row
    scales (..., 1)) with xs = max(absmax, 1e-8) / 127 and q = clip(round(
    x / xs), -127, 127), round half to even. Inside jit (where the JAX
    engine runs it) XLA computes xs as a product with the f32 reciprocal
    of 127 and q by IEEE division by xs; both are done so here, the
    division by a tensor, which PyTorch divides on every device."""
    xf = x.float()
    xs = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) * _recip(INT8_QMAX)
    q = torch.round(xf / xs).clamp(-INT8_QMAX, INT8_QMAX).to(torch.int8)
    return q, xs


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
             symmetric: Optional[bool] = None,
             scales: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """Quantize a 2-D (K, N) float matrix to a QuantizedTensor. Symmetric
    scales may be given, as AWQ's clip search finds them (JAX `quantize`
    :77-123); else min / max of the data."""
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
    if scales is None:
        scales, zps = compute_scales(w, bits=bits, group_size=group_size,
                                     symmetric=symmetric)
    else:
        scales = scales.float()
        zps = torch.zeros_like(scales, dtype=torch.int32)
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


def quantize_stacked(w3: torch.Tensor, *, bits: int = 8,
                     group_size: int = 0) -> QuantizedTensor:
    """Quantize stacked (E, K, N) weights (MoE experts) one expert at a time,
    symmetric, as JAX `quantize_stacked` (quant/quantize.py:160-183)
    vmaps it: data (E, K, N) int8 or (E, K/2, N) packed int4 (each expert
    packed apart), scales (E, G, N)."""
    if w3.dim() != 3:
        raise ValueError(f"quantize_stacked expects (E, K, N), got {tuple(w3.shape)}")
    datas, scales = [], []
    for w in w3.float():
        s, zps = compute_scales(w, bits=bits, group_size=group_size)
        q = _quantize_values(w, s, zps, bits=bits, group_size=group_size)
        datas.append(pack_int4(q) if bits == 4 else q)
        scales.append(s)
    return QuantizedTensor(data=torch.stack(datas), scales=torch.stack(scales),
                           zero_points=None, bits=bits, group_size=group_size)


def dequantize_stacked(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_stacked: -> (E, K, N) float."""
    return torch.stack([dequantize(QuantizedTensor(d, s, None, qt.bits,
                                                   qt.group_size), dtype)
                        for d, s in zip(qt.data, qt.scales)])

