"""Quantized tensor container, ported from deeppowers_tpu/quant/qtypes.py.

A `QuantizedTensor` holds packed integer data with its scales (and optional
zero points). int8 and int4 weights, per-channel or per-group, with bf16 or
int8 activations (`act_bits`), all take the dequant-matmul kernels; the
int4 half-split packing is carried over byte-identical:
  packed[i, n] = (v[i + K/2, n] << 4) | (v[i, n] & 0x0F),  i in [0, K/2)
Stacked MoE experts (E, K, N) pack each expert apart, along dim 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

INT8_QMAX = 127
INT4_QMAX = 7


@dataclass
class QuantizedTensor:
    """Packed quantized (K, N) array with quantization metadata.

    data: int8, (K, N) for bits=8 or (K/2, N) packed for bits=4; stacked
        experts (E, K[/2], N).
    scales: f32, (1, N) per-channel or (G, N) per-group; (E, G, N) stacked.
    zero_points: int32 like scales (asymmetric only) or None.
    """

    data: torch.Tensor
    scales: torch.Tensor
    zero_points: Optional[torch.Tensor]
    bits: int
    group_size: int
    act_bits: int = 0

    @property
    def shape(self) -> Tuple[int, ...]:
        s = list(self.data.shape)
        if self.bits == 4:
            s[-2] = s[-2] * 2
        return tuple(s)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def nbytes(self) -> int:
        n = self.data.numel() * self.data.element_size()
        n += self.scales.numel() * self.scales.element_size()
        if self.zero_points is not None:
            n += self.zero_points.numel() * self.zero_points.element_size()
        return n

    @property
    def is_symmetric(self) -> bool:
        return self.zero_points is None

    def to(self, device) -> "QuantizedTensor":
        zp = None if self.zero_points is None else self.zero_points.to(device)
        return QuantizedTensor(self.data.to(device), self.scales.to(device),
                               zp, self.bits, self.group_size, self.act_bits)

    def __repr__(self) -> str:
        return (f"QuantizedTensor(shape={self.shape}, bits={self.bits}, "
                f"group_size={self.group_size}, sym={self.is_symmetric}, "
                f"act_bits={self.act_bits})")


def pack_int4(values: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Pack int8-held int4 values (range [-8, 7]) half-split along `dim`
    (dim 1 packs each expert of a stacked (E, K, N) tensor apart)."""
    if values.shape[dim] % 2 != 0:
        raise ValueError(f"int4 packing needs an even dim {dim}, got {tuple(values.shape)}")
    half = values.shape[dim] // 2
    lo = values.narrow(dim, 0, half).to(torch.uint8) & 0x0F
    hi = values.narrow(dim, half, half).to(torch.uint8) & 0x0F
    return ((hi << 4) | lo).view(torch.int8)


def unpack_int4(packed: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Inverse of pack_int4: (.., K//2, ..) int8 -> (.., K, ..) int8 in
    [-8, 7] along `dim`."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)
    return torch.cat([lo, hi], dim=dim)
