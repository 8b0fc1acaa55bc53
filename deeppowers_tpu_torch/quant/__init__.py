"""Quantization core: packed int8 tensors and their per-channel scales."""

from .qtypes import INT4_QMAX, INT8_QMAX, QuantizedTensor, pack_int4, unpack_int4
from .quantize import compute_scales, dequantize, quantize

__all__ = ["INT4_QMAX", "INT8_QMAX", "QuantizedTensor", "pack_int4",
           "unpack_int4", "compute_scales", "dequantize", "quantize"]
