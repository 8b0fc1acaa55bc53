"""Quantization core: packed int8 / int4 tensors with per-channel or
per-group scales, and the per-row int8 activation quantizer."""

from .qtypes import INT4_QMAX, INT8_QMAX, QuantizedTensor, pack_int4, unpack_int4
from .quantize import (compute_scales, dequantize, dequantize_stacked,
                       quantize, quantize_stacked)

__all__ = ["INT4_QMAX", "INT8_QMAX", "QuantizedTensor", "pack_int4",
           "unpack_int4", "compute_scales", "dequantize", "dequantize_stacked",
           "quantize", "quantize_stacked"]
