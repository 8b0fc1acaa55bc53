"""Quantization: packed int8 / int4 tensors with per-channel or per-group
scales, the per-row int8 activation quantizer, calibration observers and
the calibrated recipes (quant/smooth.py: SmoothQuant / AWQ; quant/gptq.py:
GPTQ), and the accuracy report (quant/validate.py)."""

from .calibration import Calibrator, Observer
from .qtypes import INT4_QMAX, INT8_QMAX, QuantizedTensor, pack_int4, unpack_int4
from .quantize import (compute_scales, dequantize, dequantize_stacked,
                       quantize, quantize_stacked)

__all__ = ["INT4_QMAX", "INT8_QMAX", "QuantizedTensor", "pack_int4",
           "unpack_int4", "compute_scales", "dequantize", "quantize",
           "quantize_stacked", "dequantize_stacked", "Calibrator",
           "Observer"]
