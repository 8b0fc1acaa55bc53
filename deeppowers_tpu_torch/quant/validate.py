"""Quantization accuracy validation, ported from
deeppowers_tpu/quant/validate.py: per-tensor error metrics of the
dequantized weights against the originals (max / mean absolute error,
MSE, RMSE, mean relative error, a histogram, outliers past 3 sigma), a
report with a pass / fail tolerance, saved as JSON. The arithmetic is
numpy in f64 on the host, as JAX's; the port's `dequantize` /
`dequantize_stacked` give the weights back.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from .qtypes import QuantizedTensor
from .quantize import dequantize, dequantize_stacked


def _host(x) -> np.ndarray:
    """x as f64 numpy: a torch tensor (any device) or an array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


@dataclass
class ErrorMetrics:
    """Errors of a reconstruction against its original."""

    max_abs_error: float = 0.0
    mean_abs_error: float = 0.0
    mse: float = 0.0
    rmse: float = 0.0
    mean_relative_error: float = 0.0
    num_outliers: int = 0            # |err| > 3 sigma
    histogram: List[int] = field(default_factory=list)

    @classmethod
    def compare(cls, original, reconstructed, bins: int = 32) -> "ErrorMetrics":
        a = _host(original)
        b = _host(reconstructed)
        err = b - a
        abs_err = np.abs(err)
        denom = np.maximum(np.abs(a), 1e-8)
        sigma = err.std() or 1e-12
        hist, _ = np.histogram(abs_err, bins=bins)
        return cls(
            max_abs_error=float(abs_err.max(initial=0.0)),
            mean_abs_error=float(abs_err.mean()) if abs_err.size else 0.0,
            mse=float((err ** 2).mean()) if err.size else 0.0,
            rmse=float(np.sqrt((err ** 2).mean())) if err.size else 0.0,
            mean_relative_error=float((abs_err / denom).mean()) if err.size else 0.0,
            num_outliers=int((abs_err > 3 * sigma).sum()),
            histogram=hist.tolist(),
        )


@dataclass
class ValidationReport:
    """Per-tensor metrics, pass / fail against a tolerance on the largest
    absolute error, and a JSON file."""

    passed: bool = True
    tolerance: float = 0.1
    per_tensor: Dict[str, ErrorMetrics] = field(default_factory=dict)
    summary: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, metrics: ErrorMetrics) -> None:
        self.per_tensor[name] = metrics
        if metrics.max_abs_error > self.tolerance:
            self.passed = False

    def finalize(self) -> "ValidationReport":
        if self.per_tensor:
            self.summary = {
                "worst_max_abs_error": max(
                    m.max_abs_error for m in self.per_tensor.values()),
                "mean_rmse": float(np.mean(
                    [m.rmse for m in self.per_tensor.values()])),
                "tensors": len(self.per_tensor),
            }
        return self

    def save(self, path: str) -> None:
        payload = {
            "passed": self.passed,
            "tolerance": self.tolerance,
            "summary": self.summary,
            "per_tensor": {k: asdict(v) for k, v in self.per_tensor.items()},
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)


def validate_quantized_params(original_params: Any, quantized_params: Any,
                              *, tolerance: float = 0.1) -> ValidationReport:
    """Walk both trees; for every QuantizedTensor in the quantized tree,
    compare dequantize(q) against the original weight."""
    report = ValidationReport(tolerance=tolerance)

    def walk(orig, quant, path):
        if isinstance(quant, QuantizedTensor):
            w = orig["w"] if isinstance(orig, dict) else orig
            back = (dequantize_stacked(quant) if quant.data.dim() == 3
                    else dequantize(quant))
            report.add("/".join(path), ErrorMetrics.compare(w, back))
            return
        if isinstance(quant, dict):
            for key in quant:
                o = orig.get(key) if isinstance(orig, dict) else None
                if key == "w" and isinstance(quant[key], QuantizedTensor):
                    walk(orig, quant[key], path)
                else:
                    walk(o, quant[key], path + (key,))
            return
        if isinstance(quant, list):
            for i, qv in enumerate(quant):
                walk(orig[i] if orig else None, qv, path + (str(i),))

    walk(original_params, quantized_params, ())
    return report.finalize()
