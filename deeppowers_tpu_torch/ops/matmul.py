"""Quantized matmul and its decode-loop fusions, ported from
deeppowers_tpu/ops/matmul.py:75-197.

Quantized (int8 per-channel) weights go through the dequant-matmul kernel
wrapper (ops/kernels/dequant_matmul.py): the CUDA kernel for CUDA tensors,
its plain version for CPU tensors. There is no silent fallback: on CUDA a
weight or shape the kernel does not take raises. Float weights take a
plain f32-accumulated product.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from ..quant.qtypes import QuantizedTensor
from .kernels.dequant_matmul import dequant_matmul
from .normalization import rms_norm

Weight = Union[QuantizedTensor, torch.Tensor]


def _float_matmul(x, w, out_dtype):
    return torch.matmul(x.float(), w.float()).to(out_dtype)


def quantized_matmul(x: torch.Tensor, w: Weight, *,
                     out_dtype=None) -> torch.Tensor:
    """x @ w where w may be quantized. x: (..., K), w: (K, N). f32
    accumulation, output in out_dtype (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    if not isinstance(w, QuantizedTensor):
        return _float_matmul(x, w, out_dtype)
    return dequant_matmul(x, w, out_dtype=out_dtype)


def rms_matmul(x: torch.Tensor, rms_weight: torch.Tensor, w: Weight, *,
               eps: float = 1e-6, bias: Optional[torch.Tensor] = None,
               out_dtype=None) -> torch.Tensor:
    """rmsnorm(x; rms_weight, eps) @ w (+ bias), the norm folded into the
    kernel for quantized weights."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QuantizedTensor):
            return dequant_matmul(x, w, rms_weight=rms_weight, rms_eps=eps,
                              bias=bias, out_dtype=out_dtype)
    y = _float_matmul(rms_norm(x, rms_weight, eps=eps), w, out_dtype)
    return y if bias is None else y + bias.to(y.dtype)


def glu_matmul(gu: torch.Tensor, w: Weight, *, act: str = "silu",
               residual: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               out_dtype=None) -> torch.Tensor:
    """(act(gate) * up) @ w (+ bias) (+ residual), gu = gate|up on the last
    axis, the GLU elementwise and the adds folded into the kernel."""
    out_dtype = out_dtype or gu.dtype
    if isinstance(w, QuantizedTensor):
            return dequant_matmul(gu, w, glu=True, act=act, residual=residual,
                              bias=bias, out_dtype=out_dtype)
    gate, up = torch.chunk(gu, 2, dim=-1)
    a = F.silu(gate) if act == "silu" else F.gelu(gate, approximate="tanh")
    y = _float_matmul(a * up, w, out_dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y


def matmul_residual(x: torch.Tensor, w: Weight, residual: torch.Tensor, *,
                    bias: Optional[torch.Tensor] = None,
                    out_dtype=None) -> torch.Tensor:
    """x @ w (+ bias) + residual, the adds folded into the kernel."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QuantizedTensor):
            return dequant_matmul(x, w, residual=residual, bias=bias,
                              out_dtype=out_dtype)
    y = _float_matmul(x, w, out_dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y + residual.to(y.dtype)
