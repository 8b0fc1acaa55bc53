"""Quantized matmul and its decode-loop fusions, ported from
deeppowers_tpu/ops/matmul.py:75-197.

Quantized weights (int8 or int4, per-channel or per-group scales, bf16 or
dynamic int8 activations) go through the dequant-matmul kernel wrapper
(ops/kernels/dequant_matmul.py): the CUDA kernels for CUDA tensors, their
plain versions for CPU tensors, except that weight-only weights on a CPU
tensor take JAX's XLA function (below). There is no silent fallback: on
CUDA a weight or shape the kernels do not take raises. Float weights take
a plain f32-accumulated product.

With act_bits = 8 (W8A8 / W4A8) `rms_matmul` and `glu_matmul` compute what
the JAX package's XLA path computes: the norm rounded to the activation
dtype, or the GLU with its activation op by op in that dtype and the
product with up in f32, then int8 per row over the whole K (ROADMAP.md,
Decisions); residual and bias are added in f32 before the one cast.

Asymmetric weights (zero points) are weight-only whatever their act_bits,
as JAX routes them (:92, :106-116): the kernels take them on the card,
`_xla_matmul` on the CPU, where q - z (int32) is converted to the dtype
of the dequantized weight, as `_dequant_weights` converts it.

Weight-only weights (act_bits = 0) take a route chosen by the device, as
the JAX package's do (its Pallas kernel only on a TPU, `_pallas_eligible`
:199-206, its XLA path elsewhere). A CUDA tensor launches the kernel,
which computes the Pallas kernel's function (the norm's x * g before the
product and its row factor after it, an f32 GLU, bias and residual in an
f32 epilogue). A CPU tensor takes `_xla_matmul`, the XLA path's function
(:28-41, :120-123 and the unfused ops :149-196): the weight dequantized in
the dtype JAX picks, bf16(bf16(q) * bf16(s)) for a bf16 output and f32
otherwise, group by group; the dot with f32 sums, then the cast; the norm
and the GLU as the unfused ops round them, `a * up` rounded to the
activation dtype before the dot (a probe of the jitted JAX functions on
the CPU: the product reaches the dot rounded, unlike the a8 quantizer's
input); bias, then residual, added after the cast, in the output dtype.
That is XLA's function for two rows or more, and for one row of a
rank-3 input. For a single row of rank 2, (1, K), its CPU compiler fuses
the dequantization and the GLU's product into a vector-matrix dot, and
`_xla_matmul` follows what that keeps in f32 (a probe of the jitted
functions, bf16 outputs):
per-channel weights as q * bf16(s) unrounded (grouped ones still round
each product to bf16), the GLU's a * up unrounded, the norm rounded as
before. The f32 order of the dot's sums stays PyTorch's (ROADMAP.md,
Decisions). `cpu_weight_only_function("kernel")` gives
CPU tensors the kernels' function instead (their plain versions), for a
CPU reference that is held against the card's results.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..quant.qtypes import QuantizedTensor, unpack_int4
from .activation import activation
from .kernels.dequant_matmul import _check_weight, dequant_matmul, weight_only
from .normalization import rms_norm

Weight = Union[QuantizedTensor, torch.Tensor]


def _float_matmul(x, w, out_dtype):
    return torch.matmul(x.float(), w.float()).to(out_dtype)


#: what a weight-only product of a CPU tensor computes: "xla" or "kernel"
_cpu_function = "xla"


def cpu_weight_only_function(name: str) -> str:
    """Choose what a weight-only product of a CPU tensor computes, and
    return the former choice. "xla" (the default): the JAX package's XLA
    function, what its CPU engine computes. "kernel": the card kernels'
    function, through their plain versions (`dequant_matmul_plain`), for
    a CPU reference that is held against the card's results (the path
    phases of chip_smoke.py). CUDA tensors take the kernels either way."""
    global _cpu_function
    if name not in ("xla", "kernel"):
        raise ValueError(f"cpu_weight_only_function: {name!r} is neither "
                         f"'xla' nor 'kernel'")
    old, _cpu_function = _cpu_function, name
    return old


def _xla_route(x: torch.Tensor, w: Weight) -> bool:
    """A weight-only QuantizedTensor (act_bits 0, or zero points) on a CPU
    tensor, while the CPU's function is "xla": JAX's XLA function."""
    return (isinstance(w, QuantizedTensor) and weight_only(w)
            and not x.is_cuda and _cpu_function == "xla")


def _one_row(x: torch.Tensor) -> bool:
    """Whether x is a single row of rank 2, (1, K): there XLA's CPU
    compiler fuses the dequantization into a vector-matrix dot and drops
    the bf16 rounding of its products; a (1, 1, K) operand (a decode step
    of one slot) keeps the rounding, as two rows do (a probe of the
    optimized HLO: `multiply_dot_fusion` against `convert_dot_fusion`)."""
    return x.dim() == 2 and x.shape[0] == 1


def _xla_matmul(x, w: QuantizedTensor, out_dtype, cast: bool = True):
    """JAX `quantized_matmul`'s XLA path (:120-123) behind
    `_dequant_weights` (:28-41): the weight dequantized into bf16 for a
    bf16 output (each product rounded), else f32, x cast to that dtype,
    f32 sums, one cast; with zero points q - z in int32, then converted.
    At one row with per-channel scales the fused dot keeps each q * bf16(s)
    (bf16(q - z) * bf16(s)) in f32 instead (grouped weights still round; a
    probe of the jitted JAX function, asymmetric as symmetric).
    `cast=False` dots x as it comes (the one-row GLU's f32 product)."""
    _check_weight(w)
    dt = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
    q = unpack_int4(w.data) if w.bits == 4 else w.data
    k, n = q.shape
    rows = w.scales.numel() // n
    q = q.reshape(rows, k // rows, n)
    if w.zero_points is not None:
        q = q.int() - w.zero_points.int().reshape(rows, 1, n)
    q = q.to(dt)
    one = _one_row(x)
    if one and rows == 1:
        wd = q.reshape(k, n).float() * w.scales.reshape(1, n).to(dt).float()
    else:
        wd = (q * w.scales.reshape(rows, 1, n).to(dt)).reshape(k, n)
    return torch.matmul((x.to(dt) if cast else x).float(),
                        wd.float()).to(out_dtype)


def _add(y, t):
    """y + t in y's dtype, as the unfused ops add after the cast."""
    return y if t is None else y + t.to(y.dtype)


def quantized_matmul(x: torch.Tensor, w: Weight, *,
                     out_dtype=None) -> torch.Tensor:
    """x @ w where w may be quantized. x: (..., K), w: (K, N). f32
    accumulation, output in out_dtype (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    if not isinstance(w, QuantizedTensor):
        return _float_matmul(x, w, out_dtype)
    if _xla_route(x, w):
        return _xla_matmul(x, w, out_dtype)
    return dequant_matmul(x, w, out_dtype=out_dtype)


def rms_matmul(x: torch.Tensor, rms_weight: torch.Tensor, w: Weight, *,
               eps: float = 1e-6, bias: Optional[torch.Tensor] = None,
               out_dtype=None) -> torch.Tensor:
    """rmsnorm(x; rms_weight, eps) @ w (+ bias), the norm folded into the
    kernel for quantized weights."""
    out_dtype = out_dtype or x.dtype
    if _xla_route(x, w):                # JAX :149-154
        return _add(_xla_matmul(rms_norm(x, rms_weight, eps=eps), w,
                                out_dtype), bias)
    if isinstance(w, QuantizedTensor):
        return dequant_matmul(x, w, rms_weight=rms_weight, rms_eps=eps,
                              bias=bias, out_dtype=out_dtype)
    y = _float_matmul(rms_norm(x, rms_weight, eps=eps), w, out_dtype)
    return _add(y, bias)


def glu_matmul(gu: torch.Tensor, w: Weight, *, act: str = "silu",
               residual: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               out_dtype=None) -> torch.Tensor:
    """(act(gate) * up) @ w (+ bias) (+ residual), gu = gate|up on the last
    axis, the GLU elementwise and the adds folded into the kernel."""
    out_dtype = out_dtype or gu.dtype
    if isinstance(w, QuantizedTensor) and not _xla_route(gu, w):
        return dequant_matmul(gu, w, glu=True, act=act, residual=residual,
                              bias=bias, out_dtype=out_dtype)
    gate, up = torch.chunk(gu, 2, dim=-1)
    a = activation(gate, act)     # JAX's unfused ops' rounding (:172)
    if isinstance(w, QuantizedTensor):  # JAX :170-180
        # at one row the fused dot takes a * up unrounded, in f32
        one = _one_row(a)
        y = _xla_matmul(a.float() * up.float() if one else a * up, w,
                        out_dtype, cast=not one)
    else:
        y = _float_matmul(a * up, w, out_dtype)
    return _add(_add(y, bias), residual)


def matmul_residual(x: torch.Tensor, w: Weight, residual: torch.Tensor, *,
                    bias: Optional[torch.Tensor] = None,
                    out_dtype=None) -> torch.Tensor:
    """x @ w (+ bias) + residual, the adds folded into the kernel."""
    out_dtype = out_dtype or x.dtype
    if _xla_route(x, w):                # JAX :190-196
        return _add(_add(_xla_matmul(x, w, out_dtype), bias), residual)
    if isinstance(w, QuantizedTensor):
        return dequant_matmul(x, w, residual=residual, bias=bias,
                              out_dtype=out_dtype)
    return _add(_add(_float_matmul(x, w, out_dtype), bias), residual)
