"""SiLU and tanh-GELU with the JAX package's rounding.

`jax.nn.silu` is x * sigmoid(x), sigmoid lowering to 1 / (1 + exp(-x)), and
`jax.nn.gelu(approximate=True)` is x * (0.5 * (1 + tanh(sqrt(2 / pi) * (x +
0.044715 * x**3)))); XLA runs both op by op in the input's dtype, rounding
after every op. For inputs narrower than f32 `activation` runs the same ops
in the same order in the input's dtype (the constants rounded to it, the
cube as x * x * x): on bf16 that is bit for bit the jitted JAX functions,
where F.silu / F.gelu, computed in f32 and rounded once, differ on about
40% of the values. f32 inputs take F.silu / F.gelu as before.

Which rounding a call site gets follows the JAX computation it mirrors:
- sites that mirror XLA's unfused ops pass the activation-dtype tensor and
  get the per-op rounding: models/transformer.py `_act` (JAX
  transformer.py:394-396), ops/matmul.py `glu_matmul`'s float path (JAX
  ops/matmul.py:172) and the a8 input of ops/kernels/dequant_matmul.py
  (`_unfused_input`);
- sites that mirror the Pallas kernel's GLU fold, which casts the gate to
  f32 and rounds once after the product with up
  (deeppowers_tpu/ops/pallas/dequant_matmul.py:184-189), pass f32 and get
  the f32 function: the weight-only plain versions of ops/kernels/
  dequant_matmul.py and, on the card, 1p's prologue and the GEMV and
  tensor-core GLU folds (csrc/dequant_common.cuh `act_fn`). 1q's GLU mode
  follows the a8 path (`act_ops` there).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

#: sqrt(2 / pi) and the cube's coefficient of the tanh approximation
GELU_C = math.sqrt(2.0 / math.pi)
GELU_A = 0.044715


def activation(x: torch.Tensor, act: str) -> torch.Tensor:
    """silu(x) for act "silu", tanh-GELU for "gelu", rounded as above."""
    if x.dtype in (torch.float32, torch.float64):
        return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")
    if act == "silu":
        return x * (1 / (1 + torch.exp(-x)))
    c, a = _rounded(x.dtype)
    return x * (0.5 * (1 + torch.tanh(c * (x + a * (x * x * x)))))


@functools.lru_cache(maxsize=None)
def _rounded(dtype: torch.dtype):
    """GELU's constants rounded to `dtype`, as Python floats (a scalar
    operand keeps the op in x's dtype and copies nothing to the device)."""
    return tuple(float(torch.tensor(v, dtype=dtype)) for v in (GELU_C,
                                                               GELU_A))
