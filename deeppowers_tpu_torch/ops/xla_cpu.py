"""XLA's CPU arithmetic for f32, as plain functions on CPU tensors.

The JAX package's off-TPU attention (ops/attention.py `attention_verify`)
runs on XLA's CPU backend, whose f32 results differ from PyTorch's in the
last bits: another exp, another order of a row sum, another order of a
dot. The port's CPU function for bf16 verify rows
(ops/kernels/decode_attention.py `_dense_plain` under
`cpu_attention_function("xla")`) composes these to land on JAX's bf16
values. The kernels on the card and their plain versions never use them.

- `xla_exp`: XLA's vectorized expf, Cephes' degree-6 polynomial with a
  fused multiply-add at every step (each emulated as an f64 product and
  sum rounded once to f32), the exponent n = floor(x log2(e) + 1/2) held at
  most 127, and a result below the smallest normal f32 flushed to 0. Bit
  for bit with eager and jitted `jnp.exp` on f32, infinities and NaN
  included.
- `xla_sum`: a row sum as XLA's CPU reduction rewriter orders it: blocks of
  32 each summed in order from 0 (the row padded with zeros, half the pad
  in front, to a multiple of 32), then the block sums the same way, until
  at most 32 are left, summed in order.
- `xla_softmax`: `jax.nn.softmax`'s function, exp(x - max) / sum, from the
  two above, divided (not multiplied by a reciprocal).
- `dot4`: a matrix product as XLA's CPU dot sums it at these shapes, four
  partial sums over k mod 4, added (s0 + s1) + (s2 + s3).
"""

from __future__ import annotations

import torch

#: the smallest normal f32: XLA's exp returns 0 below it
_F32_TINY = float(torch.finfo(torch.float32).tiny)
_EXP_POLY = (1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
             1.6666665459e-1, 5.0000001201e-1)
_REDUCE_WINDOW = 32


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32).double()


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """fl32(a * b + c) with one rounding, of f32 operands (constants as
    `_f32` rounds them): the f64 product of two f32 values is exact."""
    return (a.double() * b + c).float()


def xla_exp(x: torch.Tensor) -> torch.Tensor:
    """exp of an f32 CPU tensor, bit for bit as XLA's CPU backend computes
    it (module docstring)."""
    x = x.float().clamp(-104.0, 89.0)
    n = torch.floor(_fma(x, _f32(1.44269504088896341), 0.5)).clamp(
        max=127.0)
    r = _fma(n, _f32(-0.693359375), x.double())
    r = _fma(n, _f32(2.12194440e-4), r.double())
    p = torch.full_like(r, 1.9875691500e-4)
    for c in _EXP_POLY:
        p = _fma(p, r.double(), _f32(c))
    y = _fma(p, (r * r).double(), r.double()) + 1.0
    out = (y.double() * torch.exp2(n.double())).float()
    return torch.where(out < _F32_TINY, torch.zeros_like(out), out)


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in XLA's CPU order (module docstring)."""
    n = x.shape[-1]
    if n <= _REDUCE_WINDOW:
        return _ordered_sum(x)
    blocks = -(-n // _REDUCE_WINDOW)
    pad = blocks * _REDUCE_WINDOW - n
    xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
    return xla_sum(_ordered_sum(
        xp.reshape(x.shape[:-1] + (blocks, _REDUCE_WINDOW))))


def xla_softmax(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softmax(x, axis=-1)` of an f32 CPU tensor, bit for bit."""
    e = xla_exp(x - x.amax(-1, keepdim=True))
    return e / xla_sum(e)[..., None]


def dot4(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) as four partial sums over k mod 4,
    added (s0 + s1) + (s2 + s3)."""
    s = [torch.matmul(a[..., i::4], b[..., i::4, :]) for i in range(4)]
    return (s[0] + s[1]) + (s[2] + s[3])
