"""Fused int8 dequant matmul: wrapper, plain version and launch count.

Replaces the Pallas TPU kernel deeppowers_tpu/ops/pallas/dequant_matmul.py
(`dequant_matmul` :554 and `dequant_matmul_fused` :582, both through
`_dispatch` :351 to the pallas_call at :528, body `_make_kernel` :152);
this one wrapper covers both entry points. CUDA source:
csrc/dequant_matmul.cu.

Computes y = a @ (W_int8 * s) [* rsqrt(mean(x^2) + eps)] [+ bias]
[+ residual] with f32 accumulation and one final cast, where a is x, or
bf16(x * g) with RMSNorm folded in (`rms_weight`), or bf16(act(gate) * up)
for a GLU input x = gate | up. Symmetric int8 per-channel weights only.

Bound on an H100: at decode the int8 weight bytes over 3.35 TB/s; at
prefill the 2*M*K*N operations. The CUDA design (split-K GEMV for M <= 16,
a tensor-core (WMMA) tiled GEMM above) is described in the source.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ...quant.qtypes import QuantizedTensor
from . import _build

#: rows at or below which the split-K GEMV runs (decode)
GEMV_MAX_M = 16
#: most K rows a GEMV block stages in shared memory
_KCHUNK_MAX = 512
#: blocks the GEMV grid aims for (two per SM of an H100)
_TARGET_BLOCKS = 264


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def dequant_matmul_plain(x, data, scales, *, rms_weight=None, rms_eps=1e-6,
                         glu=False, act="silu", residual=None, bias=None,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch. The activation block is
    rounded to x's dtype before the product, as both kernels round it to
    bf16; for f32 inputs everything stays f32."""
    k = data.shape[0]
    xf = x.float()
    if glu:
        a = _act(xf[..., :k], act) * xf[..., k:]
    elif rms_weight is not None:
        a = xf * rms_weight.float()
    else:
        a = xf
    a = a.to(x.dtype).float()
    y = (a @ data.float()) * scales.float().reshape(-1)
    if rms_weight is not None:
        y = y * torch.rsqrt((xf * xf).sum(-1, keepdim=True) / k + rms_eps)
    if bias is not None:
        y = y + bias.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def _check_weight(qw: QuantizedTensor) -> None:
    if not isinstance(qw, QuantizedTensor):
        raise TypeError("dequant_matmul needs a QuantizedTensor weight")
    if (qw.bits != 8 or qw.zero_points is not None or qw.group_size
            or qw.act_bits or qw.data.dim() != 2):
        raise NotImplementedError(
            f"dequant_matmul takes symmetric per-channel int8 weights only, "
            f"got {qw!r}")


def dequant_matmul(x: torch.Tensor, qw: QuantizedTensor, *,
                   rms_weight: Optional[torch.Tensor] = None,
                   rms_eps: float = 1e-6, glu: bool = False,
                   act: str = "silu", residual: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """x @ dequant(qw) with RMSNorm (rms_weight), GLU (glu: x = gate|up,
    (..., 2K)), bias and residual folded in. x: (..., K); returns (..., N).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises for what the kernel does not take."""
    if rms_weight is not None and glu:
        raise ValueError("rms and glu fusion are mutually exclusive")
    _check_weight(qw)
    if not x.is_cuda:
        return dequant_matmul_plain(
            x, qw.data, qw.scales, rms_weight=rms_weight, rms_eps=rms_eps,
            glu=glu, act=act, residual=residual, bias=bias,
            out_dtype=out_dtype)
    k, n = qw.data.shape
    kx = 2 * k if glu else k
    if x.shape[-1] != kx:
        raise ValueError(f"x width {x.shape[-1]} != expected {kx}")
    if x.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"CUDA dequant_matmul takes bf16 x, got {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"unsupported out_dtype {out_dtype}")
    if n % 8:
        raise NotImplementedError(f"N={n} must be a multiple of 8")
    if act not in ("silu", "gelu"):
        raise ValueError(f"unknown activation {act!r}")
    data = qw.data
    if not data.is_contiguous() or data.data_ptr() % 16:
        raise ValueError("weight data must be contiguous and 16-byte aligned")
    scales = qw.scales.reshape(-1)
    if scales.dtype != torch.float32 or scales.numel() != n:
        raise ValueError("scales must be (1, N) f32")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kx)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    m = x2.shape[0]
    g = None
    if rms_weight is not None:
        g = rms_weight.to(torch.bfloat16).contiguous()
        if g.numel() != k:
            raise ValueError(f"rms_weight has {g.numel()} values, K={k}")
    bias_f = None if bias is None else bias.float().contiguous()
    res2 = None
    if residual is not None:
        res2 = residual.reshape(-1, n)
        if res2.dtype != torch.bfloat16 or res2.shape[0] != m:
            raise ValueError("residual must be bf16 (..., N) like the output")
        if res2.stride(-1) != 1:
            res2 = res2.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    ws, kchunk = None, 0
    if m <= GEMV_MAX_M:
        bn = 128 if m > 8 else 256
        nb = -(-n // bn)
        ksplit = max(-(-k // _KCHUNK_MAX),
                     min(-(-_TARGET_BLOCKS // nb), max(1, k // 64)))
        kchunk = -(-k // ksplit)
        ksplit = -(-k // kchunk)
        ws = torch.empty((ksplit, m, n), dtype=torch.float32, device=x.device)
    for t, name in ((data, "weight"), (scales, "scales")):
        _build.require_cuda(t, name)
    lib = _build.library()

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.dpt_dequant_matmul(
        x2.data_ptr(), x2.stride(0), data.data_ptr(), scales.data_ptr(),
        ptr(g), ptr(bias_f), ptr(res2), 0 if res2 is None else res2.stride(0),
        out.data_ptr(), int(out_dtype == torch.float32), ptr(ws), m, k, n,
        kchunk, int(glu), int(act == "gelu"), float(rms_eps), _build.stream())
    _build.check(rc, "dequant_matmul")
    dequant_matmul.launches += 1
    return out.reshape(*lead, n)


dequant_matmul.launches = 0
