"""LayerNorm / RMSNorm, ported from deeppowers_tpu/ops/normalization.py.

Reductions run in f32 whatever the activation dtype; the result is cast
back to x's dtype."""

from __future__ import annotations

import torch


def layer_norm(x, weight, bias=None, *, eps: float = 1e-5):
    """GPT-2 style LayerNorm over the last axis. x: (..., H)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def rms_norm(x, weight, *, eps: float = 1e-6):
    """Llama-style RMSNorm over the last axis."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)
