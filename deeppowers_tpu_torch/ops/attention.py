"""Attention ops, ported from deeppowers_tpu/ops/attention.py
(`attention_prefill` :44, `attention_decode`, `attention_decode_auto` :265).

Dispatch tests the tensor's device where the JAX package tested
`jax.default_backend() == "tpu"`: CUDA tensors take the hand-written
kernels, CPU tensors their plain versions. Prefill keeps the JAX threshold:
the flash kernel for S >= 512, the dense path below.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernels.decode_attention import decode_attention
from .kernels.flash_attention import flash_attention_prefill

NEG_INF = -1e30
#: prompt buckets at or above this length take the flash kernel
FLASH_MIN_S = 512


def attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      lengths: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Causal self-attention over a padded prompt. q: (B, S, H, D); k, v:
    (B, S, Kh, D). Returns (B, S, H, D)."""
    b, s, h, d = q.shape
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if q.is_cuda and s >= FLASH_MIN_S:
        return flash_attention_prefill(q, k, v, lengths, scale=scale)
    # the dense masked softmax below the threshold (XLA fused it on the TPU)
    # and on the CPU; GQA-aware: grouped queries against the unrepeated K/V
    kh = k.shape[2]
    rep = h // kh
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, s, kh, rep, d).float() * scale
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg, k.float())
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] <= pos[:, None])[None, None, None]
    valid = pos[None, :] < lengths[:, None].long()
    mask = mask & valid[:, None, None, None, :]
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention over (B, S, Kh, D) caches: q (B, H, D),
    lengths (B,) valid positions including the current token."""
    b, s, kh, d = k_cache.shape
    return decode_attention(q, k_cache.reshape(b, s, kh * d),
                            v_cache.reshape(b, s, kh * d), lengths,
                            scale=scale)


def attention_decode_auto(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, lengths: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Kept to mirror the JAX module, where it picks among the quantized-KV
    decode kernels; with only bf16 caches ported it is `attention_decode`."""
    return attention_decode(q, k_cache, v_cache, lengths, scale=scale)
