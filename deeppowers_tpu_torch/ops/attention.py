"""Attention ops, ported from deeppowers_tpu/ops/attention.py
(`attention_prefill` :44, `attention_chunk` :93, `attention_verify` :126,
`attention_verify_quantized` :161, `attention_decode_quantized` :192,
`attention_decode`, `attention_decode_auto` :265).

Dispatch tests the tensor's device where the JAX package tested
`jax.default_backend() == "tpu"`: CUDA tensors take the hand-written
kernels, CPU tensors their plain versions. Prefill keeps the JAX threshold:
the flash kernel for S >= 512, the dense path below; chunks of a long
prompt take the flash kernel with a start offset on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

# attention_decode_quantized (JAX :192-228) is the int8 store's plain
# version of kernel #3 and lives beside it; it is importable from here as
# from the JAX module
from .kernels.decode_attention import (  # noqa: F401
    attention_decode_quantized, decode_attention, verify_attention)
from .kernels.flash_attention import (flash_attention_chunk,
                                      flash_attention_prefill)

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
    return attention_dense(q, k, v, lengths=lengths, scale=scale)


def attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    lengths: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """`attention_prefill`'s dense masked softmax on any device (JAX's
    `use_flash=False`, which its calibration forwards pass), f32 inside:
    below the flash threshold and on the CPU the prefill itself; GQA-aware,
    grouped queries against the unrepeated K/V."""
    b, s, h, d = q.shape
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
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


def attention_chunk(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, start: int, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill attention: the chunk's queries q (B, C, H, D) at
    positions start..start+C over a cache view (B, S, Kh, D) that holds
    this chunk's keys, with the causal frontier at start + i. Returns
    (B, C, H, D). The JAX package computes it with XLA; here a CUDA tensor
    takes kernel #4 with a start offset (`flash_attention_chunk`), a CPU
    tensor its plain version. Callers pass the view cut at start + C, the
    last key any query sees."""
    return flash_attention_chunk(q, k_cache, v_cache, start, scale=scale)


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
                          v_cache: torch.Tensor, lengths: torch.Tensor,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None, *,
                          kv_bits: int = 8, v_bits: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over (B, S, Kh, w) caches in any store: bf16, or
    int8 / packed int4 (w = D or D/2) with (B, R, S) head-major scales and
    JAX's `kv_bits` / `v_bits`. One kernel (#3) takes every variant on a
    CUDA tensor, its plain version on the CPU (JAX's own CPU numerics per
    variant, ops/kernels/decode_attention.py)."""
    b, s = k_cache.shape[:2]
    return decode_attention(q, k_cache.reshape(b, s, -1),
                            v_cache.reshape(b, s, -1), lengths,
                            k_scale=k_scale, v_scale=v_scale,
                            kv_bits=kv_bits, v_bits=v_bits, scale=scale)


def attention_verify(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Multi-token decode attention for speculative verification: q
    (B, T, H, D) window queries over (B, S, Kh, D) caches that hold the
    window's keys, lengths (B,) tokens cached before the window. Query t of
    slot b sees key j iff j <= lengths[b] + t. Returns (B, T, H, D).
    Kernel #3's verify variant on a CUDA tensor, its plain version (JAX's
    f32 numerics) on the CPU."""
    b, s, kh, d = k_cache.shape
    return verify_attention(q, k_cache.reshape(b, s, kh * d),
                            v_cache.reshape(b, s, kh * d), lengths,
                            scale=scale)


def attention_verify_quantized(q: torch.Tensor, k_q: torch.Tensor,
                               v_q: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor, lengths: torch.Tensor,
                               *, scale: Optional[float] = None
                               ) -> torch.Tensor:
    """attention_verify over an int8 cache (B, S, Kh, D) with (B, Kh, S)
    f32 scales folded in, JAX's numerics (bf16 q * scale and probabilities
    times the V scales, f32 sums) on the CPU."""
    b, s, kh, d = k_q.shape
    return verify_attention(q, k_q.reshape(b, s, kh * d),
                            v_q.reshape(b, s, kh * d), lengths,
                            k_scale=k_scale, v_scale=v_scale, scale=scale)
