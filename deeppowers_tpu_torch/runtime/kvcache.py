"""KV cache: fixed-shape, slot-based, bf16, contiguous per layer.

Ported from deeppowers_tpu/runtime/kvcache.py (`LayerKVCache` :38-190,
`init_cache`, `write_prompt`/`write_prompts`, `append_token` :432,
`slice_window` :506, `read` :565), bf16 layout only. One (B, S, F) buffer
per layer and array, F = kv_heads * head_dim, flat on the feature axis as
the decode kernels want it. Unlike the JAX version, which returns new
(donated) buffers, writes here update the tensors IN PLACE; each function
still returns the cache so call sites read the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..ops.kernels.kv_append import scatter_rows


@dataclass
class LayerKVCache:
    """KV storage for one layer: k, v (B, S, Kh*D) in the store dtype."""

    k: torch.Tensor
    v: torch.Tensor
    head_width: int

    def _view4(self, arr: torch.Tensor) -> torch.Tensor:
        b, s, f = arr.shape
        return arr.reshape(b, s, f // self.head_width, self.head_width)


def init_cache(num_layers: int, batch_slots: int, max_seq: int,
               num_kv_heads: int, head_dim: int, *, dtype=torch.bfloat16,
               kv_cache_dtype: str = "bf16", device=None
               ) -> Tuple[LayerKVCache, ...]:
    """Zero-filled caches for all layers. Zeros, never torch.empty: a NaN
    in a row no slot has written yet must not be able to reach attention
    (0 * NaN = NaN)."""
    if kv_cache_dtype != "bf16":
        raise NotImplementedError(
            f"kv_cache_dtype {kv_cache_dtype!r} is not ported yet (bf16 only)")
    shape = (batch_slots, max_seq, num_kv_heads * head_dim)
    return tuple(
        LayerKVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device),
                     head_width=head_dim)
        for _ in range(num_layers))


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(..., K, D) -> (..., K*D)."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def write_prompts(cache: LayerKVCache, k_new: torch.Tensor,
                  v_new: torch.Tensor, slots: torch.Tensor) -> LayerKVCache:
    """B prompts' K/V (B, S_pad, K, D) into the first S_pad rows of `slots`
    (B,). Out-of-range slots are dropped, as JAX's scatter drops them."""
    s_pad = k_new.shape[1]
    slots = slots.to(device=cache.k.device, dtype=torch.long)
    keep = (slots >= 0) & (slots < cache.k.shape[0])
    if not bool(keep.all()):
        slots, k_new, v_new = slots[keep], k_new[keep], v_new[keep]
    cache.k[slots, :s_pad] = _flat(k_new).to(cache.k.dtype)
    cache.v[slots, :s_pad] = _flat(v_new).to(cache.v.dtype)
    return cache


def write_prompt(cache: LayerKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor, slot: int) -> LayerKVCache:
    """One padded prompt's K/V (S_pad, K, D) into `slot`."""
    slots = torch.tensor([int(slot)], device=cache.k.device)
    return write_prompts(cache, k_new[None], v_new[None], slots)


def append_token(cache: LayerKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor, positions: torch.Tensor) -> LayerKVCache:
    """One token's K/V (B, K, D) per slot at positions (B,), in place
    through the kv_append kernel (its plain version on the CPU)."""
    scatter_rows(cache.k, cache.v, _flat(k_new), _flat(v_new), positions)
    return cache


def slice_window(cache: LayerKVCache, window: int) -> LayerKVCache:
    """View of the first `window` positions (no copy)."""
    return LayerKVCache(k=cache.k[:, :window], v=cache.v[:, :window],
                        head_width=cache.head_width)


def read(cache: LayerKVCache, dtype=torch.bfloat16
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, K, D) K/V in `dtype`."""
    return (cache._view4(cache.k).to(dtype), cache._view4(cache.v).to(dtype))

