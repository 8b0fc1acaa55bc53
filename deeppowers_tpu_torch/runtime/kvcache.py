"""KV cache: fixed-shape, slot-based, bf16, contiguous per layer, and the
layout dispatch over it and the paged layout (runtime/kvcache_paged.py).

Ported from deeppowers_tpu/runtime/kvcache.py (`LayerKVCache` :38-190,
`init_cache`, `_is_paged` :263, `write_prompt`/`write_prompts`,
`write_chunk` :377, `append_token` :432, `slice_window` :506,
`copy_prefix` :529, `read` :565), bf16 layout only. Chunked prefill reads
one slot through `slot_view`, which stands for JAX's
`read(slice_window(slice_slot(...)))`.
One (B, S, F) buffer per layer and array, F = kv_heads * head_dim, flat on
the feature axis as the decode kernels want it. Unlike the JAX version,
which returns new (donated) buffers, writes here update the tensors IN
PLACE; each function still returns the cache so call sites read the same.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..ops.kernels.kv_append import scatter_rows
from . import kvcache_paged


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


def _is_paged(cache) -> bool:
    return isinstance(cache, kvcache_paged.PagedLayerKVCache)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(..., K, D) -> (..., K*D)."""
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def write_prompts(cache: LayerKVCache, k_new: torch.Tensor,
                  v_new: torch.Tensor, slots: torch.Tensor) -> LayerKVCache:
    """B prompts' K/V (B, S_pad, K, D) into the first S_pad rows of `slots`
    (B,). Out-of-range slots are dropped, as JAX's scatter drops them.
    Contiguous caches only (batched admission runs on that layout only)."""
    if _is_paged(cache):
        raise NotImplementedError("write_prompts: contiguous caches only")
    s_pad = k_new.shape[1]
    slots = slots.to(device=cache.k.device, dtype=torch.long)
    keep = (slots >= 0) & (slots < cache.k.shape[0])
    if not bool(keep.all()):
        slots, k_new, v_new = slots[keep], k_new[keep], v_new[keep]
    cache.k[slots, :s_pad] = _flat(k_new).to(cache.k.dtype)
    cache.v[slots, :s_pad] = _flat(v_new).to(cache.v.dtype)
    return cache


def write_prompt(cache, k_new: torch.Tensor, v_new: torch.Tensor,
                 slot: int):
    """One padded prompt's K/V (S_pad, K, D) into `slot`."""
    if _is_paged(cache):
        return kvcache_paged.write_prompt(cache, k_new, v_new, slot)
    slots = torch.tensor([int(slot)], device=cache.k.device)
    return write_prompts(cache, k_new[None], v_new[None], slots)


def write_chunk(cache, k_new: torch.Tensor, v_new: torch.Tensor, slot: int,
                start: int):
    """A prefill chunk's K/V (C, K, D) at positions start..start+C of
    `slot` (chunked prefill). Positions past the cache are dropped; paged
    caches need a page-aligned start (the engine's chunk size is a page
    multiple)."""
    if _is_paged(cache):
        return kvcache_paged.write_chunk(cache, k_new, v_new, slot, start)
    end = min(start + k_new.shape[0], cache.k.shape[1])
    if end > start:
        cache.k[int(slot), start:end] = _flat(k_new[:end - start]).to(
            cache.k.dtype)
        cache.v[int(slot), start:end] = _flat(v_new[:end - start]).to(
            cache.v.dtype)
    return cache


def decode_rows(cache, positions: torch.Tensor):
    """What `append_token` can share across the layers of one decode step:
    a paged cache's pool rows for `positions` (one table serves every
    layer), None for the contiguous layout."""
    if _is_paged(cache):
        return kvcache_paged.row_ids(cache, positions)
    return None


def append_token(cache, k_new: torch.Tensor, v_new: torch.Tensor,
                 positions: torch.Tensor, rows=None):
    """One token's K/V (B, K, D) per slot at positions (B,), in place
    through the kv_append kernels (their plain versions on the CPU). A
    position outside the cache writes nothing. `rows` is
    `decode_rows(cache, positions)`, or None to compute it here."""
    if _is_paged(cache):
        return kvcache_paged.append_token(cache, k_new, v_new, positions, rows)
    scatter_rows(cache.k, cache.v, _flat(k_new), _flat(v_new), positions)
    return cache


def slice_window(cache: LayerKVCache, window: int) -> LayerKVCache:
    """View of the first `window` positions (no copy)."""
    return LayerKVCache(k=cache.k[:, :window], v=cache.v[:, :window],
                        head_width=cache.head_width)


def copy_prefix(cache: LayerKVCache, src: int, dst: int, n: int
                ) -> LayerKVCache:
    """Rows [0, n) of slot `src` into slot `dst`, in place: prefix-cache
    reuse on the contiguous layout (the paged layout maps pages instead).
    Exact: causal K/V rows depend only on the tokens [0, n)."""
    cache.k[int(dst), :n] = cache.k[int(src), :n]
    cache.v[int(dst), :n] = cache.v[int(src), :n]
    return cache


def slot_view(cache, slot: int, window: int, dtype=torch.bfloat16
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slot's first `window` positions as (1, W, K, D) K/V in `dtype`
    (chunked-prefill attention); a paged cache gathers the slot's pages."""
    if _is_paged(cache):
        return kvcache_paged.slot_view(cache, slot, dtype, window)
    s = int(slot)
    return (cache._view4(cache.k[s:s + 1, :window]).to(dtype),
            cache._view4(cache.v[s:s + 1, :window]).to(dtype))


def read(cache, dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, K, D) K/V in `dtype`; a paged cache gathers its pages."""
    if _is_paged(cache):
        return kvcache_paged.read(cache, dtype)
    return (cache._view4(cache.k).to(dtype), cache._view4(cache.v).to(dtype))
