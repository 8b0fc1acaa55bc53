"""Stacked KV cache: all layers in one (L, B, S, F') buffer per array, the
layout of scan-over-layers (RuntimeConfig.scan_layers).

Ported from deeppowers_tpu/runtime/kvcache_stacked.py (`StackedKVCache`
:38-93, `init_cache` :98, `write_prompt_layer` / `write_prompts_layer`
:142/151, `write_chunk_layer` :178, `append_token_layer` /
`append_tokens_layer` :247/253, `read_layer` / `read_raw_layer` /
`read_slot_layer` :269-316, `copy_prefix` :317, `nbytes` :334). The JAX
package stacks the layers so that `lax.scan` compiles the layer body once;
the port keeps its layout and its kernel so that a scan engine runs the
same bytes through the same operations as JAX's.

Stores, with JAX's layout for each (the quantizers are
quant/kvquant.py):
  bf16  k, v (L, B, S, Kh*D) in the activation dtype; no scales
  int8  k, v (L, B, S, Kh*D) int8; k_scale, v_scale (L, B, Kh, S) f32
  int4  k, v (L, B, S, Kh*D/2) packed; scales (L, B, 2*Kh, S)
  k8v4  int8 K with (L, B, Kh, S) scales, packed int4 V with (L, B, 2*Kh,
        S)
Every row write (prompts, chunks, decode tokens, verify windows) goes
through kernel #8, `scatter_rows_stacked` (ops/kernels/kv_append.py),
which quantizes a quantized store's rows inside its launch and reads the
layer index from device memory (`layer_ids`), as the TPU kernel prefetches
the traced layer. Reads hand layer i's (B, S, F') views, which copy
nothing, to the decode kernel (JAX's `layer=` index map). Writes update
the tensors IN PLACE; each function still returns the cache.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..ops.kernels.kv_append import scatter_rows_stacked
from ..quant.kvquant import dequant_side, flat_heads, new_store


@dataclass
class StackedKVCache:
    """KV storage for all layers: k, v (L, B, S, F') and, when quantized,
    k_scale, v_scale (L, B, R, S) f32; head_width, bits and v_bits as
    runtime/kvcache.py's LayerKVCache keeps them; layer_ids (L,) int32 on
    the cache's device, layer i's index as kernel #8 reads it."""

    k: torch.Tensor
    v: torch.Tensor
    head_width: int
    layer_ids: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    bits: int = 8
    v_bits: int = 0

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def vbits(self) -> int:
        return self.v_bits or self.bits

    @property
    def head_dim(self) -> int:
        return self.head_width * 2 if self.bits == 4 else self.head_width

    @property
    def v_width(self) -> int:
        return self.head_dim // 2 if self.vbits == 4 else self.head_dim

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]

    def _view4(self, arr: torch.Tensor, width: Optional[int] = None
               ) -> torch.Tensor:
        w = width or self.head_width
        return arr.reshape(*arr.shape[:-1], arr.shape[-1] // w, w)


@dataclass(frozen=True)
class StackedLayer:
    """Layer `index` of a stacked cache, standing where a forward takes
    one layer's cache: runtime/kvcache.py's per-layer functions hand it to
    this module's `*_layer` functions."""

    cache: StackedKVCache
    index: int


def layers(cache: StackedKVCache) -> Tuple[StackedLayer, ...]:
    return tuple(StackedLayer(cache, i) for i in range(cache.num_layers))


def init_cache(num_layers: int, batch_slots: int, max_seq: int,
               num_kv_heads: int, head_dim: int, *, dtype=torch.bfloat16,
               kv_cache_dtype: str = "bf16", device=None) -> StackedKVCache:
    """Zero-filled stacked stores (and scales) for all layers."""
    st = new_store(kv_cache_dtype, num_layers * batch_slots, max_seq,
                   num_kv_heads, head_dim, dtype=dtype, device=device)
    for name in ("k", "v", "k_scale", "v_scale"):
        if st[name] is not None:
            st[name] = st[name].view(num_layers, batch_slots,
                                     *st[name].shape[1:])
    return StackedKVCache(
        layer_ids=torch.arange(num_layers, dtype=torch.int32, device=device),
        **st)


def store_args(cache: StackedKVCache, layer: int) -> dict:
    """The keyword arguments that hand layer `layer`'s scale views and the
    store's bits to a kernel wrapper."""
    if not cache.quantized:
        return {}
    return dict(k_scale=cache.k_scale[layer], v_scale=cache.v_scale[layer],
                kv_bits=cache.bits, v_bits=cache.v_bits)


def stack_args(cache: StackedKVCache) -> dict:
    """The keyword arguments that hand the whole stack's scales and the
    store's bits to kernel #8."""
    if not cache.quantized:
        return {}
    return dict(k_scale=cache.k_scale, v_scale=cache.v_scale,
                kv_bits=cache.bits, v_bits=cache.v_bits)


def _scatter(cache: StackedKVCache, layer: int, k_rows, v_rows, positions,
             slots=None) -> StackedKVCache:
    """(N, Kh*D) rows into [layer, slots, positions] through #8; positions
    or slots out of range drop."""
    scatter_rows_stacked(cache.k, cache.v, k_rows, v_rows,
                         cache.layer_ids[layer:layer + 1], positions,
                         slots=slots, **stack_args(cache))
    return cache


def write_prompts_layer(cache: StackedKVCache, layer: int,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        slots: torch.Tensor) -> StackedKVCache:
    """B prompts' K/V (B, S_pad, K, D) into the first S_pad rows of `slots`
    (B,) at layer `layer`, in one launch; out-of-range slots drop (JAX
    :151)."""
    b, s_pad = k_new.shape[:2]
    dev = cache.k.device
    slots = slots.to(device=dev, dtype=torch.int32)
    pos = torch.arange(s_pad, device=dev, dtype=torch.int32).repeat(b)
    return _scatter(cache, layer, flat_heads(k_new).reshape(b * s_pad, -1),
                    flat_heads(v_new).reshape(b * s_pad, -1), pos,
                    slots.repeat_interleave(s_pad))


def write_prompt_layer(cache: StackedKVCache, layer: int, k_new: torch.Tensor,
                       v_new: torch.Tensor, slot: int) -> StackedKVCache:
    """One padded prompt's K/V (S_pad, K, D) into `slot` (JAX :142)."""
    return write_prompts_layer(cache, layer, k_new[None], v_new[None],
                               torch.tensor([int(slot)]))


def write_chunk_layer(cache: StackedKVCache, layer: int, k_new: torch.Tensor,
                      v_new: torch.Tensor, slot: int, start: int
                      ) -> StackedKVCache:
    """A prefill chunk's K/V (C, K, D) at [layer, slot, start:start+C];
    positions past the cache drop (JAX :178)."""
    c = k_new.shape[0]
    dev = cache.k.device
    pos = torch.arange(start, start + c, device=dev, dtype=torch.int32)
    return _scatter(cache, layer, flat_heads(k_new), flat_heads(v_new), pos,
                    torch.full((c,), int(slot), device=dev,
                               dtype=torch.int32))


def append_token_layer(cache: StackedKVCache, layer: int,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       positions: torch.Tensor) -> StackedKVCache:
    """One token's K/V (B, K, D) per slot at [layer, b, positions[b]]; a
    position outside the cache writes nothing (JAX :247)."""
    return _scatter(cache, layer, flat_heads(k_new), flat_heads(v_new),
                    positions)


def append_tokens_layer(cache: StackedKVCache, layer: int,
                        k_new: torch.Tensor, v_new: torch.Tensor,
                        positions: torch.Tensor) -> StackedKVCache:
    """A verify window's K/V (B, T, K, D) at [layer, b, positions[b, t]]
    (B, T), all B*T rows in one launch; positions outside the cache drop
    (JAX :253)."""
    b, t = positions.shape
    slots = torch.arange(b, device=positions.device,
                         dtype=torch.int32).repeat_interleave(t)
    return _scatter(cache, layer, flat_heads(k_new).reshape(b * t, -1),
                    flat_heads(v_new).reshape(b * t, -1),
                    positions.reshape(-1), slots)


def _dequant(cache: StackedKVCache, k, v, ks, vs, dtype):
    if not cache.quantized:
        return cache._view4(k).to(dtype), cache._view4(v).to(dtype)
    return (dequant_side(cache._view4(k), ks, cache.bits, dtype),
            dequant_side(cache._view4(v, cache.v_width), vs, cache.vbits,
                         dtype))


def read_raw_layer(cache: StackedKVCache, layer: int,
                   window: Optional[int] = None):
    """Layer `layer`'s raw (k, v, k_scale, v_scale): k, v as (B, W, K, w)
    views of the stores, scales (B, R, W) head-major; no copy (JAX
    :285)."""
    w = window or cache.max_seq
    ks = vs = None
    if cache.quantized:
        ks, vs = cache.k_scale[layer, :, :, :w], cache.v_scale[layer, :, :, :w]
    return (cache._view4(cache.k[layer, :, :w]),
            cache._view4(cache.v[layer, :, :w], cache.v_width), ks, vs)


def read_layer(cache: StackedKVCache, layer: int, dtype=torch.bfloat16,
               window: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Layer `layer`'s (B, W, K, D) K/V in `dtype`, dequantized (JAX
    :269)."""
    w = window or cache.max_seq
    ks = vs = None
    if cache.quantized:
        ks, vs = cache.k_scale[layer, :, :, :w], cache.v_scale[layer, :, :, :w]
    return _dequant(cache, cache.k[layer, :, :w], cache.v[layer, :, :w], ks,
                    vs, dtype)


def read_slot_layer(cache: StackedKVCache, layer: int, slot: int,
                    dtype=torch.bfloat16, window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slot's (1, W, K, D) K/V of one layer in `dtype` (chunked-prefill
    attention reads only the prefilling request's row; JAX :297)."""
    s = int(slot)
    w = window or cache.max_seq
    ks = vs = None
    if cache.quantized:
        ks = cache.k_scale[layer, s:s + 1, :, :w]
        vs = cache.v_scale[layer, s:s + 1, :, :w]
    return _dequant(cache, cache.k[layer, s:s + 1, :w],
                    cache.v[layer, s:s + 1, :w], ks, vs, dtype)


def copy_prefix(cache: StackedKVCache, src: int, dst: int, n: int
                ) -> StackedKVCache:
    """Rows [0, n) of slot `src` into slot `dst` across all layers, in
    place, with their scale columns (prefix-cache reuse; JAX :317)."""
    src, dst = int(src), int(dst)
    cache.k[:, dst, :n] = cache.k[:, src, :n]
    cache.v[:, dst, :n] = cache.v[:, src, :n]
    if cache.quantized:
        cache.k_scale[:, dst, :, :n] = cache.k_scale[:, src, :, :n]
        cache.v_scale[:, dst, :, :n] = cache.v_scale[:, src, :, :n]
    return cache


def nbytes(cache: StackedKVCache) -> int:
    """Device bytes of the stores and scales (JAX :334)."""
    return sum(a.numel() * a.element_size()
               for a in (cache.k, cache.v, cache.k_scale, cache.v_scale)
               if a is not None)
