"""KV cache: fixed-shape, slot-based, contiguous per layer, bf16 or
quantized, and the layout dispatch over it and the paged layout
(runtime/kvcache_paged.py).

Ported from deeppowers_tpu/runtime/kvcache.py (`LayerKVCache` :38-113,
`init_cache` :116-190, `_is_paged` :263, `kt_auto` :268,
`write_prompt`/`write_prompts` :344, `write_chunk` :377, `append_token`
:432, `append_tokens` :445, `slice_window` :506, `copy_prefix` :529, `read` :565, `nbytes`
:603). Chunked prefill reads one slot through `slot_view`, which stands
for JAX's `read(slice_window(slice_slot(...)))`.

One (B, S, F') buffer per layer and array, flat on the feature axis as the
decode kernels want it. `kv_cache_dtype` picks the store, with JAX's
layout exactly (the quantizers are quant/kvquant.py):
  bf16  k, v (B, S, Kh*D) in the activation dtype; no scales
  int8  k, v (B, S, Kh*D) int8; k_scale, v_scale (B, Kh, S) f32
  int4  k, v (B, S, Kh*D/2) packed int4; scales (B, 2*Kh, S), two
        sub-block scales per head (rows 2*head + half)
  k8v4  int8 K with (B, Kh, S) scales, packed int4 V with (B, 2*Kh, S)
Scales are head-major, the orientation the decode kernel reads.

An int8-K store (int8, k8v4) may also carry the chunk-transposed K mirror
`kt` (B, S/128, Kh*D, 128) int8 (JAX `LayerKVCache.kt`, `init_cache(kv_kt=)`
:116-190): chunk c holds positions [c*128, (c+1)*128) feature-major, the
layout kernel #7 (`decode_attention_kt`) reads. The row-major k stays the
source of truth. The prompt and chunk writers derive the chunks they touch
from the updated k (`_kt_write_prompts` :296, `_kt_refresh_chunks` :311);
appends leave kt alone, and the decode kernel flushes every chunk its tail
completes. A chunk is read from kt only once every row of it is cached
(the mirror's invariant, JAX decode_attention.py:824-830), so chunks left
stale by a rejected speculative window or a prefix copy heal before they
are read. `kt_auto` is JAX's policy (:268-293): off on any backend but the
TPU unless `DPT_KV_KT=1`.

A decode or verify step writes its rows and attends in one call,
`append_attend`, which hands the step's rows to the attention launch
(ops/kernels/decode_attention.py `NewRows`): the kernel writes them before
it reads the cache, so the row writers #2 / #6 / #8 do not launch in a
decode or verify step. The cache with the kt mirror keeps #2 before #7.
`append_token` / `append_tokens` stay for other callers.

Unlike the JAX version, which returns new (donated) buffers, writes here
update the tensors IN PLACE; each function still returns the cache so call
sites read the same.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..ops.kernels.decode_attention import (KT_CHUNK, NewRows,
                                            decode_attention,
                                            decode_attention_kt,
                                            decode_attention_paged,
                                            fold_tokens, int8_dots_default,
                                            unfold_tokens)
from ..ops.kernels.kv_append import scatter_rows
from ..quant.kvquant import (dequant_side, flat_heads, new_store, store_args,
                             store_variant)
from . import kvcache_paged, kvcache_stacked


@dataclass
class LayerKVCache:
    """KV storage for one layer: k, v (B, S, F') stores and, when
    quantized, k_scale, v_scale (B, R, S) f32. head_width is the STORED
    per-head K width (D, or D/2 for packed int4); bits the K store bits
    (8, or 4 packed; a bf16 cache keeps 8 and no scales, as in JAX);
    v_bits the V store bits when they differ from K (0 = same)."""

    k: torch.Tensor
    v: torch.Tensor
    head_width: int
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    bits: int = 8
    v_bits: int = 0
    #: the chunk-transposed K mirror (B, S/128, Kh*D, 128) int8, or None
    kt: Optional[torch.Tensor] = None

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
        """Stored per-head width of the V tensor."""
        return self.head_dim // 2 if self.vbits == 4 else self.head_dim

    def _view4(self, arr: torch.Tensor, width: Optional[int] = None
               ) -> torch.Tensor:
        w = width or self.head_width
        return arr.reshape(*arr.shape[:-1], arr.shape[-1] // w, w)


def init_cache(num_layers: int, batch_slots: int, max_seq: int,
               num_kv_heads: int, head_dim: int, *, dtype=torch.bfloat16,
               kv_cache_dtype: str = "bf16", kv_kt: bool = False, device=None
               ) -> Tuple[LayerKVCache, ...]:
    """Zero-filled caches (and scales) for all layers. kv_kt: also the kt
    mirror, for int8 or k8v4 stores with max_seq % 128 == 0 only (JAX
    :134)."""
    kv_kt = (kv_kt and kv_cache_dtype in ("int8", "k8v4")
             and max_seq % KT_CHUNK == 0)
    f = num_kv_heads * head_dim

    def mirror():
        if not kv_kt:
            return None
        return torch.zeros((batch_slots, max_seq // KT_CHUNK, f, KT_CHUNK),
                           dtype=torch.int8, device=device)

    return tuple(
        LayerKVCache(**new_store(kv_cache_dtype, batch_slots, max_seq,
                                 num_kv_heads, head_dim, dtype=dtype,
                                 device=device), kt=mirror())
        for _ in range(num_layers))


def kt_auto(kv_cache_dtype: str, num_kv_heads: int, head_dim: int) -> bool:
    """JAX's policy for the kt mirror (`kt_auto` :268-293): int8-K stores
    only, with kv heads <= 8 or a multiple of 8 (a TPU DMA alignment rule,
    kept so that both packages decide alike); DPT_KV_KT=0/1 overrides;
    otherwise on only on a TPU with Kh*D >= 2048, so never here."""
    if kv_cache_dtype not in ("int8", "k8v4"):
        return False
    if not (num_kv_heads <= 8 or num_kv_heads % 8 == 0):
        return False
    return os.environ.get("DPT_KV_KT", "") == "1"


def _kt_write_prompts(cache: LayerKVCache, slots: torch.Tensor,
                      s_pad: int) -> None:
    """The chunks of the first s_pad rows of `slots`, transposed from the
    updated k into kt (JAX `_kt_write_prompts` :296 transposes the
    quantized rows it wrote, zero-padded to a chunk; here the rows past
    s_pad are k's own, which no reader sees before a flush rewrites
    them). A slot out of range is clamped onto the last slot, whose
    chunks are then rewritten from its own k: always safe, as any slot's
    readable chunks equal its k rows, so no host check is needed."""
    kt = cache.kt
    b, c_n, f = kt.shape[0], kt.shape[1], kt.shape[2]
    nch = min(-(-s_pad // KT_CHUNK), c_n)
    sl = slots.long().clamp(0, b - 1)
    rows = cache.k[sl, :nch * KT_CHUNK].reshape(-1, nch, KT_CHUNK, f)
    kt[sl, :nch] = rows.transpose(2, 3)


def _kt_refresh_chunks(cache: LayerKVCache, slot: int, start: int,
                       c_len: int) -> None:
    """Re-derive the kt chunks a write of rows [start, start + c_len) of
    `slot` touched, from the updated k (JAX `_kt_refresh_chunks` :311,
    the same chunk window and clamp)."""
    kt = cache.kt
    c_n = kt.shape[1]
    s, f = cache.k.shape[1], cache.k.shape[2]
    nch = min((c_len + 254) // KT_CHUNK, c_n)
    n128 = nch * KT_CHUNK
    sc = min(max((start // KT_CHUNK) * KT_CHUNK, 0), max(s - n128, 0))
    rows = cache.k[slot, sc:sc + n128].reshape(nch, KT_CHUNK, f)
    kt[slot, sc // KT_CHUNK:sc // KT_CHUNK + nch] = rows.transpose(1, 2)


def _is_paged(cache) -> bool:
    return isinstance(cache, kvcache_paged.PagedLayerKVCache)


def write_prompts(cache: LayerKVCache, k_new: torch.Tensor,
                  v_new: torch.Tensor, slots: torch.Tensor, *,
                  in_range: bool = False) -> LayerKVCache:
    """B prompts' K/V (B, S_pad, K, D) into the first S_pad rows of `slots`
    (B,), quantized with their scale columns for a quantized cache (in the
    kv_append kernel, one launch for K, V and both scale columns).
    Out-of-range slots are dropped, as JAX's scatter drops them; a bf16
    cache finds them by reading the slots back, unless the caller checked
    them on the host (`in_range`, the engine's prefill group: once a group,
    not once a layer). Contiguous caches only (batched admission runs on
    that layout only)."""
    if _is_paged(cache):
        raise NotImplementedError("write_prompts: contiguous caches only")
    b, s_pad = k_new.shape[:2]
    slots = slots.to(device=cache.k.device, dtype=torch.int32)
    if cache.quantized:
        pos = torch.arange(s_pad, device=slots.device,
                           dtype=torch.int32).repeat(b)
        scatter_rows(cache.k, cache.v, k_new.reshape(b * s_pad, -1),
                     v_new.reshape(b * s_pad, -1), pos,
                     slots=slots.repeat_interleave(s_pad), **store_args(cache))
        if cache.kt is not None:
            _kt_write_prompts(cache, slots, s_pad)
        return cache
    slots = slots.long()
    if not in_range:
        keep = (slots >= 0) & (slots < cache.k.shape[0])
        if not bool(keep.all()):
            slots, k_new, v_new = slots[keep], k_new[keep], v_new[keep]
    cache.k[slots, :s_pad] = flat_heads(k_new).to(cache.k.dtype)
    cache.v[slots, :s_pad] = flat_heads(v_new).to(cache.v.dtype)
    return cache


def write_prompt(cache, k_new: torch.Tensor, v_new: torch.Tensor,
                 slot: int):
    """One padded prompt's K/V (S_pad, K, D) into `slot`."""
    if _is_paged(cache):
        return kvcache_paged.write_prompt(cache, k_new, v_new, slot)
    b = cache.k.shape[0]
    slots = torch.tensor([int(slot)], device=cache.k.device)
    return write_prompts(cache, k_new[None], v_new[None], slots,
                         in_range=0 <= int(slot) < b)


def write_chunk(cache, k_new: torch.Tensor, v_new: torch.Tensor, slot: int,
                start: int):
    """A prefill chunk's K/V (C, K, D) at positions start..start+C of
    `slot` (chunked prefill), quantized for a quantized cache (in the
    kv_append kernel). Positions past the cache are dropped; paged caches
    need a page-aligned start (the engine's chunk size is a page
    multiple)."""
    if _is_paged(cache):
        return kvcache_paged.write_chunk(cache, k_new, v_new, slot, start)
    if isinstance(cache, kvcache_stacked.StackedLayer):
        return kvcache_stacked.write_chunk_layer(cache.cache, cache.index,
                                                 k_new, v_new, slot, start)
    c = k_new.shape[0]
    n = min(start + c, cache.k.shape[1]) - start
    if n <= 0:
        return cache
    s = int(slot)
    if cache.quantized:
        dev = cache.k.device
        scatter_rows(cache.k, cache.v, k_new.reshape(c, -1),
                     v_new.reshape(c, -1),
                     torch.arange(start, start + c, device=dev,
                                  dtype=torch.int32),
                     slots=torch.full((c,), s, device=dev, dtype=torch.int32),
                     **store_args(cache))
        if cache.kt is not None:
            _kt_refresh_chunks(cache, s, int(start), c)
        return cache
    cache.k[s, start:start + n] = flat_heads(k_new[:n]).to(cache.k.dtype)
    cache.v[s, start:start + n] = flat_heads(v_new[:n]).to(cache.v.dtype)
    return cache


def decode_rows(cache, positions: torch.Tensor) -> NewRows:
    """What `append_attend` shares across the layers of one step, computed
    once: the write positions (B, T) as int32 (-1 writes nothing) and, on
    the paged layout, their pool rows and validity (`row_ids`; one table
    serves every layer). The rows themselves are left empty."""
    pos = positions.to(torch.int32).reshape(positions.shape[0], -1)
    rows = (kvcache_paged.row_ids(cache, pos) if _is_paged(cache)
            else (None, None))
    return NewRows(None, None, pos.contiguous(), *rows)


def append_attend(cache, q: torch.Tensor, k_new: torch.Tensor,
                  v_new: torch.Tensor, lengths: torch.Tensor,
                  at: NewRows) -> torch.Tensor:
    """A decode (T = 1) or verify step of one layer: the T tokens' K/V
    (B, T, K, D) a slot written at `at`'s positions (`decode_rows`), then
    attention of q (B, T, H, D) over `lengths` (B,) rows a slot, the T rows
    included (0 for an inactive slot). One kernel launch writes and attends
    (#3 contiguous or a stacked layer's views, #5 paged); on the CPU the
    writer's plain version, then the attention's. The kt-mirror cache runs
    #2, then #7. Returns (B, T, H, D)."""
    t = q.shape[1]
    qf = fold_tokens(q)
    if getattr(cache, "kt", None) is not None:
        if t == 1:
            append_token(cache, k_new[:, 0], v_new[:, 0], at.pos[:, 0])
        else:
            append_tokens(cache, k_new, v_new, at.pos)
        out = decode_attention_kt(qf, cache.kt, cache.k, cache.v, lengths,
                                  cache.k_scale, cache.v_scale, tokens=t,
                                  v_bits=cache.vbits)[0]
        return unfold_tokens(out, t)
    new = at._replace(k=flat_heads(k_new), v=flat_heads(v_new))
    if _is_paged(cache):
        out = decode_attention_paged(qf, cache.k_pool, cache.v_pool,
                                     cache.table, lengths, tokens=t, new=new,
                                     **store_args(cache))
    elif isinstance(cache, kvcache_stacked.StackedLayer):
        st, i = cache.cache, cache.index
        kw = kvcache_stacked.store_args(st, i)
        # JAX's stacked route reaches the kernel (and its int8-dot path)
        # at S >= 128 for every store (transformer.py:1166-1215)
        dots = int8_dots_default(store_variant(kw.get("k_scale"), st.bits,
                                               st.v_bits), st.k.shape[2],
                                 stacked=True)
        out = decode_attention(qf, st.k[i], st.v[i], lengths, tokens=t,
                               new=new, int8_dots=dots, **kw)
    else:
        out = decode_attention(qf, cache.k, cache.v, lengths, tokens=t,
                               new=new, **store_args(cache))
    return unfold_tokens(out, t)


def append_token(cache, k_new: torch.Tensor, v_new: torch.Tensor,
                 positions: torch.Tensor):
    """One token's K/V (B, K, D) per slot at positions (B,), in place
    through the kv_append kernels (their plain versions on the CPU), which
    quantize the rows for a quantized cache. A position outside the cache
    writes nothing."""
    if _is_paged(cache):
        return kvcache_paged.append_token(cache, k_new, v_new, positions)
    if isinstance(cache, kvcache_stacked.StackedLayer):
        return kvcache_stacked.append_token_layer(cache.cache, cache.index,
                                                  k_new, v_new, positions)
    scatter_rows(cache.k, cache.v, flat_heads(k_new), flat_heads(v_new), positions,
                 **store_args(cache))
    return cache


def append_tokens(cache, k_new: torch.Tensor, v_new: torch.Tensor,
                  positions: torch.Tensor):
    """T tokens' K/V (B, T, K, D) per slot at positions (B, T): a
    speculative verify window, in place, all B*T rows in one kv_append
    launch (per-row slots), quantized inside it for a quantized cache.
    Positions at or past the cache end, or negative (an inactive slot),
    are dropped, as JAX's scatter drops them (JAX :445-454)."""
    if _is_paged(cache):
        return kvcache_paged.append_tokens(cache, k_new, v_new, positions)
    if isinstance(cache, kvcache_stacked.StackedLayer):
        return kvcache_stacked.append_tokens_layer(cache.cache, cache.index,
                                                   k_new, v_new, positions)
    b, t = positions.shape
    slots = torch.arange(b, device=positions.device,
                         dtype=torch.int32).repeat_interleave(t)
    scatter_rows(cache.k, cache.v, flat_heads(k_new).reshape(b * t, -1),
                 flat_heads(v_new).reshape(b * t, -1),
                 positions.reshape(-1), slots=slots, **store_args(cache))
    return cache


def slice_window(cache: LayerKVCache, window: int) -> LayerKVCache:
    """View of the first `window` positions (no copy). The kt mirror is
    dropped, as in JAX (:506-527): the kt kernel takes the whole cache."""
    def cut(sc):
        return None if sc is None else sc[:, :, :window]

    return LayerKVCache(k=cache.k[:, :window], v=cache.v[:, :window],
                        head_width=cache.head_width,
                        k_scale=cut(cache.k_scale), v_scale=cut(cache.v_scale),
                        bits=cache.bits, v_bits=cache.v_bits)


def copy_prefix(cache: LayerKVCache, src: int, dst: int, n: int
                ) -> LayerKVCache:
    """Rows [0, n) of slot `src` into slot `dst`, in place, with their
    scale columns: prefix-cache reuse on the contiguous layout (the paged
    layout maps pages instead). Exact: causal K/V rows depend only on the
    tokens [0, n), and quantized rows and scales copy bit for bit."""
    src, dst = int(src), int(dst)
    cache.k[dst, :n] = cache.k[src, :n]
    cache.v[dst, :n] = cache.v[src, :n]
    if cache.quantized:
        cache.k_scale[dst, :, :n] = cache.k_scale[src, :, :n]
        cache.v_scale[dst, :, :n] = cache.v_scale[src, :, :n]
    if cache.kt is not None:
        # JAX `one_kt` (:547-558): positions below n, chunk * 128 + lane;
        # the partly covered boundary chunk heals before it is read
        whole, part = divmod(n, KT_CHUNK)
        cache.kt[dst, :whole] = cache.kt[src, :whole]
        if part and whole < cache.kt.shape[1]:
            cache.kt[dst, whole, :, :part] = cache.kt[src, whole, :, :part]
    return cache


def _read4(cache: LayerKVCache, k, v, ks, vs, dtype):
    """(…, S, F') stores (and (…, R, S) scales) -> (…, S, K, D) in dtype."""
    if not cache.quantized:
        return cache._view4(k).to(dtype), cache._view4(v).to(dtype)
    return (dequant_side(cache._view4(k), ks, cache.bits, dtype),
            dequant_side(cache._view4(v, cache.v_width), vs, cache.vbits,
                         dtype))


def slot_view(cache, slot: int, window: int, dtype=torch.bfloat16
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slot's first `window` positions as (1, W, K, D) K/V in `dtype`,
    dequantized (chunked-prefill attention); a paged cache gathers the
    slot's pages."""
    if _is_paged(cache):
        return kvcache_paged.slot_view(cache, slot, dtype, window)
    if isinstance(cache, kvcache_stacked.StackedLayer):
        return kvcache_stacked.read_slot_layer(cache.cache, cache.index, slot,
                                               dtype, window)
    s = int(slot)

    def cut(sc):
        return None if sc is None else sc[s:s + 1, :, :window]

    return _read4(cache, cache.k[s:s + 1, :window], cache.v[s:s + 1, :window],
                  cut(cache.k_scale), cut(cache.v_scale), dtype)


def read(cache, dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, K, D) K/V in `dtype`, dequantized; a paged cache gathers its
    pages."""
    if _is_paged(cache):
        return kvcache_paged.read(cache, dtype)
    return _read4(cache, cache.k, cache.v, cache.k_scale, cache.v_scale, dtype)


def nbytes(caches) -> int:
    """Device bytes of the caches: stores, scales and (paged) the one
    shared table, counted once."""
    seen, total = set(), 0
    for c in caches:
        arrs = ((c.k_pool, c.v_pool, c.k_scale, c.v_scale, c.table)
                if _is_paged(c) else (c.k, c.v, c.k_scale, c.v_scale, c.kt))
        for arr in arrs:
            if arr is not None and id(arr) not in seen:
                seen.add(id(arr))
                total += arr.numel() * arr.element_size()
    return total
