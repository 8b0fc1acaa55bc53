"""Paged KV cache: fixed-size pages in one pool per layer, per-slot page
tables, and the host-side page allocators.

Ported from deeppowers_tpu/runtime/kvcache_paged.py (`PagedLayerKVCache`
:60, `init_paged_cache` :116, `write_prompt`/`write_chunk` :186/:192,
`_row_ids` :233 (here `row_ids`), `append_token` :298, `append_tokens`
:305, `_gather`/`read` :317/:361,
`slot_view` :377, `with_table` :392, `PageAllocator` :405,
`PrefixCachingAllocator` :518), with quantized pools (`_quant_side` :45,
`init_paged_cache` :140-178, `write_chunk`'s `scatter_scale` :192-231,
`_append` :254-296, `_dequant_gathered` :349).

Layout per layer, flat on the feature axis like the contiguous cache:
  k_pool, v_pool:   (P, page, F'), P pages shared by all slots; F' = Kh*D
                    (bf16, int8) or Kh*D/2 (packed int4), per
                    `kv_cache_dtype` as in runtime/kvcache.py
  k_scale, v_scale: (P, R, page) f32 head-major when quantized, R = Kh
                    (int8) or 2*Kh (int4); page p's scales live at index p,
                    so a shared prefix page shares its scales by
                    construction
  table:            (B, max_pages) int32, the page id of each (slot,
                    virtual page); page 0 is a reserved scratch page that
                    every unallocated entry points at and no slot ever
                    reads.

One table tensor on the device serves every layer: all layers' caches
hold the same tensor object. The JAX package keeps one copy per layer
only because a donated buffer cannot appear twice in one call
(kvcache_paged.py:141-142); eager PyTorch donates nothing, so the copies
would only cost memory and a copy per layer at every table change.
`with_table` therefore copies the host table into that one tensor in
place, synchronously: the host table is mutated in place right after, so
a non-blocking copy from it could read a later version.

Writes update the pools IN PLACE (the JAX functions return new buffers);
each function still returns the cache so call sites read the same.
Decode attention walks the table inside the kernel
(ops/kernels/decode_attention.py::decode_attention_paged) and never
gathers; `slot_view` gathers one slot's pages for chunked prefill, `read`
all slots' pages for the tests. The allocators are plain Python and
numpy, carried over line for line; `ShardedPageAllocator` (:453) belongs
to the data-parallel slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.kv_append import scatter_pool_rows
from ..quant.kvquant import (dequant_side, flat_heads, gather_scale, new_store,
                              store_args)


@dataclass
class PagedLayerKVCache:
    """KV pools of one layer and the (shared) page table. head_width,
    bits and v_bits as in kvcache.LayerKVCache."""

    k_pool: torch.Tensor                 # (P, page, F')
    v_pool: torch.Tensor
    table: torch.Tensor                  # (B, max_pages) int32, all layers
    head_width: int
    k_scale: Optional[torch.Tensor] = None   # (P, R, page) f32
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
    def v_width(self) -> int:
        """Stored per-head width of the V pool."""
        d = self.head_width * 2 if self.bits == 4 else self.head_width
        return d // 2 if self.vbits == 4 else d

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[1]

    @property
    def num_slots(self) -> int:
        return self.table.shape[0]

    @property
    def max_seq(self) -> int:
        return self.table.shape[1] * self.page_size

    def _view4(self, arr: torch.Tensor, width: Optional[int] = None
               ) -> torch.Tensor:
        w = width or self.head_width
        return arr.reshape(*arr.shape[:-1], arr.shape[-1] // w, w)


def init_paged_cache(num_layers: int, batch_slots: int, max_seq: int,
                     num_kv_heads: int, head_dim: int, *, page_size: int = 128,
                     total_pages: Optional[int] = None, dtype=torch.bfloat16,
                     kv_cache_dtype: str = "bf16", device=None
                     ) -> Tuple[PagedLayerKVCache, ...]:
    """Zero-filled pools (and scale pools) for all layers over one shared
    table. total_pages defaults to full reservation (B * max_seq / page +
    the scratch page); size it smaller for oversubscribed serving."""
    if max_seq % page_size:
        raise ValueError(f"max_seq {max_seq} % page_size {page_size} != 0")
    max_pages = max_seq // page_size
    pages = total_pages or (batch_slots * max_pages + 1)
    table = torch.zeros((batch_slots, max_pages), dtype=torch.int32,
                        device=device)

    def layer():
        st = new_store(kv_cache_dtype, pages, page_size, num_kv_heads,
                       head_dim, dtype=dtype, device=device)
        return PagedLayerKVCache(k_pool=st.pop("k"), v_pool=st.pop("v"),
                                 table=table, **st)

    return tuple(layer() for _ in range(num_layers))


def write_prompt(cache: PagedLayerKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor, slot: int) -> PagedLayerKVCache:
    """A padded prompt's K/V (S_pad, Kh, D) into `slot`'s pages."""
    return write_chunk(cache, k_new, v_new, slot, 0)


def write_chunk(cache: PagedLayerKVCache, k_new: torch.Tensor,
                v_new: torch.Tensor, slot: int, start: int
                ) -> PagedLayerKVCache:
    """A prefill chunk's K/V (C, Kh, D) at positions start..start+C of
    `slot`; `start` is page-aligned (the engine's chunk size is a page
    multiple). Whole pages are written, the tail padded. Virtual pages past
    the table are dropped (JAX's dynamic_slice would clamp them back over
    earlier pages); table entries not allocated yet point at the scratch
    page 0, where a lazy reservation's padded rows land, as in JAX."""
    ps = cache.page_size
    if start % ps:
        raise ValueError(f"chunk start {start} is not a multiple of {ps}")
    c = k_new.shape[0]
    first = start // ps
    n_pages = min(-(-c // ps), cache.table.shape[1] - first)
    if n_pages <= 0:
        return cache
    page_ids = cache.table[int(slot), first:first + n_pages].long()

    def padded(x):                       # (n_pages * ps, Kh, D), zero tail
        x = x[:n_pages * ps]
        pad = n_pages * ps - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        return x

    if cache.quantized:
        # the scatter_pool_rows kernel quantizes the rows, the zero-padded
        # tail too (scale 1e-8 / qmax), as JAX does
        rows = (page_ids[:, None] * ps + torch.arange(
            ps, device=page_ids.device)).reshape(-1).to(torch.int32)
        scatter_pool_rows(cache.k_pool, cache.v_pool,
                          flat_heads(padded(k_new)), flat_heads(padded(v_new)),
                          rows, torch.ones_like(rows, dtype=torch.bool),
                          **store_args(cache))
        return cache
    for pool, x in ((cache.k_pool, k_new), (cache.v_pool, v_new)):
        rows = flat_heads(padded(x))
        pool[page_ids] = rows.reshape(n_pages, ps, rows.shape[1]).to(
            pool.dtype)
    return cache


def row_ids(cache: PagedLayerKVCache, positions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (B,) or (B, T) (slot b's row of a speculative window) ->
    (absolute int32 rows in the (P*page, F) pool view, bool validity), flat
    over B*T in the form scatter_pool_rows takes without a copy. Positions
    at or past max_seq, or negative, are invalid and map to row 0 of the
    scratch page. The table is shared, so one call serves every layer of a
    step."""
    ps = cache.page_size
    pos = positions.long()
    valid = (pos >= 0) & (pos < cache.max_seq)
    vpage = torch.where(valid, pos // ps, torch.zeros_like(pos))
    slots = torch.arange(pos.shape[0], device=pos.device)
    if pos.dim() == 2:
        slots = slots[:, None]
    page_ids = torch.where(valid, cache.table[slots, vpage].long(),
                           torch.zeros_like(pos))
    rows = torch.where(valid, page_ids * ps + pos % ps, torch.zeros_like(pos))
    return rows.reshape(-1).to(torch.int32), valid.reshape(-1)


def append_token(cache: PagedLayerKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor, positions: torch.Tensor
                 ) -> PagedLayerKVCache:
    """One token's K/V (B, Kh, D) per slot at positions (B,), in place
    through the scatter_pool_rows kernel (its plain version on the CPU).
    An invalid position writes nothing."""
    rows, valid = row_ids(cache, positions)
    scatter_pool_rows(cache.k_pool, cache.v_pool, flat_heads(k_new),
                      flat_heads(v_new), rows, valid, **store_args(cache))
    return cache


def append_tokens(cache: PagedLayerKVCache, k_new: torch.Tensor,
                  v_new: torch.Tensor, positions: torch.Tensor
                  ) -> PagedLayerKVCache:
    """A speculative window's K/V (B, T, Kh, D) at positions (B, T), all
    B*T rows in one scatter_pool_rows launch (JAX `append_tokens` :305 /
    `_append` :254). The engine reserves the window's pages ahead, so every
    in-range position maps to an allocated page; positions at or past
    max_seq write nothing."""
    b, t = positions.shape
    rows, valid = row_ids(cache, positions)
    scatter_pool_rows(cache.k_pool, cache.v_pool,
                      flat_heads(k_new).reshape(b * t, -1),
                      flat_heads(v_new).reshape(b * t, -1), rows, valid,
                      **store_args(cache))
    return cache


def _gather(pool: torch.Tensor, table_slice: torch.Tensor) -> torch.Tensor:
    """(P, page, F) gathered by (B, W_pages) -> (B, W_pages*page, F)."""
    b, wp = table_slice.shape
    g = pool[table_slice.reshape(-1).long()]
    return g.reshape(b, wp * pool.shape[1], pool.shape[2])


def _dequant_gathered(cache: PagedLayerKVCache, tab: torch.Tensor, dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather both sides through `tab` into (B, W, Kh, D) in `dtype`,
    dequantizing a quantized cache (JAX `_dequant_gathered` :349)."""
    k4 = cache._view4(_gather(cache.k_pool, tab))
    v4 = cache._view4(_gather(cache.v_pool, tab), cache.v_width)
    if not cache.quantized:
        return k4.to(dtype), v4.to(dtype)
    return (dequant_side(k4, gather_scale(cache.k_scale, tab), cache.bits,
                         dtype),
            dequant_side(v4, gather_scale(cache.v_scale, tab), cache.vbits,
                         dtype))


def read(cache: PagedLayerKVCache, dtype=torch.bfloat16
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The virtual (B, max_seq, Kh, D) K/V view, gathered through the
    table and dequantized."""
    return _dequant_gathered(cache, cache.table, dtype)


def slot_view(cache: PagedLayerKVCache, slot: int, dtype=torch.bfloat16,
              window: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slot's virtual K/V (1, W, Kh, D) for chunked-prefill attention,
    dequantized."""
    wp = cache.table.shape[1] if window is None else -(-window // cache.page_size)
    return _dequant_gathered(cache, cache.table[int(slot):int(slot) + 1, :wp],
                             dtype)


def with_table(caches: Tuple[PagedLayerKVCache, ...],
               table: np.ndarray) -> Tuple[PagedLayerKVCache, ...]:
    """Copy the host-updated page table into the one device table every
    layer shares, synchronously (see the module docstring)."""
    caches[0].table.copy_(torch.from_numpy(np.ascontiguousarray(table)))
    return caches


class PageAllocator:
    """Host-side free-list allocator. Page 0 is reserved (the zero page every
    unallocated table entry points to)."""

    def __init__(self, total_pages: int, batch_slots: int, max_pages: int):
        self.free = list(range(total_pages - 1, 0, -1))     # stack; excludes 0
        self.per_slot = [[] for _ in range(batch_slots)]
        self.max_pages = max_pages

    @property
    def free_pages(self) -> int:
        return len(self.free)

    def ensure(self, table_host, slot: int, upto_len: int, page_size: int
               ) -> bool:
        """Allocate pages so `slot` can hold upto_len tokens; updates
        table_host in place. Returns False when the pool is exhausted."""
        need = -(-upto_len // page_size)
        have = len(self.per_slot[slot])
        while have < need:
            if not self.free:
                return False
            page = self.free.pop()
            table_host[slot, have] = page
            self.per_slot[slot].append(page)
            have += 1
        return True

    def release(self, table_host, slot: int) -> None:
        for page in self.per_slot[slot]:
            self.free.append(page)
        self.per_slot[slot] = []
        table_host[slot, :] = 0


class PrefixCachingAllocator(PageAllocator):
    """PageAllocator with page-granular prompt-prefix sharing.

    A page that holds a FULL page of prompt tokens is registered under the
    exact byte-key of the whole token prefix up to and including that page
    (no hash collisions). Later prompts that share the prefix map the same
    physical pages into their tables (refcounted) and skip prefilling them.
    Unreferenced cached pages stay resident and are evicted LRU only when
    the free list runs dry.
    """

    def __init__(self, total_pages: int, batch_slots: int, max_pages: int):
        super().__init__(total_pages, batch_slots, max_pages)
        self.refcount = {}                  # page_id -> int
        self.by_key = {}                    # prefix bytes -> page_id
        self.key_of = {}                    # page_id -> prefix bytes
        self.lru = []                       # unreferenced cached pages, LRU
        self.shared_per_slot = [[] for _ in range(batch_slots)]
        self.hits = 0
        self.hit_tokens = 0

    @property
    def cached_pages(self) -> int:
        return len(self.by_key)

    def _take_free(self):
        if self.free:
            return self.free.pop()
        if self.lru:                        # evict oldest unreferenced page
            page = self.lru.pop(0)
            key = self.key_of.pop(page)
            del self.by_key[key]
            return page
        return None

    def ensure(self, table_host, slot: int, upto_len: int, page_size: int
               ) -> bool:
        """Like PageAllocator.ensure but draws from free + evictable pages."""
        need = -(-upto_len // page_size)
        base = len(self.shared_per_slot[slot])
        have = base + len(self.per_slot[slot])
        while have < need:
            page = self._take_free()
            if page is None:
                return False
            table_host[slot, have] = page
            self.per_slot[slot].append(page)
            have += 1
        return True

    def match_prefix(self, table_host, slot: int, prompt, page_size: int
                     ) -> int:
        """Map shared pages for the longest cached full-page prefix of
        `prompt` into `slot`'s table. Returns the number of matched TOKENS
        (a multiple of page_size, capped at len(prompt)-1 so at least one
        suffix token remains to produce first-token logits)."""
        n = len(prompt)
        max_full = (n - 1) // page_size
        ids = np.asarray(prompt, dtype=np.int32)
        matched = 0
        for i in range(max_full):
            key = ids[:(i + 1) * page_size].tobytes()
            page = self.by_key.get(key)
            if page is None:
                break
            table_host[slot, i] = page
            self.shared_per_slot[slot].append(page)
            self.refcount[page] = self.refcount.get(page, 0) + 1
            if page in self.lru:
                self.lru.remove(page)
            matched = (i + 1) * page_size
        if matched:
            self.hits += 1
            self.hit_tokens += matched
        return matched

    def register_prefix(self, slot: int, prompt, page_size: int) -> None:
        """After the slot's prompt is fully prefilled, publish its private
        full-prompt pages into the cache so later prompts can share them."""
        n = len(prompt)
        base = len(self.shared_per_slot[slot])
        max_full = (n - 1) // page_size
        ids = np.asarray(prompt, dtype=np.int32)
        # table-position -> page mapping, snapshotted BEFORE the loop mutates
        # per_slot (removing while indexing would register the wrong pages)
        combined = list(self.shared_per_slot[slot]) + list(self.per_slot[slot])
        for i in range(base, max_full):
            if i >= len(combined):
                break
            page = combined[i]
            key = ids[:(i + 1) * page_size].tobytes()
            if key in self.by_key:
                continue
            self.by_key[key] = page
            self.key_of[page] = key
            self.refcount[page] = self.refcount.get(page, 0) + 1
            # ownership moves from the slot to the cache: on release the
            # refcount drops and the page becomes evictable, not free
            self.per_slot[slot].remove(page)
            self.shared_per_slot[slot].append(page)

    def release(self, table_host, slot: int) -> None:
        for page in self.shared_per_slot[slot]:
            self.refcount[page] -= 1
            if self.refcount[page] == 0:
                del self.refcount[page]
                if page in self.key_of:
                    self.lru.append(page)   # cached, evictable
                else:
                    self.free.append(page)
        self.shared_per_slot[slot] = []
        super().release(table_host, slot)
