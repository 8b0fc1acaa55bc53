"""Host-side prefix-cache index for the contiguous KV layout, copied from
deeppowers_tpu/runtime/prefix_index.py (numpy only).

The paged layout shares prompt KV by *mapping* pages
(kvcache_paged.PrefixCachingAllocator). Contiguous layouts have no
indirection, but retired slots' K/V rows stay resident in HBM until the slot
is reused — so a new request whose prompt shares a prefix with any resident
slot's tokens can COPY those rows (kvcache.copy_prefix) and prefill only the
suffix. Copying rows is HBM-bandwidth work (~us); recomputing the prefill is
model-FLOPs work (~ms) — the copy wins for any non-trivial prefix, and it is
exact (causal rows depend only on the prefix).

This index tracks which token sequence each slot's cache rows currently
hold: the prompt at activation, extended with the generated tokens that
actually entered the cache at retirement (everything but the final token,
which is never fed back). Multi-turn chat then hits on the full previous
conversation including the assistant's reply.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class SlotPrefixIndex:
    """Longest-resident-prefix matcher over the engine's batch slots."""

    def __init__(self, num_slots: int, min_tokens: int = 16):
        self._tokens: List[Optional[np.ndarray]] = [None] * num_slots
        self.min_tokens = min_tokens
        self.hits = 0
        self.hit_tokens = 0

    def invalidate(self, slot: int) -> None:
        self._tokens[slot] = None

    def register(self, slot: int, tokens) -> None:
        self._tokens[slot] = np.asarray(tokens, dtype=np.int32)

    def extend(self, slot: int, tokens) -> None:
        """Append generated tokens whose K/V rows are now resident."""
        cur = self._tokens[slot]
        if cur is None or not len(tokens):
            return
        self._tokens[slot] = np.concatenate(
            [cur, np.asarray(tokens, dtype=np.int32)])

    def match(self, prompt, exclude: int) -> Tuple[int, int]:
        """Longest common prefix of `prompt` with any resident slot's tokens.

        Returns (src_slot, matched_len) or (-1, 0). matched_len is capped at
        len(prompt) - 1 — at least one suffix token must prefill so the
        request has last-token logits to sample from.
        """
        prompt = np.asarray(prompt, dtype=np.int32)
        cap = len(prompt) - 1
        best_len, best_slot = 0, -1
        for s, toks in enumerate(self._tokens):
            if toks is None or s == exclude:
                continue
            m = min(len(toks), cap)
            if m <= best_len:
                continue
            eq = prompt[:m] == toks[:m]
            length = m if eq.all() else int(np.argmin(eq))
            if length > best_len:
                best_len, best_slot = length, s
        if best_len >= self.min_tokens:
            return best_slot, best_len
        return -1, 0

    def record_hit(self, matched: int) -> None:
        """Stats are recorded by the engine AFTER the copy actually happens
        (a match can be dropped when the only free slot is the source)."""
        self.hits += 1
        self.hit_tokens += matched
