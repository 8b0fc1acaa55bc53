"""Inference engine: slot-based continuous batching over one model.

Ported from deeppowers_tpu/runtime/engine.py with the same public surface
(add_request / begin_request, step, pop_finished, generate, generate_batch,
deferred_admission for the scheduler) and the same retirement rules: EOS,
max_tokens, and the capacity guard that retires a slot once
lengths >= max_seq - 1 (engine.py:370-381), so an append never runs past
the cache.

Eager PyTorch needs none of the JAX engine's compile machinery (jit caches,
donation, multi-step dispatch, pipelined harvests, window buckets): each
step() runs one decode forward over all slots and one host transfer of the
per-slot results. Decode attention bounds its reads per slot by length in
the kernel. Prompts prefill whole, padded to a bucket; within a
deferred-admission round the prompts of one bucket prefill as one batch.
The KV cache is always the unrolled per-layer layout
(RuntimeConfig.scan_layers is accepted and gives the same outputs).
Not ported yet (ROADMAP.md): chunked prefill, paged KV, quantized KV,
prefix caching, speculative and structured decoding, meshes.
"""

from __future__ import annotations

import time
import zlib
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import GenerationConfig, RuntimeConfig
from ..device import resolve_device
from ..models.transformer import (TransformerConfig, forward_decode,
                                  forward_prefill, fuse_params)
from ..ops.sampling import SamplingParams, logprobs_of, sample
from . import kvcache

NEG_INF = -1e30


@dataclass
class DecodeState:
    """Per-slot decode state on the device, leading dim B."""

    tokens: torch.Tensor          # int32, last token (next step's input)
    lengths: torch.Tensor         # int32, tokens currently in cache
    active: torch.Tensor          # bool
    generated: torch.Tensor       # int32, tokens emitted per slot
    max_tokens: torch.Tensor      # int32
    eos_id: torch.Tensor          # int32 (-1 => no EOS check)
    token_counts: torch.Tensor    # (B, V) int32, for penalties
    last_logprob: torch.Tensor    # f32
    sampling: SamplingParams


def init_state(batch_slots: int, vocab_size: int, device) -> DecodeState:
    b = batch_slots

    def zeros_i():
        return torch.zeros((b,), dtype=torch.int32, device=device)

    return DecodeState(
        tokens=zeros_i(), lengths=zeros_i(),
        active=torch.zeros((b,), dtype=torch.bool, device=device),
        generated=zeros_i(), max_tokens=zeros_i(),
        eos_id=torch.full((b,), -1, dtype=torch.int32, device=device),
        token_counts=torch.zeros((b, vocab_size), dtype=torch.int32,
                                 device=device),
        last_logprob=torch.zeros((b,), dtype=torch.float32, device=device),
        sampling=SamplingParams.from_config(
            GenerationConfig(do_sample=False, top_k=0, top_p=1.0), b, device),
    )


@dataclass
class SlotResult:
    """Accumulates one request's output on the host."""

    request_id: str
    prompt_len: int
    max_tokens: int = 0
    stop_token_ids: Tuple[int, ...] = ()
    token_ids: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    stop_reason: str = ""           # "eos" | "max_tokens" | "max_seq" | ...
    start_time: float = 0.0
    first_token_time: float = 0.0
    end_time: float = 0.0

    @property
    def ttft_ms(self) -> float:
        return (self.first_token_time - self.start_time) * 1e3

    @property
    def generation_time(self) -> float:
        return (self.end_time or time.perf_counter()) - self.start_time


class InferenceEngine:
    """Slot-based continuous-batching engine over one model."""

    def __init__(self, params, cfg: TransformerConfig, *,
                 runtime: Optional[RuntimeConfig] = None,
                 eos_token_id: Optional[int] = None,
                 kv_cache_dtype: str = "bf16", act_dtype=torch.bfloat16,
                 seed: int = 0, fuse_projections: bool = True, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.runtime = runtime or RuntimeConfig()
        self.eos_token_id = eos_token_id
        self.act_dtype = act_dtype
        self.kv_cache_dtype = kv_cache_dtype
        if params["embedding"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embedding'].device}, the engine "
                f"runs on {self.device}")
        self.params = fuse_params(params, cfg) if fuse_projections else params
        self.scan_layers = False
        b = self.runtime.max_batch_size
        self.max_seq = min(self.runtime.max_seq_len, cfg.max_seq_len)
        self.caches = kvcache.init_cache(
            cfg.num_layers, b, self.max_seq, cfg.kv_heads, cfg.dim_head,
            dtype=act_dtype, kv_cache_dtype=kv_cache_dtype,
            device=self.device)
        self.state = init_state(b, cfg.vocab_size, self.device)
        self._rng = torch.Generator(device=self.device).manual_seed(seed)
        self._lengths_host = np.zeros((b,), dtype=np.int64)
        self._active_host = np.zeros((b,), dtype=bool)
        self._temp_host = np.zeros((b,), dtype=np.float32)
        self._penalty_host = np.zeros((b,), dtype=bool)
        self._slots: List[Optional[SlotResult]] = [None] * b
        self._finished: List[SlotResult] = []
        self._defer_admission = False
        self._pending_batch: List[Dict] = []
        self.steps = 0

    # -- slot management ----------------------------------------------------
    @property
    def num_slots(self) -> int:
        return len(self._slots)

    @property
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s is None]

    @property
    def active_requests(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def prefilling_slots(self) -> List[int]:
        """Slots in chunked prefill: none, prompts prefill whole here."""
        return []

    def _bucket(self, n: int) -> int:
        for b in self.runtime.prefill_buckets:
            if n <= b and b <= self.max_seq:
                return b
        return self.max_seq

    def add_request(self, token_ids: Sequence[int], gen: GenerationConfig, *,
                    request_id: str = "") -> int:
        """Prefill a prompt into a free slot; returns the slot index.
        Raises RuntimeError when no slot is free."""
        return self.begin_request(token_ids, gen, request_id=request_id)

    def begin_request(self, token_ids: Sequence[int], gen: GenerationConfig,
                      *, request_id: str = "") -> int:
        """Reserve a slot and prefill (now, or at the end of a
        deferred-admission round, batched with the round's other prompts
        of the same bucket)."""
        gen.validate()
        if gen.guide is not None:
            raise NotImplementedError(
                "structured output is not ported yet (ROADMAP.md)")
        free = self.free_slots
        if not free:
            raise RuntimeError("no free slots")
        n = len(token_ids)
        if n == 0:
            raise ValueError("empty prompt")
        if self.max_seq - n <= 0:
            raise ValueError(
                f"prompt length {n} exceeds max_seq_len {self.max_seq}")
        slot = free[0]
        t0 = time.perf_counter()
        self._slots[slot] = SlotResult(request_id=request_id, prompt_len=n,
                                       start_time=t0)
        item = {"slot": slot, "ids": list(token_ids), "n": n, "gen": gen,
                "rid": request_id, "t0": t0, "bucket": self._bucket(n)}
        if self._defer_admission and self.runtime.batched_admission:
            self._pending_batch.append(item)
            return slot
        self._prefill_group([item])
        return slot

    def _prefill_group(self, items: List[Dict]) -> None:
        """Prefill prompts of one bucket as one batch, write their K/V into
        their slots and activate them."""
        bucket = items[0]["bucket"]
        ids = np.zeros((len(items), bucket), dtype=np.int64)
        for i, it in enumerate(items):
            ids[i, :it["n"]] = it["ids"]
        dev = self.device
        lengths = torch.tensor([it["n"] for it in items], device=dev)
        slots = torch.tensor([it["slot"] for it in items], device=dev)
        with torch.no_grad():
            last, kv = forward_prefill(
                self.params, self.cfg, torch.from_numpy(ids).to(dev), lengths,
                dtype=self.act_dtype, logits_at=lengths - 1)
            for cache, (k, v) in zip(self.caches, kv):
                kvcache.write_prompts(cache, k, v, slots)
        for i, it in enumerate(items):
            self._activate_slot(it, last[i])

    def _flush_batch_prefills(self) -> None:
        pend, self._pending_batch = self._pending_batch, []
        groups: Dict[int, List[Dict]] = {}
        for it in pend:
            res = self._slots[it["slot"]]
            if res is None or res.request_id != it["rid"]:
                continue                      # cancelled while pending
            groups.setdefault(it["bucket"], []).append(it)
        for bucket in sorted(groups):
            try:
                self._prefill_group(groups[bucket])
            except Exception:
                # free the group's reserved slots before propagating
                for it in groups[bucket]:
                    res = self._slots[it["slot"]]
                    if res is not None and res.request_id == it["rid"]:
                        self._slots[it["slot"]] = None
                raise

    @contextmanager
    def deferred_admission(self):
        """Batch the prefills of every admission inside the context (the
        scheduler wraps its admission loop in this)."""
        self._defer_admission = True
        try:
            yield self
        finally:
            self._defer_admission = False
            self._flush_batch_prefills()

    def _activate_slot(self, it: Dict, last_logits: torch.Tensor) -> None:
        """Sample the first token from the prefill logits and install the
        slot into the batched decode state."""
        slot, gen, n = it["slot"], it["gen"], it["n"]
        dev, v = self.device, self.cfg.vocab_size
        sp1 = SamplingParams.from_config(gen, 1, dev)
        seed = gen.seed if gen.seed is not None else (
            zlib.crc32(it["rid"].encode()) & 0x7FFFFFFF)
        rng = torch.Generator(device=dev).manual_seed(seed * 1009 + slot)
        ids = torch.tensor(it["ids"], dtype=torch.long, device=dev)
        counts = torch.bincount(ids[ids < v], minlength=v)[None].to(torch.int32)
        eos_suppress = self.eos_token_id if self.eos_token_id is not None else -1
        adj = last_logits.float().clone()
        if gen.min_tokens > 0 and eos_suppress >= 0:
            adj[eos_suppress] += NEG_INF
        temp = gen.temperature if gen.do_sample else 0.0
        penalties = (gen.repetition_penalty != 1.0 or gen.presence_penalty
                     or gen.frequency_penalty)
        with torch.no_grad():
            tok = sample(adj[None], sp1, rng,
                         token_counts=counts if penalties else None,
                         any_sampled=temp > 0)
            lp = logprobs_of(last_logits[None], tok)
        counts[0, tok.long()] += 1
        eos = self.eos_token_id if self.eos_token_id is not None else -1
        if gen.stop_token_ids and eos == -1:
            eos = gen.stop_token_ids[0]
        st = self.state
        st.tokens[slot] = tok[0]
        st.lengths[slot] = n
        st.active[slot] = True
        st.generated[slot] = 1
        st.max_tokens[slot] = gen.max_tokens
        st.eos_id[slot] = eos
        st.token_counts[slot] = counts[0]
        st.last_logprob[slot] = lp[0]
        st.sampling.set_row(slot, sp1)
        self._temp_host[slot] = temp
        self._penalty_host[slot] = bool(penalties)
        self._active_host[slot] = True
        self._lengths_host[slot] = n
        res = self._slots[slot]
        res.prompt_len = n
        res.max_tokens = gen.max_tokens
        res.stop_token_ids = tuple(gen.stop_token_ids)
        first = int(tok[0])
        res.first_token_time = time.perf_counter()
        res.token_ids.append(first)
        res.logprobs.append(float(lp[0]))
        hit_stop = first == eos or first in gen.stop_token_ids
        if (hit_stop and gen.min_tokens < 1) or gen.max_tokens <= 1:
            st.active[slot] = False
            res.stop_reason = "eos" if hit_stop else "max_tokens"
            self._retire(slot)

    # -- decode -------------------------------------------------------------
    def step(self) -> Dict[int, List[int]]:
        """One decode step for every active slot; returns {slot: [token]}.
        Retires finished slots (EOS / max_tokens / cache full)."""
        if not self._active_host.any():
            return {}
        st = self.state
        with torch.no_grad():
            logits, self.caches = forward_decode(
                self.params, self.cfg, st.tokens, self.caches, st.lengths,
                dtype=self.act_dtype)
            sp = st.sampling
            b = logits.shape[0]
            rows = torch.arange(b, device=logits.device)
            suppress = (st.generated < sp.min_tokens) & (st.eos_id >= 0)
            eos_col = st.eos_id.clamp(0, logits.shape[1] - 1).long()
            logits[rows, eos_col] += torch.where(
                suppress, torch.full_like(logits[:, 0], NEG_INF),
                torch.zeros_like(logits[:, 0]))
            need_pen = bool(self._penalty_host[self._active_host].any())
            nxt = sample(logits, sp, self._rng,
                         token_counts=st.token_counts if need_pen else None,
                         any_sampled=bool(
                             (self._temp_host[self._active_host] > 0).any()))
            lp = logprobs_of(logits, nxt)
            active = st.active
            new_lengths = torch.where(active, st.lengths + 1, st.lengths)
            new_generated = torch.where(active, st.generated + 1, st.generated)
            hit_eos = (nxt == st.eos_id) & (st.eos_id >= 0) & (
                new_generated >= sp.min_tokens.clamp(min=1))
            hit_max = new_generated >= st.max_tokens
            # capacity guard, as the JAX engine's: cap - 1 keeps every
            # append inside the cache
            hit_cap = new_lengths >= self.max_seq - 1
            still_active = active & ~hit_eos & ~hit_max & ~hit_cap
            if need_pen:
                st.token_counts[rows, nxt.long()] += active.to(torch.int32)
            emitted = torch.where(active, nxt, torch.full_like(nxt, -1))
            st.tokens = torch.where(active, nxt, st.tokens)
            st.lengths = new_lengths.to(torch.int32)
            st.active = still_active
            st.generated = new_generated.to(torch.int32)
            st.last_logprob = lp
            packed = torch.stack([emitted.double(), lp.double(),
                                  still_active.double(),
                                  st.lengths.double(), st.eos_id.double()])
        self.steps += 1
        got = packed.cpu().numpy()
        return self._harvest(got)

    def _harvest(self, got: np.ndarray) -> Dict[int, List[int]]:
        """Host bookkeeping of one step: emissions, stop ids, retires."""
        emitted_np = got[0].astype(np.int64)
        lp_np = got[1]
        active_np = got[2] > 0.5
        lengths_np = got[3].astype(np.int64)
        eos_np = got[4].astype(np.int64)
        self._lengths_host = lengths_np
        self._active_host = active_np.copy()
        out: Dict[int, List[int]] = {}
        for slot in range(len(self._slots)):
            res = self._slots[slot]
            if res is None or emitted_np[slot] < 0:
                continue
            tok = int(emitted_np[slot])
            res.token_ids.append(tok)
            res.logprobs.append(float(lp_np[slot]))
            out[slot] = [tok]
            if res.stop_token_ids and active_np[slot] and \
                    tok in res.stop_token_ids:
                self.state.active[slot] = False
                active_np[slot] = False
                res.stop_reason = "eos"
            cache_full = lengths_np[slot] >= self.max_seq - 1
            if not active_np[slot] or cache_full:
                if cache_full and active_np[slot]:
                    self.state.active[slot] = False
                    res.stop_reason = res.stop_reason or "max_seq"
                elif tok == eos_np[slot]:
                    res.stop_reason = res.stop_reason or "eos"
                elif cache_full:
                    res.stop_reason = res.stop_reason or "max_seq"
                else:
                    res.stop_reason = res.stop_reason or "max_tokens"
                self._retire(slot)
        return out

    def cancel(self, slot: int) -> None:
        """Cancel a running request."""
        if self._slots[slot] is None:
            return
        self.state.active[slot] = False
        self._slots[slot].stop_reason = "cancelled"
        self._retire(slot)

    def _retire(self, slot: int) -> None:
        res = self._slots[slot]
        res.end_time = time.perf_counter()
        self._finished.append(res)
        self._slots[slot] = None
        self._active_host[slot] = False
        self._lengths_host[slot] = 0
        self._temp_host[slot] = 0.0
        self._penalty_host[slot] = False
        self.state.lengths[slot] = 0

    def pop_finished(self) -> List[SlotResult]:
        done, self._finished = self._finished, []
        return done

    def reset(self) -> None:
        """Drop all in-flight state: fresh caches and decode state, slots
        freed (the scheduler's failure recovery)."""
        b = self.num_slots
        self.caches = kvcache.init_cache(
            self.cfg.num_layers, b, self.max_seq, self.cfg.kv_heads,
            self.cfg.dim_head, dtype=self.act_dtype,
            kv_cache_dtype=self.kv_cache_dtype, device=self.device)
        self.state = init_state(b, self.cfg.vocab_size, self.device)
        self._active_host = np.zeros((b,), dtype=bool)
        self._lengths_host = np.zeros((b,), dtype=np.int64)
        self._temp_host = np.zeros((b,), dtype=np.float32)
        self._penalty_host = np.zeros((b,), dtype=bool)
        self._slots = [None] * b
        self._finished = []
        self._pending_batch = []

    # -- one-shot APIs --------------------------------------------------------
    def generate(self, token_ids: Sequence[int],
                 gen: Optional[GenerationConfig] = None) -> SlotResult:
        """Blocking single-prompt generation."""
        return self.generate_batch([token_ids], gen)[0]

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       gen: Optional[GenerationConfig] = None
                       ) -> List[SlotResult]:
        """All prompts decode together in the batched step (at most
        num_slots prompts)."""
        gen = gen or GenerationConfig()
        order = []
        for i, p in enumerate(prompts):
            rid = f"batch-{i}"
            self.add_request(p, gen, request_id=rid)
            order.append(rid)
        results: Dict[str, SlotResult] = {}
        pending = set(order)
        while pending:
            progressed = self.step()
            for r in self.pop_finished():
                results[r.request_id] = r
                pending.discard(r.request_id)
            if not progressed and pending:
                raise RuntimeError("engine stalled with pending requests")
        return [results[rid] for rid in order]
