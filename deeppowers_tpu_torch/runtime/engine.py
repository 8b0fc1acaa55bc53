"""Inference engine: slot-based continuous batching over one model.

Ported from deeppowers_tpu/runtime/engine.py with the same public surface
(add_request / begin_request, step, pop_finished, generate, generate_batch,
deferred_admission for the scheduler) and the same retirement rules: EOS,
max_tokens, and the capacity guard that retires a slot once
lengths >= max_seq - 1 (engine.py:370-381), so an append never runs past
the cache.

Dispatch, as in the JAX engine (`step` :1512-1613): one step() runs a
dispatch of N = `decode_steps_per_dispatch` decode steps and harvests it
in one host transfer (emitted tokens and logprobs (N, B), then a snapshot
of active, lengths and EOS ids). N = 0 picks the depth itself
(`_auto_observe`: 7 dispatches at 4, 7 at 12, a fit of the fixed cost D
and the step time s, a ladder depth). With `pipelined_dispatch` (the
default) a plain decode enqueues dispatch n + 1 before it harvests
dispatch n; slot epochs keep a harvest from touching a slot whose
occupant changed while its dispatch was in flight. Every step updates the
state and the caches in place (`decode_step`), so on the card each step
of a dispatch is a replay of one CUDA graph (runtime/graphs.py), captured
once per variant of the host branches; on the CPU it runs eagerly. Eager
PyTorch needs none of the JAX engine's other compile machinery (jit
caches, donation, window buckets). Decode attention bounds its reads per
slot by length in the kernel. The KV cache is contiguous or paged (`kv_layout="paged"`, JAX
engine.py:635-665). `RuntimeConfig.scan_layers` decides as in JAX
(:615-630): "auto" (the default) stacks the layers of a model with 16 or
more homogeneous layers on the contiguous layout, a mixed-precision model
staying unrolled; True stacks them or raises ValueError (paged layout,
mixed precision); False keeps the unrolled forwards. A stacked model
keeps the stacked cache (runtime/kvcache_stacked.py) and runs the scan
forwards, with the same greedy tokens as JAX's scan engine; a draft
model's cache stays per layer. An unrolled contiguous cache of an int8-K
store carries the kt mirror when `kvcache.kt_auto` says so: never by
default on this card (as JAX's policy off the TPU), always with
DPT_KV_KT=1; decode and verify then read K through kernel #7.

Admission, as in the JAX engine (`begin_request` :941-987): a prompt
longer than `prefill_chunk_size`, or one whose prefix is found in the
prefix cache, enters chunked prefill: the slot is reserved and the caller
(the scheduler) runs one chunk at a time through `continue_prefill`,
interleaved with decode steps. Other prompts prefill whole, padded to a
bucket; within a deferred-admission round the prompts of one bucket
prefill as one batch (contiguous layout only). On the paged layout each
admission reserves pages for its whole token budget (`kv_reserve="full"`)
or for prompt + slack (`"lazy"`), growing page by page before each
decode step and preempting the youngest request when the pool runs dry;
a reservation the pool cannot cover raises NoFreePages. Prefix caching
maps shared full pages (paged) or copies a retired slot's rows
(contiguous). One deliberate difference: an inactive slot neither writes
nor reads its cache in a decode step, where the JAX engine writes its
row lengths = 0, over a prompt in chunked prefill or a retired prompt kept
for prefix reuse.
The KV store is bf16 or quantized (`kv_cache_dtype` "int8", "int4" or
"k8v4", JAX's layouts) on either layout; pages count rows, so the page
budget does not depend on the store.
MoE models (Mixtral) run on the one device with their quantized experts
in the cat layout, as the JAX engine runs them without a mesh; their
batched prefills pad the batch as the JAX engine does, so each forward's
token count, which picks an MoE layer's branch, is the JAX engine's.
Speculative decoding (`RuntimeConfig.speculative_tokens` = K > 0, JAX
engine.py:731-821, 1565-1691; runtime/speculative.py) runs on either
layout and store: each step drafts K tokens a slot by prompt lookup over a
device token history, or with a draft model (`draft_params` /
`draft_cfg`, its own contiguous cache in the target's store, prefilled at
activation), verifies the window in one forward and emits 1..K+1 tokens a
slot; a dispatch runs N such steps as plain decode runs them (never
pipelined, as in JAX), the rows of its harvest ordered (step, window
position). Pages are reserved K rows further ahead, and the engine falls
back to plain decode when the mean accepted window stays below
`speculative_min_accepted` (scaled by a draft's cost).
Structured output (`GenerationConfig.guide`, a compiled guide of
serving/structured.py; JAX :337-346, 392-395, 1099-1153, 1347-1397): every
registered guide's DFA rows are stacked into two device tables (allow
(R, V) bool, next (R, V) int32), the EOS column rewritten from the DFA's
accept states; the first token is masked to the initial row and walked on
the host, each decode step (and each speculative window position) masks a
guided slot's logits to its row and advances the row on the device, and a
guided slot with no legal token (an accept-only state without an EOS id)
stops with "guide_complete". `min_tokens` is 0 under a guide. Top log
probabilities (`RuntimeConfig.emit_top_logprobs` = k > 0, JAX :407-411,
479-482): the first token's top k over the raw prefill logits, a decode
step's over its logits after EOS suppression and the guide mask, a
speculative position's over the raw verify logits, in `jax.lax.top_k`'s
order (ops/sampling.py `top_logprobs`); they ride in the dispatch's output
rows and land in `SlotResult.top_tokens`, cut with the tokens at a stop id.
Both run inside the captured decode graphs: the guided variants read the
tables and are dropped and captured anew when a guide registers.
Not ported yet (ROADMAP.md): sequence-parallel prefill and meshes (tensor
and expert parallelism); the RuntimeConfig field that asks for the first
raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
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
                                  forward_decode_scan, forward_prefill,
                                  forward_prefill_chunk,
                                  forward_prefill_chunk_scan,
                                  forward_prefill_scan_batch, fuse_params,
                                  param_nbytes, stack_layer_params)
from ..ops.kernels.decode_attention import int8_dots_switch
from ..ops.sampling import (SamplingParams, guide_mask, logprobs_of, sample,
                             top_logprobs)
from . import kvcache, kvcache_paged, kvcache_stacked, speculative
from .graphs import StepGraphs
from .prefix_index import SlotPrefixIndex

NEG_INF = -1e30


class NoFreePages(RuntimeError):
    """The paged-KV pool cannot cover a request's token budget right now;
    retry after running requests release pages (transient, not a request
    error)."""


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
    # int32, the structured-output DFA row in the engine's stacked guide
    # tables (`_register_guide`); -1 = unguided
    guide_state: torch.Tensor
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
        guide_state=torch.full((b,), -1, dtype=torch.int32, device=device),
        sampling=SamplingParams.from_config(
            GenerationConfig(do_sample=False, top_k=0, top_p=1.0), b, device),
    )


def record_rows(out: torch.Tensor, row: torch.Tensor, emitted: torch.Tensor,
                lps: torch.Tensor, st: DecodeState,
                topk: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> None:
    """A step's results into a dispatch's output rows, in place: `out` is
    (rows, B) f64, emitted tokens in rows [0, R), logprobs in
    [R, 2 R), then active, lengths and EOS ids as they stand after the
    step, then with top-k (k candidates a row, `topk` = (values, ids)
    each (T, B, k)) the values of emission row r in rows 2 R + 3 + r·k ..
    + k - 1 and the ids R·k rows further (2 R + 3 + 2 R·k rows in all);
    `row` (1,) int64 counts the steps written so far. A step of T rows (T = K + 1 for a speculative
    window) fills rows row·T .. row·T + T - 1, so a dispatch's rows run
    (step, window position), as JAX reshapes its (N, B, T) emissions and
    (N, B, T, k) top-k (engine.py:1592-1598, 1658-1663)."""
    k = 0 if topk is None else topk[0].shape[-1]
    rmax = (out.shape[0] - 3) // (2 + 2 * k)
    t = emitted.shape[0]
    idx = row * t + torch.arange(t, device=out.device)
    out.index_copy_(0, idx, emitted.double())
    out.index_copy_(0, idx + rmax, lps.double())
    out[2 * rmax:2 * rmax + 3].copy_(torch.stack(
        [st.active.double(), st.lengths.double(), st.eos_id.double()]))
    if k:
        kidx = (idx[:, None] * k + torch.arange(k, device=out.device)
                ).reshape(-1) + 2 * rmax + 3
        b = emitted.shape[1]
        for j, part in enumerate(topk):
            out.index_copy_(0, kidx + j * rmax * k, part.permute(0, 2, 1)
                            .reshape(t * k, b).double())
    row.add_(1)


def decode_step(params, cfg: TransformerConfig, caches, st: DecodeState,
                out: torch.Tensor, row: torch.Tensor, *, scan: bool,
                max_seq: int, dtype, need_pen: bool, any_sampled: bool,
                generator: Optional[torch.Generator], guide_tables=None,
                top_k: int = 0) -> None:
    """One decode step of every slot (JAX `_decode_core`), all in place:
    the forward appends each active slot's token to the caches, the next
    tokens are sampled, the state advances (EOS, max_tokens and the
    capacity guard, as the JAX engine's :370-381, retire slots on the
    device) and `record_rows` writes the step's row of the dispatch. With
    `guide_tables` (allow (R, V) bool, next (R, V) int32) guided slots are
    masked to their DFA row and advance it on the device (:337-346,
    392-395); with `top_k` the step also records the top_k
    log-probabilities of its logits after the EOS suppression and the
    guide mask (:407-411). The host branches are arguments (a CUDA graph's
    variant). This is the function the card captures and replays
    (runtime/graphs.py); eager, it is the graph's plain version."""
    fwd = forward_decode_scan if scan else forward_decode
    logits, _ = fwd(params, cfg, st.tokens, caches, st.lengths, dtype=dtype,
                    active=st.active)
    sp = st.sampling
    b = logits.shape[0]
    rows = torch.arange(b, device=logits.device)
    suppress = (st.generated < sp.min_tokens) & (st.eos_id >= 0)
    eos_col = st.eos_id.clamp(0, logits.shape[1] - 1).long()
    logits[rows, eos_col] += torch.where(
        suppress, torch.full_like(logits[:, 0], NEG_INF),
        torch.zeros_like(logits[:, 0]))
    active = st.active
    if guide_tables is not None:
        guided = st.guide_state >= 0
        g_rows = st.guide_state.clamp(0, guide_tables[0].shape[0] - 1).long()
        logits, _, no_move = guide_mask(logits, g_rows, guided,
                                        guide_tables[0])
        active = active & ~no_move
    nxt = sample(logits, sp, generator,
                 token_counts=st.token_counts if need_pen else None,
                 any_sampled=any_sampled)
    lp = logprobs_of(logits, nxt)
    new_lengths = torch.where(active, st.lengths + 1, st.lengths)
    new_generated = torch.where(active, st.generated + 1, st.generated)
    hit_eos = (nxt == st.eos_id) & (st.eos_id >= 0) & (
        new_generated >= sp.min_tokens.clamp(min=1))
    hit_max = new_generated >= st.max_tokens
    # capacity guard, as the JAX engine's: cap - 1 keeps every append
    # inside the cache
    hit_cap = new_lengths >= max_seq - 1
    still_active = active & ~hit_eos & ~hit_max & ~hit_cap
    if need_pen:
        st.token_counts[rows, nxt.long()] += active.to(torch.int32)
    emitted = torch.where(active, nxt, torch.full_like(nxt, -1))
    if guide_tables is not None:
        nxt_row = guide_tables[1][g_rows, nxt.long()]
        st.guide_state.copy_(torch.where(guided & active, nxt_row,
                                         st.guide_state))
    st.tokens.copy_(torch.where(active, nxt, st.tokens))
    st.lengths.copy_(new_lengths)
    st.active.copy_(still_active)
    st.generated.copy_(new_generated)
    st.last_logprob.copy_(lp)
    topk = None
    if top_k:
        tv, ti = top_logprobs(logits, top_k)
        topk = (tv[None], ti[None])
    record_rows(out, row, emitted[None], lp[None], st, topk)


def clone_state(st: DecodeState) -> DecodeState:
    """A copy of every tensor of the state (the warm-up of a graph's
    capture and chip_smoke.py's eager step run on such copies)."""
    sp = SamplingParams(**{f.name: getattr(st.sampling, f.name).clone()
                           for f in dataclasses.fields(SamplingParams)})
    return DecodeState(**{f.name: getattr(st, f.name).clone()
                          for f in dataclasses.fields(DecodeState)
                          if f.name != "sampling"}, sampling=sp)


@dataclass
class _PendingPrefill:
    """Host-side state of an in-progress chunked prefill."""

    ids: np.ndarray
    gen: GenerationConfig
    request_id: str
    pos: int = 0


@dataclass
class SlotResult:
    """Accumulates one request's output on the host."""

    request_id: str
    prompt_len: int
    max_tokens: int = 0
    stop_token_ids: Tuple[int, ...] = ()
    token_ids: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    # a token's [(candidate id, logprob), ...] with emit_top_logprobs > 0
    top_tokens: List[List[Tuple[int, float]]] = field(default_factory=list)
    guided: bool = False            # under a structured-output guide
    stop_reason: str = ""           # "eos" | "max_tokens" | "max_seq" |
    #                                 "guide_complete" | ...
    start_time: float = 0.0
    first_token_time: float = 0.0
    end_time: float = 0.0

    @property
    def ttft_ms(self) -> float:
        return (self.first_token_time - self.start_time) * 1e3

    @property
    def generation_time(self) -> float:
        return (self.end_time or time.perf_counter()) - self.start_time


#: RuntimeConfig fields the JAX engine acts on and the port does not yet,
#: with their defaults: a run that sets one raises instead of ignoring it
UNPORTED_RUNTIME_DEFAULTS = {"seq_parallel_prefill": False}

#: the depths the auto dispatch depth picks from (JAX engine.py:1794)
AUTO_LADDER = (1, 2, 4, 6, 8, 12, 16, 24, 32)


def _scan_policy(params, cfg: TransformerConfig, scan, kv_layout: str):
    """(params, scan?) as the JAX engine decides `scan_layers`
    (engine.py:615-630): "auto" stacks the layers of a model with at least
    16 of them on the contiguous layout and stays unrolled when they do not
    stack (mixed per-depth precision); True stacks them, raising
    ValueError on the paged layout or for layers that do not stack; False
    keeps them unrolled."""
    if scan == "auto":
        if cfg.num_layers < 16 or kv_layout == "paged":
            return params, False
        try:
            return stack_layer_params(params), True
        except ValueError:
            return params, False
    if scan:
        if kv_layout == "paged":
            raise ValueError("scan_layers requires kv_layout='contiguous'")
        return stack_layer_params(params), True
    return params, False


def _require_ported(runtime: RuntimeConfig) -> None:
    for name, default in UNPORTED_RUNTIME_DEFAULTS.items():
        value = getattr(runtime, name)
        if value != default:
            raise NotImplementedError(
                f"RuntimeConfig.{name}={value!r} is not ported yet "
                f"(ROADMAP.md); the port runs with {name}={default!r}")


class InferenceEngine:
    """Slot-based continuous-batching engine over one model."""

    def __init__(self, params, cfg: TransformerConfig, *,
                 runtime: Optional[RuntimeConfig] = None,
                 eos_token_id: Optional[int] = None,
                 kv_cache_dtype: str = "bf16", act_dtype=torch.bfloat16,
                 seed: int = 0, fuse_projections: bool = True, device=None,
                 kv_layout: str = "contiguous",
                 kv_total_pages: Optional[int] = None,
                 draft_params=None,
                 draft_cfg: Optional[TransformerConfig] = None):
        if kv_layout not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.runtime = runtime or RuntimeConfig()
        _require_ported(self.runtime)
        self.eos_token_id = eos_token_id
        self.act_dtype = act_dtype
        self.kv_cache_dtype = kv_cache_dtype
        if params["embedding"].device.type != self.device.type:
            raise ValueError(
                f"params live on {params['embedding'].device}, the engine "
                f"runs on {self.device}")
        params = fuse_params(params, cfg) if fuse_projections else params
        self.params, self.scan_layers = _scan_policy(
            params, cfg, self.runtime.scan_layers, kv_layout)
        b = self.runtime.max_batch_size
        self.max_seq = min(self.runtime.max_seq_len, cfg.max_seq_len)
        self.kv_layout = kv_layout
        self.kv_total_pages = kv_total_pages
        self._page_alloc = None
        self._table_host: Optional[np.ndarray] = None
        self.caches = self._new_caches()
        # prefix caching on the contiguous layout: retired slots' rows stay
        # resident until the slot is reused and are copied on a match; the
        # paged layout maps shared pages instead (PrefixCachingAllocator)
        self._prefix_idx = (SlotPrefixIndex(b) if self.runtime.enable_prefix_cache
                            and kv_layout != "paged" else None)
        self._prefilling: Dict[int, _PendingPrefill] = {}
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
        # multi-step dispatch (JAX engine.py:738-755): 0 asks for the auto
        # depth, which probes at 4 steps, then 12 (`_auto_observe`)
        spd = self.runtime.decode_steps_per_dispatch
        self._auto_dispatch = spd == 0
        self._steps_per_dispatch = 4 if self._auto_dispatch else max(1, spd)
        self._auto_times: Dict[int, List[float]] = {}
        self._auto_done = not self._auto_dispatch
        self._inflight: Optional[Dict] = None      # the pipelined dispatch
        # a slot's occupancy epoch: a harvest touches a slot only while its
        # occupant is the one its dispatch ran (JAX :751-755)
        self._slot_epoch = np.zeros((b,), dtype=np.int64)
        self.dispatch_count = 0
        self.transfer_count = 0
        self._init_speculation(draft_params, draft_cfg, fuse_projections)
        # structured-output guides (JAX :711-718): every registered guide's
        # DFA rows stacked into two device tables (`_register_guide`)
        self._guides: Dict[str, Tuple[int, object]] = {}
        self._guide_allow_host: Optional[np.ndarray] = None
        self._guide_next_host: Optional[np.ndarray] = None
        self._guide_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._guided_host = np.zeros((b,), dtype=bool)
        self._top_k = self.runtime.emit_top_logprobs
        # a dispatch's output rows (`record_rows`) at the deepest dispatch,
        # the steps' row counter, and two host buffers for its transfer
        rmax = max(AUTO_LADDER[-1], self._steps_per_dispatch) * (
            self._spec_k + 1)
        cuda = self.device.type == "cuda"
        self._out = torch.zeros((2 * rmax + 3 + 2 * rmax * self._top_k, b),
                                dtype=torch.float64, device=self.device)
        self._row = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self._host = [torch.zeros(self._out.shape, dtype=torch.float64,
                                  pin_memory=cuda) for _ in range(2)]
        self._graphs = StepGraphs(self._rng) if cuda else None

    def _init_speculation(self, draft_params, draft_cfg,
                          fuse_projections: bool) -> None:
        """Speculative decoding state (JAX engine.py:731-821): the prompt
        lookup history, or the draft model and its cache; the counters."""
        b = self.runtime.max_batch_size
        self._spec_k = self.runtime.speculative_tokens
        self._history: Optional[torch.Tensor] = None
        self._draft = None           # (params, cfg) for draft-model drafting
        self._draft_caches = None
        # the last drafts and whole-window slots of the previous step, and
        # whether any window of the last harvested step was whole
        # (speculative.spec_decode_draft_core)
        self._draft_tail = None
        self._tail_due = False
        # forward-equivalents of one speculative step against one plain
        # decode step: 1 for prompt lookup, 1 + K * (draft bytes / target
        # bytes) with a draft model (decode streams the weights)
        self._spec_cost_ratio = 1.0
        if self._spec_k > 0:
            if self._spec_k + 1 >= min(self.runtime.prefill_buckets):
                raise ValueError(
                    "speculative_tokens must be smaller than the smallest "
                    "prefill bucket (stale window writes must be overwritten "
                    "by the next prefill)")
            if draft_params is not None:
                if draft_cfg is None:
                    raise ValueError("draft_params needs draft_cfg")
                if draft_cfg.vocab_size != self.cfg.vocab_size:
                    raise ValueError(
                        f"draft vocab {draft_cfg.vocab_size} != target "
                        f"vocab {self.cfg.vocab_size} (same tokenizer "
                        f"required)")
                if draft_params["embedding"].device.type != self.device.type:
                    raise ValueError(
                        f"draft params live on "
                        f"{draft_params['embedding'].device}, the engine "
                        f"runs on {self.device}")
                if fuse_projections:
                    draft_params = fuse_params(draft_params, draft_cfg)
                self._draft = (draft_params, draft_cfg)
                self._spec_cost_ratio = 1.0 + self._spec_k * (
                    param_nbytes(draft_params)
                    / max(param_nbytes(self.params), 1))
                self._draft_caches = self._new_draft_caches()
                self._draft_tail = (
                    torch.zeros((b,), dtype=torch.int32, device=self.device),
                    torch.zeros((b,), dtype=torch.bool, device=self.device))
            else:
                self._history = speculative.init_history(b, self.max_seq,
                                                         self.device)
        self.spec_steps = 0
        self.spec_emitted = 0
        # accepted tokens per non-empty window (index 1..K+1): feeds the
        # auto-disable policy and the scheduler's stats
        self.spec_accept_hist = np.zeros((self._spec_k + 2,), dtype=np.int64)
        self.spec_disabled = False

    def _new_draft_caches(self):
        """The draft model's contiguous cache, in the target's store."""
        dcfg = self._draft[1]
        return kvcache.init_cache(
            dcfg.num_layers, self.runtime.max_batch_size, self.max_seq,
            dcfg.kv_heads, dcfg.dim_head, dtype=self.act_dtype,
            kv_cache_dtype=self.kv_cache_dtype, device=self.device)

    @property
    def spec_mean_accepted(self) -> float:
        """Mean tokens emitted per speculative step, over all slots."""
        return self.spec_emitted / max(self.spec_steps, 1)

    @property
    def spec_window_mean(self) -> float:
        """Mean accepted tokens per non-empty speculative window (a slot's
        window), 0 before the first."""
        total = int(self.spec_accept_hist.sum())
        if total == 0:
            return 0.0
        counts = np.arange(self.spec_accept_hist.shape[0])
        return float((self.spec_accept_hist * counts).sum() / total)

    @property
    def kv_nbytes(self) -> int:
        """Device bytes of the KV caches (stores, scales, page table)."""
        if self.scan_layers:
            return kvcache_stacked.nbytes(self.caches)
        return kvcache.nbytes(self.caches)

    def _new_caches(self):
        """Zeroed caches of the engine's layout; on the paged layout also a
        fresh allocator and host table (the JAX engine's init :635-665)."""
        cfg, b = self.cfg, self.runtime.max_batch_size
        if self.scan_layers:
            return kvcache_stacked.init_cache(
                cfg.num_layers, b, self.max_seq, cfg.kv_heads, cfg.dim_head,
                dtype=self.act_dtype, kv_cache_dtype=self.kv_cache_dtype,
                device=self.device)
        if self.kv_layout != "paged":
            return kvcache.init_cache(
                cfg.num_layers, b, self.max_seq, cfg.kv_heads, cfg.dim_head,
                dtype=self.act_dtype, kv_cache_dtype=self.kv_cache_dtype,
                kv_kt=kvcache.kt_auto(self.kv_cache_dtype, cfg.kv_heads,
                                      cfg.dim_head),
                device=self.device)
        ps = self.runtime.kv_page_size
        if self.max_seq % ps or self.runtime.prefill_chunk_size % ps:
            raise ValueError(
                f"max_seq {self.max_seq} and prefill_chunk_size must be "
                f"multiples of kv_page_size {ps}")
        max_pages = self.max_seq // ps
        pages = self.kv_total_pages or (b * max_pages + 1)
        alloc_cls = (kvcache_paged.PrefixCachingAllocator
                     if self.runtime.enable_prefix_cache
                     else kvcache_paged.PageAllocator)
        self._page_alloc = alloc_cls(pages, b, max_pages)
        self._table_host = np.zeros((b, max_pages), dtype=np.int32)
        return kvcache_paged.init_paged_cache(
            cfg.num_layers, b, self.max_seq, cfg.kv_heads, cfg.dim_head,
            page_size=ps, total_pages=pages, dtype=self.act_dtype,
            kv_cache_dtype=self.kv_cache_dtype, device=self.device)

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
        """Slots in chunked prefill, in admission order."""
        return list(self._prefilling)

    @property
    def prefix_cache_stats(self) -> Dict[str, int]:
        """{hits, hit_tokens, cached_pages}, zeros when prefix caching is
        off; cached_pages counts on the paged layout only."""
        a = self._page_alloc
        if a is not None and hasattr(a, "hits"):
            return {"hits": a.hits, "hit_tokens": a.hit_tokens,
                    "cached_pages": a.cached_pages}
        if self._prefix_idx is not None:
            return {"hits": self._prefix_idx.hits,
                    "hit_tokens": self._prefix_idx.hit_tokens,
                    "cached_pages": 0}
        return {"hits": 0, "hit_tokens": 0, "cached_pages": 0}

    def _bucket(self, n: int) -> int:
        for b in self.runtime.prefill_buckets:
            if n <= b and b <= self.max_seq:
                return b
        return self.max_seq

    def add_request(self, token_ids: Sequence[int], gen: GenerationConfig, *,
                    request_id: str = "") -> int:
        """Prefill a prompt into a free slot (all its chunks, for a long
        one); returns the slot index. Raises RuntimeError when no slot is
        free, NoFreePages when the page pool cannot cover it."""
        slot = self.begin_request(token_ids, gen, request_id=request_id)
        while slot in self._prefilling:
            self.continue_prefill(slot)
        return slot

    def begin_request(self, token_ids: Sequence[int], gen: GenerationConfig,
                      *, request_id: str = "") -> int:
        """Reserve a slot and start prefill: a short prompt prefills now
        (or at the end of a deferred-admission round, batched with the
        round's other prompts of the same bucket); a long one, or a
        prefix-cache hit, enters chunked prefill, driven one chunk at a time
        by `continue_prefill` (JAX engine.py:900-998)."""
        gen.validate()
        if gen.guide is not None:
            # a guide of another vocabulary raises here, before a slot is
            # taken (registration is idempotent: activation finds it)
            self._register_guide(gen.guide)
            if gen.min_tokens:
                # min_tokens suppresses EOS, which can conflict with an
                # accept-only DFA state: the guide decides termination
                # (JAX :897-904)
                gen = dataclasses.replace(gen, min_tokens=0)
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
        matched = 0
        if self._prefix_idx is not None:
            src, matched = self._prefix_idx.match(token_ids, exclude=-1)
            if matched and src == slot:
                # don't clobber the source: prefer another free slot
                alt = [s for s in free if s != src]
                if alt:
                    slot = alt[0]
                else:
                    matched = 0
            # this slot's rows are about to be overwritten: never a source
            self._prefix_idx.invalidate(slot)
            if matched:
                if self.scan_layers:
                    kvcache_stacked.copy_prefix(self.caches, src, slot,
                                                matched)
                else:
                    for cache in self.caches:
                        kvcache.copy_prefix(cache, src, slot, matched)
                self._prefix_idx.record_hit(matched)
        if self._page_alloc is not None:
            ps = self.runtime.kv_page_size
            if self.runtime.enable_prefix_cache:
                # map shared pages for the longest cached full-page prefix;
                # the suffix prefills in chunks from `matched`, so shared
                # pages are never rewritten
                matched = self._page_alloc.match_prefix(
                    self._table_host, slot, token_ids, ps)
            if self.runtime.kv_reserve == "lazy":
                # prompt + slack (+ a window's overrun); grown page by page
                # before decode steps
                budget = min(n + self.runtime.kv_lazy_slack + self._spec_k,
                             self.max_seq)
            else:
                # the whole token budget (a speculative window writes up to
                # K rows past the last accepted token), and the padded
                # prompt write
                budget = min(n + gen.max_tokens + 1 + self._spec_k,
                             self.max_seq)
                budget = max(budget, self._bucket(n))
            if not self._page_alloc.ensure(self._table_host, slot, budget, ps):
                # ensure() is not transactional: release the partial
                # allocation, or the empty slot strands pages
                self._page_alloc.release(self._table_host, slot)
                raise NoFreePages(
                    f"no free KV pages ({self._page_alloc.free_pages} left, "
                    f"need {-(-budget // ps)})")
            self._sync_table()
        self._slots[slot] = SlotResult(request_id=request_id, prompt_len=n,
                                       start_time=t0)
        if n - matched > self.runtime.prefill_chunk_size or matched:
            # a new occupant: a dispatch in flight must not harvest it
            self._slot_epoch[slot] += 1
            self._prefilling[slot] = _PendingPrefill(
                ids=np.asarray(token_ids, dtype=np.int32), gen=gen,
                request_id=request_id, pos=matched)
            return slot
        item = {"slot": slot, "ids": list(token_ids), "n": n, "gen": gen,
                "rid": request_id, "t0": t0, "bucket": self._bucket(n)}
        if (self._defer_admission and self.runtime.batched_admission
                and self._page_alloc is None and self._draft is None):
            self._slot_epoch[slot] += 1
            self._pending_batch.append(item)
            return slot
        self._prefill_group([item])
        return slot

    def continue_prefill(self, slot: int) -> bool:
        """Run one prefill chunk of a reserved slot; returns True when the
        prompt is fully prefilled (the slot is then active in the decode
        batch). JAX engine.py:1010-1038."""
        pp = self._prefilling[slot]
        chunk = self.runtime.prefill_chunk_size
        n = len(pp.ids)
        piece = pp.ids[pp.pos:pp.pos + chunk]
        c_ids = np.zeros((chunk,), dtype=np.int64)
        c_ids[:len(piece)] = piece
        fwd = (forward_prefill_chunk_scan if self.scan_layers
               else forward_prefill_chunk)
        with torch.no_grad():
            last, _ = fwd(
                self.params, self.cfg, torch.from_numpy(c_ids).to(self.device),
                self.caches, slot, pp.pos, dtype=self.act_dtype,
                logits_at=len(piece) - 1)
        pp.pos += len(piece)
        if pp.pos < n:
            return False
        del self._prefilling[slot]
        self._activate_slot({"slot": slot, "ids": pp.ids.tolist(), "n": n,
                             "gen": pp.gen, "rid": pp.request_id}, last)
        return True

    def _prefill_group(self, items: List[Dict], rows: int = 0) -> None:
        """Prefill prompts of one bucket as one batch of `rows` (default
        len(items); padding rows hold id 0 and length 1) and one prompt on
        the paged layout, write their K/V into their slots and activate
        them."""
        bucket = items[0]["bucket"]
        rows = max(rows, len(items))
        ids = np.zeros((rows, bucket), dtype=np.int64)
        lens = np.ones((rows,), dtype=np.int64)
        for i, it in enumerate(items):
            ids[i, :it["n"]] = it["ids"]
            lens[i] = it["n"]
        # the group's slots, checked once on the host (write_prompts then
        # reads nothing back)
        in_range = all(0 <= it["slot"] < self.num_slots for it in items)
        dev = self.device
        lengths = torch.from_numpy(lens).to(dev)
        n = len(items)
        # padding rows go to slot B, which the stacked cache's scatter drops
        slots = torch.tensor([it["slot"] for it in items]
                             + [self.num_slots] * (rows - n), device=dev)
        with torch.no_grad():
            if self.scan_layers:
                _, last = forward_prefill_scan_batch(
                    self.params, self.cfg, torch.from_numpy(ids).to(dev),
                    lengths, slots, self.caches, dtype=self.act_dtype)
            else:
                last, kv = forward_prefill(
                    self.params, self.cfg, torch.from_numpy(ids).to(dev),
                    lengths, dtype=self.act_dtype, logits_at=lengths - 1)
                for cache, (k, v) in zip(self.caches, kv):
                    if self._page_alloc is not None:
                        kvcache.write_prompt(cache, k[0], v[0],
                                             items[0]["slot"])
                    else:
                        kvcache.write_prompts(cache, k[:n], v[:n],
                                              slots[:n], in_range=in_range)
        for i, it in enumerate(items):
            self._activate_slot(it, last[i])

    def _flush_batch_prefills(self) -> None:
        """The round's prompts, one batch per bucket. An MoE model's go in
        batches of at most 8 padded to a power of two rows, as the JAX
        engine batches them (engine.py:1209-1221): a forward's token count
        b·s, which picks an MoE layer's branch, is then the JAX engine's.
        A dense model's rows do not depend on their batch, so it pads
        none."""
        pend, self._pending_batch = self._pending_batch, []
        groups: Dict[int, List[Dict]] = {}
        for it in pend:
            res = self._slots[it["slot"]]
            if res is None or res.request_id != it["rid"]:
                continue                      # cancelled while pending
            groups.setdefault(it["bucket"], []).append(it)
        for bucket in sorted(groups):
            items = groups[bucket]
            while items:
                rows = len(items)
                if self.cfg.num_experts:
                    rows = 1
                    while rows < min(len(items), 8):
                        rows *= 2
                take, items = items[:rows], items[rows:]
                try:
                    self._prefill_group(take, rows)
                except Exception:
                    # free the bucket's reserved, not yet active slots
                    for it in take + items:
                        res = self._slots[it["slot"]]
                        if res is not None and res.request_id == it["rid"]:
                            self._slots[it["slot"]] = None
                            self._slot_epoch[it["slot"]] += 1
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
        guide = gen.guide
        g_offset = self._register_guide(guide) if guide is not None else 0
        if guide is not None:
            # the initial state's mask (JAX `_first_token_core` :474-475)
            row0 = self._guide_tables[0][g_offset]
            adj = torch.where(row0, adj, torch.full((), NEG_INF, device=dev))
        temp = gen.temperature if gen.do_sample else 0.0
        penalties = (gen.repetition_penalty != 1.0 or gen.presence_penalty
                     or gen.frequency_penalty)
        with torch.no_grad():
            tok = sample(adj[None], sp1, rng,
                         token_counts=counts if penalties else None,
                         any_sampled=temp > 0)
            lp = logprobs_of(last_logits[None], tok)
            if self._top_k:
                # over the raw prefill logits, as JAX's first token (:479-482)
                tv, ti = top_logprobs(last_logits[None], self._top_k)
        counts[0, tok.long()] += 1
        first = int(tok[0])
        g_state = -1
        if guide is not None:
            # the DFA walks the first token on the host (JAX :1127-1131)
            vt = guide.allow.shape[1]
            if first < vt and guide.allow[0, first]:
                g_state = g_offset + int(guide.next_state[0, first])
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
        st.guide_state[slot] = g_state
        st.sampling.set_row(slot, sp1)
        self._guided_host[slot] = g_state >= 0
        self._temp_host[slot] = temp
        self._penalty_host[slot] = bool(penalties)
        self._active_host[slot] = True
        self._lengths_host[slot] = n
        self._slot_epoch[slot] += 1
        if self._page_alloc is not None and self.runtime.enable_prefix_cache:
            self._page_alloc.register_prefix(slot, it["ids"],
                                             self.runtime.kv_page_size)
        if self._prefix_idx is not None:
            self._prefix_idx.register(slot, it["ids"])
        if self._history is not None:
            # the prompt-lookup history row: the prompt, then the first token
            row = torch.zeros((self._history.shape[1],), dtype=torch.int32)
            row[:n] = torch.as_tensor(it["ids"], dtype=torch.int32)
            self._history[slot] = row.to(dev)
            self._history[slot, n] = tok[0]
        if self._draft is not None:
            self._prefill_draft(slot, it["ids"])
            self._draft_tail[1][slot] = False         # a new occupant
        res = self._slots[slot]
        res.prompt_len = n
        res.max_tokens = gen.max_tokens
        res.stop_token_ids = tuple(gen.stop_token_ids)
        res.guided = guide is not None
        res.first_token_time = time.perf_counter()
        res.token_ids.append(first)
        res.logprobs.append(float(lp[0]))
        if self._top_k:
            res.top_tokens.append([(int(i), float(v)) for i, v in
                                   zip(ti[0].tolist(), tv[0].tolist())])
        hit_stop = first == eos or first in gen.stop_token_ids
        if (hit_stop and gen.min_tokens < 1) or gen.max_tokens <= 1:
            st.active[slot] = False
            res.stop_reason = "eos" if hit_stop else "max_tokens"
            self._retire(slot)

    def _prefill_draft(self, slot: int, ids: Sequence[int]) -> None:
        """The draft model prefills the whole prompt into its own cache,
        padded to its bucket (JAX engine.py:1172-1183), also after a
        chunked target prefill; its logits are not used."""
        dparams, dcfg = self._draft
        n = len(ids)
        padded = np.zeros((1, self._bucket(n)), dtype=np.int64)
        padded[0, :n] = ids
        dev = self.device
        with torch.no_grad():
            _, kv = forward_prefill(
                dparams, dcfg, torch.from_numpy(padded).to(dev),
                torch.tensor([n], device=dev), dtype=self.act_dtype,
                logits_at=torch.tensor([n - 1], device=dev))
            for cache, (k, v) in zip(self._draft_caches, kv):
                kvcache.write_prompt(cache, k[0], v[0], slot)

    def _register_guide(self, guide) -> int:
        """Append a compiled guide's (allow, next_state) rows to the stacked
        tables and return its row offset (JAX :1347-1397). Idempotent per
        grammar (keyed on the guide's key). The EOS column is rewritten
        from the DFA's accept states; ids past the guide's vocabulary (a
        padded model vocabulary) are never allowed. The tables are
        rebuilt, so the captured graph variants that read them (the guided
        ones) are dropped and captured anew at their next use; no other
        variant reads them."""
        key = guide.key or str(id(guide))
        hit = self._guides.get(key)
        if hit is not None:
            return hit[0]
        v = self.cfg.vocab_size
        s, vt = guide.allow.shape
        if vt > v:
            raise ValueError(
                f"guide vocab {vt} exceeds model vocab {v}: compile the "
                "guide with the model's tokenizer")
        offset = 0 if self._guide_allow_host is None else len(
            self._guide_allow_host)
        allow = np.zeros((s, v), dtype=bool)
        allow[:, :vt] = guide.allow
        nxt = np.zeros((s, v), dtype=np.int32)
        nxt[:, :vt] = guide.next_state.astype(np.int32) + offset
        eos = self.eos_token_id if self.eos_token_id is not None else -1
        if 0 <= eos < v:
            allow[:, eos] = guide.eos_allowed
            nxt[:, eos] = offset        # unused: the slot retires on EOS
        if self._guide_allow_host is not None:
            allow = np.concatenate([self._guide_allow_host, allow])
            nxt = np.concatenate([self._guide_next_host, nxt])
        self._guide_allow_host, self._guide_next_host = allow, nxt
        if self._graphs is not None:
            self._graphs.drop(lambda k: k[-2])
        self._guide_tables = (torch.from_numpy(allow).to(self.device),
                              torch.from_numpy(nxt).to(self.device))
        self._guides[key] = (offset, guide)
        return offset

    def synchronize(self) -> None:
        """Wait for the work queued on the card (a prefill chunk returns
        before its kernels end), so that a span timed after it holds only
        its own work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- decode -------------------------------------------------------------
    def step(self) -> Dict[int, List[int]]:
        """Run one decode dispatch (N steps of every active slot, N =
        `decode_steps_per_dispatch`; speculative steps with
        speculative_tokens > 0) and harvest it; returns {slot: [tokens]}.
        Retires finished slots (EOS / stop id / max_tokens / cache full).

        Pipelined (JAX engine.py:1512-1560: plain decode, no lazy paging,
        the auto depth settled, `pipelined_dispatch`): dispatch n + 1 is
        enqueued before dispatch n is harvested, so the harvest's wait
        overlaps the next dispatch's device work. The device state is
        always current; the host's bookkeeping runs one dispatch behind,
        at the cost of at most one wasted dispatch when the batch
        drains."""
        if not self._active_host.any():
            if self._inflight is not None:
                # the final harvest: the batch went idle with a dispatch
                # in flight
                h, self._inflight = self._inflight, None
                return self._harvest(h)
            return {}
        lazy = (self._page_alloc is not None
                and self.runtime.kv_reserve == "lazy")
        pipelined = (self._spec_k == 0 and not lazy and self._auto_done
                     and self.runtime.pipelined_dispatch)
        if pipelined:
            h_new = self._dispatch()
            prev, self._inflight = self._inflight, h_new
            if prev is None:
                # prime the pipeline: one more dispatch in flight, then
                # the first one's tokens
                self._inflight = self._dispatch()
                return self._harvest(h_new)
            out = self._harvest(prev)
            if not out and self._active_host.any():
                # the harvested dispatch predates every live occupant:
                # harvest the fresh one too, so that a step with active
                # requests returns tokens
                h, self._inflight = self._inflight, self._dispatch()
                out = self._harvest(h)
            return out
        if self._inflight is not None:     # the mode switched
            h, self._inflight = self._inflight, None
            out = self._harvest(h)
            if out:
                return out
        if lazy:
            self._grow_pages()
            if not self._active_host.any():
                return {}
        t0 = time.perf_counter()
        out = self._harvest(self._dispatch())
        if not self._auto_done:
            self._auto_observe(time.perf_counter() - t0)
        return out

    def _need_penalties(self) -> bool:
        return bool(self._penalty_host[self._active_host].any())

    def _variant(self, first: bool) -> tuple:
        """The host branches of a dispatch's next step, as a key: ("plain",
        penalties, any sampled slot), ("lookup", K, penalties) or
        ("draft", K, penalties, tail), then #3's int8-dot switch
        (`int8_dots_switch`, read at each call as JAX reads it at trace
        time), whether an active slot is guided (only then does the step
        read the guide tables) and the top-k width. A draft dispatch's
        first step writes the tail when the last harvested step held a
        whole window; its later steps always run it, the mask choosing the
        slots."""
        pen = self._need_penalties()
        tail = (int8_dots_switch(),
                bool(self._guided_host[self._active_host].any()), self._top_k)
        if self._spec_k == 0:
            return ("plain", pen,
                    bool((self._temp_host[self._active_host] > 0).any())
                    ) + tail
        if self._draft is None:
            return ("lookup", self._spec_k, pen) + tail
        return ("draft", self._spec_k, pen, self._tail_due or not first
                ) + tail

    def _run_step(self, key: tuple, st: DecodeState, out: torch.Tensor,
                  row: torch.Tensor, history, tail) -> None:
        """Variant `key` of one step, over the engine's caches and the
        given state, output rows, history and draft tail (in place)."""
        tables = self._guide_tables if key[-2] else None
        top_k = key[-1]
        if key[0] == "plain":
            decode_step(self.params, self.cfg, self.caches, st, out, row,
                        scan=self.scan_layers, max_seq=self.max_seq,
                        dtype=self.act_dtype, need_pen=key[1],
                        any_sampled=key[2], generator=self._rng,
                        guide_tables=tables, top_k=top_k)
            return
        common = dict(k_draft=key[1], max_cache_len=self.max_seq,
                      generator=self._rng, penalties=key[2],
                      dtype=self.act_dtype, guide_tables=tables,
                      top_k_out=top_k)
        if key[0] == "lookup":
            got = speculative.spec_decode_core(
                self.params, self.cfg, self.caches, st, history,
                ngram=self.runtime.speculative_ngram, **common)
            emitted, lps = got[1], got[2]
        else:
            got = speculative.spec_decode_draft_core(
                self.params, self._draft[0], self.cfg, self._draft[1],
                self.caches, self._draft_caches, st,
                tail=tail if key[3] else None, **common)
            emitted, lps, last = got[2], got[3], got[4]
            tail[0].copy_(last[0])
            tail[1].copy_(last[1])
        topk = None
        if top_k:
            topk = tuple(a.transpose(0, 1) for a in got[-1])   # (T, B, k)
        record_rows(out, row, emitted.t(), lps.t(), st, topk)

    def _dispatch(self) -> Dict:
        """Enqueue one dispatch of N steps and its host transfer; returns
        the handle its harvest reads. On the card each step replays its
        variant's CUDA graph, and the rows go to a pinned buffer of two
        (one dispatch may fly while the other is read) behind an event;
        on the CPU the steps run eagerly."""
        n = self._steps_per_dispatch
        t = self._spec_k + 1
        runs = [(self._variant(True), 1)]
        if n > 1:
            runs.append((self._variant(False), n - 1))
        self.dispatch_count += 1
        self._row.zero_()
        with torch.no_grad():
            for key, reps in runs:
                if self._graphs is not None:
                    self._replay(key, reps)
                    continue
                for _ in range(reps):
                    self._run_step(key, self.state, self._out, self._row,
                                   self._history, self._draft_tail)
        host = self._host[self.dispatch_count % 2]
        host.copy_(self._out, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        self.steps += n
        if t > 1:
            self.spec_steps += n
        return {"host": host, "event": event, "rows": n * t, "t": t,
                "epoch": self._slot_epoch.copy()}

    def _replay(self, key: tuple, n: int) -> None:
        """Variant `key` n times as CUDA graph replays (runtime/graphs.py;
        captured at its first use, after one run on copies of the state,
        the output rows, the history and the draft tail)."""
        def run():
            self._run_step(key, self.state, self._out, self._row,
                           self._history, self._draft_tail)

        def warm():
            tail = self._draft_tail
            self._run_step(
                key, clone_state(self.state), self._out.clone(),
                self._row.clone(),
                None if self._history is None else self._history.clone(),
                None if tail is None else (tail[0].clone(), tail[1].clone()))

        self._graphs.replay(key, run, warm, n)

    def _spec_observe(self, emitted_np: np.ndarray, t: int) -> None:
        """Acceptance counters of one speculative dispatch (its rows
        (N·T, B), ordered (step, window position)) and the auto-disable
        policy (JAX engine.py:1668-1691): below the break-even window mean
        (speculative_min_accepted, times a draft model's cost ratio) after
        speculative_probe_steps windows, fall back to plain decode."""
        valid = emitted_np >= 0
        self.spec_emitted += int(valid.sum())
        wins = valid.reshape(-1, t, valid.shape[1]).sum(axis=1)   # (N, B)
        self._tail_due = bool((wins[-1] == t).any())
        np.add.at(self.spec_accept_hist, np.clip(wins[wins > 0], 0, t), 1)
        thresh = self.runtime.speculative_min_accepted * self._spec_cost_ratio
        if (thresh > 0 and self.spec_accept_hist.sum()
                >= self.runtime.speculative_probe_steps
                and self.spec_window_mean < thresh):
            # rows past each slot's length are never read, so the stale
            # window writes need no cleanup
            self._spec_k = 0
            self.spec_disabled = True

    def _harvest(self, h: Dict) -> Dict[int, List[int]]:
        """Host bookkeeping of one dispatch from its one transfer
        (`record_rows`' layout): emissions in order, stop ids (a stop id
        cuts the tokens after it), retires, speculative counters. A slot
        whose occupant changed since the dispatch (its epoch) is left to
        a later harvest, and keeps its current host mirror (JAX
        engine.py:1642-1770)."""
        if h["event"] is not None:
            h["event"].synchronize()
        got = h["host"].numpy()
        self.transfer_count += 1
        k = self._top_k
        r, rmax = h["rows"], (got.shape[0] - 3) // (2 + 2 * k)
        emitted_np = got[:r].astype(np.int64)
        lp_np = got[rmax:rmax + r]
        active_np = got[2 * rmax] > 0.5
        lengths_np = got[2 * rmax + 1].astype(np.int64)
        eos_np = got[2 * rmax + 2].astype(np.int64)
        if k:
            base = 2 * rmax + 3
            top_v = got[base:base + r * k].reshape(r, k, -1)
            top_i = got[base + rmax * k:base + rmax * k + r * k].reshape(
                r, k, -1).astype(np.int64)
        if h["t"] > 1:
            self._spec_observe(emitted_np, h["t"])
        epoch = h["epoch"]
        fresh = epoch == self._slot_epoch
        if not fresh.all():
            active_np = np.where(fresh, active_np, self._active_host)
            lengths_np = np.where(fresh, lengths_np, self._lengths_host)
        self._lengths_host = lengths_np
        self._active_host = active_np.copy()
        out: Dict[int, List[int]] = {}
        for slot in range(len(self._slots)):
            res = self._slots[slot]
            if res is None or not fresh[slot]:
                continue
            keep = emitted_np[:, slot] >= 0
            if not keep.any():
                if not active_np[slot] and slot not in self._prefilling:
                    # deactivated without a token: a guided slot reached an
                    # accept-only DFA state with no EOS id (JAX :1716-1722)
                    res.stop_reason = res.stop_reason or (
                        "guide_complete" if res.guided else "max_tokens")
                    self._retire(slot)
                continue
            toks = [int(t) for t in emitted_np[keep, slot]]
            lps = [float(x) for x in lp_np[keep, slot]]
            tops = []
            if k:
                tops = [[(int(i), float(v)) for i, v in
                         zip(top_i[row, :, slot], top_v[row, :, slot])]
                        for row in np.flatnonzero(keep)]
            stop = next((i for i, t in enumerate(toks)
                         if t in res.stop_token_ids), None)
            if stop is not None and (active_np[slot] or stop < len(toks) - 1):
                # the device tracks one EOS id; the others stop here, and
                # cut the tokens, logprobs and top tokens after them
                toks, lps = toks[:stop + 1], lps[:stop + 1]
                tops = tops[:stop + 1]
                self.state.active[slot] = False
                active_np[slot] = False
                res.stop_reason = "eos"
            res.token_ids.extend(toks)
            res.logprobs.extend(lps)
            res.top_tokens.extend(tops)
            out[slot] = toks
            cache_full = lengths_np[slot] >= self.max_seq - 1
            if not active_np[slot] or cache_full:
                if cache_full and active_np[slot]:
                    self.state.active[slot] = False
                    res.stop_reason = res.stop_reason or "max_seq"
                elif toks[-1] == eos_np[slot]:
                    res.stop_reason = res.stop_reason or "eos"
                elif cache_full:
                    res.stop_reason = res.stop_reason or "max_seq"
                elif (res.guided and res.max_tokens
                      and len(res.token_ids) < res.max_tokens):
                    # deactivated short of max_tokens without EOS: the DFA
                    # reached an accept-only state inside a speculative
                    # window (JAX :1761-1766)
                    res.stop_reason = res.stop_reason or "guide_complete"
                else:
                    res.stop_reason = res.stop_reason or "max_tokens"
                self._retire(slot)
        return out

    def _auto_observe(self, dt: float) -> None:
        """The auto dispatch depth (`decode_steps_per_dispatch` = 0; JAX
        engine.py:1772-1797): 7 dispatches at 4 steps, then 7 at 12; from
        the fastest of each but the first, the step time s and the fixed
        cost D a dispatch; the ladder depth nearest the one that keeps D
        under 8% of the device time, at most 100 ms of steps and 32."""
        n = self._steps_per_dispatch
        times = self._auto_times.setdefault(n, [])
        times.append(dt)
        probe = 7                      # the first sample is dropped
        if n == 4 and len(times) >= probe:
            self._steps_per_dispatch = 12
        elif n == 12 and len(times) >= probe:
            t4 = min(self._auto_times[4][1:])
            t12 = min(times[1:])
            step_s = max((t12 - t4) / 8.0, 1e-6)
            fixed = max(t4 - 4.0 * step_s, 0.0)
            want = fixed / (0.08 * step_s)
            cap = 0.1 / step_s
            n_star = max(1.0, min(want, cap, 32.0))
            self._steps_per_dispatch = min(AUTO_LADDER,
                                           key=lambda x: abs(x - n_star))
            self._auto_done = True

    def _grow_pages(self) -> None:
        """Lazy paged mode: before each decode step, extend every active
        slot's pages to cover the step; when the pool is exhausted, preempt
        the youngest other request (old requests never starve). A slot that
        cannot grow and has no victim stops at its current length
        (stop_reason "kv_pages"). JAX engine.py:1799-1834: a dispatch of N
        steps grows N rows ahead; a speculative step writes K + 1 rows and
        may overrun by K, so N of them grow N (K + 1) + K rows ahead."""
        ps = self.runtime.kv_page_size
        alloc = self._page_alloc
        shared = getattr(alloc, "shared_per_slot", None)
        steps = self._steps_per_dispatch
        if self._spec_k:
            steps = steps * (self._spec_k + 1) + self._spec_k
        changed = False
        for slot in range(self.num_slots):
            res = self._slots[slot]
            if res is None or slot in self._prefilling:
                continue
            needed = min(int(self._lengths_host[slot]) + steps + 1,
                         self.max_seq)
            have_pages = len(alloc.per_slot[slot]) + (
                len(shared[slot]) if shared else 0)
            if needed <= have_pages * ps:
                continue
            while not alloc.ensure(self._table_host, slot, needed, ps):
                victim = self._pick_victim(exclude=slot)
                if victim is None:
                    self.state.active[slot] = False
                    res.stop_reason = "kv_pages"
                    self._retire(slot)
                    break
                self.preempt(victim)
            else:
                changed = True
        if changed:
            self._sync_table()

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """The youngest other request, slots in chunked prefill included
        (they are typically the youngest and release their pages
        cleanly)."""
        best, best_t = None, -1.0
        for slot, res in enumerate(self._slots):
            if res is None or slot == exclude:
                continue
            if res.start_time > best_t:
                best, best_t = slot, res.start_time
        return best

    def preempt(self, slot: int) -> None:
        """Evict a request under page-pool pressure: deactivate it, release
        its pages and surface it through pop_finished with stop_reason
        "preempted"; the scheduler requeues it and generation resumes by
        prefilling prompt + generated prefix."""
        if self._slots[slot] is None:
            return
        self._prefilling.pop(slot, None)
        self.state.active[slot] = False
        self._slots[slot].stop_reason = "preempted"
        self._retire(slot)

    def cancel(self, slot: int) -> None:
        """Cancel a running request."""
        if self._slots[slot] is None:
            return
        self._prefilling.pop(slot, None)
        self.state.active[slot] = False
        self._slots[slot].stop_reason = "cancelled"
        self._retire(slot)

    def _sync_table(self) -> None:
        kvcache_paged.with_table(self.caches, self._table_host)

    def _retire(self, slot: int) -> None:
        res = self._slots[slot]
        res.end_time = time.perf_counter()
        self._finished.append(res)
        self._slots[slot] = None
        self._active_host[slot] = False
        self._lengths_host[slot] = 0
        self._temp_host[slot] = 0.0
        self._penalty_host[slot] = False
        self._guided_host[slot] = False
        # occupancy changed: a dispatch in flight neither touches this slot
        # nor brings back its active / length mirror
        self._slot_epoch[slot] += 1
        self.state.lengths[slot] = 0
        if self._prefix_idx is not None and len(res.token_ids) > 1:
            # rows [n, n + g - 1) hold the generated tokens but the last
            # (never fed back): extend the resident claim for reuse
            self._prefix_idx.extend(slot, res.token_ids[:-1])
        if self._page_alloc is not None:
            self._page_alloc.release(self._table_host, slot)
            self._sync_table()

    def pop_finished(self) -> List[SlotResult]:
        done, self._finished = self._finished, []
        return done

    def reset(self) -> None:
        """Drop all in-flight state: fresh caches (and page pool, draft
        cache, drafting history) and decode state, slots freed, the
        dispatch in flight and the captured graphs dropped, speculative
        counters cleared (the scheduler's failure recovery)."""
        b = self.num_slots
        self._inflight = None
        if self._graphs is not None:
            # the graphs hold the old caches' and state's addresses
            self._graphs = StepGraphs(self._rng)
        self.caches = self._new_caches()
        self.state = init_state(b, self.cfg.vocab_size, self.device)
        self._active_host = np.zeros((b,), dtype=bool)
        self._lengths_host = np.zeros((b,), dtype=np.int64)
        self._temp_host = np.zeros((b,), dtype=np.float32)
        self._penalty_host = np.zeros((b,), dtype=bool)
        self._guided_host = np.zeros((b,), dtype=bool)
        self._slots = [None] * b
        self._finished = []
        self._pending_batch = []
        self._prefilling = {}
        if self._prefix_idx is not None:
            self._prefix_idx = SlotPrefixIndex(b)   # fresh caches: no residents
        if self._history is not None:
            self._history = speculative.init_history(b, self.max_seq,
                                                     self.device)
        if self._draft is not None:
            self._draft_caches = self._new_draft_caches()
        if self._draft_tail is not None:
            self._draft_tail[1].zero_()
        self._tail_due = False
        self.spec_steps = 0
        self.spec_emitted = 0
        self.spec_accept_hist = np.zeros_like(self.spec_accept_hist)

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
