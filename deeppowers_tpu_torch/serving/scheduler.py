"""Continuous-batching scheduler, ported from
deeppowers_tpu/serving/scheduler.py (host-only).

One daemon thread drives the engine: admission between decode steps
(batched through engine.deferred_admission), one chunk of a chunked
prefill per loop turn interleaved with decode (JAX :171-176), per-request
streaming with incremental detokenization and stop-string scanning,
admission control (queue capacity + max active), requeueing on an
exhausted page pool (NoFreePages, :292-297), resumption of preempted
requests from prompt + generated prefix, their logprobs and top tokens
(:273-285, :368-415), and failure recovery (reset the engine and requeue
in-flight requests; fail them after repeated failures). `tokenizer` and
`model_name` are what the server reads for chat templates, structured
output and /v1/models.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from ..config import SchedulerConfig
from ..runtime.engine import InferenceEngine, NoFreePages, SlotResult
from .metrics import Monitor
from .queue import QueueFullError, RequestQueue
from .request import Request, RequestStatus, Span


class Scheduler:
    def __init__(self, engine: InferenceEngine, *,
                 encode: Callable[[str], List[int]],
                 decode: Callable[[List[int]], str],
                 config: Optional[SchedulerConfig] = None,
                 monitor: Optional[Monitor] = None, tokenizer=None,
                 model_name: str = "deeppowers"):
        self.engine = engine
        self.encode = encode
        self.decode = decode
        #: read by the server: chat templates and structured-output guides
        #: need the tokenizer; /v1/models names the model (JAX sets both on
        #: the scheduler, examples/serve.py:163-164)
        self.tokenizer = tokenizer
        self.model_name = model_name
        self.config = config or SchedulerConfig()
        self.monitor = monitor or Monitor()
        self.queue = RequestQueue(self.config.max_queue_size)
        self._by_slot: Dict[int, Request] = {}
        self._emitted_text: Dict[int, str] = {}
        self._held: Dict[int, bool] = {}
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._hold_t0 = None
        self._pending_cancels: List = []
        self._consecutive_failures = 0
        self.dropped_requests = 0
        self.recovered_requests = 0
        self.preempted_requests = 0
        #: traceback text of the last engine failure the loop recovered from
        self.last_error: Optional[str] = None

    # -- public API ---------------------------------------------------------
    def start(self) -> None:
        if self._running:
            return
        self._running = True
        self.monitor.start_sampling()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="deeppowers-scheduler")
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        self._running = False
        self._wake.set()
        if self._thread:
            self._thread.join(timeout)
            self._thread = None
        self.monitor.stop_sampling()

    def submit(self, request: Request) -> Request:
        """Enqueue with admission control."""
        if self.config.enable_admission_control:
            total = len(self.queue) + self.engine.active_requests
            if total >= self.config.max_active_requests:
                self.dropped_requests += 1
                request.mark_failed("admission rejected: at capacity")
                self.monitor.record_request(0, error="admission_reject")
                return request
        try:
            self.queue.enqueue(request)
        except QueueFullError as e:
            self.dropped_requests += 1
            request.mark_failed(str(e))
            self.monitor.record_request(0, error="queue_full")
            return request
        self.monitor.queue_depth = len(self.queue)
        self._wake.set()
        return request

    def submit_sync(self, request: Request,
                    timeout: Optional[float] = None) -> Request:
        """Blocking submit."""
        self.submit(request)
        if request.status == RequestStatus.FAILED:
            return request
        timeout = timeout or self.engine.runtime.request_timeout_s
        if not request.wait(timeout):
            self.cancel(request.request_id)
            request.mark_failed("timeout")
            self.monitor.record_request(0, error="timeout")
        return request

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued or in-flight request. In-flight cancels are
        deferred to the scheduler loop: the engine is driven by one thread."""
        if self.queue.cancel(request_id):
            return True
        for slot, req in list(self._by_slot.items()):
            if req.request_id == request_id:
                self._pending_cancels.append((slot, request_id))
                self._wake.set()
                return True
        return False

    def _drain_cancels(self) -> None:
        while self._pending_cancels:
            slot, rid = self._pending_cancels.pop(0)
            req = self._by_slot.get(slot)
            if req is None or req.request_id != rid:
                continue
            self.engine.cancel(slot)

    def is_healthy(self) -> bool:
        return (self._running and self._thread is not None
                and self._thread.is_alive())

    def stats(self) -> Dict:
        return {
            "queued": len(self.queue),
            "active": self.engine.active_requests,
            "free_slots": len(self.engine.free_slots),
            "dropped": self.dropped_requests,
            "recovered": self.recovered_requests,
            "preempted": self.preempted_requests,
            "prefix_cache": self.engine.prefix_cache_stats,
            "steps": self.engine.steps,
            "healthy": self.is_healthy(),
            "speculative": {
                "window_mean_accepted": round(self.engine.spec_window_mean, 3),
                "accept_hist": self.engine.spec_accept_hist.tolist(),
                "disabled": self.engine.spec_disabled,
            },
        }

    # -- the loop -----------------------------------------------------------
    def _loop(self) -> None:
        while self._running:
            try:
                self._drain_cancels()
                self._admit()
                self._finalize()   # requests can finish at admission time
                # one prefill chunk per loop turn, interleaved with decode:
                # a long prompt never stalls the running requests
                for slot in self.engine.prefilling_slots[:1]:
                    self.engine.continue_prefill(slot)
                    self.engine.synchronize()   # decode_step times decode only
                    self._stream({slot: None})
                    self._finalize()
                if self.engine.active_requests == 0:
                    if not self.engine.prefilling_slots:
                        self._wake.wait(self.config.batch_timeout_ms / 1e3)
                        self._wake.clear()
                    continue
                t0 = time.monotonic()
                steps = self.engine.steps
                toks = self.engine.step()
                step_ms = (time.monotonic() - t0) * 1e3
                if self.engine.steps != steps:   # a decode step ran
                    self.monitor.record_step(step_ms)
                    self.monitor.record_latency("decode_step", step_ms)
                self._stream(toks)
                self._finalize()
                self._consecutive_failures = 0
            except Exception:
                self.last_error = traceback.format_exc()
                traceback.print_exc()
                self._recover()

    def _recover(self) -> None:
        """Reset the engine and requeue in-flight requests; after more
        than three consecutive failures, fail them instead."""
        self._consecutive_failures += 1
        inflight = list(self._by_slot.values())
        self._by_slot.clear()
        self._emitted_text.clear()
        self._held.clear()
        self.engine.reset()
        if self._consecutive_failures > 3:
            for req in inflight:
                req.mark_failed("engine failure (recovery exhausted): "
                                + (self.last_error or "").strip()[-500:])
                self.monitor.record_request(0, error="engine_failure")
            return
        for req in inflight:
            req.status = RequestStatus.PENDING
            self.recovered_requests += 1
            try:
                self.queue.enqueue(req)
            except QueueFullError:
                req.mark_failed("queue full during recovery")
                self.monitor.record_request(0, error="recovery_drop")

    def _admit(self) -> None:
        # While decode is active, hold new admissions up to
        # batch_timeout_ms or until a small batch can land, so one
        # interruption of the decode loop admits several requests.
        hold_ms = self.config.batch_timeout_ms
        if hold_ms > 0 and self.engine.active_requests > 0:
            q = len(self.queue)
            free = len(self.engine.free_slots)
            if q == 0 or free == 0:
                self._hold_t0 = None
                return
            if self._hold_t0 is None:
                self._hold_t0 = time.perf_counter()
            want = min(4, q, self.engine.num_slots)
            if (min(q, free) < want
                    and (time.perf_counter() - self._hold_t0) * 1e3 < hold_ms):
                return
        self._hold_t0 = None
        with self.engine.deferred_admission():
            self._admit_loop()
        # the deferred prefills ran at the context's exit: stream the
        # first tokens of the slots they activated
        self._stream({s: None for s in self._by_slot})

    def _admit_loop(self) -> None:
        while self.engine.free_slots and self._running:
            req = self.queue.dequeue(timeout=None)
            self.monitor.queue_depth = len(self.queue)
            if req is None:
                return
            resume = req.resume
            try:
                if resume is not None:
                    # preempted earlier: prefill prompt + generated prefix
                    # with the remaining token budget
                    ids = resume["prompt_ids"] + resume["tokens"]
                    done = len(resume["tokens"])
                    cfg = dataclasses.replace(
                        req.config,
                        max_tokens=max(1, req.config.max_tokens - done),
                        min_tokens=max(0, req.config.min_tokens - done))
                else:
                    ids = self.encode(req.prompt)
                    cfg = req.config
                req.mark_running()
                slot = self.engine.begin_request(
                    ids, cfg, request_id=req.request_id)
            except NoFreePages:
                # transient: running requests will release pages; requeue
                # and stop admitting this round
                req.status = RequestStatus.PENDING
                self.queue.enqueue(req)
                return
            except Exception as e:
                req.mark_failed(str(e))
                self.monitor.record_request(0, error="add_request")
                continue
            self.monitor.active_requests = self.engine.active_requests
            self._by_slot[slot] = req
            self._emitted_text[slot] = (resume or {}).get("emitted", "")
            res = self.engine._slots[slot]
            if res is None or res.request_id != req.request_id:
                # finished on its first token: complete it now, before the
                # next admission of this round reuses the slot
                self._finalize()

    def _stream(self, toks: Dict[int, Optional[List[int]]]) -> None:
        for slot in toks:
            req = self._by_slot.get(slot)
            if req is None:
                continue
            res = self.engine._slots[slot]
            if res is None or res.request_id != req.request_id:
                continue  # finished this step; handled in _finalize
            if not res.token_ids:
                continue  # still in chunked prefill
            text = self.decode(self._full_tokens(req, res.token_ids))
            if req.config.stop_tokens:
                cut = _find_stop(text, req.config.stop_tokens)
                if cut is not None:
                    self._emit_delta(slot, req, text[:cut])
                    req.result.stop_reason = "stop_string"
                    self.engine.cancel(slot)
                    continue
            self._emit_delta(slot, req, text)

    def _emit_delta(self, slot: int, req: Request, text: str) -> None:
        prev = self._emitted_text.get(slot, "")
        if len(text) > len(prev) and req.stream_callback is not None:
            delta = text[len(prev):]
            # hold back a trailing replacement char for one step (possible
            # partial UTF-8); a persistent one is genuinely invalid: emit
            if delta.endswith("�") and not self._held.get(slot):
                self._held[slot] = True
                return
            self._held.pop(slot, None)
            if not req.stream_callback(delta):
                req.result.stop_reason = "cancelled"
                self.engine.cancel(slot)
        self._emitted_text[slot] = text

    def _finalize(self) -> None:
        for res in self.engine.pop_finished():
            slot = next((s for s, req in self._by_slot.items()
                         if req.request_id == res.request_id), None)
            if slot is None:
                continue
            req = self._by_slot.pop(slot)
            emitted = self._emitted_text.pop(slot, "")
            if res.stop_reason == "preempted":
                self._requeue_preempted(req, res, emitted)
            else:
                self._complete(req, res, emitted)
            self.monitor.active_requests = self.engine.active_requests

    def _requeue_preempted(self, req: Request, res: SlotResult,
                           emitted: str) -> None:
        """A preempted request resumes from its generated prefix: keep this
        segment's tokens and put the request back in the queue."""
        st = req.resume
        if st is None:
            st = req.resume = {"prompt_ids": self.encode(req.prompt),
                               "tokens": [], "logprobs": [], "top": []}
        st["tokens"] += list(res.token_ids)
        st["logprobs"] += list(res.logprobs)
        st["top"] += list(res.top_tokens)
        st["emitted"] = emitted
        self.preempted_requests += 1
        req.status = RequestStatus.PENDING
        try:
            self.queue.enqueue(req)
        except QueueFullError:
            req.mark_failed("queue full after preemption")
            self.monitor.record_request(0, error="preempt_drop")

    @staticmethod
    def _full_tokens(req: Request, seg_tokens) -> List[int]:
        st = req.resume
        return list(seg_tokens) if st is None else st["tokens"] + list(seg_tokens)

    def _complete(self, req: Request, res: SlotResult, emitted: str) -> None:
        st = req.resume
        all_tokens = self._full_tokens(req, res.token_ids)
        all_logprobs = (st["logprobs"] if st else []) + list(res.logprobs)
        all_top = (st["top"] if st else []) + list(res.top_tokens)
        if st is not None:
            emitted = emitted or st.get("emitted", "")
        text = self.decode(all_tokens)
        if req.config.stop_tokens:
            cut = _find_stop(text, req.config.stop_tokens)
            if cut is not None:
                text = text[:cut]
                if not res.stop_reason or res.stop_reason == "max_tokens":
                    res.stop_reason = "stop_string"
        if req.stream_callback is not None and len(text) > len(emitted):
            req.stream_callback(text[len(emitted):])
        r = req.result
        r.text = text
        r.token_ids = all_tokens
        r.logprobs = all_logprobs
        r.top_tokens = all_top
        r.stop_reason = req.result.stop_reason or res.stop_reason
        r.prompt_tokens = len(st["prompt_ids"]) if st else res.prompt_len
        r.completion_tokens = len(all_tokens)
        r.ttft_ms = res.ttft_ms
        r.total_time_ms = res.generation_time * 1e3
        r.spans = [
            Span("queue_wait", req.wait_time_s * 1e3),
            Span("prefill_to_first_token", res.ttft_ms),
            Span("decode", max(0.0, r.total_time_ms - res.ttft_ms)),
        ]
        if req.status == RequestStatus.RUNNING:
            req.mark_completed()
        self.monitor.record_latency("request", r.total_time_ms)
        self.monitor.record_latency("ttft", r.ttft_ms)
        self.monitor.record_request(r.completion_tokens)


def _find_stop(text: str, stops) -> Optional[int]:
    cuts = [text.find(s) for s in stops if s and text.find(s) >= 0]
    return min(cuts) if cuts else None
