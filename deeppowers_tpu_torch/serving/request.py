"""Request model for the serving pipeline, copied from
deeppowers_tpu/serving/request.py (host-only).

Mirrors the reference's Request (reference: src/core/request_queue/
request.hpp:13-93 — id, prompt, status PENDING/RUNNING/COMPLETED/FAILED/
CANCELLED, priority LOW..CRITICAL, per-request RequestConfig, RequestResult
with logprobs + timings).
"""

from __future__ import annotations

import enum
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from ..config import GenerationConfig


class RequestStatus(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


class RequestPriority(enum.IntEnum):
    # reference: request.hpp:19-24
    LOW = 0
    NORMAL = 1
    HIGH = 2
    CRITICAL = 3


@dataclass
class Span:
    """Timing span inside a request trace (reference:
    monitoring_middleware.hpp:52-62 — Trace {request_id, duration, spans
    (name, us)})."""

    name: str
    duration_ms: float


@dataclass
class RequestResult:
    """reference: request.hpp:38-44 {text, logprobs, processing_time}."""

    text: str = ""
    token_ids: List[int] = field(default_factory=list)
    logprobs: List[float] = field(default_factory=list)
    # per-token top-k alternatives [(id, logprob), ...] when the engine runs
    # with emit_top_logprobs > 0 (reference: request.hpp:38-44 top_tokens)
    top_tokens: List[list] = field(default_factory=list)
    stop_reason: str = ""
    prompt_tokens: int = 0
    completion_tokens: int = 0
    ttft_ms: float = 0.0
    total_time_ms: float = 0.0
    error: Optional[str] = None
    spans: List["Span"] = field(default_factory=list)


@dataclass
class Request:
    prompt: str
    config: GenerationConfig = field(default_factory=GenerationConfig)
    priority: RequestPriority = RequestPriority.NORMAL
    request_id: str = field(default_factory=lambda: f"req-{uuid.uuid4().hex[:12]}")
    status: RequestStatus = RequestStatus.PENDING
    # Streaming: called with each decoded text chunk; return False to cancel.
    stream_callback: Optional[Callable[[str], bool]] = None
    created_at: float = field(default_factory=time.monotonic)
    started_at: float = 0.0
    finished_at: float = 0.0
    result: RequestResult = field(default_factory=RequestResult)
    _done: threading.Event = field(default_factory=threading.Event, repr=False)

    # -- lifecycle ----------------------------------------------------------
    def mark_running(self) -> None:
        self.status = RequestStatus.RUNNING
        self.started_at = time.monotonic()

    def mark_completed(self) -> None:
        self.status = RequestStatus.COMPLETED
        self.finished_at = time.monotonic()
        self._done.set()

    def mark_failed(self, error: str) -> None:
        # reference: scheduler.cpp:70-74 mark_failed + dropped counter
        self.status = RequestStatus.FAILED
        self.result.error = error
        self.finished_at = time.monotonic()
        self._done.set()

    def mark_cancelled(self) -> None:
        self.status = RequestStatus.CANCELLED
        self.finished_at = time.monotonic()
        self._done.set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    # -- timings (reference: request.hpp:47-52) -----------------------------
    @property
    def wait_time_s(self) -> float:
        start = self.started_at or time.monotonic()
        return start - self.created_at

    @property
    def processing_time_s(self) -> float:
        if not self.started_at:
            return 0.0
        end = self.finished_at or time.monotonic()
        return end - self.started_at
