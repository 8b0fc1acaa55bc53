"""Bounded priority request queue, copied from
deeppowers_tpu/serving/queue.py (host-only).

Mirrors the reference's RequestQueue (reference: src/core/request_queue/
request_queue.hpp:34-75 — bounded capacity 1000, (priority, FIFO) ordering,
id -> request map, enqueue/dequeue callbacks).
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Callable, Dict, List, Optional

from .request import Request, RequestStatus


class QueueFullError(RuntimeError):
    pass


class RequestQueue:
    def __init__(self, max_size: int = 1000):
        self.max_size = max_size
        self._heap: List = []            # (-priority, seq, request)
        self._seq = itertools.count()    # FIFO tiebreak
        self._by_id: Dict[str, Request] = {}
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self.on_enqueue: Optional[Callable[[Request], None]] = None
        self.on_dequeue: Optional[Callable[[Request], None]] = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._by_id)

    def enqueue(self, request: Request) -> None:
        with self._not_empty:
            if len(self._by_id) >= self.max_size:
                raise QueueFullError(
                    f"queue full ({self.max_size} requests)")
            heapq.heappush(self._heap,
                           (-int(request.priority), next(self._seq), request))
            self._by_id[request.request_id] = request
            self._not_empty.notify()
        if self.on_enqueue:
            self.on_enqueue(request)

    def dequeue(self, timeout: Optional[float] = None) -> Optional[Request]:
        with self._not_empty:
            req = self._pop_valid()
            if req is None and timeout:
                self._not_empty.wait(timeout)
                req = self._pop_valid()
        if req is not None and self.on_dequeue:
            self.on_dequeue(req)
        return req

    def dequeue_batch(self, max_batch: int,
                      timeout: Optional[float] = None) -> List[Request]:
        """Up to max_batch requests, highest priority first (reference:
        request_queue.hpp:35 dequeue_batch with batch timeout)."""
        out: List[Request] = []
        first = self.dequeue(timeout=timeout)
        if first is None:
            return out
        out.append(first)
        while len(out) < max_batch:
            nxt = self.dequeue(timeout=None)
            if nxt is None:
                break
            out.append(nxt)
        return out

    def _pop_valid(self) -> Optional[Request]:
        while self._heap:
            _, _, req = heapq.heappop(self._heap)
            if req.request_id in self._by_id:
                del self._by_id[req.request_id]
                if req.status == RequestStatus.CANCELLED:
                    continue
                return req
        return None

    def cancel(self, request_id: str) -> bool:
        """Cancel a still-queued request by id."""
        with self._lock:
            req = self._by_id.pop(request_id, None)
        if req is None:
            return False
        req.mark_cancelled()
        return True

    def get(self, request_id: str) -> Optional[Request]:
        with self._lock:
            return self._by_id.get(request_id)
