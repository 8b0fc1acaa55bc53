"""Serving observability, ported from deeppowers_tpu/serving/metrics.py:
latency percentiles, throughput, errors, alerts, and hardware sampling on a
background thread (device memory through torch.cuda.memory_stats, where
the JAX package read jax `device.memory_stats()`), plus the engine duty
cycle recorded by the scheduler loop around engine.step()."""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

import numpy as np

_HISTORY = 1000  # reference: monitor.hpp:83


@dataclass
class LatencySnapshot:
    p50_ms: float = 0.0
    p90_ms: float = 0.0
    p95_ms: float = 0.0
    p99_ms: float = 0.0
    avg_ms: float = 0.0
    max_ms: float = 0.0
    count: int = 0


@dataclass
class AlertThresholds:
    # reference: monitoring_middleware.hpp:22-23 — error rate 5%, latency 1s
    max_error_rate: float = 0.05
    max_latency_ms: float = 1000.0
    max_queue_depth: int = 500
    # OOM approach: alert before the allocator fails (reference samples GPU
    # memory at monitor.hpp:77-83 and counts OOMs at :66-74)
    max_hbm_utilization: float = 0.92


def default_hardware_provider() -> Dict[str, float]:
    """Device-memory occupancy of the current CUDA device from
    torch.cuda.memory_stats() and mem_get_info().

    Returns {} when there is no CUDA device (CPU runs): hardware metrics
    are then absent from snapshots, never an error."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    stats = torch.cuda.memory_stats()
    _, total = torch.cuda.mem_get_info()
    in_use = float(stats.get("allocated_bytes.all.current", 0))
    return {"hbm_bytes_in_use": in_use, "hbm_bytes_limit": float(total),
            "hbm_utilization": in_use / total if total else 0.0}


class Monitor:
    # hardware samples every 5 s, as in the JAX package
    def __init__(self, thresholds: Optional[AlertThresholds] = None,
                 hardware_provider=default_hardware_provider,
                 sample_interval_s: float = 5.0):
        self._lock = threading.Lock()
        self._latencies: Dict[str, Deque[float]] = {}
        self._requests_done = 0
        self._tokens_out = 0
        self._errors: Dict[str, int] = {}
        self._window_start = time.monotonic()
        self._recent_events: Deque[tuple] = deque(maxlen=4096)  # (t, tokens, error?)
        self.thresholds = thresholds or AlertThresholds()
        self.queue_depth = 0
        self.active_requests = 0
        # hardware sampling (reference: 100ms thread, monitor.hpp:77-83)
        self._hw_provider = hardware_provider
        self._hw_interval = sample_interval_s
        self._hw_latest: Dict[str, float] = {}
        self._hw_history: Deque[Dict[str, float]] = deque(maxlen=_HISTORY)
        self._hw_thread: Optional[threading.Thread] = None
        self._hw_stop = threading.Event()
        # duty cycle: device-busy ms recorded by the engine-driving loop
        self._busy_events: Deque[tuple] = deque(maxlen=4096)  # (t_end, ms)

    # -- hardware sampling ---------------------------------------------------
    def start_sampling(self) -> None:
        """Start the hardware sampling thread (idempotent)."""
        if self._hw_thread is not None or self._hw_provider is None:
            return
        self._hw_stop.clear()
        self._hw_thread = threading.Thread(
            target=self._sample_loop, daemon=True, name="deeppowers-hw-monitor")
        self._hw_thread.start()

    def stop_sampling(self) -> None:
        self._hw_stop.set()
        if self._hw_thread is not None:
            self._hw_thread.join(2.0)
            self._hw_thread = None

    def _sample_loop(self) -> None:
        while not self._hw_stop.wait(self._hw_interval):
            self.sample_hardware()

    def sample_hardware(self) -> Dict[str, float]:
        """Take one hardware sample now (also called by the thread)."""
        try:
            sample = dict(self._hw_provider() or {})
        except Exception:                          # pragma: no cover
            sample = {}
        sample["duty_cycle"] = self.duty_cycle()
        with self._lock:
            self._hw_latest = sample
            self._hw_history.append(sample)
        return sample

    def hardware(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._hw_latest)

    # -- recording ----------------------------------------------------------
    def record_step(self, busy_ms: float) -> None:
        """One engine dispatch took busy_ms of wall time (device busy from
        the host's point of view) — feeds the duty-cycle metric."""
        with self._lock:
            self._busy_events.append((time.monotonic(), busy_ms))

    def duty_cycle(self, window_s: float = 10.0) -> float:
        now = time.monotonic()
        with self._lock:
            busy = sum(ms for t, ms in self._busy_events
                       if now - t <= window_s)
        return min(busy / (window_s * 1e3), 1.0)

    def record_latency(self, name: str, ms: float) -> None:
        with self._lock:
            self._latencies.setdefault(name, deque(maxlen=_HISTORY)).append(ms)

    def record_request(self, tokens: int, error: Optional[str] = None) -> None:
        now = time.monotonic()
        with self._lock:
            self._requests_done += 1
            self._tokens_out += tokens
            if error:
                self._errors[error] = self._errors.get(error, 0) + 1
            self._recent_events.append((now, tokens, error is not None))

    # -- reading ------------------------------------------------------------
    def latency(self, name: str) -> LatencySnapshot:
        with self._lock:
            vals = list(self._latencies.get(name, ()))
        if not vals:
            return LatencySnapshot()
        arr = np.asarray(vals)
        return LatencySnapshot(
            p50_ms=float(np.percentile(arr, 50)),
            p90_ms=float(np.percentile(arr, 90)),
            p95_ms=float(np.percentile(arr, 95)),
            p99_ms=float(np.percentile(arr, 99)),
            avg_ms=float(arr.mean()),
            max_ms=float(arr.max()),
            count=len(vals),
        )

    def throughput(self, window_s: float = 60.0) -> Dict[str, float]:
        now = time.monotonic()
        with self._lock:
            recent = [(t, n, e) for t, n, e in self._recent_events
                      if now - t <= window_s]
        dt = max(window_s, 1e-6)
        return {
            "requests_per_sec": len(recent) / dt,
            "tokens_per_sec": sum(n for _, n, _ in recent) / dt,
        }

    def error_rate(self, window_s: float = 60.0) -> float:
        now = time.monotonic()
        with self._lock:
            recent = [(t, n, e) for t, n, e in self._recent_events
                      if now - t <= window_s]
        if not recent:
            return 0.0
        return sum(1 for _, _, e in recent if e) / len(recent)

    def check_alerts(self) -> List[str]:
        """reference: monitor.hpp:96-115 check_alerts."""
        alerts = []
        er = self.error_rate()
        if er > self.thresholds.max_error_rate:
            alerts.append(f"error_rate {er:.1%} > {self.thresholds.max_error_rate:.0%}")
        lat = self.latency("request")
        if lat.p99_ms > self.thresholds.max_latency_ms:
            alerts.append(
                f"p99 latency {lat.p99_ms:.0f}ms > {self.thresholds.max_latency_ms:.0f}ms")
        if self.queue_depth > self.thresholds.max_queue_depth:
            alerts.append(f"queue depth {self.queue_depth}")
        hw = self.hardware()
        util = hw.get("hbm_utilization")
        if util is not None and util > self.thresholds.max_hbm_utilization:
            alerts.append(
                f"HBM {util:.0%} > {self.thresholds.max_hbm_utilization:.0%} "
                "(OOM approach)")
        return alerts

    def snapshot(self) -> Dict:
        """Full metrics dump for /metrics (reference: deeppowers.proto:34-74
        GetMetrics shape)."""
        with self._lock:
            errors = dict(self._errors)
            done, toks = self._requests_done, self._tokens_out
        return {
            "requests_completed": done,
            "tokens_generated": toks,
            "active_requests": self.active_requests,
            "queue_depth": self.queue_depth,
            "throughput": self.throughput(),
            "latency": {name: vars(self.latency(name))
                        for name in list(self._latencies)},
            "errors": errors,
            "error_rate": self.error_rate(),
            "alerts": self.check_alerts(),
            "uptime_s": time.monotonic() - self._window_start,
            "hardware": self.hardware(),
        }
