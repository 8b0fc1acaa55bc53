"""HTTP serving front-end, ported from deeppowers_tpu/serving/server.py
(host-only).

This slice serves GET /health and POST /api/v1/generate (alias /generate)
with the JAX package's request and response JSON, plus its bearer-token
auth and per-client rate limit. The streaming, batch, async and
OpenAI-compatible routes are not ported yet (ROADMAP.md).

The server runs http.server's ThreadingHTTPServer on one daemon thread;
stop() shuts it down, closes the socket and joins the thread. Bind port 0
to take a free port (read it back from `.port` after start()).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..config import GenerationConfig
from .request import Request, RequestPriority, RequestStatus
from .scheduler import Scheduler


def _gen_config_from_json(body: Dict) -> GenerationConfig:
    if "logit_bias" in body and body["logit_bias"] is not None and \
            not isinstance(body["logit_bias"], dict):
        raise ValueError("logit_bias must be an object of token_id -> bias")
    return GenerationConfig(
        max_tokens=int(body.get("max_tokens", 100)),
        temperature=float(body.get("temperature", 0.7)),
        top_p=float(body.get("top_p", 0.9)),
        top_k=int(body.get("top_k", 50)),
        repetition_penalty=float(body.get("repetition_penalty", 1.0)),
        presence_penalty=float(body.get("presence_penalty", 0.0)),
        frequency_penalty=float(body.get("frequency_penalty", 0.0)),
        do_sample=bool(body.get("do_sample", True)),
        stop_tokens=tuple(body.get("stop", [])),
        min_tokens=int(body.get("min_tokens", 0)),
        seed=body.get("seed"),
        logit_bias={int(k): float(v)
                    for k, v in body["logit_bias"].items()}
        if body.get("logit_bias") else None,
    )


def _result_json(req: Request) -> Dict:
    r = req.result
    return {
        "id": req.request_id,
        "text": r.text,
        "tokens": r.token_ids,
        "logprobs": r.logprobs,
        "stop_reason": r.stop_reason,
        "usage": {
            "prompt_tokens": r.prompt_tokens,
            "completion_tokens": r.completion_tokens,
            "total_tokens": r.prompt_tokens + r.completion_tokens,
        },
        "timing": {"ttft_ms": round(r.ttft_ms, 2),
                   "total_ms": round(r.total_time_ms, 2),
                   "spans": [{"name": s.name, "ms": round(s.duration_ms, 2)}
                             for s in r.spans]},
    }


class RateLimiter:
    """Fixed-window per-client limit."""

    def __init__(self, max_per_minute: int = 600):
        self.max_per_minute = max_per_minute
        self._counts: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def allow(self, client: str) -> bool:
        now = time.monotonic()
        with self._lock:
            window, count = self._counts.get(client, (now, 0))
            if now - window > 60.0:
                window, count = now, 0
            count += 1
            self._counts[client] = (window, count)
            return count <= self.max_per_minute


class APIServer:
    """HTTP server over a Scheduler."""

    def __init__(self, scheduler: Scheduler, host: str = "127.0.0.1",
                 port: int = 8000, *, auth_token: Optional[str] = None,
                 rate_limit_per_minute: int = 600):
        self.scheduler = scheduler
        self.host, self.port = host, port
        self.auth_token = auth_token
        self.rate_limiter = RateLimiter(rate_limit_per_minute)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = 120              # bounds slow or stalled clients

            def log_message(self, *a):
                pass

            def do_GET(self):
                server._handle_get(self)

            def do_POST(self):
                server._handle_post(self)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="deeppowers-http")
        self._thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread:
            self._thread.join(timeout)
            self._thread = None

    # -- middleware ---------------------------------------------------------
    def _gate(self, h: BaseHTTPRequestHandler) -> bool:
        if not self.rate_limiter.allow(h.client_address[0]):
            self._send(h, 429, {"error": {"type": "rate_limited",
                                          "message": "too many requests"}})
            return False
        if self.auth_token:
            if h.headers.get("Authorization", "") != f"Bearer {self.auth_token}":
                self._send(h, 401, {"error": {"type": "unauthorized",
                                              "message": "invalid token"}})
                return False
        return True

    # -- routing ------------------------------------------------------------
    def _handle_get(self, h: BaseHTTPRequestHandler) -> None:
        path = h.path.split("?")[0]
        if path in ("/health", "/api/v1/health"):
            healthy = self.scheduler.is_healthy()
            self._send(h, 200 if healthy else 503,
                       {"status": "ok" if healthy else "unhealthy",
                        **self.scheduler.stats()})
        else:
            self._send(h, 404, {"error": {"type": "not_found",
                                          "message": h.path}})

    def _handle_post(self, h: BaseHTTPRequestHandler) -> None:
        if not self._gate(h):
            return
        path = h.path.split("?")[0]
        try:
            n = int(h.headers.get("Content-Length", 0))
            body = json.loads(h.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._send(h, 400, {"error": {"type": "bad_request",
                                          "message": str(e)}})
            return
        try:
            if path in ("/generate", "/api/v1/generate"):
                self._generate(h, body)
            else:
                self._send(h, 404, {"error": {"type": "not_found",
                                              "message": path}})
        except ValueError as e:
            self._send(h, 400, {"error": {"type": "invalid_params",
                                          "message": str(e)}})
        except Exception as e:      # the HTTP thread must answer
            self._send(h, 500, {"error": {"type": "internal",
                                          "message": str(e)}})

    # -- endpoints ----------------------------------------------------------
    def _make_request(self, body: Dict) -> Request:
        prompt = body.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            raise ValueError("'prompt' (non-empty string) required")
        cfg = _gen_config_from_json(body)
        cfg.validate()
        prio = RequestPriority[body.get("priority", "normal").upper()]
        return Request(prompt=prompt, config=cfg, priority=prio)

    def _generate(self, h, body: Dict) -> None:
        req = self.scheduler.submit_sync(self._make_request(body))
        if req.status == RequestStatus.FAILED:
            self._send(h, 503, {"error": {"type": "failed",
                                          "message": req.result.error}})
        else:
            self._send(h, 200, _result_json(req))

    # -- util ---------------------------------------------------------------
    @staticmethod
    def _send(h: BaseHTTPRequestHandler, code: int, payload: Dict) -> None:
        data = json.dumps(payload).encode()
        h.send_response(code)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)
