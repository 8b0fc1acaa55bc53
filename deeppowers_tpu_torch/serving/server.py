"""HTTP serving front-end, ported from deeppowers_tpu/serving/server.py
(host-only).

Every route of the JAX package's server (:367-418), with its request and
response JSON and status codes:
- GET /health (alias /api/v1/health), /metrics (alias /api/v1/metrics),
  /v1/models, /api/v1/result/<id> (202 while the request runs);
- POST /api/v1/generate (alias /generate), /api/v1/generate_stream
  (chunked transfer, one `data:` event a decoded delta, then a `done`
  event with the result), /api/v1/generate_batch, /api/v1/generate_async
  (202 with the result's URL), and the OpenAI-compatible /v1/completions
  and /v1/chat/completions, each also streamed (SSE, ending `data:
  [DONE]`);
- structured output from `response_format` (json_object / json_schema),
  `guided_regex`, `guided_choice` or `guided_json` (`_guide_from_body`,
  compiled with the scheduler's tokenizer by serving/structured.py);
- `top_tokens` in a result when the engine emits top logprobs; as in
  JAX, /v1/completions answers `"logprobs": null`;
- bearer-token auth and a per-client rate limit on POST; optional TLS.

Two differences from JAX's: a streaming client that disconnects cancels
its request (the stream callback answers False and the scheduler is asked
to cancel it), and stop() joins the server's thread. The server runs
http.server's ThreadingHTTPServer on one daemon thread; bind port 0 to
take a free port (read it back from `.port` after start()).
"""

from __future__ import annotations

import dataclasses
import json
import ssl
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from ..config import GenerationConfig
from .request import Request, RequestPriority, RequestStatus
from .scheduler import Scheduler
from .structured import compile_guide, guide_for_choice, guide_for_json


def _gen_config_from_json(body: Dict) -> GenerationConfig:
    """reference: generate_handler.cpp:33-49 field set."""
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
    """reference: generate_handler.cpp:59-80 response shape."""
    r = req.result
    return {
        "id": req.request_id,
        "text": r.text,
        "tokens": r.token_ids,
        "logprobs": r.logprobs,
        "stop_reason": r.stop_reason,
        **({"top_tokens": r.top_tokens} if r.top_tokens else {}),
        "usage": {
            "prompt_tokens": r.prompt_tokens,
            "completion_tokens": r.completion_tokens,
            "total_tokens": r.prompt_tokens + r.completion_tokens,
        },
        "timing": {"ttft_ms": round(r.ttft_ms, 2),
                   "total_ms": round(r.total_time_ms, 2),
                   "spans": [{"name": s.name,
                              "ms": round(s.duration_ms, 2)}
                             for s in r.spans]},
    }


class RateLimiter:
    """Fixed-window per-client limit (reference: http_server.hpp:60-77)."""

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
    """HTTP server over a Scheduler.

    reference analogue: APIServer endpoint registry with per-endpoint
    auth/rate-limit (api_server.hpp:16-23,74-76).
    """

    def __init__(self, scheduler: Scheduler, host: str = "127.0.0.1",
                 port: int = 8000, *, auth_token: Optional[str] = None,
                 rate_limit_per_minute: int = 600, max_batch: int = 32,
                 ssl_certfile: Optional[str] = None,
                 ssl_keyfile: Optional[str] = None):
        self.scheduler = scheduler
        self.host, self.port = host, port
        self.auth_token = auth_token
        self.rate_limiter = RateLimiter(rate_limit_per_minute)
        self.max_batch = max_batch
        # TLS termination in-process (reference: http_server.hpp ssl_cert/
        # ssl_key config); None = plaintext, typical behind an LB
        self.ssl_certfile = ssl_certfile
        self.ssl_keyfile = ssl_keyfile
        self._async_results: Dict[str, Request] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # bounds slow/stalled clients (incl. the deferred TLS handshake,
            # which runs on first read in this per-connection thread)
            timeout = 120

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                server._handle_get(self)

            def do_POST(self):
                server._handle_post(self)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        if self.ssl_certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self.ssl_certfile,
                                keyfile=self.ssl_keyfile or None)
            # do_handshake_on_connect=False: the handshake must NOT run in
            # the single accept() loop (a client that connects and stalls
            # would block all new connections); deferred, it runs on first
            # read inside the per-connection handler thread, bounded by
            # Handler.timeout
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True,
                do_handshake_on_connect=False)
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
        client = h.client_address[0]
        if not self.rate_limiter.allow(client):
            self._send(h, 429, {"error": {"type": "rate_limited",
                                          "message": "too many requests"}})
            return False
        if self.auth_token:
            auth = h.headers.get("Authorization", "")
            if auth != f"Bearer {self.auth_token}":
                self._send(h, 401, {"error": {"type": "unauthorized",
                                              "message": "invalid token"}})
                return False
        return True

    # -- structured outputs ---------------------------------------------------
    def _guide_from_body(self, body: Dict):
        """Compile a structured-output guide from request fields:
        `response_format` (OpenAI json_object / json_schema), or the
        `guided_regex` / `guided_choice` / `guided_json` extensions."""
        rf = body.get("response_format")
        regex = body.get("guided_regex")
        choice = body.get("guided_choice")
        gjson = body.get("guided_json", None)
        if not (rf or regex or choice or gjson is not None):
            return None
        tok = getattr(self.scheduler, "tokenizer", None)
        if tok is None:
            raise ValueError("structured output requires a tokenizer")
        if regex:
            return compile_guide(str(regex), tok)
        if choice:
            if not isinstance(choice, list) or not choice:
                raise ValueError("'guided_choice' must be a non-empty list")
            return guide_for_choice([str(c) for c in choice], tok)
        if gjson is not None:
            return guide_for_json(gjson if isinstance(gjson, dict) else None,
                                  tok)
        t = rf.get("type") if isinstance(rf, dict) else None
        if t == "json_object":
            return guide_for_json(None, tok)
        if t == "json_schema":
            js = rf.get("json_schema") or {}
            schema = js.get("schema") if isinstance(js, dict) else None
            return guide_for_json(schema, tok)
        if t in (None, "text"):
            return None
        raise ValueError(f"unsupported response_format type {t!r}")

    # -- routing ------------------------------------------------------------
    # -- OpenAI-compatible surface (beyond the reference: drop-in client
    #    compatibility with the de-facto serving API) ------------------------
    def _oai_request(self, body: Dict, prompt: str) -> Request:
        cfg = GenerationConfig(
            guide=self._guide_from_body(body),
            max_tokens=int(body.get("max_tokens", 16)),
            temperature=float(body.get("temperature", 1.0)),
            top_p=float(body.get("top_p", 1.0)),
            top_k=int(body.get("top_k", 0)),
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            do_sample=float(body.get("temperature", 1.0)) > 0.0,
            stop_tokens=tuple([body["stop"]] if isinstance(body.get("stop"),
                                                           str)
                              else body.get("stop") or ()),
            seed=body.get("seed"),
            logit_bias={int(k): float(v)
                        for k, v in body["logit_bias"].items()}
            if body.get("logit_bias") else None,
        )
        cfg.validate()
        return Request(prompt=prompt, config=cfg)

    @staticmethod
    def _finish_reason(req: Request) -> str:
        return ("stop" if req.result.stop_reason in
                ("eos", "stop_string", "guide_complete") else "length")

    def _oai_usage(self, req: Request) -> Dict:
        return {"prompt_tokens": req.result.prompt_tokens,
                "completion_tokens": req.result.completion_tokens,
                "total_tokens": (req.result.prompt_tokens
                                 + req.result.completion_tokens)}

    def _oai_completions(self, h, body: Dict) -> None:
        prompt = body.get("prompt")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        if not isinstance(prompt, str) or not prompt:
            raise ValueError("'prompt' required")
        req = self._oai_request(body, prompt)
        if body.get("stream"):
            return self._oai_stream(h, req, chat=False,
                                    model=body.get("model", "deeppowers"))
        req = self.scheduler.submit_sync(req)
        if req.status == RequestStatus.FAILED:
            self._send(h, 503, {"error": {"type": "failed",
                                          "message": req.result.error}})
            return
        self._send(h, 200, {
            "id": f"cmpl-{req.request_id}",
            "object": "text_completion",
            "created": int(time.time()),
            "model": body.get("model", "deeppowers"),
            "choices": [{"index": 0, "text": req.result.text,
                         "logprobs": None,
                         "finish_reason": self._finish_reason(req)}],
            "usage": self._oai_usage(req),
        })

    @staticmethod
    def _render_chat(messages) -> str:
        """Minimal generic chat template (model-specific templates come from
        the tokenizer when available)."""
        parts = []
        for m in messages:
            parts.append(f"{m.get('role', 'user')}: {m.get('content', '')}")
        parts.append("assistant:")
        return "\n".join(parts)

    def _oai_chat(self, h, body: Dict) -> None:
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise ValueError("'messages' (non-empty list) required")
        tok = getattr(self.scheduler, "tokenizer", None)
        if tok is not None and hasattr(tok, "apply_chat_template"):
            prompt = tok.apply_chat_template(messages)
        else:
            prompt = self._render_chat(messages)
        if not isinstance(prompt, str) or not prompt:
            raise ValueError("chat template produced an empty prompt")
        req = self._oai_request(body, prompt)
        if body.get("stream"):
            return self._oai_stream(h, req, chat=True,
                                    model=body.get("model", "deeppowers"))
        req = self.scheduler.submit_sync(req)
        if req.status == RequestStatus.FAILED:
            self._send(h, 503, {"error": {"type": "failed",
                                          "message": req.result.error}})
            return
        self._send(h, 200, {
            "id": f"chatcmpl-{req.request_id}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": body.get("model", "deeppowers"),
            "choices": [{"index": 0,
                         "message": {"role": "assistant",
                                     "content": req.result.text},
                         "finish_reason": self._finish_reason(req)}],
            "usage": self._oai_usage(req),
        })

    def _pump(self, h, req: Request, event, last) -> None:
        """Submit a streamed request and answer with chunked transfer: one
        `event(delta)` payload a decoded delta as the scheduler's stream
        callback hands them over, then `last()`'s payloads. A client that
        disconnects cancels its request."""
        chunks: "list" = []
        lock = threading.Lock()
        gone = threading.Event()

        def cb(delta: str) -> bool:
            with lock:
                chunks.append(delta)
            return not gone.is_set()

        req.stream_callback = cb
        self.scheduler.submit(req)
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("Transfer-Encoding", "chunked")
        h.end_headers()

        def write_chunk(payload: str) -> None:
            data = payload.encode()
            h.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            h.wfile.flush()

        sent = 0
        try:
            while not req.wait(0.02):
                with lock:
                    pending = chunks[sent:]
                    sent = len(chunks)
                for delta in pending:
                    write_chunk(event(delta))
            with lock:
                pending = chunks[sent:]
            for delta in pending:
                write_chunk(event(delta))
            for payload in last():
                write_chunk(payload)
            h.wfile.write(b"0\r\n\r\n")
        except OSError:          # the client went away: stop generating
            gone.set()
            self.scheduler.cancel(req.request_id)
            h.close_connection = True

    def _oai_stream(self, h, req: Request, *, chat: bool, model: str) -> None:
        """OpenAI SSE format; terminates with data: [DONE]."""
        oid = ("chatcmpl-" if chat else "cmpl-") + req.request_id
        obj = "chat.completion.chunk" if chat else "text_completion"

        def event(delta: str, finish=None) -> str:
            if chat:
                choice = {"index": 0, "delta":
                          ({"content": delta} if delta else {}),
                          "finish_reason": finish}
            else:
                choice = {"index": 0, "text": delta, "finish_reason": finish}
            return "data: " + json.dumps({
                "id": oid, "object": obj, "created": int(time.time()),
                "model": model, "choices": [choice]}) + "\n\n"

        self._pump(h, req, event, lambda: [
            event("", finish=self._finish_reason(req)), "data: [DONE]\n\n"])

    def _handle_get(self, h: BaseHTTPRequestHandler) -> None:
        path = h.path.split("?")[0]
        if path in ("/health", "/api/v1/health"):
            healthy = self.scheduler.is_healthy()
            self._send(h, 200 if healthy else 503,
                       {"status": "ok" if healthy else "unhealthy",
                        **self.scheduler.stats()})
        elif path in ("/metrics", "/api/v1/metrics"):
            self._send(h, 200, self.scheduler.monitor.snapshot())
        elif path == "/v1/models":
            name = getattr(self.scheduler, "model_name", "deeppowers")
            self._send(h, 200, {"object": "list", "data": [
                {"id": name, "object": "model", "created": int(time.time()),
                 "owned_by": "deeppowers-tpu"}]})
        elif path.startswith("/api/v1/result/"):
            rid = path.rsplit("/", 1)[-1]
            req = self._async_results.get(rid)
            if req is None:
                self._send(h, 404, {"error": {"type": "not_found",
                                              "message": rid}})
            elif req.status in (RequestStatus.PENDING, RequestStatus.RUNNING):
                self._send(h, 202, {"id": rid, "status": req.status.value})
            else:
                self._async_results.pop(rid, None)
                self._send(h, 200, _result_json(req))
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
            elif path == "/api/v1/generate_stream":
                self._generate_stream(h, body)
            elif path == "/api/v1/generate_batch":
                self._generate_batch(h, body)
            elif path == "/api/v1/generate_async":
                self._generate_async(h, body)
            elif path == "/v1/completions":
                self._oai_completions(h, body)
            elif path == "/v1/chat/completions":
                self._oai_chat(h, body)
            else:
                self._send(h, 404, {"error": {"type": "not_found",
                                              "message": path}})
        except ValueError as e:
            self._send(h, 400, {"error": {"type": "invalid_params",
                                          "message": str(e)}})
        except Exception as e:  # pragma: no cover
            self._send(h, 500, {"error": {"type": "internal",
                                          "message": str(e)}})

    # -- endpoints ----------------------------------------------------------
    def _make_request(self, body: Dict) -> Request:
        prompt = body.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            raise ValueError("'prompt' (non-empty string) required")
        cfg = _gen_config_from_json(body)
        guide = self._guide_from_body(body)
        if guide is not None:
            cfg = dataclasses.replace(cfg, guide=guide)
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

    def _generate_stream(self, h, body: Dict) -> None:
        """SSE streaming (reference streams 16-token chunks; we stream each
        decoded delta — generate_routes.hpp:22)."""
        req = self._make_request(body)
        self._pump(
            h, req, lambda d: "data: " + json.dumps({"text": d}) + "\n\n",
            lambda: ["data: " + json.dumps(
                {"done": True, **_result_json(req)}) + "\n\n"])

    def _generate_batch(self, h, body: Dict) -> None:
        prompts = body.get("prompts")
        if not isinstance(prompts, list) or not prompts:
            raise ValueError("'prompts' (non-empty list) required")
        if len(prompts) > self.max_batch:
            raise ValueError(f"batch too large (max {self.max_batch})")
        cfg = _gen_config_from_json(body)
        cfg.validate()
        reqs = [Request(prompt=p, config=cfg) for p in prompts]
        for r in reqs:
            self.scheduler.submit(r)
        deadline = time.monotonic() + self.scheduler.engine.runtime.request_timeout_s
        for r in reqs:
            r.wait(max(0.0, deadline - time.monotonic()))
        self._send(h, 200, {"results": [_result_json(r) for r in reqs]})

    def _generate_async(self, h, body: Dict) -> None:
        req = self._make_request(body)
        self._async_results[req.request_id] = req
        self.scheduler.submit(req)
        self._send(h, 202, {"id": req.request_id, "status": "accepted",
                            "result_url": f"/api/v1/result/{req.request_id}"})

    # -- util ---------------------------------------------------------------
    @staticmethod
    def _send(h: BaseHTTPRequestHandler, code: int, payload: Dict) -> None:
        data = json.dumps(payload).encode()
        h.send_response(code)
        h.send_header("Content-Type", "application/json")
        h.send_header("Content-Length", str(len(data)))
        h.end_headers()
        h.wfile.write(data)
