"""Every route of the port's HTTP server (deeppowers_tpu_torch/serving/
server.py) against the JAX package's (deeppowers_tpu/serving/server.py
:367-418), each over its own scheduler and a tiny-llama greedy engine with
the same weights (f32, byte tokenizer, top logprobs on): the same status
codes, the same JSON keys, and the same text and tokens (timings, request
ids and `created` aside; /health's stats carry the port's one extra key,
"recovered"). Also the SSE framing of the streamed routes, structured
output from each request field, auth, the rate limit, 400 and 404, a
streaming client that disconnects (its request is cancelled), and
`python -m deeppowers_tpu_torch.scripts.serve --device cpu` answering
/health and /v1/completions, and a CPU rehearsal of chip_smoke.py's
api_serve phase.
"""

import http.client
import json
import os
import re
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.config import RuntimeConfig as JRuntime
from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.models.presets import tiny_llama_config as jax_tiny_llama
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine
from deeppowers_tpu.serving.scheduler import Scheduler as JScheduler
from deeppowers_tpu.serving import structured as JStructured
from deeppowers_tpu.serving.server import APIServer as JServer
from deeppowers_tpu.serving.tokenizer import ByteTokenizer as JByte

from deeppowers_tpu_torch.config import RuntimeConfig
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_llama_config
from deeppowers_tpu_torch.runtime.engine import InferenceEngine
from deeppowers_tpu_torch.serving.scheduler import Scheduler
from deeppowers_tpu_torch.serving.server import APIServer
from deeppowers_tpu_torch.serving.structured import (compile_regex,
                                                    json_schema_to_regex)
from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 300
GREEDY = {"temperature": 0.0, "do_sample": False}
#: the port's health stats beside JAX's: recovery count
PORT_ONLY_STATS = {"recovered"}


@pytest.fixture(scope="module")
def servers():
    """{"jax": server, "port": server}, started; stopped at the end."""
    jcfg = jax_tiny_llama(vocab_size=VOCAB, max_seq_len=128)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(4), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    kw = dict(max_batch_size=4, max_seq_len=128, prefill_buckets=(16, 32, 64),
              emit_top_logprobs=3)
    jtok, ttok = JByte(), ByteTokenizer()
    # JAX's guide cache keys on id(tokenizer) alone: drop what freed
    # tokenizers of earlier tests left under ids jtok may now hold
    JStructured._GUIDE_CACHE.clear()
    jeng = JEngine(jp, jcfg, runtime=JRuntime(**kw), act_dtype=jnp.float32,
                   eos_token_id=1)
    teng = InferenceEngine(tp, tiny_llama_config(vocab_size=VOCAB,
                                                 max_seq_len=128),
                           runtime=RuntimeConfig(**kw),
                           act_dtype=torch.float32, device="cpu",
                           eos_token_id=1)
    js = JScheduler(jeng, encode=jtok.encode, decode=jtok.decode)
    js.tokenizer, js.model_name = jtok, "tiny"
    ts = Scheduler(teng, encode=ttok.encode, decode=ttok.decode,
                   tokenizer=ttok, model_name="tiny")
    out = {"jax": JServer(js, port=0), "port": APIServer(ts, port=0)}
    for name, sched in (("jax", js), ("port", ts)):
        sched.start()
        out[name].start()
    yield out
    for srv in out.values():
        srv.stop()
        srv.scheduler.stop()


def call(port, method, path, body=None, headers=None, raw=False):
    """(status, JSON body or text, response headers)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    data = body if isinstance(body, (bytes, type(None))) else \
        json.dumps(body).encode()
    conn.request(method, path, body=data, headers=headers or {})
    resp = conn.getresponse()
    text = resp.read().decode()
    conn.close()
    if raw or resp.getheader("Content-Type") == "text/event-stream":
        return resp.status, text, dict(resp.getheaders())
    return resp.status, json.loads(text), dict(resp.getheaders())


def both(servers, method, path, body=None, headers=None):
    """The same call on both servers: [(status, payload, headers)] JAX's
    first."""
    return [call(servers[k].port, method, path, body, headers)
            for k in ("jax", "port")]


def keys(x):
    """The key structure of a JSON value (lists by their first item)."""
    if isinstance(x, dict):
        return {k: keys(v) for k, v in x.items()}
    if isinstance(x, list):
        return [keys(x[0])] if x else []
    return None


def same_result(j, p):
    """Equal text and tokens, top tokens' ids equal and values within
    1e-5, logprobs within 1e-5, equal stop reasons and usage."""
    assert p["text"] == j["text"]
    assert p["tokens"] == j["tokens"]
    assert p["stop_reason"] == j["stop_reason"]
    assert p["usage"] == j["usage"]
    np.testing.assert_allclose(p["logprobs"], j["logprobs"], atol=1e-5)
    assert [[t[0] for t in row] for row in p["top_tokens"]] == \
        [[t[0] for t in row] for row in j["top_tokens"]]
    np.testing.assert_allclose([[t[1] for t in row] for row in p["top_tokens"]],
                               [[t[1] for t in row] for row in j["top_tokens"]],
                               atol=1e-5)


def events(text):
    """The `data:` payloads of an SSE body, each framed "data: ...\\n\\n"."""
    assert text.endswith("\n\n")
    parts = text[:-2].split("\n\n")
    assert all(p.startswith("data: ") for p in parts), parts
    return [p[len("data: "):] for p in parts]


@pytest.mark.parametrize("path", ["/health", "/api/v1/health"])
def test_health(servers, path):
    (js, jb, _), (ps, pb, _) = both(servers, "GET", path)
    assert js == ps == 200
    assert set(pb) == set(jb) | PORT_ONLY_STATS
    assert pb["status"] == jb["status"] == "ok"
    assert keys(pb["speculative"]) == keys(jb["speculative"])


@pytest.mark.parametrize("path", ["/metrics", "/api/v1/metrics"])
def test_metrics(servers, path):
    (js, jb, _), (ps, pb, _) = both(servers, "GET", path)
    assert js == ps == 200
    assert set(pb) == set(jb)


def test_models(servers):
    (js, jb, _), (ps, pb, _) = both(servers, "GET", "/v1/models")
    assert js == ps == 200
    assert keys(pb) == keys(jb)
    assert pb["data"][0]["id"] == jb["data"][0]["id"] == "tiny"


@pytest.mark.parametrize("path", ["/api/v1/generate", "/generate"])
def test_generate(servers, path):
    body = {"prompt": "the cat", "max_tokens": 12, **GREEDY}
    (js, jb, _), (ps, pb, _) = both(servers, "POST", path, body)
    assert js == ps == 200
    assert keys(pb) == keys(jb)
    same_result(jb, pb)


def test_generate_stream(servers):
    """Chunked SSE: one {"text": delta} event a delta, then {"done": true}
    with the result; the deltas joined are the result's text and JAX's."""
    body = {"prompt": "a stream", "max_tokens": 16, **GREEDY}
    out = []
    for status, text, hdrs in both(servers, "POST", "/api/v1/generate_stream",
                                   body):
        assert status == 200
        assert hdrs["Transfer-Encoding"] == "chunked"
        evs = [json.loads(e) for e in events(text)]
        assert evs[-1]["done"] is True
        joined = "".join(e["text"] for e in evs[:-1])
        assert joined == evs[-1]["text"]
        out.append((joined, evs[-1]))
    assert out[1][0] == out[0][0]
    assert keys(out[1][1]) == keys(out[0][1])
    same_result(out[0][1], out[1][1])


def test_generate_batch(servers):
    body = {"prompts": ["one", "two two", "three"], "max_tokens": 8,
            **GREEDY}
    (js, jb, _), (ps, pb, _) = both(servers, "POST", "/api/v1/generate_batch",
                                    body)
    assert js == ps == 200
    assert keys(pb) == keys(jb)
    for j, p in zip(jb["results"], pb["results"]):
        same_result(j, p)
    too_many = {"prompts": ["x"] * 33, "max_tokens": 2}
    (js, jb, _), (ps, pb, _) = both(servers, "POST", "/api/v1/generate_batch",
                                    too_many)
    assert js == ps == 400 and keys(pb) == keys(jb)


def test_generate_async_and_result(servers):
    """202 with the result's URL; the result route answers 202 while the
    request runs, then 200 with the result (once), then 404."""
    body = {"prompt": "later", "max_tokens": 40, **GREEDY}
    results = []
    for name in ("jax", "port"):
        port = servers[name].port
        status, acc, _ = call(port, "POST", "/api/v1/generate_async", body)
        assert status == 202
        assert acc["result_url"] == f"/api/v1/result/{acc['id']}"
        codes = set()
        for _ in range(600):
            status, res, _ = call(port, "GET", acc["result_url"])
            codes.add(status)
            if status == 200:
                break
            assert status == 202 and res["status"] in ("pending", "running")
            time.sleep(0.01)
        assert status == 200
        assert call(port, "GET", acc["result_url"])[0] == 404
        results.append((acc, res))
    assert keys(results[1][0]) == keys(results[0][0])
    assert keys(results[1][1]) == keys(results[0][1])
    same_result(results[0][1], results[1][1])


@pytest.mark.parametrize("chat", [False, True])
def test_openai_routes(servers, chat):
    path = "/v1/chat/completions" if chat else "/v1/completions"
    body = {"max_tokens": 10, "temperature": 0.0, "model": "m"}
    if chat:
        body["messages"] = [{"role": "system", "content": "terse"},
                            {"role": "user", "content": "hi"}]
    else:
        body["prompt"] = "once upon"
    (js, jb, _), (ps, pb, _) = both(servers, "POST", path, body)
    assert js == ps == 200
    assert keys(pb) == keys(jb)
    for k in ("object", "model", "usage"):
        assert pb[k] == jb[k]
    assert pb["choices"] == jb["choices"]
    if not chat:
        assert pb["choices"][0]["logprobs"] is None


@pytest.mark.parametrize("chat", [False, True])
def test_openai_streams(servers, chat):
    """SSE chunks of the completion object, a last one with the finish
    reason, then `data: [DONE]`; the deltas joined equal the same request
    served without streaming."""
    path = "/v1/chat/completions" if chat else "/v1/completions"
    body = {"max_tokens": 14, "temperature": 0.0}
    if chat:
        body["messages"] = [{"role": "user", "content": "stream it"}]
    else:
        body["prompt"] = "stream it"
    plain = call(servers["port"].port, "POST", path, body)[1]
    want = plain["choices"][0]["message"]["content"] if chat else \
        plain["choices"][0]["text"]
    shapes = []
    for status, text, _ in both(servers, "POST", path,
                                dict(body, stream=True)):
        assert status == 200
        evs = events(text)
        assert evs[-1] == "[DONE]"
        objs = [json.loads(e) for e in evs[:-1]]
        last = objs[-1]["choices"][0]
        assert last["finish_reason"] == plain["choices"][0]["finish_reason"]
        if chat:
            joined = "".join(o["choices"][0]["delta"].get("content", "")
                             for o in objs)
        else:
            joined = "".join(o["choices"][0]["text"] for o in objs)
        assert joined == want
        shapes.append(keys(objs[0]))
    assert shapes[1] == shapes[0]


J_INT = {"type": "object", "properties": {"n": {"type": "integer"}},
         "required": ["n"]}
J_BOOL = {"type": "object", "properties": {"ok": {"type": "boolean"}},
          "required": ["ok"]}
#: (request fields, the regex its guide compiles)
GUIDED = [
    ({"guided_regex": r"(yes|no) [a-c]{2,4}"}, r"(yes|no) [a-c]{2,4}"),
    ({"guided_choice": ["red", "green", "blue"]}, "red|green|blue"),
    ({"guided_json": J_INT}, json_schema_to_regex(J_INT)),
    ({"response_format": {"type": "json_object"}},
     json_schema_to_regex(None)),
    ({"response_format": {"type": "json_schema",
                          "json_schema": {"schema": J_BOOL}}},
     json_schema_to_regex(J_BOOL)),
]


def _fits(regex, text, finished) -> bool:
    """A finished output matches the regex; one cut by max_tokens is a
    prefix the regex's DFA still accepts a continuation of."""
    dfa = compile_regex(regex)
    state = dfa.step_str(0, text)
    return state >= 0 and (bool(dfa.accept[state]) or not finished)


@pytest.mark.parametrize("case", range(len(GUIDED)))
def test_structured_output_fields(servers, case):
    """Each structured-output field of a request gives the JAX server's
    text, which fits its guide (through /v1/completions and, for the
    first, /api/v1/generate)."""
    fields, regex = GUIDED[case]
    body = {"prompt": "answer:", "max_tokens": 40, "temperature": 0.0,
            **fields}
    (js, jb, _), (ps, pb, _) = both(servers, "POST", "/v1/completions", body)
    assert js == ps == 200
    assert pb["choices"] == jb["choices"]
    choice = pb["choices"][0]
    assert _fits(regex, choice["text"], choice["finish_reason"] == "stop")
    if case < 2:
        assert choice["finish_reason"] == "stop"
    if case == 0:
        (js, jb, _), (ps, pb, _) = both(servers, "POST", "/api/v1/generate",
                                        dict(body, do_sample=False))
        assert js == ps == 200
        same_result(jb, pb)


@pytest.mark.parametrize("method,path,body,code", [
    ("POST", "/api/v1/generate", b"{not json", 400),
    ("POST", "/api/v1/generate", {"max_tokens": 3}, 400),
    ("POST", "/api/v1/generate", {"prompt": "x", "max_tokens": 0}, 400),
    ("POST", "/v1/completions", {"prompt": ""}, 400),
    ("POST", "/v1/chat/completions", {"messages": []}, 400),
    ("POST", "/v1/completions", {"prompt": "x", "guided_choice": "red"}, 400),
    ("POST", "/v1/completions",
     {"prompt": "x", "response_format": {"type": "grammar"}}, 400),
    ("POST", "/api/v1/nowhere", {"prompt": "x"}, 404),
    ("GET", "/nowhere", None, 404),
    ("GET", "/api/v1/result/no-such-id", None, 404),
])
def test_errors(servers, method, path, body, code):
    (js, jb, _), (ps, pb, _) = both(servers, method, path, body)
    assert js == ps == code
    assert keys(pb) == keys(jb)
    assert pb["error"]["type"] == jb["error"]["type"]


def test_auth_and_rate_limit(servers):
    """A bearer token: 401 without it or with another, 200 with it; a rate
    limit of 2 a minute: the third POST answers 429. GET routes pass
    both, as in JAX."""
    codes = []
    for name, cls in (("jax", JServer), ("port", APIServer)):
        sched = servers[name].scheduler
        gated = cls(sched, port=0, auth_token="s3cret",
                    rate_limit_per_minute=3)
        gated.start()
        try:
            body = {"prompt": "hi", "max_tokens": 2, **GREEDY}
            got = [call(gated.port, "POST", "/generate", body)[0],
                   call(gated.port, "POST", "/generate", body,
                        {"Authorization": "Bearer nope"})[0],
                   call(gated.port, "POST", "/generate", body,
                        {"Authorization": "Bearer s3cret"})[0],
                   call(gated.port, "POST", "/generate", body,
                        {"Authorization": "Bearer s3cret"})[0],
                   call(gated.port, "GET", "/health")[0]]
        finally:
            gated.stop()
        codes.append(got)
    assert codes[1] == codes[0] == [401, 401, 200, 429, 200]


def test_stream_disconnect_cancels_the_request(servers):
    """A client that reads the first chunk of a long stream and hangs up:
    the port's server cancels its request, which ends well short of its
    max_tokens, and the engine goes idle."""
    srv = servers["port"]
    sched = srv.scheduler
    asked = []
    real = sched.cancel

    def cancel(rid):
        asked.append(rid)
        return real(rid)

    sched.cancel = cancel
    try:
        body = json.dumps({"prompt": "go on", "max_tokens": 110,
                           **GREEDY}).encode()
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=60)
        sock.sendall(b"POST /api/v1/generate_stream HTTP/1.1\r\n"
                     b"Host: x\r\nContent-Length: " + str(len(body)).encode()
                     + b"\r\n\r\n" + body)
        got = sock.recv(4096)
        assert b"200" in got.split(b"\r\n")[0]
        sock.close()
        for _ in range(500):
            if asked and sched.engine.active_requests == 0:
                break
            time.sleep(0.01)
    finally:
        sched.cancel = real
    assert asked
    assert sched.engine.active_requests == 0


def test_serve_script_answers_on_cpu():
    """The port's serving entry point on the CPU: the URL line, then
    /health and /v1/completions; a refused flag names itself."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeppowers_tpu_torch.scripts.serve",
         "--model", "tiny-llama", "--device", "cpu", "--port", "0",
         "--quantize", "none", "--max-batch", "2", "--decode-steps", "1",
         "--emit-top-logprobs", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        port = None
        for line in proc.stdout:
            m = re.match(r"http://127\.0\.0\.1:(\d+)$", line.strip())
            if m:
                port = int(m.group(1))
                break
        assert port, "no URL line"
        status, health, _ = call(port, "GET", "/health")
        assert status == 200 and health["status"] == "ok"
        status, res, _ = call(port, "POST", "/v1/completions",
                              {"prompt": "hello", "max_tokens": 4,
                               "temperature": 0.0})
        assert status == 200
        assert res["usage"]["completion_tokens"] == 4
        assert res["model"] == "deeppowers"
    finally:
        proc.terminate()
        proc.wait(30)
    bad = subprocess.run(
        [sys.executable, "-m", "deeppowers_tpu_torch.scripts.serve",
         "--mesh", "model=2"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert bad.returncode == 2 and "--mesh" in bad.stderr


def test_chip_smoke_api_serve_runs_on_cpu(monkeypatch):
    """A CPU rehearsal of chip_smoke.py's api_serve phase: its engines on
    a CPU tiny-llama (vocabulary 600 for the trained BPE tokenizer, 1024
    positions), the card-only pieces stood in (launch counts, the graph
    check reads the variant, no profile or timing): every HTTP gate must
    pass, and the variants must be the top-k, guided and guided lookup
    ones."""
    import importlib.util
    from deeppowers_tpu_torch.models import transformer as T
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = tiny_llama_config(vocab_size=600, max_seq_len=1024)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")

    def engine(params, cfg, eos, **rt):
        kw = dict(max_batch_size=8, max_seq_len=1024, scan_layers=False,
                  prefill_buckets=(64, 128, 256, 512, 1024))
        kw.update(rt)
        return InferenceEngine(params, cfg, device="cpu", eos_token_id=eos,
                               act_dtype=torch.float32,
                               runtime=RuntimeConfig(**kw))

    def fail(msg):
        raise AssertionError(msg)

    keys = ["dequant_matmul[gemv]", "dequant_matmul[mma]",
            "flash_attention_prefill", cs.fold_key("decode_attention",
                                                  "bf16")]
    monkeypatch.setattr(cs, "dispatch_engine", engine)
    monkeypatch.setattr(cs, "fail", fail)
    monkeypatch.setattr(cs, "read_counts", lambda c: dict.fromkeys(keys, 1))
    monkeypatch.setattr(cs, "graph_against_eager", lambda torch, eng, name:
                        {"variant": list(eng._variant(True))})
    monkeypatch.setattr(cs, "dispatch_profile", lambda *a: {})
    monkeypatch.setattr(cs, "topk_ms", lambda torch: {})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    out = cs.api_serve(torch, params, cfg, {})
    assert out["top_misses"] == 0 and out["requests"] >= 10
    assert out["lookup"]["spec_steps"] > 0
    assert set(out["guided"]) == {"regex", "choice", "json"}
    for kind, text in out["guided"].items():
        assert cs.guide_misfit(kind, text) is None
    variants = {k: v["variant"] for k, v in out["graph"].items()}
    assert variants["top-k"][0] == "plain" and variants["top-k"][-2:] == \
        [False, cs.API_TOP_K]
    assert variants["guided"][-2:] == [True, cs.API_TOP_K]
    assert variants["guided+lookup"][0] == "lookup"
