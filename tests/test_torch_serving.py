"""The port's host side on the CPU: config JSON round trip, sampling, the
scheduler and the HTTP server end to end, and the server's lifecycle."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from deeppowers_tpu.config import RuntimeConfig as JRuntime
from deeppowers_tpu.config import config_to_json as jax_config_to_json
from deeppowers_tpu.serving.tokenizer import ByteTokenizer as JByteTokenizer

from deeppowers_tpu_torch.config import (GenerationConfig, QuantConfig,
                                         QuantMode, RuntimeConfig,
                                         SchedulerConfig, config_from_json,
                                         config_to_json)
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.presets import tiny_llama_config
from deeppowers_tpu_torch.ops.sampling import SamplingParams, sample
from deeppowers_tpu_torch.runtime.engine import InferenceEngine
from deeppowers_tpu_torch.serving.scheduler import Scheduler
from deeppowers_tpu_torch.serving.server import APIServer
from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(1)


@pytest.mark.parametrize("cfg", [
    QuantConfig(mode=QuantMode.INT8, layer_overrides={"mlp": "int4"},
                skip_layers=("lm_head",)),
    GenerationConfig(max_tokens=7, stop_tokens=("x",), stop_token_ids=(3,)),
    RuntimeConfig(max_batch_size=8, prefill_buckets=(64, 128)),
    SchedulerConfig(max_queue_size=5),
])
def test_config_json_roundtrip(cfg):
    back = config_from_json(type(cfg), config_to_json(cfg))
    assert back == cfg


def test_runtime_config_json_matches_jax():
    assert json.loads(config_to_json(RuntimeConfig())) == json.loads(
        jax_config_to_json(JRuntime()))


def test_byte_tokenizer_matches_jax():
    text = "héllo, wörld ✓"
    assert ByteTokenizer().encode(text) == JByteTokenizer().encode(text)
    ids = JByteTokenizer().encode(text) + [0, 1, 2]
    assert ByteTokenizer().decode(ids) == JByteTokenizer().decode(ids) == text


def test_sampling_distribution_and_greedy():
    """Sampled tokens follow softmax(logits / T) within top-k/top-p; greedy
    slots take the argmax in the same batch."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, -8.0]] * 2)
    cfg = GenerationConfig(temperature=1.0, top_k=4, top_p=1.0)
    sp = SamplingParams.from_config(cfg, 2)
    sp.temperature[1] = 0.0                      # slot 1 greedy
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(5)
    for _ in range(4000):
        tok = sample(logits, sp, gen)
        assert int(tok[1]) == 0
        counts[int(tok[0])] += 1
    want = torch.softmax(logits[0, :4], -1).numpy()
    assert counts[4] == 0                          # outside top-k
    np.testing.assert_allclose(counts[:4] / counts.sum(), want, atol=0.03)


def test_sampling_top_p_keeps_nucleus_only():
    logits = torch.tensor([[3.0, 2.9, 0.0, -1.0]])
    sp = SamplingParams.from_config(
        GenerationConfig(temperature=1.0, top_k=0, top_p=0.5), 1)
    gen = torch.Generator().manual_seed(1)
    seen = {int(sample(logits, sp, gen)[0]) for _ in range(300)}
    assert seen <= {0, 1} and 0 in seen


@pytest.fixture
def served():
    cfg = tiny_llama_config(vocab_size=260, max_seq_len=128)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32)
    params = T.quantize_params(params, QuantConfig())
    engine = InferenceEngine(
        params, cfg, act_dtype=torch.float32, device="cpu",
        runtime=RuntimeConfig(max_batch_size=4, max_seq_len=128,
                              prefill_buckets=(16, 32, 64, 128)))
    tok = ByteTokenizer()
    sched = Scheduler(engine, encode=tok.encode, decode=tok.decode)
    sched.start()
    server = APIServer(sched, host="127.0.0.1", port=0)
    server.start()
    yield engine, sched, server
    server.stop()
    sched.stop()


def _post(port, body, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_server_round_trip_matches_engine(served):
    """Concurrent HTTP requests (more than the slots) come back with the
    tokens the engine gives the same prompts directly."""
    engine, sched, server = served
    prompts = ["a", "hello there", "the cat sat on the mat", "x" * 40,
               "batch", "sixth prompt"]
    out = [None] * len(prompts)

    def run(i):
        out[i] = _post(server.port, {"prompt": prompts[i], "max_tokens": 6,
                                     "temperature": 0.0})

    threads = [threading.Thread(target=run, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    sched.stop()                       # the engine is ours again
    tok = ByteTokenizer()
    for p, (status, body) in zip(prompts, out):
        assert status == 200
        assert body["stop_reason"] == "max_tokens"
        assert body["usage"]["completion_tokens"] == 6
        assert body["usage"]["prompt_tokens"] == len(tok.encode(p))
        direct = engine.generate(tok.encode(p), GenerationConfig(
            max_tokens=6, temperature=0.0))
        assert body["tokens"] == direct.token_ids
        assert body["text"] == tok.decode(direct.token_ids)


def test_server_health_and_errors(served):
    _, _, server = served
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/health",
                                timeout=10) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["healthy"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, {"max_tokens": 3})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.port, {"prompt": "x", "temperature": 9.0})
    assert e.value.code == 400


def test_stop_joins_threads(served):
    _, sched, server = served
    server.stop()
    sched.stop()
    names = {t.name for t in threading.enumerate()}
    assert "deeppowers-http" not in names
    assert "deeppowers-scheduler" not in names
