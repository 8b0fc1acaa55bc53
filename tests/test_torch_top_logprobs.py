"""Top log-probabilities (`RuntimeConfig.emit_top_logprobs`) in the port
against the JAX engine (engine.py:407-411, 479-482, 1576-1749).

tiny-llama, f32 activations, the same weights in both packages: every
token's top-k ids equal JAX's and the values lie within 1e-5, for the
first token (the raw prefill logits), at N = 1 and 3 steps a dispatch,
pipelined and not, with prompt-lookup and draft-model speculation (rows
(step, window position), the raw verify logits), and under a guide (the
masked logits); a stop id met inside a dispatch cuts the top tokens with
the tokens; a request the page pool preempts keeps its top tokens across
the resume (the scheduler's resume state). `top_logprobs` orders equal
values as `jax.lax.top_k` does (the lower id first), on logits tied on
purpose. The card case (the top-k graph variant against its eager step)
carries the `cuda` marker and skips here.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.config import GenerationConfig as JGen
from deeppowers_tpu.config import RuntimeConfig as JRuntime
from deeppowers_tpu.config import SchedulerConfig as JSchedCfg
from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.models.presets import tiny_llama_config as jax_tiny_llama
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine
from deeppowers_tpu.serving import structured as JS
from deeppowers_tpu.serving.request import Request as JRequest
from deeppowers_tpu.serving.scheduler import Scheduler as JScheduler

from deeppowers_tpu_torch.config import (GenerationConfig, RuntimeConfig,
                                         SchedulerConfig)
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_llama_config
from deeppowers_tpu_torch.ops.sampling import top_logprobs
from deeppowers_tpu_torch.runtime.engine import InferenceEngine
from deeppowers_tpu_torch.serving import structured as PS
from deeppowers_tpu_torch.serving.request import Request
from deeppowers_tpu_torch.serving.scheduler import Scheduler
from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 300
K = 4
PROMPTS = [[5, 9, 7, 3, 5, 9, 7, 3, 5, 9], [11, 12, 13], [40] * 6,
           [1, 2] * 5]


def _tree(p):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                             device="cpu")


@pytest.fixture(scope="module")
def model():
    jcfg = jax_tiny_llama(vocab_size=VOCAB, max_seq_len=256)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    return jcfg, jp, tiny_llama_config(vocab_size=VOCAB, max_seq_len=256), \
        _tree(jp)


@pytest.fixture(scope="module")
def draft():
    jcfg = jax_tiny_llama(vocab_size=VOCAB, max_seq_len=256, num_layers=1)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(8), dtype=jnp.float32)
    return jcfg, jp, tiny_llama_config(vocab_size=VOCAB, max_seq_len=256,
                                       num_layers=1), _tree(jp)


def _engines(model, draft=None, eos=1, layout="contiguous", pages=None,
             **rt):
    jcfg, jp, cfg, tp = model
    kw = dict(max_batch_size=4, max_seq_len=256, prefill_buckets=(16, 32),
              kv_page_size=32, prefill_chunk_size=32, emit_top_logprobs=K)
    kw.update(rt)
    common = dict(eos_token_id=eos, kv_layout=layout, kv_total_pages=pages)
    jd, td = {}, {}
    if draft is not None:
        jd = dict(draft_params=draft[1], draft_cfg=draft[0])
        td = dict(draft_params=draft[3], draft_cfg=draft[2])
    return (JEngine(jp, jcfg, runtime=JRuntime(**kw), act_dtype=jnp.float32,
                    **common, **jd),
            InferenceEngine(tp, cfg, runtime=RuntimeConfig(**kw),
                            act_dtype=torch.float32, device="cpu", **common,
                            **td))


def _gens(n, **kw):
    return (JGen(max_tokens=n, temperature=0.0, do_sample=False, **kw),
            GenerationConfig(max_tokens=n, temperature=0.0, do_sample=False,
                             **kw))


def _same_top(got, want, tol=1e-5):
    """Equal tokens; one top list a token; equal ids; values within tol."""
    assert got.token_ids == want.token_ids
    assert len(got.top_tokens) == len(got.token_ids)
    assert [[i for i, _ in t] for t in got.top_tokens] == \
        [[i for i, _ in t] for t in want.top_tokens]
    np.testing.assert_allclose([[v for _, v in t] for t in got.top_tokens],
                               [[v for _, v in t] for t in want.top_tokens],
                               atol=tol, rtol=0)


RUNTIMES = {
    "N=1": dict(pipelined_dispatch=False),
    "N=1 pipelined": dict(),
    "N=3": dict(decode_steps_per_dispatch=3, pipelined_dispatch=False),
    "N=3 pipelined": dict(decode_steps_per_dispatch=3),
    "lookup": dict(speculative_tokens=3, speculative_ngram=2),
    "lookup N=3": dict(speculative_tokens=2, speculative_ngram=2,
                       decode_steps_per_dispatch=3),
    "draft": dict(speculative_tokens=3),
}


@pytest.mark.parametrize("runtime", list(RUNTIMES))
def test_top_tokens_match_jax(model, draft, runtime):
    jeng, teng = _engines(model, draft if runtime == "draft" else None,
                          **RUNTIMES[runtime])
    gj, gt = _gens(18)
    want = jeng.generate_batch(PROMPTS, gj)
    got = teng.generate_batch(PROMPTS, gt)
    for g, w in zip(got, want):
        _same_top(g, w)
        # the emitted greedy token heads its own list
        for tok, top in zip(g.token_ids, g.top_tokens):
            assert top[0][0] == tok
    if runtime.startswith(("lookup", "draft")):
        assert teng.spec_steps > 0


@pytest.mark.parametrize("n", [1, 4])
def test_first_token_top_is_the_raw_prefill_logits(model, n):
    """A request of one token: its only top list is the first token's,
    over the raw prefill logits; under min_tokens the EOS suppression
    changes the token JAX and the port sample, not the top list."""
    jeng, teng = _engines(model)
    for kw in ({}, dict(min_tokens=2)):
        gj, gt = _gens(n, **kw)
        _same_top(teng.generate(PROMPTS[1], gt), jeng.generate(PROMPTS[1], gj))


@pytest.mark.parametrize("runtime", ["N=1 pipelined", "lookup"])
def test_guided_top_tokens_match_jax(model, runtime):
    """Under a guide a decode step's top list is over the masked logits (a
    disallowed id never appears in it past the first token), a verify
    position's over the raw ones: JAX's either way."""
    jeng, teng = _engines(model, **RUNTIMES[runtime])
    tok = ByteTokenizer()
    gj, gt = _gens(24)
    pat = r"(yes|no) [a-d]{3,6}\."
    JS._GUIDE_CACHE.clear()          # JAX's cache keys on id() alone
    want = jeng.generate(PROMPTS[0], dataclasses.replace(
        gj, guide=JS.compile_guide(pat, tok)))
    got = teng.generate(PROMPTS[0], dataclasses.replace(
        gt, guide=PS.compile_guide(pat, tok)))
    _same_top(got, want)


def test_stop_id_inside_a_dispatch_cuts_the_top_tokens(model):
    """A secondary stop id met in the middle of a 5-step dispatch: the
    tokens, the logprobs and the top lists all end at it, as JAX's."""
    jeng, teng = _engines(model, eos=None, decode_steps_per_dispatch=5,
                          pipelined_dispatch=False)
    free = teng.generate(PROMPTS[1], _gens(20)[1]).token_ids
    stop = free[7]
    gj, gt = _gens(20, stop_token_ids=(9999, stop))
    want, got = jeng.generate(PROMPTS[1], gj), teng.generate(PROMPTS[1], gt)
    _same_top(got, want)
    assert got.token_ids[-1] == stop and got.stop_reason == want.stop_reason
    assert len(got.logprobs) == len(got.top_tokens) == len(got.token_ids) \
        == free.index(stop) + 1


def test_top_tokens_carry_across_preemption(model):
    """Two requests on a 6-page lazy pool: one is preempted and resumed
    from its generated prefix; both complete with the JAX scheduler's
    tokens and top lists, one list a token."""
    jeng, teng = _engines(model, eos=0, layout="paged", pages=6,
                          max_batch_size=2, kv_reserve="lazy",
                          kv_lazy_slack=16)

    def encode(s):
        return [ord(c) % 96 + 1 for c in s]

    def decode(ids):
        return "".join(chr(97 + (t % 26)) for t in ids)

    gj, gt = _gens(90)
    out = []
    for sched, req_cls, g in (
            (JScheduler(jeng, encode=encode, decode=decode,
                        config=JSchedCfg()), JRequest, gj),
            (Scheduler(teng, encode=encode, decode=decode,
                       config=SchedulerConfig()), Request, gt)):
        reqs = [req_cls(request_id=f"q{i}", prompt="abcdefgh", config=g)
                for i in range(2)]
        sched.start()
        try:
            for r in reqs:
                sched.submit(r)
            assert all(r.wait(300.0) for r in reqs)
        finally:
            sched.stop()
        assert sched.preempted_requests >= 1
        out.append([r.result for r in reqs])
    for g, w in zip(out[1], out[0]):
        assert len(g.top_tokens) == g.completion_tokens == 90
        _same_top(g, w)


def _ties(rng, shape):
    """Logits with ties on purpose: a few bf16 levels repeated over the
    vocabulary, some rows masked to -1e30 past a point, one row constant."""
    x = rng.choice(np.array([2.5, 1.0, 1.0, 0.5, -3.0], np.float32),
                   size=shape)
    x = x + rng.integers(0, 3, size=shape).astype(np.float32) * 0.25
    x[..., 0, 40:] = -1e30
    x[..., 1, :] = 0.75
    return x


@pytest.mark.parametrize("shape", [(6, 300), (3, 4, 257), (2, 32000)])
@pytest.mark.parametrize("k", [1, 5, 20])
def test_tie_order_matches_jax_top_k(shape, k):
    """Tied log-probabilities come lower id first, as jax.lax.top_k gives
    them: ids equal, values within 1e-6 (the logsumexp's f32 order)."""
    x = _ties(np.random.default_rng(k + len(shape)), shape)
    jx = jnp.asarray(x)
    tv, ti = jax.lax.top_k(
        jx - jax.scipy.special.logsumexp(jx, axis=-1, keepdims=True), k)
    v, i = top_logprobs(torch.from_numpy(x), k)
    assert i.dtype == torch.int32 and v.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ti))
    np.testing.assert_allclose(v.numpy(), np.asarray(tv), atol=1e-6, rtol=0)


def test_tie_order_of_bf16_logits():
    """bf16 logits widened to f32 (the card's served logits tie often):
    the same ids as jax.lax.top_k over the same f32 values."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 32000)).astype(np.float32)
                         ).to(torch.bfloat16).float()
    jx = jnp.asarray(x.numpy())
    _, ti = jax.lax.top_k(
        jx - jax.scipy.special.logsumexp(jx, axis=-1, keepdims=True), 8)
    np.testing.assert_array_equal(top_logprobs(x, 8)[1].numpy(),
                                  np.asarray(ti))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py's api_serve "
                    "phase holds the top-k and guided graphs against eager)")
    return torch.device("cuda")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("spec_k", [0, 3])
def test_cuda_top_k_graph_equals_eager(cuda_device, spec_k):
    """The top-k variant (and a guided one beside it) replayed as a graph
    against its eager step, bit for bit (chip_smoke.py's
    `graph_against_eager`), plain and with prompt lookup."""
    from deeppowers_tpu_torch.config import QuantConfig
    from deeppowers_tpu_torch.models import transformer as T
    cs = _chip_smoke()
    cfg = tiny_llama_config(max_seq_len=256, vocab_size=512, hidden_size=256,
                            intermediate_size=512)
    params = T.quantize_params(T.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0),
        dtype=torch.bfloat16, device=cuda_device), QuantConfig())
    eng = InferenceEngine(params, cfg, device=cuda_device, eos_token_id=1,
                          runtime=RuntimeConfig(
                              max_batch_size=4, max_seq_len=256,
                              prefill_buckets=(16, 32), emit_top_logprobs=5,
                              speculative_tokens=spec_k))
    tok = ByteTokenizer()
    g = GenerationConfig(max_tokens=30, temperature=0.0)
    eng.add_request([1, 2, 3], g)
    eng.add_request(tok.encode("json:"), dataclasses.replace(
        g, guide=PS.guide_for_json(None, tok)))
    out = cs.graph_against_eager(torch, eng, f"top-k K={spec_k}")
    assert out["variant"][-1] == 5 and out["variant"][-2] is True
