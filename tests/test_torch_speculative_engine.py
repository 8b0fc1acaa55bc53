"""Speculative decoding through the port's engine and scheduler against the
JAX engine: greedy token streams of prompt lookup and of a draft model on
both KV layouts and in the bf16, int8 and k8v4 stores, on tiny-llama, the
trained checkpoint lm124_ckpt and tiny-moe W4A8 g32; the stop rules inside
a window, the cache end, lazy paged reservation with prefix hits and
preemption, the acceptance histogram and the auto-disable policy, the
configuration checks and the scheduler's stats.

Tiny sizes and f32 activations, where the two packages' greedy streams
agree token for token (tests/test_speculative.py's setups); a speculative
engine's greedy stream must also equal the port's own engine without
speculation.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.config import GenerationConfig as JGen
from deeppowers_tpu.config import QuantConfig as JQuant
from deeppowers_tpu.config import QuantMode as JMode
from deeppowers_tpu.config import RuntimeConfig as JRuntime
from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.models.presets import tiny_llama_config as jax_tiny_llama
from deeppowers_tpu.models.presets import tiny_moe_config as jax_tiny_moe
from deeppowers_tpu.runtime.checkpoint import load_checkpoint
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine

from deeppowers_tpu_torch.config import (GenerationConfig, QuantConfig,
                                         QuantMode, RuntimeConfig)
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import (tiny_llama_config,
                                                 tiny_moe_config)
from deeppowers_tpu_torch.runtime.engine import InferenceEngine
from deeppowers_tpu_torch.serving.request import Request
from deeppowers_tpu_torch.serving.scheduler import Scheduler
from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a prompt with strong n-gram repetition, so prompt lookup drafts
REPETITIVE = [5, 9, 7, 3, 5, 9, 7, 3, 5, 9, 7, 3, 5, 9]
PROMPTS = [REPETITIVE, [11, 12, 13], [40] * 10, [1, 2] * 8]
K = 4


def _tree(t):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, t),
                             device="cpu")


def _gen(n, **kw):
    return (JGen(max_tokens=n, do_sample=False, **kw),
            GenerationConfig(max_tokens=n, do_sample=False, **kw))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_llama(max_seq_len=256)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(20), dtype=jnp.float32)
    return jcfg, jparams, tiny_llama_config(max_seq_len=256), _tree(jparams)


@pytest.fixture(scope="module")
def draft():
    """A one-layer draft of tiny-llama's vocabulary and other weights."""
    jcfg = jax_tiny_llama(max_seq_len=256, num_layers=1)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(7), dtype=jnp.float32)
    return (jcfg, jparams, tiny_llama_config(max_seq_len=256, num_layers=1),
            _tree(jparams))


def _runtime(k=K, **kw):
    base = dict(max_batch_size=4, max_seq_len=256,
                prefill_buckets=(32, 64, 128), kv_page_size=32,
                prefill_chunk_size=32, speculative_tokens=k,
                speculative_ngram=2)
    base.update(kw)
    return JRuntime(**base), RuntimeConfig(**base)


def _engines(model, k=K, draft=None, jax_too=True, rt=None, **kw):
    """(JAX engine or None, port engine) over `model`, f32 activations."""
    jcfg, jparams, cfg, tparams = model
    jrt, trt = _runtime(k, **(rt or {}))
    kw.setdefault("eos_token_id", 0)
    jd, td = {}, {}
    if draft is not None:
        jd = dict(draft_params=draft[1], draft_cfg=draft[0])
        td = dict(draft_params=draft[3], draft_cfg=draft[2])
    jeng = (JEngine(jparams, jcfg, runtime=jrt, act_dtype=jnp.float32, **jd,
                    **kw) if jax_too else None)
    teng = InferenceEngine(tparams, cfg, runtime=trt, act_dtype=torch.float32,
                           device="cpu", **td, **kw)
    return jeng, teng


def _ids(results):
    return [r.token_ids for r in results]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("dtype", ["bf16", "int8", "k8v4"])
def test_greedy_streams_match_jax_and_plain(tiny, dtype, layout):
    """Four prompts decoded together with K = 4 prompt lookup: the JAX
    speculative engine's tokens, stop reasons and acceptance histogram,
    and the port's own tokens without speculation; windows accept more
    than one token on the repetitive prompt."""
    gj, gt = _gen(40)
    jeng, teng = _engines(tiny, kv_layout=layout, kv_cache_dtype=dtype)
    _, plain = _engines(tiny, k=0, jax_too=False, kv_layout=layout,
                        kv_cache_dtype=dtype)
    want = jeng.generate_batch(PROMPTS, gj)
    got = teng.generate_batch(PROMPTS, gt)
    assert _ids(got) == _ids(want)
    assert [r.stop_reason for r in got] == [r.stop_reason for r in want]
    assert _ids(plain.generate_batch(PROMPTS, gt)) == _ids(got)
    np.testing.assert_array_equal(teng.spec_accept_hist,
                                  jeng.spec_accept_hist)
    assert teng.spec_window_mean > 1.2 and not teng.spec_disabled
    assert teng.spec_steps == jeng.spec_steps


def test_penalties_match_jax_and_plain(tiny):
    """Repetition, presence and frequency penalties: the window's counts
    advance token by token inside the acceptance, so a greedy stream still
    equals the JAX speculative engine's and the port's plain one."""
    jeng, teng = _engines(tiny)
    _, plain = _engines(tiny, k=0, jax_too=False)
    gj, gt = _gen(32, repetition_penalty=1.3, presence_penalty=0.2,
                  frequency_penalty=0.1)
    want = _ids(jeng.generate_batch(PROMPTS[:2], gj))
    assert _ids(teng.generate_batch(PROMPTS[:2], gt)) == want
    assert _ids(plain.generate_batch(PROMPTS[:2], gt)) == want


@pytest.fixture(scope="module")
def lm124():
    jparams, jcfg, _ = load_checkpoint(os.path.join(REPO, "lm124_ckpt"))
    cfg = T.TransformerConfig(**{f: getattr(jcfg, f) for f in
                                 jcfg.__dataclass_fields__})
    return jcfg, jparams, cfg, _tree(jparams)


def _text_ids(text: str):
    return [c + 4 for c in text.encode()]


@pytest.mark.parametrize("layout, dtype", [("contiguous", "bf16"),
                                           ("paged", "k8v4")])
def test_lm124_spec_matches_jax_and_plain(lm124, layout, dtype):
    """The trained checkpoint (12 layers, GQA 12/6): text whose continuation
    repeats, where prompt lookup accepts; the JAX engine's tokens and
    histogram, and the port's plain stream."""
    prompts = [_text_ids("the cat sat on the mat. the cat sat on the mat. "
                         "the cat sat on the"),
               _text_ids("once upon a time, once upon a")]
    rt = dict(max_batch_size=2, max_seq_len=128, prefill_buckets=(64, 128))
    jeng, teng = _engines(lm124, rt=rt, eos_token_id=None, kv_layout=layout,
                          kv_cache_dtype=dtype)
    _, plain = _engines(lm124, k=0, rt=rt, jax_too=False, eos_token_id=None,
                        kv_layout=layout, kv_cache_dtype=dtype)
    gj, gt = _gen(16)
    want = _ids(jeng.generate_batch(prompts, gj))
    assert _ids(teng.generate_batch(prompts, gt)) == want
    assert _ids(plain.generate_batch(prompts, gt)) == want
    np.testing.assert_array_equal(teng.spec_accept_hist,
                                  jeng.spec_accept_hist)


def test_tiny_moe_w4a8_spec_matches_jax_and_plain():
    """tiny-moe at W4A8 g32 with int8 KV: a verify window of 3 slots x 5
    tokens (15 < 256: the cat branch through #1, as JAX picks it) gives the
    JAX engine's tokens and the port's plain ones."""
    jcfg = jax_tiny_moe(max_seq_len=256)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    fields = dict(group_size=32, act_bits=8)
    jq = JT.quantize_params(jparams, JQuant(mode=JMode("int4"), **fields))
    tq = T.quantize_params(_tree(jparams),
                           QuantConfig(mode=QuantMode("int4"), **fields))
    model = (jcfg, jq, tiny_moe_config(max_seq_len=256), tq)
    rt = dict(max_batch_size=3)
    jeng, teng = _engines(model, rt=rt, eos_token_id=None,
                          kv_cache_dtype="int8")
    _, plain = _engines(model, k=0, rt=rt, jax_too=False, eos_token_id=None,
                        kv_cache_dtype="int8")
    gj, gt = _gen(12)
    want = _ids(jeng.generate_batch(PROMPTS[:3], gj))
    assert _ids(teng.generate_batch(PROMPTS[:3], gt)) == want
    assert _ids(plain.generate_batch(PROMPTS[:3], gt)) == want


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_draft_model_streams_match_jax_and_plain(tiny, draft, layout):
    """A one-layer draft of the same vocabulary, its own contiguous cache
    in the target's store (k8v4): the JAX draft engine's tokens and
    histogram, the port's plain tokens, and its cost ratio 1 + K * (draft
    bytes / target bytes)."""
    jeng, teng = _engines(tiny, draft=draft, kv_layout=layout,
                          kv_cache_dtype="k8v4")
    _, plain = _engines(tiny, k=0, jax_too=False, kv_layout=layout,
                        kv_cache_dtype="k8v4")
    assert teng._spec_cost_ratio == pytest.approx(jeng._spec_cost_ratio,
                                                  rel=1e-6)
    assert teng._draft_caches[0].vbits == 4 and teng._history is None
    gj, gt = _gen(24)
    want = jeng.generate_batch(PROMPTS, gj)
    got = teng.generate_batch(PROMPTS, gt)
    assert _ids(got) == _ids(want)
    assert _ids(plain.generate_batch(PROMPTS, gt)) == _ids(want)
    np.testing.assert_array_equal(teng.spec_accept_hist,
                                  jeng.spec_accept_hist)


@pytest.fixture(scope="module")
def tied():
    """tests/test_speculative.py's model: 2 layers, 4 heads, tied
    embeddings, PRNGKey(0)."""
    fields = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                  max_seq_len=256, positions="rope", norm="rmsnorm",
                  glu=True, activation="silu", qkv_bias=False,
                  attn_out_bias=False, mlp_bias=False, tie_embeddings=True)
    jcfg = JT.TransformerConfig(**fields)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jparams, T.TransformerConfig(**fields), _tree(jparams)


def test_perfect_draft_accepts_whole_windows(tied, tiny):
    """The target as its own draft: every window accepts all K drafts and
    the bonus token, so 40 tokens after the first take 8 steps, as in the
    JAX engine on tests/test_speculative.py's model. On tiny-llama the JAX
    engine needs 11 steps: after a whole window its draft cache lacks the
    last draft's row (JAX speculative.py:357-381), which the port writes
    first in the next step, so its windows stay whole."""
    gj, gt = _gen(41)
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    for model, jax_steps in ((tied, 8), (tiny, 11)):
        jeng, teng = _engines(model, draft=model)
        assert (teng.generate(prompt, gt).token_ids
                == jeng.generate(prompt, gj).token_ids)
        assert jeng.spec_steps == jax_steps
        assert teng.spec_steps == 8 and teng.spec_accept_hist[K + 1] == 8
        assert teng.spec_mean_accepted == K + 1


def test_draft_cache_holds_every_accepted_token(tiny):
    """After speculative steps with the target as its own draft (f32), the
    draft cache's rows below each slot's length equal the target cache's
    rows (written by the verify forwards; 1e-5), the rows of whole
    windows' last drafts included; only the last step's whole windows
    still owe theirs, written at the start of the next step."""
    _, teng = _engines(tiny, draft=tiny, jax_too=False)
    for p in PROMPTS[:3]:
        teng.add_request(p, GenerationConfig(max_tokens=60, do_sample=False))
    for _ in range(6):
        teng.step()
    assert teng.spec_accept_hist[K + 1] >= 3
    owed = teng._draft_tail[1].tolist()
    lens = [n - o for n, o in zip(teng.state.lengths.tolist(), owed)]
    for tc, dc in zip(teng.caches, teng._draft_caches):
        for slot, n in enumerate(lens[:3]):
            for a, b in ((tc.k, dc.k), (tc.v, dc.v)):
                torch.testing.assert_close(a[slot, :n], b[slot, :n],
                                           atol=1e-5, rtol=1e-5)


def test_max_tokens_and_min_tokens(tiny):
    """max_tokens holds inside a window (a window that would pass it emits
    only up to it); min_tokens keeps the EOS id out of the first tokens,
    as the engine without speculation does."""
    _, teng = _engines(tiny, jax_too=False)
    _, plain = _engines(tiny, k=0, jax_too=False)
    for n in (1, 2, 7, 10):
        g = GenerationConfig(max_tokens=n, do_sample=False)
        res = teng.generate(REPETITIVE, g)
        assert res.token_ids == plain.generate(REPETITIVE, g).token_ids
        assert len(res.token_ids) == n and res.stop_reason == "max_tokens"
    g = GenerationConfig(max_tokens=16, min_tokens=8, do_sample=False)
    res = teng.generate(REPETITIVE, g)
    assert 0 not in res.token_ids[:7]
    assert res.token_ids == plain.generate(REPETITIVE, g).token_ids


def test_stop_id_inside_a_window_cuts_there(tiny):
    """A secondary stop id emitted inside a multi-token window (the target
    drafting for itself, so windows accept new tokens) ends the request at
    it: the tokens after it in the window are dropped, as the plain engine
    never emits them."""
    _, teng = _engines(tiny, draft=tiny, jax_too=False, eos_token_id=None)
    _, plain = _engines(tiny, k=0, jax_too=False, eos_token_id=None)
    stream = plain.generate(REPETITIVE, GenerationConfig(
        max_tokens=40, do_sample=False)).token_ids
    windows = []
    _, probe = _engines(tiny, draft=tiny, jax_too=False, eos_token_id=None)
    probe.add_request(REPETITIVE, GenerationConfig(max_tokens=40,
                                                   do_sample=False))
    while probe.active_requests:
        windows += [t for t in probe.step().values()]
    # a token first seen inside (not last in) a window of several
    first = {}
    for i, t in enumerate(stream):
        first.setdefault(t, i)
    pos, stop = 1, None
    for w in windows:
        for j, t in enumerate(w[:-1]):
            if first[t] == pos + j and first[t] > 0:
                stop = t
                break
        if stop is not None:
            break
        pos += len(w)
    assert stop is not None
    g = GenerationConfig(max_tokens=40, do_sample=False,
                         stop_token_ids=[stop])
    res = teng.generate(REPETITIVE, g)
    want = plain.generate(REPETITIVE, g)
    assert res.token_ids == want.token_ids == stream[:first[stop] + 1]
    assert res.stop_reason == want.stop_reason == "eos"


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_cache_end_matches_jax_and_plain(tiny, layout):
    """A 200-token prompt into a 256-row cache with room for 500 tokens:
    windows run into the capacity guard (max_seq - 1) and past the cache
    end (dropped writes); the JAX engine's tokens and stop reason, the
    port's plain ones, and a healthy request afterwards."""
    long_prompt = [int(x) for x in np.random.RandomState(2).randint(
        1, 127, 200)]
    jeng, teng = _engines(tiny, kv_layout=layout)
    _, plain = _engines(tiny, k=0, jax_too=False, kv_layout=layout)
    gj, gt = _gen(500)
    want = jeng.generate(long_prompt, gj)
    got = teng.generate(long_prompt, gt)
    assert got.token_ids == want.token_ids
    assert got.stop_reason == want.stop_reason == "max_seq"
    assert plain.generate(long_prompt, gt).token_ids == got.token_ids
    gj, gt = _gen(8)
    assert (teng.generate(REPETITIVE, gt).token_ids
            == jeng.generate(REPETITIVE, gj).token_ids)


def test_lazy_paged_prefix_cache_and_preemption_match_jax(tiny):
    """Lazy reservation that grows (K + 1) + K rows ahead, a prefix hit on
    a shared page, and a pool too small for two long requests: the younger
    is preempted at the same step as in the JAX engine, and both engines
    give the same tokens, prefix counts and preemptions."""
    rt = dict(max_batch_size=2, kv_reserve="lazy", kv_lazy_slack=16,
              enable_prefix_cache=True)
    jeng, teng = _engines(tiny, rt=rt, kv_layout="paged", kv_total_pages=6)
    out = []
    for eng, g, g4 in ((jeng, *[g for g in zip(_gen(150), _gen(4))][0]),
                       (teng, *[g for g in zip(_gen(150), _gen(4))][1])):
        done = {}
        eng.generate(REPETITIVE * 3, g4)
        eng.add_request(REPETITIVE * 3 + [1, 2], g, request_id="old")
        eng.add_request([5, 6, 7, 8], g, request_id="young")
        for _ in range(400):
            eng.step()
            for r in eng.pop_finished():
                done.setdefault(r.request_id, []).append(
                    (r.stop_reason, r.token_ids))
            if eng.active_requests == 0:
                break
        out.append((done, eng.prefix_cache_stats))
    assert out[1] == out[0]
    assert [s for s, _ in out[1][0]["young"]] == ["preempted"]
    assert out[1][1]["hits"] >= 1


def test_auto_disable_below_break_even(tiny, draft):
    """Prompts without repeated bigrams, sampled: prompt lookup accepts
    about one token a window and turns itself off after the probe windows
    at a 1.2 threshold, then serves plain; a draft model's threshold scales
    by its cost ratio, so a useless same-size draft turns off at 0.5,
    where prompt lookup stays on."""
    rt = dict(max_batch_size=2, prefill_buckets=(32, 64),
              speculative_min_accepted=1.2, speculative_probe_steps=8)
    _, eng = _engines(tiny, jax_too=False, rt=rt)
    gen = GenerationConfig(max_tokens=40, temperature=1.5, seed=3)
    eng.generate(list(range(1, 30)), gen)
    assert eng.spec_disabled and eng._spec_k == 0
    assert eng.spec_accept_hist.sum() >= 8
    res = eng.generate([1, 2, 3], GenerationConfig(max_tokens=5,
                                                   do_sample=False))
    assert len(res.token_ids) == 5
    jcfg, _, cfg, _ = tiny
    bad = T.init_params(cfg, torch.Generator().manual_seed(99),
                        dtype=torch.float32)
    rt["speculative_min_accepted"] = 0.5
    _, eng = _engines(tiny, jax_too=False, rt=rt,
                      draft=(jcfg, None, cfg, bad))
    assert eng._spec_cost_ratio == pytest.approx(1 + K, rel=0.05)
    eng.generate(list(range(1, 30)), gen)
    assert eng.spec_disabled
    _, eng = _engines(tiny, jax_too=False, rt=rt)
    eng.generate(list(range(1, 30)), gen)
    assert not eng.spec_disabled


@pytest.mark.parametrize("case", ["bucket", "vocab", "no_cfg"])
def test_configuration_checks_raise(tiny, draft, case):
    """K + 1 must stay below the smallest prefill bucket; a draft needs its
    config and the target's vocabulary (the JAX engine's checks)."""
    _, _, cfg, tparams = tiny
    _, trt = _runtime()
    kw = {}
    if case == "bucket":
        _, trt = _runtime(prefill_buckets=(5, 64))
    elif case == "vocab":
        dcfg = tiny_llama_config(max_seq_len=256, vocab_size=100)
        kw = dict(draft_params=T.init_params(
            dcfg, torch.Generator().manual_seed(0)), draft_cfg=dcfg)
    else:
        kw = dict(draft_params=draft[3])
    with pytest.raises(ValueError):
        InferenceEngine(tparams, cfg, runtime=trt, device="cpu", **kw)


@pytest.mark.parametrize("drafting", ["lookup", "draft"])
def test_speculation_with_top_logprobs_matches_jax(tiny, draft, drafting):
    """emit_top_logprobs = 2 beside speculation, once refused, runs: with
    prompt lookup and with a draft model every token's top-2 ids equal
    the JAX engine's (rows (step, window position)), values within 1e-5,
    and the tokens are JAX's."""
    jeng, teng = _engines(tiny, draft=draft if drafting == "draft" else None,
                          rt=dict(emit_top_logprobs=2))
    gj, gt = _gen(20)
    want = jeng.generate_batch(PROMPTS, gj)
    got = teng.generate_batch(PROMPTS, gt)
    assert teng.spec_steps > 0
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        assert len(g.top_tokens) == len(g.token_ids)
        assert [[i for i, _ in t] for t in g.top_tokens] == \
            [[i for i, _ in t] for t in w.top_tokens]
        np.testing.assert_allclose([[v for _, v in t] for t in g.top_tokens],
                                   [[v for _, v in t] for t in w.top_tokens],
                                   atol=1e-5, rtol=0)


def test_reset_clears_speculation(tiny, draft):
    """reset() (the scheduler's recovery) clears the history, the draft
    cache and the counters; generation afterwards is unchanged."""
    _, teng = _engines(tiny, draft=draft, jax_too=False)
    gt = _gen(12)[1]
    first = teng.generate(REPETITIVE, gt).token_ids
    assert teng.spec_steps > 0
    teng.reset()
    assert teng.spec_steps == teng.spec_emitted == 0
    assert teng.spec_accept_hist.sum() == 0
    assert all(not c.k.any() for c in teng._draft_caches)
    assert teng.generate(REPETITIVE, gt).token_ids == first


def test_scheduler_streams_windows_and_reports_stats(tiny):
    """Through the scheduler with a byte tokenizer: each request's streamed
    pieces join to its text in order although steps emit several tokens,
    and stats()["speculative"] reports the window mean and histogram."""
    _, _, cfg, tparams = tiny
    _, trt = _runtime(max_seq_len=256)
    tok = ByteTokenizer()
    eng = InferenceEngine(tparams, cfg, runtime=trt, device="cpu",
                          act_dtype=torch.float32,
                          eos_token_id=tok.eos_token_id)
    sched = Scheduler(eng, encode=tok.encode, decode=tok.decode)
    pieces = {i: [] for i in range(3)}
    reqs = []
    for i, text in enumerate(["abcabcabcabc", "hello hello hello",
                              "xyz"]):
        r = Request(prompt=text, config=GenerationConfig(
            max_tokens=24, do_sample=False))
        r.stream_callback = (lambda d, i=i: pieces[i].append(d) or True)
        reqs.append(r)
        sched.submit(r)
    sched.start()
    try:
        assert all(r.wait(120.0) for r in reqs)
    finally:
        sched.stop()
    for i, r in enumerate(reqs):
        assert r.status.name == "COMPLETED"
        assert "".join(pieces[i]) == r.result.text
    st = sched.stats()["speculative"]
    assert st["accept_hist"] == eng.spec_accept_hist.tolist()
    assert sum(st["accept_hist"]) > 0 and st["window_mean_accepted"] >= 1.0
    assert st["disabled"] is False


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["bf16", "k8v4"])
def test_chip_smoke_verify_path_runs_on_cpu(dtype):
    """chip_smoke.py's spec_path phase on a tiny model on the CPU (plain
    versions): the teacher-forced verify logits of both layouts equal, and
    within the phase's 5e-2 of five sequential decode steps."""
    cs = _chip_smoke()
    cfg = tiny_llama_config(vocab_size=260, max_seq_len=2048)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32)
    ids, window = list(range(5, 45)), [7, 8, 9, 10, 11]
    out = [cs.verify_logits(torch, T, params, cfg, ids, window, "cpu",
                            paged=paged, kv_cache_dtype=dtype)
           for paged in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    for verify, seq in out:
        assert verify.shape == (5, cfg.vocab_size)
        assert torch.isfinite(verify).all()
        assert ((verify - seq).norm() / seq.norm()).item() <= 5e-2


@pytest.mark.parametrize("order", [0, 3, 17])
def test_chip_smoke_spec_paged_traffic_preempts_hits_and_chunks(order):
    """chip_smoke.py's spec_paged_serve[k8v4] requires preemption, a prefix
    hit and a two-chunk prompt under K = 4 speculation (pages grow 2K + 2
    rows ahead): its traffic, pool and lazy slack on a tiny model on the
    CPU through the scheduler in three arrival orders (3 and 17 did not
    preempt at a slack of 64), and windows that accept more than one
    token."""
    import random
    cs = _chip_smoke()
    cfg = tiny_llama_config(vocab_size=260, max_seq_len=2048)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32)
    tok = ByteTokenizer()
    engine = cs.paged_engine(params, cfg, "cpu", tok.eos_token_id, "k8v4",
                             spec_k=cs.SPEC_K, slack=cs.SPEC_PAGED_SLACK)
    sched = Scheduler(engine, encode=tok.encode, decode=tok.decode)
    gen = GenerationConfig(max_tokens=cs.PAGED_MAX_TOKENS, temperature=0.0)
    prompts = cs.paged_prompts()
    random.Random(order).shuffle(prompts)
    reqs = [Request(prompt=p, config=gen) for p in prompts]
    for r in reqs:
        sched.submit(r)
    sched.start()
    try:
        assert all(r.wait(240.0) for r in reqs)
    finally:
        sched.stop()
    assert all(r.status.name == "COMPLETED" for r in reqs)
    assert sched.preempted_requests >= 1
    assert engine.prefix_cache_stats["hits"] >= 1
    assert max(engine.chunks.values()) >= 2
    assert engine.spec_steps > 0 and engine.spec_window_mean > 1.0
