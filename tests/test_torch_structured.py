"""Structured output in the port against the JAX package.

The compiler (deeppowers_tpu_torch/serving/structured.py, a copy of
deeppowers_tpu/serving/structured.py): for the patterns of
tests/test_structured.py, the DFA's transition and accept arrays and its
byte classes equal JAX's; `json_schema_to_regex` makes JAX's regex, string
for string; `build_guide`'s allow, next and EOS arrays equal JAX's over
the byte tokenizer and a BPE tokenizer trained in both packages.

The engine (runtime/engine.py, runtime/speculative.py): guided greedy
streams of tiny-llama (f32, the same weights in both packages) equal the
JAX engine's token for token, with the same stop reasons, at N = 1 and 3
steps a dispatch, pipelined and not, with prompt-lookup and draft-model
speculation, guided and unguided slots in one batch; every output
matches its guide. With no EOS id a guided slot stops at an accept-only
state with "guide_complete", in plain decode and inside a speculative
window. The Decision on near ties does not come into play here: every
stream is equal.
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.config import GenerationConfig as JGen
from deeppowers_tpu.config import RuntimeConfig as JRuntime
from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.models.presets import tiny_llama_config as jax_tiny_llama
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine
from deeppowers_tpu.serving import structured as JS
from deeppowers_tpu.serving import tokenizer as JTok

from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_llama_config
from deeppowers_tpu_torch.runtime.engine import InferenceEngine
from deeppowers_tpu_torch.serving import structured as PS
from deeppowers_tpu_torch.serving import tokenizer as PTok

torch.set_num_threads(1)

PATTERNS = [
    r"abc", r"a(b|c)*d", r"[a-f]{2,4}", r"-?(0|[1-9][0-9]*)",
    r'"(?:[^"\\]|\\.)*"', r"(?:red|green|blue)", r"a+b?c*", r"\d{3}-\d{4}",
    r"[^x]*x", r"(ab){2,}", r"[α-ω]+", r"héllo|wörld", r'"[^"]*"',
    r'[^\x00-\x1f"]*', r"ab(c|d)e",
]
SCHEMAS = [
    None,
    {"type": "string"},
    {"type": "object", "properties": {
        "name": {"type": "string"}, "age": {"type": "integer"},
        "tags": {"type": "array", "items": {"type": "string"}},
        "ok": {"type": "boolean"}}, "required": ["name", "age"]},
    {"enum": ["a", 1, True, None]},
    {"anyOf": [{"type": "integer"}, {"type": "boolean"}]},
    {"type": "array", "items": {"type": "integer"}, "minItems": 1,
     "maxItems": 3},
    {"type": "number"},
]
CORPUS = ["the cat sat on the mat", "yes no maybe", '{"name": "bob"}',
          "red green blue 123-4567"] * 4


def _bpe():
    return (JTok.BPETokenizer.train(CORPUS, vocab_size=300),
            PTok.BPETokenizer.train(CORPUS, vocab_size=300))


def _same_dfa(p, j):
    assert np.array_equal(p.trans, j.trans)
    assert np.array_equal(p.accept, j.accept)
    assert [p.alphabet.class_of_byte(b) for b in range(256)] == \
        [j.alphabet.class_of_byte(b) for b in range(256)]


@pytest.mark.parametrize("pattern", PATTERNS)
def test_dfa_arrays_match_jax(pattern):
    _same_dfa(PS.compile_regex(pattern), JS.compile_regex(pattern))


@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("schema", range(len(SCHEMAS)))
def test_schema_regex_matches_jax(schema, depth):
    s = SCHEMAS[schema]
    got = PS.json_schema_to_regex(s, depth=depth)
    assert got == JS.json_schema_to_regex(s, depth=depth)
    if depth == 2:
        _same_dfa(PS.compile_regex(got), JS.compile_regex(got))


@pytest.mark.parametrize("tok", ["byte", "bpe"])
@pytest.mark.parametrize("pattern", [r"(?:red|green|blue)", r"\d{3}-\d{4}",
                                     r'"(?:[^"\\]|\\.)*"', r"[α-ω]+",
                                     "json", "choice"])
def test_build_guide_matches_jax(pattern, tok):
    jt, pt = ((JTok.ByteTokenizer(), PTok.ByteTokenizer()) if tok == "byte"
              else _bpe())
    JS._GUIDE_CACHE.clear()          # JAX's cache keys on id() alone
    assert PS.token_bytes(pt) == JS.token_bytes(jt)
    if pattern == "json":
        got, want = (PS.guide_for_json(SCHEMAS[2], pt),
                     JS.guide_for_json(SCHEMAS[2], jt))
    elif pattern == "choice":
        got, want = (PS.guide_for_choice(["yes", "no", "maybe"], pt),
                     JS.guide_for_choice(["yes", "no", "maybe"], jt))
    else:
        got, want = (PS.compile_guide(pattern, pt),
                     JS.compile_guide(pattern, jt))
    assert np.array_equal(got.allow, want.allow)
    assert np.array_equal(got.next_state, want.next_state)
    assert np.array_equal(got.eos_allowed, want.eos_allowed)
    assert got.key == want.key


# -- the engine ---------------------------------------------------------------

VOCAB = 300


@pytest.fixture(scope="module")
def model():
    jcfg = jax_tiny_llama(vocab_size=VOCAB, max_seq_len=128)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(11), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, jp, tiny_llama_config(vocab_size=VOCAB, max_seq_len=128), tp


@pytest.fixture(scope="module")
def draft():
    jcfg = jax_tiny_llama(vocab_size=VOCAB, max_seq_len=128, num_layers=1)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, jp, tiny_llama_config(vocab_size=VOCAB, max_seq_len=128,
                                       num_layers=1), tp


def _engines(model, draft=None, eos=1, **rt):
    jcfg, jp, cfg, tp = model
    kw = dict(max_batch_size=4, max_seq_len=128, prefill_buckets=(16, 32))
    kw.update(rt)
    jd, td = {}, {}
    if draft is not None:
        jd = dict(draft_params=draft[1], draft_cfg=draft[0])
        td = dict(draft_params=draft[3], draft_cfg=draft[2])
    return (JEngine(jp, jcfg, runtime=JRuntime(**kw), act_dtype=jnp.float32,
                    eos_token_id=eos, **jd),
            InferenceEngine(tp, cfg, runtime=RuntimeConfig(**kw),
                            act_dtype=torch.float32, device="cpu",
                            eos_token_id=eos, **td))


#: (kind, spec)
GUIDES = [
    ("regex", r"(yes|no|maybe) [a-c]{2,5}!"),
    ("choice", ["red", "green", "blue"]),
    ("json", {"type": "object", "properties": {
        "n": {"type": "integer"}, "ok": {"type": "boolean"}},
        "required": ["n", "ok"]}),
]


def _guide(mod, tok, kind, spec):
    if mod is JS:
        # JAX's cache keys on id(tokenizer) alone: a tokenizer of an
        # earlier test, freed, may have left its guide under this id
        JS._GUIDE_CACHE.clear()
    if kind == "regex":
        return mod.compile_guide(spec, tok)
    if kind == "choice":
        return mod.guide_for_choice(spec, tok)
    return mod.guide_for_json(spec, tok)


def _matches(kind, spec, text) -> bool:
    if kind == "regex":
        return re.fullmatch(spec, text) is not None
    if kind == "choice":
        return text in spec
    obj = json.loads(text)
    return set(obj) == {"n", "ok"} and isinstance(obj["n"], int) and \
        isinstance(obj["ok"], bool)


def _stream(eng, mod, gen_cls, tok, prompts, guides, max_tokens=28):
    base = gen_cls(max_tokens=max_tokens, temperature=0.0, do_sample=False)
    for i, (p, g) in enumerate(zip(prompts, guides)):
        gen = base if g is None else dataclasses.replace(
            base, guide=_guide(mod, tok, *g))
        eng.add_request(tok.encode(p), gen, request_id=f"r{i}")
    done = {}
    for _ in range(400):
        eng.step()
        for r in eng.pop_finished():
            done[r.request_id] = (r.stop_reason, list(r.token_ids))
        if len(done) == len(prompts):
            break
    return [done[f"r{i}"] for i in range(len(prompts))]


RUNTIMES = {
    "N=1": dict(pipelined_dispatch=False),
    "N=1 pipelined": dict(),
    "N=3 pipelined": dict(decode_steps_per_dispatch=3),
    "lookup": dict(speculative_tokens=3, speculative_ngram=2),
    "lookup N=3": dict(speculative_tokens=2, decode_steps_per_dispatch=3),
    "draft": dict(speculative_tokens=3),
}


@pytest.mark.parametrize("tok", ["byte", "bpe"])
@pytest.mark.parametrize("runtime", list(RUNTIMES))
def test_guided_greedy_streams_match_jax(model, draft, runtime, tok):
    """Three guided requests and one unguided request decode together:
    the same tokens and stop reasons as the JAX engine, every guided
    output a match of its guide (the EOS that ends it aside)."""
    jt, pt = ((JTok.ByteTokenizer(), PTok.ByteTokenizer()) if tok == "byte"
              else _bpe())
    d = draft if runtime == "draft" else None
    jeng, teng = _engines(model, d, **RUNTIMES[runtime])
    prompts = ["answer:", "colour:", "json:", "free text"]
    guides = GUIDES + [None]
    want = _stream(jeng, JS, JGen, jt, prompts, guides)
    got = _stream(teng, PS, GenerationConfig, pt, prompts, guides)
    assert got == want
    for (reason, ids), g in zip(got, guides):
        if g is None:
            continue
        assert reason in ("eos", "guide_complete")
        text = pt.decode([i for i in ids if i != pt.eos_token_id])
        assert _matches(g[0], g[1], text), (g, text)
    if runtime.startswith(("lookup", "draft")):
        assert teng.spec_steps > 0


@pytest.mark.parametrize("runtime", ["N=1 pipelined", "N=3 pipelined",
                                     "lookup", "draft"])
def test_accept_only_state_stops_with_guide_complete(model, draft, runtime):
    """No EOS id: a guided slot whose DFA reaches an accept-only state has
    no legal token and retires with "guide_complete" after exactly the
    guide's text, in plain decode and inside a speculative window; JAX's
    engine does the same."""
    tok = PTok.ByteTokenizer()
    d = draft if runtime == "draft" else None
    jeng, teng = _engines(model, d, eos=None, **RUNTIMES[runtime])
    out = []
    for eng, mod, gen_cls in ((jeng, JS, JGen),
                              (teng, PS, GenerationConfig)):
        gen = gen_cls(max_tokens=20, temperature=0.0, do_sample=False,
                      min_tokens=3,
                      guide=mod.guide_for_choice(["xyz"], tok))
        res = eng.generate(tok.encode("q:"), gen)
        out.append((res.stop_reason, res.token_ids))
    assert out[1] == out[0]
    assert out[1][0] == "guide_complete"
    assert tok.decode(out[1][1]) == "xyz"


def test_guide_registration_is_idempotent_and_checked(model):
    """Registering a guide twice reuses its rows; a second guide stacks
    below the first (next rows offset); a guide of a larger vocabulary
    raises ValueError at admission, before a slot is taken."""
    _, teng = _engines(model)
    tok = PTok.ByteTokenizer()
    g1 = PS.guide_for_choice(["aa", "bb"], tok)
    assert teng._register_guide(g1) == 0
    assert teng._register_guide(g1) == 0
    g2 = PS.compile_guide("zz+", tok)
    off = teng._register_guide(g2)
    assert off == g1.n_states
    allow, nxt = teng._guide_tables
    assert allow.shape == (g1.n_states + g2.n_states, VOCAB)
    assert bool(allow[:, 260:].any()) is False      # past the guide vocab
    assert int(nxt[off:, :260].min()) >= off
    big = PS.Guide(allow=np.ones((1, VOCAB + 1), bool),
                   next_state=np.zeros((1, VOCAB + 1), np.int32),
                   eos_allowed=np.ones((1,), bool), key="big")
    with pytest.raises(ValueError, match="vocab"):
        teng.add_request([5, 6], GenerationConfig(max_tokens=4, guide=big))
    assert teng.free_slots == list(range(4))


def test_guide_cache_checks_its_tokenizer():
    """The port's cache hands a guide back only to the tokenizer it was
    built for: an entry under the same id whose tokenizer is another
    object (a freed one's id reused, in JAX's cache) is rebuilt."""
    import weakref
    byte, (_, bpe) = PTok.ByteTokenizer(), _bpe()
    g = PS.compile_guide("abc|abd", byte)
    assert PS.compile_guide("abc|abd", byte) is g
    stale = PS.compile_guide("abc|abd", bpe)
    PS._GUIDE_CACHE[("abc|abd", id(byte))] = (weakref.ref(bpe), stale)
    again = PS.compile_guide("abc|abd", byte)
    assert again is not stale
    assert np.array_equal(again.allow, g.allow)
    assert again.allow.shape[1] == byte.vocab_size != stale.allow.shape[1]
