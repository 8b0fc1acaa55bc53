"""Speculative decoding's pieces in the port against the JAX package:
prompt-lookup drafting, the sampling distribution the window is accepted
against, the acceptance rule's output distribution, the verify attention
(the plain versions of kernels #3 and #5 at tokens > 1 against the Pallas
kernels in interpret mode, and JAX's own CPU functions), the window
appends of kernels #2 and #6 on both layouts, and `forward_verify`.

Inputs are made with numpy from seeds at tiny widths. Integer results
(drafts, cache bytes and scales) must be equal; float results hold the
tolerance each test states. The CUDA kernels run only on a card (the
`cuda` marker below; chip_smoke.py holds them against these plain
versions at full width).
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.models.presets import tiny_llama_config as jax_tiny_llama
from deeppowers_tpu.ops import attention as jatt
from deeppowers_tpu.ops import sampling as jsamp
from deeppowers_tpu.ops.pallas.decode_attention import (
    verify_attention_mxu, verify_attention_paged_mxu)
from deeppowers_tpu.runtime import kvcache as jkv
from deeppowers_tpu.runtime import kvcache_paged as jkvp
from deeppowers_tpu.runtime import speculative as jspec

from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_llama_config
from deeppowers_tpu_torch.ops import attention as tatt
from deeppowers_tpu_torch.ops import sampling as tsamp
from deeppowers_tpu_torch.ops.kernels import decode_attention as da
from deeppowers_tpu_torch.ops.kernels import kv_append as ka
from deeppowers_tpu_torch.quant import kvquant
from deeppowers_tpu_torch.runtime import kvcache, kvcache_paged
from deeppowers_tpu_torch.runtime import speculative as tspec

torch.set_num_threads(1)

STORES = ["bf16", "int8", "int4", "k8v4"]
BITS = {"bf16": (16, 16), "int8": (8, 8), "int4": (4, 4), "k8v4": (8, 4)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _row_ratio(got, ref) -> np.ndarray:
    """Per query row: max|got - ref| over that row's max|ref|."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max(-1) / np.maximum(np.abs(ref).max(-1), 1e-30)


# ---------------------------------------------------------------------------
# prompt-lookup drafting
# ---------------------------------------------------------------------------

def _hist(rows, s):
    h = np.zeros((len(rows), s), np.int32)
    for i, r in enumerate(rows):
        h[i, :len(r)] = r
    return h


@pytest.mark.parametrize("rows, lens, ngram, k, want", [
    # the latest match of [2, 3] is at 1: continuation [4, 2, 3]
    ([[1, 2, 3, 4, 2, 3]], [6], 2, 3, [[4, 2, 3]]),
    # no match: the last token repeated
    ([[1, 2, 3, 4]], [4], 2, 2, [[4, 4]]),
    # the trailing gram itself is no match
    ([[7, 1, 2]], [3], 2, 2, [[2, 2]]),
    # histories shorter than the gram, one empty
    ([[9], []], [1, 0], 3, 2, None),
])
def test_draft_ngram_edge_cases_match_jax(rows, lens, ngram, k, want):
    """tests/test_speculative.py's cases: equal to JAX's drafts and to the
    expected tokens."""
    s = 32 if len(rows) == 1 else 16
    h = _hist(rows, s)
    ref = np.asarray(jspec.draft_ngram(jnp.asarray(h), jnp.asarray(lens),
                                       ngram=ngram, k_draft=k))
    got = tspec.draft_ngram(_t(h), torch.tensor(lens), ngram, k)
    assert got.shape == (len(rows), k)
    np.testing.assert_array_equal(got.numpy(), ref)
    if want is not None:
        assert got.tolist() == want


@pytest.mark.parametrize("ngram, k", [(1, 3), (2, 4), (3, 4), (4, 2)])
def test_draft_ngram_matches_jax_on_seeded_histories(ngram, k):
    """Histories over 4 tokens (many matches, overlapping ones) of every
    length from 0 to S: the same drafts as JAX, token for token."""
    rng = np.random.default_rng(ngram * 10 + k)
    b, s = 41, 40
    h = rng.integers(0, 4, (b, s)).astype(np.int32)
    lens = np.arange(b, dtype=np.int32)
    ref = np.asarray(jspec.draft_ngram(jnp.asarray(h), jnp.asarray(lens),
                                       ngram=ngram, k_draft=k))
    got = tspec.draft_ngram(_t(h), _t(lens), ngram, k)
    np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# processed_probs and the acceptance rule
# ---------------------------------------------------------------------------

def _params(rows):
    """The same per-slot sampling parameters for both packages from dicts
    of GenerationConfig fields (`bias`: {id: value})."""
    b = len(rows)
    ids = np.full((b, tsamp.LOGIT_BIAS_SLOTS), -1, np.int32)
    vals = np.zeros((b, tsamp.LOGIT_BIAS_SLOTS), np.float32)
    for i, r in enumerate(rows):
        for j, (tid, v) in enumerate(r.get("bias", {}).items()):
            ids[i, j], vals[i, j] = tid, v
    cols = {
        "temperature": np.float32, "top_k": np.int32, "top_p": np.float32,
        "repetition_penalty": np.float32, "presence_penalty": np.float32,
        "frequency_penalty": np.float32, "min_tokens": np.int32}
    defaults = dict(temperature=0.0, top_k=0, top_p=1.0,
                    repetition_penalty=1.0, presence_penalty=0.0,
                    frequency_penalty=0.0, min_tokens=0)
    arrs = {k: np.array([r.get(k, defaults[k]) for r in rows], dt)
            for k, dt in cols.items()}
    jp = jsamp.SamplingParams(**{k: jnp.asarray(v) for k, v in arrs.items()},
                              bias_ids=jnp.asarray(ids),
                              bias_vals=jnp.asarray(vals))
    tp = tsamp.SamplingParams(**{k: _t(v) for k, v in arrs.items()},
                              bias_ids=_t(ids), bias_vals=_t(vals))
    return jp, tp


SAMPLING_ROWS = {
    "greedy": [dict(), dict(repetition_penalty=1.3),
               dict(min_tokens=5, bias={3: 2.5}),
               dict(presence_penalty=0.5, frequency_penalty=0.25)],
    "sampled": [dict(temperature=0.7), dict(temperature=1.0, top_k=5),
                dict(temperature=0.9, top_p=0.8, repetition_penalty=1.2),
                dict(temperature=1.3, min_tokens=4, top_k=20, top_p=0.95,
                     bias={3: -1.0, 7: 4.0})],
}


@pytest.mark.parametrize("kind", ["greedy", "sampled"])
def test_processed_probs_matches_jax(kind):
    """Penalties, logit bias, min-tokens EOS suppression (slot 2's EOS id
    is none), temperature, top-k/top-p: a greedy slot's one-hot is exact,
    a sampled slot's probabilities within 1e-6."""
    rng = np.random.default_rng(3)
    b, v = 4, 64
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, (b, v)).astype(np.int32)
    gen = np.array([0, 6, 3, 2], np.int32)
    eos = np.array([3, 3, -1, 7], np.int32)
    jp, tp = _params(SAMPLING_ROWS[kind])
    ref = np.asarray(jsamp.processed_probs(
        jnp.asarray(logits), jp, token_counts=jnp.asarray(counts),
        generated_counts=jnp.asarray(gen), eos_ids=jnp.asarray(eos)))
    got = tsamp.processed_probs(_t(logits), tp, token_counts=_t(counts),
                                generated_counts=_t(gen),
                                eos_ids=_t(eos)).numpy()
    if kind == "greedy":
        np.testing.assert_array_equal(got, ref)
        assert (got.sum(-1) == 1).all() and (got.max(-1) == 1).all()
    else:
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def _window_state(b, v, temperature):
    _, tp = _params([dict(temperature=temperature)] * b)
    z = torch.zeros((b,), dtype=torch.int32)
    return SimpleNamespace(
        sampling=tp, active=torch.ones((b,), dtype=torch.bool), generated=z,
        eos_id=torch.full((b,), -1, dtype=torch.int32),
        max_tokens=torch.full((b,), 100, dtype=torch.int32), lengths=z,
        token_counts=torch.zeros((b, v), dtype=torch.int32))


def _chi2_p(samples, probs) -> float:
    """p-value of a chi-square goodness-of-fit test of integer samples
    against probabilities (tokens of expected count < 5 pooled)."""
    n = len(samples)
    obs = np.bincount(samples, minlength=len(probs)).astype(np.float64)
    probs = probs.astype(np.float64)
    exp = probs / probs.sum() * n
    big = exp >= 5
    obs_b = np.append(obs[big], obs[~big].sum())
    exp_b = np.append(exp[big], exp[~big].sum())
    keep = exp_b > 0
    return scipy.stats.chisquare(obs_b[keep], exp_b[keep]).pvalue


@pytest.mark.parametrize("draft", ["point", "model"])
def test_accept_window_output_is_the_target_distribution(draft):
    """The first emitted token of a window is distributed as
    processed_probs of the target's first logits, and, where the first
    draft was accepted, the second as processed_probs of the second
    logits (speculative sampling keeps the target chain). 20,000 windows
    at V = 6 with fixed seeds; each chi-square p-value must exceed 1e-3.
    Drafts are a fixed point mass, or drawn from random draft
    distributions q (the draft-model case)."""
    rng = np.random.default_rng(11 if draft == "point" else 12)
    n, v, k = 20000, 6, 2
    base = rng.standard_normal((k + 1, v)).astype(np.float32) * 1.5
    logits = torch.from_numpy(np.broadcast_to(base, (n, k + 1, v)).copy())
    state = _window_state(n, v, 1.0)
    one = _window_state(1, v, 1.0).sampling
    p = [tsamp.processed_probs(logits[:1, j], one).numpy()[0]
         for j in range(k + 1)]
    if draft == "point":
        drafts = torch.tensor([[2, 4]] * n, dtype=torch.int32)
        q = None
    else:
        qd = rng.dirichlet(np.ones(v), size=k).astype(np.float32)
        drafts = torch.from_numpy(np.stack(
            [rng.choice(v, size=n, p=qd[j] / qd[j].sum()) for j in range(k)],
            1).astype(np.int32))
        q = torch.from_numpy(np.broadcast_to(qd, (n, k, v)).copy())
    gen = torch.Generator().manual_seed(5)
    emitted, lps, _, _, term, _ = tspec._accept_window(logits, drafts, state,
                                                    gen, None, 10_000,
                                                    q_probs=q)
    e = emitted.numpy()
    assert (e[:, 0] >= 0).all() and not term.any()
    assert _chi2_p(e[:, 0], p[0]) > 1e-3
    acc = e[:, 0] == drafts[:, 0].numpy()
    assert acc.sum() > 1000 and (e[acc, 1] >= 0).all()
    assert _chi2_p(e[acc, 1], p[1]) > 1e-3
    # emission is a prefix of the window
    assert ((e[:, 1:] >= 0) <= (e[:, :-1] >= 0)).all()
    np.testing.assert_allclose(
        lps[:, 0].numpy(), np.log(p[0][e[:, 0]]), atol=1e-5)


def test_accept_window_greedy_is_the_argmax_chain():
    """Temperature 0: drafts equal to the argmax are accepted, the first
    other one is replaced by the argmax and ends the window; a min_tokens
    slot never emits its EOS id."""
    rng = np.random.default_rng(13)
    b, v, k = 3, 16, 3
    logits = torch.from_numpy(rng.standard_normal((b, k + 1, v)).astype(
        np.float32))
    am = logits.argmax(-1).to(torch.int32)
    drafts = am[:, :k].clone()
    drafts[1, 1] = (am[1, 1] + 1) % v           # slot 1 rejects draft 1
    state = _window_state(b, v, 0.0)
    state.eos_id[2] = int(am[2, 0])
    state.sampling.min_tokens[2] = 10           # slot 2 may not emit EOS
    emitted, _, _, gen, term, _ = tspec._accept_window(
        logits, drafts, state, torch.Generator().manual_seed(0), None, 1000)
    assert emitted[0].tolist() == am[0].tolist()
    assert emitted[1].tolist() == am[1, :2].tolist() + [-1, -1]
    assert int(am[2, 0]) not in emitted[2].tolist()[:1]
    assert gen.tolist() == [4, 2, int((emitted[2] >= 0).sum())]
    assert not term.any()


# ---------------------------------------------------------------------------
# verify attention (kernels #3 and #5 at tokens > 1)
# ---------------------------------------------------------------------------

def _window_inputs(rng, b, t, h, kh, d, s, lengths):
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def test_attention_verify_matches_jax():
    """f32 caches: the port's attention_verify (the plain #3 over the
    folded window) against JAX's attention_verify, and the int8 one
    against attention_verify_quantized: 1e-5 of each row's max|ref|
    (summation order only)."""
    rng = np.random.default_rng(21)
    b, t, h, kh, d, s = 3, 5, 8, 2, 64, 96
    lens = [0, 40, 91]                    # the window fills the last cache
    q, k, v, ln = _window_inputs(rng, b, t, h, kh, d, s, lens)
    ref = jatt.attention_verify(*(jnp.asarray(a) for a in (q, k, v, ln)))
    got = tatt.attention_verify(_t(q), _t(k), _t(v), _t(ln))
    assert _row_ratio(got.numpy(), ref).max() <= 1e-5
    (qk, sk), (qv, sv) = (jkv._quant_kv(jnp.asarray(a)) for a in (k, v))
    qk, qv = qk.reshape(k.shape), qv.reshape(v.shape)
    sk, sv = jnp.swapaxes(sk, 1, 2), jnp.swapaxes(sv, 1, 2)
    ref = jatt.attention_verify_quantized(jnp.asarray(q), qk, qv, sk, sv,
                                          jnp.asarray(ln))
    got = tatt.attention_verify_quantized(_t(q), _t(qk), _t(qv), _t(sk),
                                          _t(sv), _t(ln))
    assert _row_ratio(got.numpy(), ref).max() <= 1e-5


def _store(dtype, k, v):
    """(k store, v store, k scale, v scale, kwargs) of a contiguous cache of
    `dtype` holding k, v (B, S, Kh, D), quantized by JAX's quantizers."""
    b, s = k.shape[:2]
    kb, vb = BITS[dtype]
    if dtype == "bf16":
        ks = [np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(
            jnp.float32)).reshape(b, s, -1) for a in (k, v)]
        return ks[0], ks[1], None, None, {}
    quant = {8: jkv._quant_kv, 4: lambda x: jkv._quant_kv4(x, nh=2)}
    (qk, sk), (qv, sv) = quant[kb](jnp.asarray(k)), quant[vb](jnp.asarray(v))
    sk, sv = (np.array(jnp.swapaxes(a, 1, 2)) for a in (sk, sv))
    return (np.array(qk).reshape(b, s, -1), np.array(qv).reshape(b, s, -1),
            sk, sv, dict(kv_bits=kb, v_bits=vb))


@pytest.mark.parametrize("dtype", STORES)
def test_verify_plain_matches_pallas(dtype, monkeypatch):
    """#3's plain version at tokens = 5 (8 window rows a kv head over 2 kv
    heads) against Pallas verify_attention_mxu in interpret mode, bf16 q,
    bf16 dots (DPT_ATTN_INT8=0, as the quantized decode test holds it),
    lengths of 0, inside and at the end of the cache: 2e-2 of a row's
    max|ref| for bf16 (the Pallas kernel rounds p to bf16 for p.V) and
    1e-2 for the quantized stores, as at tokens = 1. A wrong version, the
    window's lengths one short, must fail the limit."""
    monkeypatch.setenv("DPT_ATTN_INT8", "0")
    rng = np.random.default_rng(22)
    b, t, h, kh, d, s = 3, 5, 8, 2, 64, 256
    q, k, v, ln = _window_inputs(rng, b, t, h, kh, d, s, [0, 100, 251])
    kc, vc, sk, sv, kw = _store(dtype, k, v)
    qj = jnp.asarray(q).astype(jnp.bfloat16)
    qt = _t(qj.astype(jnp.float32)).to(torch.bfloat16)
    scales = {} if sk is None else dict(k_scale=_t(sk), v_scale=_t(sv))
    kcj = jnp.asarray(kc) if dtype != "bf16" else jnp.asarray(
        kc).astype(jnp.bfloat16)
    vcj = jnp.asarray(vc) if dtype != "bf16" else jnp.asarray(
        vc).astype(jnp.bfloat16)
    jargs = [kcj.reshape(b, s, kh, -1), vcj.reshape(b, s, kh, -1),
             jnp.asarray(ln)]
    if sk is not None:
        jargs += [jnp.asarray(sk), jnp.asarray(sv)]
    ref = np.asarray(verify_attention_mxu(qj, *jargs, **kw).astype(
        jnp.float32))
    tk, tv = (_t(a) if dtype != "bf16" else _t(a).to(torch.bfloat16)
              for a in (kc, vc))
    got = da.verify_attention(qt, tk, tv, _t(ln), **scales, **kw)
    assert got.shape == (b, t, h, d) and torch.isfinite(got).all()
    tol = 2e-2 if dtype == "bf16" else 1e-2
    assert _row_ratio(got.float().numpy(), ref).max() <= tol
    wrong = da.verify_attention(qt, tk, tv, _t(ln) - 1, **scales, **kw)
    assert _row_ratio(wrong.float().numpy(), ref).max() > tol


def _paged(a, table, ps, p):
    """A contiguous (B, S, F) store (or (B, R, S) scales) scattered over
    the pool pages of `table`; other rows NaN (scales) or random."""
    b, wp = table.shape
    if a.ndim == 3 and a.shape[1] == wp * ps:           # store rows
        pool = np.zeros((p, ps, a.shape[2]), a.dtype)
        pool[table.reshape(-1)] = a.reshape(b * wp, ps, a.shape[2])
        return pool
    r = a.shape[1]
    pool = np.full((p, r, ps), np.nan, np.float32)
    pool[table.reshape(-1)] = a.reshape(b, r, wp, ps).transpose(
        0, 2, 1, 3).reshape(b * wp, r, ps)
    return pool


@pytest.mark.parametrize("dtype", STORES)
def test_verify_paged_plain_matches_pallas(dtype):
    """#5's plain version at tokens = 5 over shuffled pages of 128 rows
    (NaN in every unwritten scale entry): equal to #3's plain version over
    the contiguous view, and within the limits of
    test_verify_plain_matches_pallas of Pallas verify_attention_paged_mxu
    in interpret mode (its scales with the stale entries zeroed; lengths
    that end in the last page of a four-page step, as the bf16 paged
    kernel needs, tests/test_torch_paged.py)."""
    rng = np.random.default_rng(23)
    b, t, h, kh, d, ps, wp = 3, 5, 8, 2, 64, 128, 8
    s, p = ps * wp, b * wp + 3
    q, k, v, ln = _window_inputs(rng, b, t, h, kh, d, s, [395, 507, 895])
    kc, vc, sk, sv, kw = _store(dtype, k, v)
    table = (rng.permutation(np.arange(1, p))[:b * wp].reshape(b, wp)
             ).astype(np.int32)
    pools = [_paged(a, table, ps, p) for a in (kc, vc)]
    qj = jnp.asarray(q).astype(jnp.bfloat16)
    qt = _t(qj.astype(jnp.float32)).to(torch.bfloat16)
    cast = (lambda a: _t(a).to(torch.bfloat16)) if dtype == "bf16" else _t
    scales, jsc, flat_sc = {}, [], {}
    if sk is not None:
        sp = [_paged(a, table, ps, p) for a in (sk, sv)]
        scales = dict(k_scale=_t(sp[0]), v_scale=_t(sp[1]))
        jsc = [jnp.asarray(np.nan_to_num(a, nan=0.0)) for a in sp]
        flat_sc = dict(k_scale=_t(sk), v_scale=_t(sv))
    got = da.verify_attention_paged(qt, cast(pools[0]), cast(pools[1]),
                                    _t(table), _t(ln), **scales, **kw)
    flat = da.verify_attention(qt, cast(kc), cast(vc), _t(ln), **flat_sc,
                               **kw)
    assert torch.isfinite(got).all() and torch.equal(got, flat)
    jpools = [jnp.asarray(a) if dtype != "bf16" else
              jnp.asarray(a).astype(jnp.bfloat16) for a in pools]
    ref = np.asarray(verify_attention_paged_mxu(
        qj, *jpools, jnp.asarray(table), jnp.asarray(ln), *jsc,
        **kw).astype(jnp.float32))
    tol = 2e-2 if dtype == "bf16" else 1e-2
    assert _row_ratio(got.float().numpy(), ref).max() <= tol


def test_verify_rows_see_their_own_bound():
    """Window token t of a slot sees exactly lengths + 1 + t positions: NaN
    and huge values in every later cache row change nothing, a window of
    one is the decode kernel, and the launch counters stay 0 on the
    CPU."""
    rng = np.random.default_rng(24)
    b, t, h, kh, d, s = 2, 4, 4, 2, 64, 64
    q, k, v, ln = _window_inputs(rng, b, t, h, kh, d, s, [10, 50])
    clean = tatt.attention_verify(_t(q), _t(k), _t(v), _t(ln))
    kb, vb = k.copy(), v.copy()
    for i, n in enumerate(ln):
        kb[i, n + t:] = np.nan
        vb[i, n + t:] = 1e30
    dirty = tatt.attention_verify(_t(q), _t(kb), _t(vb), _t(ln))
    assert torch.equal(clean, dirty)
    one = tatt.attention_verify(_t(q[:, :1]), _t(k), _t(v), _t(ln))
    dec = tatt.attention_decode(_t(q[:, 0]), _t(k), _t(v), _t(ln) + 1)
    assert torch.equal(one[:, 0], dec)
    assert da.decode_attention.launches == 0


# ---------------------------------------------------------------------------
# window appends (kernels #2 and #6 at T > 1)
# ---------------------------------------------------------------------------

def _kv(rng, *shape):
    return (rng.standard_normal(shape) * rng.uniform(
        0.1, 4, shape[:-1] + (1,))).astype(np.float32)


def _same(tc, jc):
    if isinstance(tc, kvcache_paged.PagedLayerKVCache):
        pairs = [(tc.k_pool, jc.k_pool), (tc.v_pool, jc.v_pool)]
    else:
        pairs = [(tc.k, jc.k), (tc.v, jc.v)]
    pairs += [(tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)]
    for got, ref in pairs:
        if ref is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", STORES)
def test_append_tokens_contiguous_bit_exact_with_jax(dtype):
    """A window of 5 rows per slot at per-slot positions, one window
    running past the cache end (its last two rows dropped): the same bytes
    and scales as JAX's append_tokens, in one kv_append call."""
    rng = np.random.default_rng(31)
    b, t, s, kh, d = 3, 5, 64, 2, 16
    (jc,) = jkv.init_cache(1, b, s, kh, d, dtype=jnp.float32,
                           kv_cache_dtype=dtype)
    (tc,) = kvcache.init_cache(1, b, s, kh, d, dtype=torch.float32,
                               kv_cache_dtype=dtype)
    kn, vn = _kv(rng, b, t, kh, d), _kv(rng, b, t, kh, d)
    pos = np.array([0, 30, 61], np.int32)[:, None] + np.arange(t)
    jc = jkv.append_tokens(jc, jnp.asarray(kn), jnp.asarray(vn),
                           jnp.asarray(pos, jnp.int32))
    kvcache.append_tokens(tc, _t(kn), _t(vn), _t(pos))
    _same(tc, jc)
    assert ka.scatter_rows.launches == 0


@pytest.mark.parametrize("dtype", STORES)
def test_append_tokens_paged_bit_exact_with_jax(dtype):
    """The same over a shared table (page 5 mapped by both slots), a window
    across a page edge and one past max_seq: the same pools and scale
    pools as JAX's append_tokens; a row past max_seq writes nothing."""
    rng = np.random.default_rng(32)
    b, t, s, kh, d, ps = 2, 5, 64, 2, 16, 16
    table = np.zeros((b, s // ps), np.int32)
    table[0, :4] = [5, 2, 7, 1]
    table[1, :4] = [5, 3, 4, 6]
    (jc,) = jkvp.init_paged_cache(1, b, s, kh, d, page_size=ps,
                                  total_pages=9, dtype=jnp.float32,
                                  kv_cache_dtype=dtype)
    (jc,) = jkvp.with_table((jc,), jnp.asarray(table))
    tcs = kvcache_paged.init_paged_cache(1, b, s, kh, d, page_size=ps,
                                         total_pages=9, dtype=torch.float32,
                                         kv_cache_dtype=dtype)
    kvcache_paged.with_table(tcs, table)
    (tc,) = tcs
    kn, vn = _kv(rng, b, t, kh, d), _kv(rng, b, t, kh, d)
    pos = np.array([13, 61], np.int32)[:, None] + np.arange(t)
    jc = jkvp.append_tokens(jc, jnp.asarray(kn), jnp.asarray(vn),
                            jnp.asarray(pos, jnp.int32))
    rows, valid = kvcache_paged.row_ids(tc, _t(pos))
    assert rows.shape == (b * t,) and valid.tolist() == [True] * 8 + [
        False] * 2
    kvcache.append_tokens(tc, _t(kn), _t(vn), _t(pos))
    _same(tc, jc)


# ---------------------------------------------------------------------------
# forward_verify
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_llama(max_seq_len=256)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(20), dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tiny_llama_config(max_seq_len=256), tparams


def _caches(jcfg, cfg, dtype, layout, b, s):
    if layout == "contiguous":
        return (jkv.init_cache(jcfg.num_layers, b, s, jcfg.kv_heads,
                               jcfg.dim_head, dtype=jnp.float32,
                               kv_cache_dtype=dtype),
                kvcache.init_cache(cfg.num_layers, b, s, cfg.kv_heads,
                                   cfg.dim_head, dtype=torch.float32,
                                   kv_cache_dtype=dtype))
    ps = 32
    table = np.arange(1, b * (s // ps) + 1, dtype=np.int32).reshape(b, -1)
    jc = jkvp.init_paged_cache(jcfg.num_layers, b, s, jcfg.kv_heads,
                               jcfg.dim_head, page_size=ps,
                               total_pages=table.size + 1, dtype=jnp.float32,
                               kv_cache_dtype=dtype)
    jc = jkvp.with_table(jc, jnp.asarray(table))
    tc = kvcache_paged.init_paged_cache(cfg.num_layers, b, s, cfg.kv_heads,
                                        cfg.dim_head, page_size=ps,
                                        total_pages=table.size + 1,
                                        dtype=torch.float32,
                                        kv_cache_dtype=dtype)
    kvcache_paged.with_table(tc, table)
    return jc, tc


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("dtype", ["bf16", "int8", "k8v4"])
def test_forward_verify_matches_jax_and_sequential_decode(tiny, dtype,
                                                          layout):
    """Two prompts prefilled into a cache, then a window of T = 5 tokens a
    slot: the port's forward_verify logits against JAX's (f32 activations:
    1e-4 of the logits' max|ref|), and against five sequential
    forward_decode steps of the port over the same tokens (1e-4: both
    read the same cache rows, through the T-token and the one-token
    variants of the attention kernel's plain version)."""
    jcfg, jparams, cfg, tparams = tiny
    rng = np.random.default_rng(41)
    b, s, t = 2, 128, 5
    lens = np.array([7, 30], np.int32)
    ids = rng.integers(1, cfg.vocab_size, (b, 32)).astype(np.int32)
    win = rng.integers(1, cfg.vocab_size, (b, t)).astype(np.int32)
    jc, tc = _caches(jcfg, cfg, dtype, layout, b, s)
    _, jkv_ = JT.forward_prefill(jparams, jcfg, jnp.asarray(ids),
                                 jnp.asarray(lens), dtype=jnp.float32)
    _, tkv = T.forward_prefill(tparams, cfg, _t(ids).long(), _t(lens),
                               dtype=torch.float32)
    jc = list(jc)
    for li, ((jk, jv), (tk, tv)) in enumerate(zip(jkv_, tkv)):
        for i in range(b):
            jc[li] = jkv.write_prompt(jc[li], jk[i], jv[i], i)
            kvcache.write_prompt(tc[li], tk[i], tv[i], i)
    ref, _ = JT.forward_verify(jparams, jcfg, jnp.asarray(win), tuple(jc),
                               jnp.asarray(lens), dtype=jnp.float32)
    ref = np.asarray(ref)
    tc_seq = copy.deepcopy(tc)
    got, _ = T.forward_verify(tparams, cfg, _t(win).long(), tc, _t(lens),
                              dtype=torch.float32,
                              active=torch.ones(b, dtype=torch.bool))
    assert got.shape == (b, t, cfg.vocab_size)
    scale = np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * scale
    seq = []
    ln = _t(lens)
    for j in range(t):
        lg, tc_seq = T.forward_decode(tparams, cfg, _t(win[:, j]), tc_seq,
                                      ln, dtype=torch.float32)
        seq.append(lg)
        ln = ln + 1
    seq = torch.stack(seq, 1)
    assert (got - seq).abs().max().item() <= 1e-4 * scale


def test_forward_verify_inactive_slot_touches_nothing(tiny):
    """An inactive slot's window neither writes its cache rows nor reads
    them (the port's standing decision for decode): its rows stay as they
    were and the active slot's logits do not change."""
    _, _, cfg, tparams = tiny
    rng = np.random.default_rng(42)
    b, s, t = 2, 64, 3
    tc = kvcache.init_cache(cfg.num_layers, b, s, cfg.kv_heads,
                            cfg.dim_head, dtype=torch.float32)
    for c in tc:
        c.k.normal_(generator=torch.Generator().manual_seed(1))
        c.v.normal_(generator=torch.Generator().manual_seed(2))
    before = [(c.k.clone(), c.v.clone()) for c in tc]
    win = _t(rng.integers(1, cfg.vocab_size, (b, t))).long()
    lens = torch.tensor([10, 20], dtype=torch.int32)
    on = T.forward_verify(tparams, cfg, win, tc, lens, dtype=torch.float32,
                          active=torch.tensor([True, False]))[0]
    for c, (k, v) in zip(tc, before):
        assert torch.equal(c.k[1], k[1]) and torch.equal(c.v[1], v[1])
        assert not torch.equal(c.k[0], k[0])
    both = T.forward_verify(tparams, cfg, win, tc, lens, dtype=torch.float32,
                            active=torch.tensor([True, True]))[0]
    assert torch.equal(on[0], both[0])


# ---------------------------------------------------------------------------
# the CUDA kernels (card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py runs these "
                    "kernels on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", STORES)
@pytest.mark.parametrize("h, kh, d", [(32, 4, 64), (32, 32, 128),
                                      (32, 8, 128)])
def test_cuda_verify_kernels_match_plain(cuda_device, dtype, h, kh, d,
                                         monkeypatch):
    """#3 and #5 at tokens = 5 against their plain versions on the card
    (TinyLlama's 40 rows a kv head, Llama-2-7B's 5, Mixtral's 20): each
    row within 1e-2 of its max|ref| (2e-2 for int8 at 20 rows of D = 128,
    where the plain version's bf16 probabilities alone part by up to
    1.14e-2 on these inputs), finite with NaN in stale scales; each launch
    counted under the store's `:t5` variant. #3's bf16-dot kernel
    (DPT_ATTN_INT8=0; the int8-dot variant is
    tests/test_torch_decode_attention.py's)."""
    monkeypatch.setenv("DPT_ATTN_INT8", "0")
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)
    b, s, t, ps = 8, 1024, 5, 128
    lens = torch.tensor([48, 96, 132, 232, 332, 482, 632, 932], device=dev)
    q = torch.randn(b, t, h, d, generator=g, device=dev).to(torch.bfloat16)
    kb, vb = BITS[dtype]
    if dtype == "bf16":
        kc, vc = (torch.randn(b, s, kh * d, generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2))
        kw, sc = {}, (None, None)
    else:
        (kc, ks), (vc, vs) = (kvquant.quant_side(
            torch.randn(b, s, kh, d, generator=g, device=dev), bits,
            2 if bits == 4 else 1) for bits in (kb, vb))
        kc, vc = kc.reshape(b, s, -1), vc.reshape(b, s, -1)
        ks, vs = ks.transpose(1, 2).contiguous(), vs.transpose(1, 2).contiguous()
        pos = torch.arange(s, device=dev)
        stale = pos[None, :] >= (lens[:, None] + t)
        for a in (ks, vs):
            a.masked_fill_(stale[:, None, :], float("nan"))
        kw, sc = dict(kv_bits=kb, v_bits=vb), (ks, vs)
    args = dict(kw)
    if sc[0] is not None:
        args.update(k_scale=sc[0], v_scale=sc[1])
    counts = da.decode_attention.variant_launches
    before = counts[f"{dtype}:t{t}"]
    out = da.verify_attention(q, kc, vc, lens, **args)
    ref = da.verify_attention(q.cpu(), kc.cpu(), vc.cpu(), lens.cpu(),
                              **{k: (v.cpu() if torch.is_tensor(v) else v)
                                 for k, v in args.items()})
    lim = 2e-2 if (dtype == "int8" and d == 128 and h // kh == 4) else 1e-2
    assert torch.isfinite(out).all()
    assert _row_ratio(out.float().cpu(), ref.float()).max() <= lim
    assert counts[f"{dtype}:t{t}"] == before + 1
    assert torch.equal(out, da.verify_attention(q, kc, vc, lens, **args))
    wp = s // ps
    table = (torch.randperm(b * wp, generator=torch.Generator().manual_seed(
        1)) + 1).reshape(b, wp).to(dev, torch.int32)

    def pool(x):
        p = torch.zeros((b * wp + 1, ps, x.shape[-1]), dtype=x.dtype,
                        device=dev)
        p[table.long()] = x.reshape(b, wp, ps, -1)
        return p

    def spool(x):
        p = torch.full((b * wp + 1, x.shape[1], ps), float("nan"), device=dev)
        p[table.long()] = x.reshape(b, x.shape[1], wp, ps).transpose(1, 2)
        return p

    pargs = dict(kw)
    if sc[0] is not None:
        pargs.update(k_scale=spool(sc[0]), v_scale=spool(sc[1]))
    outp = da.verify_attention_paged(q, pool(kc), pool(vc), table, lens,
                                     **pargs)
    assert torch.isfinite(outp).all()
    assert _row_ratio(outp.float().cpu(), ref.float()).max() <= lim


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", STORES)
def test_cuda_window_appends_match_plain(cuda_device, dtype):
    """A verify window's 8 x 5 rows through #2 (contiguous, per-row slots,
    a window past the cache end) and #6 (paged): bytes and scales equal to
    the plain versions, one launch each."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(3)
    b, t, s, kh, d, ps = 8, 5, 1024, 4, 64, 128
    kn, vn = (torch.randn(b, t, kh, d, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    pos = (torch.tensor([16, 64, 100, 200, 300, 450, 600, 1021], device=dev)
           [:, None] + torch.arange(t, device=dev)).to(torch.int32)
    (c1,) = kvcache.init_cache(1, b, s, kh, d, kv_cache_dtype=dtype,
                               device=dev)
    (c2,) = kvcache.init_cache(1, b, s, kh, d, kv_cache_dtype=dtype,
                               device="cpu")
    n0 = ka.scatter_rows.launches
    kvcache.append_tokens(c1, kn, vn, pos)
    kvcache.append_tokens(c2, kn.cpu(), vn.cpu(), pos.cpu())
    assert ka.scatter_rows.launches == n0 + 1
    for a, r in ((c1.k, c2.k), (c1.v, c2.v), (c1.k_scale, c2.k_scale),
                 (c1.v_scale, c2.v_scale)):
        assert (a is None and r is None) or torch.equal(a.cpu(), r)
    table = np.arange(1, b * (s // ps) + 1, dtype=np.int32).reshape(b, -1)
    p1 = kvcache_paged.init_paged_cache(1, b, s, kh, d, page_size=ps,
                                        total_pages=table.size + 1,
                                        kv_cache_dtype=dtype, device=dev)
    p2 = kvcache_paged.init_paged_cache(1, b, s, kh, d, page_size=ps,
                                        total_pages=table.size + 1,
                                        kv_cache_dtype=dtype, device="cpu")
    for c in (p1, p2):
        kvcache_paged.with_table(c, table)
    n0 = ka.scatter_pool_rows.launches
    kvcache.append_tokens(p1[0], kn, vn, pos)
    kvcache.append_tokens(p2[0], kn.cpu(), vn.cpu(), pos.cpu())
    assert ka.scatter_pool_rows.launches == n0 + 1
    for a, r in ((p1[0].k_pool, p2[0].k_pool), (p1[0].v_pool, p2[0].v_pool),
                 (p1[0].k_scale, p2[0].k_scale),
                 (p1[0].v_scale, p2[0].v_scale)):
        assert (a is None and r is None) or torch.equal(a.cpu(), r)
