"""The port's paged KV layout against the JAX package: the two paged
kernels' plain versions against the JAX Pallas kernels (interpret mode on
the CPU), the pool operations and the page allocators, and the engine and
scheduler with full and lazy reservation, preemption and prefix sharing.

Tiny sizes, f32, the setups of tests/test_paged_kv.py: tiny_llama_config
(max_seq_len=256), page 32, chunk 32. Weights are made once by the JAX
package and converted with params_from_numpy; greedy token streams must be
equal. The CUDA kernels run only on a card (the `cuda` marker below;
chip_smoke.py holds them against their plain versions at full width).
"""

import importlib.util
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.config import GenerationConfig as JGen
from deeppowers_tpu.config import RuntimeConfig as JRuntime
from deeppowers_tpu.config import SchedulerConfig as JSchedCfg
from deeppowers_tpu.config import config_to_json as jax_config_to_json
from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.models.presets import tiny_llama_config as jax_tiny_llama
from deeppowers_tpu.ops.pallas.decode_attention import (
    decode_attention_paged_mxu)
from deeppowers_tpu.ops.pallas.kv_append import (
    scatter_pool_rows as jax_scatter_pool_rows)
from deeppowers_tpu.runtime import kvcache as jkv
from deeppowers_tpu.runtime import kvcache_paged as jkvp
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine
from deeppowers_tpu.serving.request import Request as JRequest
from deeppowers_tpu.serving.scheduler import Scheduler as JScheduler

from deeppowers_tpu_torch.config import (GenerationConfig, RuntimeConfig,
                                         SchedulerConfig, config_from_json,
                                         config_to_json)
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_llama_config
from deeppowers_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_paged, decode_attention_paged_plain)
from deeppowers_tpu_torch.ops.kernels.kv_append import (
    scatter_pool_rows, scatter_pool_rows_plain)
from deeppowers_tpu_torch.runtime import kvcache, kvcache_paged
from deeppowers_tpu_torch.runtime.engine import InferenceEngine, NoFreePages
from deeppowers_tpu_torch.serving.request import Request
from deeppowers_tpu_torch.serving.scheduler import Scheduler
from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAGE = 32


def _bf16_pair(a: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


# ---------------------------------------------------------------------------
# kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def test_scatter_pool_rows_plain_equals_pallas_bit_for_bit():
    """Rows into a (P, page, F) pool at absolute rows; invalid rows, one of
    them aimed at a live row, leave the pool untouched."""
    rng = np.random.default_rng(0)
    p, ps, f, b = 6, 16, 128, 5
    kp_j, kp_t = _bf16_pair(rng.standard_normal((p, ps, f)))
    vp_j, vp_t = _bf16_pair(rng.standard_normal((p, ps, f)))
    kr_j, kr_t = _bf16_pair(rng.standard_normal((b, f)))
    vr_j, vr_t = _bf16_pair(rng.standard_normal((b, f)))
    rows = np.array([17, 0, 95, 40, 41], np.int32)
    valid = np.array([True, False, True, False, True])
    kj, vj = jax_scatter_pool_rows([kp_j, vp_j], [kr_j, vr_j], [], [],
                                   jnp.asarray(rows), jnp.asarray(valid))
    before = kp_t.clone()
    scatter_pool_rows(kp_t, vp_t, kr_t, vr_t, torch.from_numpy(rows),
                      torch.from_numpy(valid))
    for got, ref in ((kp_t, kj), (vp_t, vj)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    flat, old = kp_t.view(-1, f), before.view(-1, f)
    assert torch.equal(flat[40], old[40]) and torch.equal(flat[0], old[0])
    assert torch.equal(flat[17], kr_t[0]) and torch.equal(flat[41], kr_t[4])


def _paged_inputs(rng, b, h, kh, d, ps, wp, p, lengths, stale=1.0):
    """Pools whose pages are scattered over the pool by a shuffled table,
    with stale rows (`stale`, e.g. NaN) past each length."""
    f = kh * d
    kp = rng.standard_normal((p, ps, f)).astype(np.float32)
    vp = rng.standard_normal((p, ps, f)).astype(np.float32)
    ids = rng.permutation(np.arange(1, p))[:b * wp].reshape(b, wp)
    table = ids.astype(np.int32)
    for i, n in enumerate(lengths):
        for pos in range(n, wp * ps):
            page, row = table[i, pos // ps], pos % ps
            kp[page, row] = stale
            vp[page, row] = stale
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _row_ratio(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per (slot, head) row: max|got - ref| over that row's max|ref|."""
    return np.abs(got - ref).max(-1) / np.abs(ref).max(-1)


def _paged_against_pallas(ps, wp, lengths, seed):
    """The plain version and the Pallas kernel (interpret mode) on the same
    bf16 inputs; returns (got, ref, inputs) in f32."""
    rng = np.random.default_rng(seed)
    b, h, kh, d = len(lengths), 8, 2, 64
    q, kp, vp, table, lens = _paged_inputs(rng, b, h, kh, d, ps, wp,
                                           b * wp + 2, lengths)
    q_j, q_t = _bf16_pair(q)
    kp_j, kp_t = _bf16_pair(kp)
    vp_j, vp_t = _bf16_pair(vp)
    ref = np.asarray(decode_attention_paged_mxu(
        q_j, kp_j, vp_j, jnp.asarray(table),
        jnp.asarray(lens)).astype(jnp.float32))
    args = (q_t, kp_t, vp_t, torch.from_numpy(table))
    got = decode_attention_paged(*args, torch.from_numpy(lens))
    return got.float().numpy(), ref, args


@pytest.mark.parametrize("ps, wp, lengths, seed", [
    (512, 2, [1, 37, 512, 700], 1),
    (128, 8, [400, 512, 900, 1000], 5),
])
def test_decode_attention_paged_plain_matches_pallas(ps, wp, lengths, seed):
    """bf16, tokens = 1. Tolerance, per (slot, head) row as chip_smoke.py
    holds the kernel: both accumulate in f32 from the same bf16 values; the
    Pallas kernel rounds the probabilities to bf16 for its p.V product and
    its output to bf16, so outputs agree to a few bf16 steps of the row's
    scale (2e-2 of its max|ref|). A wrong version, the last slot's length
    one page short, must fail that limit.

    The Pallas kernel takes min(512 // page, WP) pages a super-step. Its
    bf16 path multiplies the zero probabilities of a slot's last, partly
    live step by V rows of pages it never copied into VMEM (the quantized
    paths re-mask them, decode_attention.py:660-663); interpret mode fills
    that VMEM with NaN. So 512-row pages (one a step) take lengths of one
    row, inside a page, on a page edge and over two pages; the 128-row
    pages the card runs (four a step) take lengths that end in the last
    page of their step, crossing page edges inside a step with stale rows
    after them, two of them over a second step."""
    got, ref, args = _paged_against_pallas(ps, wp, lengths, seed)
    assert np.isfinite(got).all()
    assert _row_ratio(got, ref).max() <= 2e-2
    short = np.asarray(lengths, np.int32)
    short[-1] -= ps
    wrong = decode_attention_paged_plain(*args, torch.from_numpy(short))
    assert _row_ratio(wrong.float().numpy(), ref)[-1].min() > 2e-2


def test_decode_attention_paged_plain_ignores_stale_nan():
    """Rows past each length hold NaN (a released page's old content):
    the output is finite and equals the same call over zeroed stale rows."""
    b, h, kh, d, ps, wp = 3, 4, 2, 64, 16, 4
    lengths = [5, 16, 50]
    args = [_paged_inputs(np.random.default_rng(2), b, h, kh, d, ps, wp, 14,
                          lengths, stale=s) for s in (np.nan, 0.0)]
    outs = [decode_attention_paged_plain(*(torch.from_numpy(a) for a in x))
            for x in args]
    assert torch.isfinite(outs[0]).all()
    assert torch.equal(outs[0], outs[1])


def test_plain_versions_are_the_wrappers_on_cpu():
    rng = np.random.default_rng(3)
    q, kp, vp, table, lens = (torch.from_numpy(a) for a in _paged_inputs(
        rng, 2, 4, 2, 64, 16, 2, 6, [3, 20]))
    assert torch.equal(decode_attention_paged(q, kp, vp, table, lens),
                       decode_attention_paged_plain(q, kp, vp, table, lens))
    k2, v2 = kp.clone(), vp.clone()
    rows = torch.tensor([3, 40])
    valid = torch.tensor([True, True])
    scatter_pool_rows(kp, vp, q[:, :2].reshape(2, -1), q[:, 2:].reshape(2, -1),
                      rows, valid)
    scatter_pool_rows_plain(k2, v2, q[:, :2].reshape(2, -1),
                            q[:, 2:].reshape(2, -1), rows, valid)
    assert torch.equal(kp, k2) and torch.equal(vp, v2)
    assert scatter_pool_rows.launches == decode_attention_paged.launches == 0


# ---------------------------------------------------------------------------
# pool operations and allocators
# ---------------------------------------------------------------------------

def test_pool_ops_match_jax():
    """write_chunk (page-aligned start, padded tail), appends across a page
    edge and a dropped position, read and slot_view through a shared,
    partly unallocated table: the same pools and views as JAX's."""
    rng = np.random.default_rng(4)
    b, s, kh, d = 2, 128, 2, 8
    table = np.zeros((b, s // PAGE), np.int32)
    table[0, :3] = [5, 2, 7]
    table[1, :2] = [1, 3]
    (jc,) = jkvp.init_paged_cache(1, b, s, kh, d, page_size=PAGE,
                                  total_pages=9, dtype=jnp.float32)
    (jc,) = jkvp.with_table((jc,), jnp.asarray(table))
    tc = kvcache_paged.init_paged_cache(2, b, s, kh, d, page_size=PAGE,
                                        total_pages=9, dtype=torch.float32)
    assert tc[0].table is tc[1].table          # one table for all layers
    kvcache_paged.with_table(tc, table)
    (tc,) = tc[:1]
    chunk = rng.standard_normal((40, kh, d)).astype(np.float32)
    jc = jkv.write_chunk(jc, jnp.asarray(chunk), jnp.asarray(chunk * 2), 0, 32)
    kvcache.write_chunk(tc, torch.from_numpy(chunk),
                        torch.from_numpy(chunk * 2), 0, 32)
    for pos in ([31, 60], [32, 200]):
        tok = rng.standard_normal((b, kh, d)).astype(np.float32)
        jc = jkv.append_token(jc, jnp.asarray(tok), jnp.asarray(-tok),
                              jnp.asarray(pos, jnp.int32))
        kvcache.append_token(tc, torch.from_numpy(tok), torch.from_numpy(-tok),
                             torch.tensor(pos))
    np.testing.assert_array_equal(tc.k_pool.numpy(), np.asarray(jc.k_pool))
    np.testing.assert_array_equal(tc.v_pool.numpy(), np.asarray(jc.v_pool))
    for got, ref in zip(kvcache.read(tc, torch.float32),
                        jkv.read(jc, jnp.float32)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for got, ref in zip(kvcache_paged.slot_view(tc, 1, torch.float32, 64),
                        jkvp.slot_view(jc, 1, jnp.float32, 64)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("cached", [False, True])
def test_allocators_match_jax(cached):
    """The same sequence of ensure / match_prefix / register_prefix /
    release calls leaves the same tables, free lists and counters."""
    cls_t = (kvcache_paged.PrefixCachingAllocator if cached
             else kvcache_paged.PageAllocator)
    cls_j = jkvp.PrefixCachingAllocator if cached else jkvp.PageAllocator
    at, aj = cls_t(12, 3, 4), cls_j(12, 3, 4)
    tt, tj = np.zeros((3, 4), np.int32), np.zeros((3, 4), np.int32)
    prompt = list(range(1, 80))
    rng = np.random.default_rng(5)
    for _ in range(60):
        op, slot = rng.integers(0, 4), int(rng.integers(0, 3))
        if op == 0:
            n = int(rng.integers(1, 65))
            assert at.ensure(tt, slot, n, 16) == aj.ensure(tj, slot, n, 16)
        elif op == 1:
            at.release(tt, slot)
            aj.release(tj, slot)
        elif cached and op == 2 and not at.per_slot[slot] \
                and not at.shared_per_slot[slot]:
            n = int(rng.integers(2, 80))
            assert (at.match_prefix(tt, slot, prompt[:n], 16)
                    == aj.match_prefix(tj, slot, prompt[:n], 16))
        elif cached and op == 3:
            n = int(rng.integers(2, 80))
            at.register_prefix(slot, prompt[:n], 16)
            aj.register_prefix(slot, prompt[:n], 16)
        np.testing.assert_array_equal(tt, tj)
        assert at.free == aj.free and at.per_slot == aj.per_slot
        if cached:
            assert (at.shared_per_slot, at.lru, at.refcount, at.hits,
                    at.hit_tokens) == (aj.shared_per_slot, aj.lru,
                                       aj.refcount, aj.hits, aj.hit_tokens)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def test_paged_runtime_fields_round_trip_with_jax():
    kw = dict(kv_page_size=32, kv_reserve="lazy", kv_lazy_slack=16,
              enable_prefix_cache=True, prefill_chunk_size=64)
    text = jax_config_to_json(JRuntime(**kw))
    assert config_to_json(RuntimeConfig(**kw)) == text
    assert config_from_json(RuntimeConfig, text) == RuntimeConfig(**kw)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_llama(max_seq_len=256)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(20), dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tiny_llama_config(max_seq_len=256), tparams


def _engines(tiny, *, batch=2, pages=None, eos=0, **rt):
    jcfg, jparams, cfg, tparams = tiny
    kw = dict(max_batch_size=batch, max_seq_len=256, kv_page_size=PAGE,
              prefill_chunk_size=32, prefill_buckets=(32, 64))
    kw.update(rt)
    jeng = JEngine(jparams, jcfg, runtime=JRuntime(**kw), eos_token_id=eos,
                   act_dtype=jnp.float32, kv_layout="paged",
                   kv_total_pages=pages)
    teng = InferenceEngine(tparams, cfg, runtime=RuntimeConfig(**kw),
                           eos_token_id=eos, act_dtype=torch.float32,
                           device="cpu", kv_layout="paged",
                           kv_total_pages=pages)
    return jeng, teng


def _gen(n):
    return (JGen(max_tokens=n, temperature=0.0, do_sample=False),
            GenerationConfig(max_tokens=n, temperature=0.0, do_sample=False))


PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7],
           [int(t) for t in np.random.default_rng(6).integers(1, 128, 45)]]


@pytest.mark.parametrize("reserve", ["full", "lazy"])
def test_paged_generate_batch_matches_jax(tiny, reserve):
    """Three prompts, one of them chunked (45 > 32), over 3 slots; the same
    tokens, stop reasons and page use as the JAX engine's paged layout."""
    jeng, teng = _engines(tiny, batch=3, kv_reserve=reserve,
                          kv_lazy_slack=16)
    gj, gt = _gen(40)
    jr = jeng.generate_batch(PROMPTS, gj)
    tr = teng.generate_batch(PROMPTS, gt)
    assert [r.token_ids for r in tr] == [r.token_ids for r in jr]
    assert [r.stop_reason for r in tr] == [r.stop_reason for r in jr]
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-3)
    assert teng._page_alloc.free_pages == jeng._page_alloc.free_pages


def test_paged_matches_contiguous_port(tiny):
    _, teng = _engines(tiny, batch=3)
    _, _, cfg, tparams = tiny
    ceng = InferenceEngine(tparams, cfg, runtime=teng.runtime,
                           eos_token_id=0, act_dtype=torch.float32,
                           device="cpu")
    gt = _gen(20)[1]
    assert ([r.token_ids for r in teng.generate_batch(PROMPTS, gt)]
            == [r.token_ids for r in ceng.generate_batch(PROMPTS, gt)])


def _drive(eng, steps=400):
    done = {}
    for _ in range(steps):
        eng.step()
        for r in eng.pop_finished():
            done.setdefault(r.request_id, []).append(r)
        if eng.active_requests == 0:
            break
    return done


def test_lazy_admits_more_than_full_would(tiny):
    """Three requests in a pool that full reservation could not hold."""
    jeng, teng = _engines(tiny, batch=3, pages=10, kv_reserve="lazy",
                          kv_lazy_slack=16)
    gj, gt = _gen(16)
    for i in range(3):
        ids = [1 + i, 2, 3, 4, 5, 6, 7, 8]
        jeng.add_request(ids, gj, request_id=f"r{i}")
        teng.add_request(ids, gt, request_id=f"r{i}")
    assert teng.active_requests == jeng.active_requests == 3
    dj, dt = _drive(jeng), _drive(teng)
    assert {k: [r.token_ids for r in v] for k, v in dt.items()} == \
        {k: [r.token_ids for r in v] for k, v in dj.items()}
    assert all(len(v[0].token_ids) == 16 for v in dt.values())


def test_preemption_matches_jax(tiny):
    """A pool too small for two long requests: the younger is preempted in
    both engines at the same step, the older completes with the same
    tokens."""
    jeng, teng = _engines(tiny, pages=5, kv_reserve="lazy", kv_lazy_slack=16)
    gj, gt = _gen(120)
    for eng, g in ((jeng, gj), (teng, gt)):
        eng.add_request([1, 2, 3, 4], g, request_id="old")
        eng.add_request([5, 6, 7, 8], g, request_id="young")
    dj, dt = _drive(jeng), _drive(teng)
    summary = [{k: [(r.stop_reason, r.token_ids) for r in v]
                for k, v in d.items()} for d in (dj, dt)]
    assert summary[0] == summary[1]
    assert [r.stop_reason for r in dt["young"]] == ["preempted"]
    assert dt["old"][0].stop_reason in ("max_tokens", "eos", "max_seq")


def test_no_free_pages_and_release_match_jax(tiny):
    jeng, teng = _engines(tiny, pages=4)        # 3 usable pages
    gj, gt = _gen(40)
    jeng.add_request([1, 2, 3], gj, request_id="a")
    teng.add_request([1, 2, 3], gt, request_id="a")
    with pytest.raises(NoFreePages, match="no free KV pages"):
        teng.add_request([4, 5], gt, request_id="b")
    assert teng._page_alloc.free_pages == jeng._page_alloc.free_pages == 1
    dj, dt = _drive(jeng), _drive(teng)
    assert dt["a"][0].token_ids == dj["a"][0].token_ids
    assert teng._page_alloc.free_pages == 3
    assert (teng._table_host == 0).all()
    assert (teng.caches[0].table == 0).all()


def _run_scheduler(sched, req_cls, gen, n=2):
    sched.start()
    try:
        reqs = [req_cls(request_id=f"q{i}", prompt="abcdefgh", config=gen)
                for i in range(n)]
        for r in reqs:
            sched.submit(r)
        for r in reqs:
            assert r.wait(300.0), r.request_id
    finally:
        sched.stop()
    return reqs


def test_scheduler_resumes_preempted_like_jax(tiny):
    """test_paged_kv.py's resume case through both schedulers: both
    requests complete with 90 tokens after at least one preemption, with
    the same token streams as the JAX scheduler's."""
    jeng, teng = _engines(tiny, pages=6, kv_reserve="lazy", kv_lazy_slack=16)

    def encode(s):
        return [ord(c) % 96 + 1 for c in s]

    def decode(ids):
        return "".join(chr(97 + (t % 26)) for t in ids)

    gj, gt = _gen(90)
    js = JScheduler(jeng, encode=encode, decode=decode, config=JSchedCfg())
    ts = Scheduler(teng, encode=encode, decode=decode,
                   config=SchedulerConfig())
    jr = _run_scheduler(js, JRequest, gj)
    tr = _run_scheduler(ts, Request, gt)
    for r in tr:
        assert r.status.name == "COMPLETED", (r.request_id, r.result.error)
        assert r.result.completion_tokens == 90
    assert ts.preempted_requests >= 1 and js.preempted_requests >= 1
    assert ts.stats()["preempted"] == ts.preempted_requests
    assert [r.result.token_ids for r in tr] == [r.result.token_ids for r in jr]


def test_scheduler_request_finishing_at_admission_is_completed(tiny):
    """A request that ends on its first token frees its slot inside the
    admission round; the next admission reuses the slot, and both requests
    still complete, with the JAX scheduler's tokens."""
    jeng, teng = _engines(tiny)
    gens = [_gen(1), _gen(5), _gen(4)]
    out = []
    for sched_cls, req_cls, eng, k, cfg in (
            (JScheduler, JRequest, jeng, 0, JSchedCfg()),
            (Scheduler, Request, teng, 1, SchedulerConfig())):
        sched = sched_cls(eng, encode=lambda s: [ord(c) % 96 + 1 for c in s],
                          decode=lambda ids: "", config=cfg)
        reqs = [req_cls(prompt=f"p{i}", config=g[k])
                for i, g in enumerate(gens)]
        for r in reqs:
            sched.submit(r)
        sched.start()
        try:
            assert all(r.wait(60.0) for r in reqs)
        finally:
            sched.stop()
        out.append([r.result.token_ids for r in reqs])
    assert out[1] == out[0]
    assert [len(t) for t in out[1]] == [1, 5, 4]


# ---------------------------------------------------------------------------
# prefix caching on the paged layout
# ---------------------------------------------------------------------------

SYSTEM = [int(t) for t in np.random.RandomState(3).randint(1, 127, 70)]


def test_paged_prefix_hits_match_jax_and_cache_off(tiny):
    """test_paged_kv.py's shared-prefix case: the second prompt maps two
    shared pages (64 tokens) and prefills the rest; tokens equal the
    cache-off run and the JAX engine's, with the same hits."""
    gj, gt = _gen(12)
    jeng, teng = _engines(tiny, batch=3, enable_prefix_cache=True)
    _, off = _engines(tiny, batch=3)
    ref = [off.generate(SYSTEM + [t], gt).token_ids for t in (5, 9)]
    out = [teng.generate(SYSTEM + [t], gt).token_ids for t in (5, 9)]
    jout = [jeng.generate(SYSTEM + [t], gj).token_ids for t in (5, 9)]
    assert out == ref == jout
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats
    assert teng.prefix_cache_stats["hits"] == 1
    assert teng.prefix_cache_stats["hit_tokens"] == 64


def test_paged_prefix_sharing_with_live_requests(tiny):
    """Two live requests share pages while a third decodes; retiring one
    must not disturb the other (refcounts), and chunks of a prefix hit
    interleave with decode steps without writing shared pages."""
    gt = _gen(30)[1]
    short = _gen(2)[1]
    _, teng = _engines(tiny, batch=3, enable_prefix_cache=True)
    _, off = _engines(tiny, batch=3)
    ref = off.generate(SYSTEM + [5], gt).token_ids
    teng.generate(SYSTEM + [1], short)               # populates the cache
    shared = [p for p, k in teng._page_alloc.key_of.items()]
    before = [teng.caches[0].k_pool[p].clone() for p in shared]
    teng.add_request([3, 4, 5], gt, request_id="other")
    teng.begin_request(SYSTEM + [5], gt, request_id="a")
    teng.begin_request(SYSTEM + [9], short, request_id="b")
    done = {}
    while teng.active_requests:
        for slot in teng.prefilling_slots[:1]:
            teng.continue_prefill(slot)
        teng.step()
        done.update({r.request_id: r for r in teng.pop_finished()})
    assert done["a"].token_ids == ref
    assert teng.prefix_cache_stats["hits"] == 2
    for p, old in zip(shared, before):
        assert torch.equal(teng.caches[0].k_pool[p], old)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("order", [0, 1, 2])
def test_chip_smoke_paged_traffic_preempts_hits_and_chunks(order):
    """chip_smoke.py's paged serve phase checks that preemption, a prefix
    hit and a two-chunk prompt all occur. Its traffic and pool, on a tiny
    model on the CPU through the scheduler, in three arrival orders: the
    token counts that decide them are the card's."""
    cs = _chip_smoke()
    cfg = tiny_llama_config(vocab_size=260, max_seq_len=2048)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32)
    tok = ByteTokenizer()
    engine = cs.paged_engine(params, cfg, "cpu", tok.eos_token_id)
    prompts = cs.paged_prompts()
    random.Random(order).shuffle(prompts)
    sched = Scheduler(engine, encode=tok.encode, decode=tok.decode)
    gen = GenerationConfig(max_tokens=cs.PAGED_MAX_TOKENS, temperature=0.0)
    reqs = [Request(prompt=p, config=gen) for p in prompts]
    for r in reqs:
        sched.submit(r)
    sched.start()
    try:
        assert all(r.wait(120.0) for r in reqs)
    finally:
        sched.stop()
    for r in reqs:
        assert r.status.name == "COMPLETED", r.result.error
        assert (r.result.completion_tokens == cs.PAGED_MAX_TOKENS
                or r.result.stop_reason == "eos")
    assert sched.preempted_requests >= 1
    assert engine.prefix_cache_stats["hits"] >= 1
    assert max(engine.chunks.values()) >= 2


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: "
                    "python -m pytest -m cuda tests/test_torch_paged.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_paged_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(7)
    q, kp, vp, table, lens = (torch.from_numpy(a).to(cuda_device)
                              for a in _paged_inputs(rng, 3, 32, 4, 64, 128,
                                                     8, 40, [48, 300, 1024],
                                                     stale=np.nan))
    q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    out = decode_attention_paged(q, kp, vp, table, lens)
    ref = decode_attention_paged_plain(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().amax(-1)
    assert (err <= 1e-2 * ref.float().abs().amax(-1)).all()
    assert torch.equal(out, decode_attention_paged(q, kp, vp, table, lens))
    zero = decode_attention_paged(q, kp, vp, table, lens * 0)
    assert (zero == 0).all()                     # length 0: a zero row
    k2, v2 = kp.clone(), vp.clone()
    rows = torch.tensor([5, 130, 7, 4000], device=cuda_device)
    valid = torch.tensor([True, False, True, True], device=cuda_device)
    kr, vr = (torch.randn(4, 256, device=cuda_device).to(torch.bfloat16)
              for _ in range(2))
    scatter_pool_rows(kp, vp, kr, vr, rows, valid)
    scatter_pool_rows_plain(k2, v2, kr, vr, rows, valid)
    torch.cuda.synchronize()
    assert torch.equal(kp.nan_to_num(), k2.nan_to_num())
    assert torch.equal(vp.nan_to_num(), v2.nan_to_num())
