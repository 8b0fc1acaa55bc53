"""Chunked prefill and prefix caching on the contiguous layout, the port
against the JAX package.

The port's first slice prefilled every prompt whole and ignored
RuntimeConfig.prefill_chunk_size; the JAX engine sends a prompt longer
than the chunk through `continue_prefill`, one chunk per scheduler turn,
so a long prompt never stalls the running slots for its whole prefill.
The first test pins that behaviour to the JAX engine's.

Tiny sizes, f32, the setups of tests/test_paged_kv.py: tiny_llama_config
(max_seq_len=256), chunk 32 (page 32 where a test runs the paged layout).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.config import GenerationConfig as JGen
from deeppowers_tpu.config import RuntimeConfig as JRuntime
from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.models.presets import tiny_llama_config as jax_tiny_llama
from deeppowers_tpu.ops.attention import attention_chunk as jax_attention_chunk
from deeppowers_tpu.runtime import kvcache as jkv
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine

from deeppowers_tpu_torch.config import (GenerationConfig, RuntimeConfig,
                                         SchedulerConfig)
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_llama_config
from deeppowers_tpu_torch.ops.attention import attention_chunk
from deeppowers_tpu_torch.runtime import kvcache
from deeppowers_tpu_torch.runtime.engine import InferenceEngine
from deeppowers_tpu_torch.serving.request import Request
from deeppowers_tpu_torch.serving.scheduler import Scheduler

torch.set_num_threads(1)

CHUNK = 32


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_llama(max_seq_len=256)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tiny_llama_config(max_seq_len=256), tparams


def _engines(tiny, *, layout="contiguous", batch=2, eos=None, **rt):
    jcfg, jparams, cfg, tparams = tiny
    kw = dict(max_batch_size=batch, max_seq_len=256, kv_page_size=32,
              prefill_chunk_size=CHUNK, prefill_buckets=(32, 64))
    kw.update(rt)
    jeng = JEngine(jparams, jcfg, runtime=JRuntime(**kw), eos_token_id=eos,
                   act_dtype=jnp.float32, kv_layout=layout)
    teng = InferenceEngine(tparams, cfg, runtime=RuntimeConfig(**kw),
                           eos_token_id=eos, act_dtype=torch.float32,
                           device="cpu", kv_layout=layout)
    return jeng, teng


def _gen(n):
    return (JGen(max_tokens=n, temperature=0.0, do_sample=False),
            GenerationConfig(max_tokens=n, temperature=0.0, do_sample=False))


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 128, n)]


@pytest.mark.parametrize("n", [33, 80, 100])
def test_long_prompt_enters_chunked_prefill_like_jax(tiny, n):
    """A prompt longer than prefill_chunk_size reserves its slot, shows in
    prefilling_slots and takes as many continue_prefill calls as in the
    JAX engine (ceil(n / chunk)); a running request keeps decoding between
    the chunks with the JAX engine's tokens. (The JAX engine runs
    unpipelined here, so each step() returns its own tokens.) The long
    prompt's tokens equal the JAX engine's run of it alone: interleaved,
    the JAX engine overwrites its first row (see
    test_prefill_interleaved_with_decode_is_exact)."""
    jeng, teng = _engines(tiny, pipelined_dispatch=False)
    gj, gt = _gen(12)
    long = _prompt(n, n)
    alone = _engines(tiny)[0].generate(long, gj).token_ids
    out = []
    for eng, g in ((jeng, gj), (teng, gt)):
        eng.add_request([3, 4, 5], g, request_id="run")
        slot = eng.begin_request(long, g, request_id="long")
        assert eng.prefilling_slots == [slot]
        calls, streamed = 0, []
        while True:
            calls += 1
            finished = eng.continue_prefill(slot)
            streamed.append(eng.step())       # decode between the chunks
            if finished:
                break
        assert eng.prefilling_slots == []
        done = {}
        while eng.active_requests:
            eng.step()
            done.update({r.request_id: r for r in eng.pop_finished()})
        done.update({r.request_id: r for r in eng.pop_finished()})
        out.append((calls, [len(s) for s in streamed],
                    done["run"].token_ids))
    assert out[0][0] == -(-n // CHUNK)
    assert out[1] == out[0]
    assert done["long"].token_ids == alone


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_chunked_prefill_tokens_match_jax(tiny, layout):
    jeng, teng = _engines(tiny, layout=layout, batch=3)
    gj, gt = _gen(16)
    prompts = [_prompt(100, 1), [7, 8, 9], _prompt(64, 2)]
    jr = jeng.generate_batch(prompts, gj)
    tr = teng.generate_batch(prompts, gt)
    assert [r.token_ids for r in tr] == [r.token_ids for r in jr]
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-3)


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_interleaved_with_decode_is_exact(tiny, layout):
    """Decode steps between the chunks of another prompt leave its rows
    alone: the prompt's tokens equal the JAX engine's run of it alone. (The
    JAX engine writes each inactive slot's decode K/V at its row
    lengths = 0, over the prefilling prompt's first row.)"""
    jeng, teng = _engines(tiny, layout=layout)
    gj, gt = _gen(10)
    long = _prompt(90, 7)
    ref = jeng.generate(long, gj).token_ids
    teng.add_request([3, 4, 5], _gen(40)[1], request_id="run")
    slot = teng.begin_request(long, gt, request_id="long")
    for _ in range(3):                      # decode steps before each chunk
        teng.step()
        teng.step()
        teng.continue_prefill(slot)
    done = {}
    while teng.active_requests:
        teng.step()
        done.update({r.request_id: r for r in teng.pop_finished()})
    assert done["long"].token_ids == ref


def test_forward_prefill_chunk_logits_match_jax(tiny):
    """Two chunks through forward_prefill_chunk (contiguous cache, slot 1)
    against JAX's: f32, so 1e-4 of the logits' scale bounds the summation
    order differences."""
    jcfg, jparams, cfg, tparams = tiny
    ids = np.asarray(_prompt(64, 3), np.int32)
    jc = jkv.init_cache(cfg.num_layers, 2, 256, cfg.kv_heads, cfg.dim_head,
                        dtype=jnp.float32)
    tc = kvcache.init_cache(cfg.num_layers, 2, 256, cfg.kv_heads,
                            cfg.dim_head, dtype=torch.float32)
    for start in (0, 32):
        piece = ids[start:start + 32]
        ref, jc = JT.forward_prefill_chunk(jparams, jcfg, jnp.asarray(piece),
                                           jc, jnp.int32(1), jnp.int32(start),
                                           dtype=jnp.float32)
        got, tc = T.forward_prefill_chunk(
            tparams, cfg, torch.from_numpy(piece.astype(np.int64)), tc, 1,
            start, dtype=torch.float32)
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-4 * np.abs(ref).max())
        last, _ = T.forward_prefill_chunk(
            tparams, cfg, torch.from_numpy(piece.astype(np.int64)), tc, 1,
            start, dtype=torch.float32, logits_at=5)
        np.testing.assert_allclose(last.numpy(), got[5].numpy(), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(tc[0].k[1, :64].numpy(),
                               np.asarray(jc[0].k[1, :64]), atol=1e-5)


@pytest.mark.parametrize("start", [0, 13, 40])
def test_attention_chunk_matches_jax(start):
    """Chunk queries over a cache view (B, S, Kh, D) with the causal
    frontier at start + i: f32 on both sides, 1e-5."""
    rng = np.random.default_rng(start)
    b, c, h, kh, d, s = 2, 16, 8, 2, 16, 64
    q = rng.standard_normal((b, c, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    ref = np.asarray(jax_attention_chunk(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.int32(start)))
    got = attention_chunk(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), start).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # the view cut at start + c (what the model passes) gives the same rows
    cut = attention_chunk(torch.from_numpy(q), torch.from_numpy(k[:, :start + c]),
                          torch.from_numpy(v[:, :start + c]), start).numpy()
    np.testing.assert_allclose(cut, ref, atol=1e-5)


# ---------------------------------------------------------------------------
# prefix caching on the contiguous layout (row copies)
# ---------------------------------------------------------------------------

LONG = _prompt(48, 11)


@pytest.mark.parametrize("second", ["repeat", "partial", "multiturn"])
def test_contiguous_prefix_hits_match_jax_and_cache_off(tiny, second):
    """A retired slot's rows are copied for the next prompt that shares
    their prefix; the suffix prefills in chunks. Tokens equal the
    cache-off run and the JAX engine's; hits and hit_tokens equal JAX's."""
    gj, gt = _gen(10)
    jeng, teng = _engines(tiny, batch=4, enable_prefix_cache=True)
    _, off = _engines(tiny, batch=4)
    out = []
    for eng, g in ((jeng, gj), (teng, gt)):
        r1 = eng.generate(LONG, g).token_ids
        p2 = {"repeat": LONG, "partial": LONG[:32] + [121, 122, 123],
              "multiturn": LONG + r1[:-1] + [99, 98]}[second]
        out.append((r1, eng.generate(p2, g).token_ids, p2))
    (jr1, jr2, _), (tr1, tr2, p2) = out
    assert (tr1, tr2) == (jr1, jr2)
    assert tr2 == off.generate(p2, gt).token_ids
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats
    assert teng.prefix_cache_stats["hits"] == 1


def test_scheduler_interleaves_chunks_with_decode(tiny):
    """Through the port's scheduler, a long prompt admitted beside a
    running request: both complete with the tokens of the JAX engine's
    standalone runs, and the long prompt went through its chunks."""
    jeng, teng = _engines(tiny, batch=2)
    gj, gt = _gen(24)
    long = _prompt(100, 5)
    ref = [jeng.generate(p, gj).token_ids for p in ([3, 4, 5], long)]
    calls = []
    real = teng.continue_prefill

    def counting(slot):
        calls.append(slot)
        return real(slot)

    teng.continue_prefill = counting
    ids = {"a": [3, 4, 5], "b": long}
    sched = Scheduler(teng, encode=lambda s: ids[s], decode=lambda t: "",
                      config=SchedulerConfig())
    reqs = [Request(prompt=p, config=gt) for p in ("a", "b")]
    for r in reqs:
        sched.submit(r)
    sched.start()
    try:
        for r in reqs:
            assert r.wait(120.0)
    finally:
        sched.stop()
    assert [r.result.token_ids for r in reqs] == ref
    assert len(calls) == -(-len(long) // CHUNK)
