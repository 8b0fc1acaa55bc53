"""Greedy token streams of the port's engine with a quantized KV cache
(int8, int4, k8v4) against the JAX engine, on both layouts, with chunked
prefill, prefix hits and (paged) preemption; and the repairs that came
with this slice: a RuntimeConfig field the port does not act on raises,
top logprobs over each store match JAX's, and an int8 engine over the
trained checkpoint's untied 260-wide head runs.

Tiny sizes, f32 activations, the setups of tests/test_paged_kv.py:
tiny_llama_config (max_seq_len=256), page 32, chunk 32; and lm124_ckpt,
loaded through the JAX package's own loader. Greedy token streams must be
equal. The JAX engine writes an idle slot's decode K/V at its row 0 (the
port writes nothing), so prefix reuse is driven by requests one after
another, as tests/test_torch_chunked.py does.
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
from deeppowers_tpu.config import RuntimeConfig as JRuntime
from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.models.presets import tiny_llama_config as jax_tiny_llama
from deeppowers_tpu.runtime.checkpoint import load_checkpoint
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine

from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_llama_config
from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
from deeppowers_tpu_torch.quant.quantize import quantize
from deeppowers_tpu_torch.runtime import kvcache
from deeppowers_tpu_torch.runtime.engine import (UNPORTED_RUNTIME_DEFAULTS,
                                                 InferenceEngine)
from deeppowers_tpu_torch.serving.request import Request
from deeppowers_tpu_torch.serving.scheduler import Scheduler
from deeppowers_tpu_torch.serving.tokenizer import ByteTokenizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = ["int8", "int4", "k8v4"]
LAYOUTS = ["contiguous", "paged"]
PAGE = 32


def _prompt(n, seed, vocab=128):
    return [int(t) for t in np.random.default_rng(seed).integers(1, vocab, n)]


def _gen(n):
    return (JGen(max_tokens=n, temperature=0.0, do_sample=False),
            GenerationConfig(max_tokens=n, temperature=0.0, do_sample=False))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_llama(max_seq_len=256)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(20), dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tiny_llama_config(max_seq_len=256), tparams


def _engines(model, dtype, layout, *, batch=3, pages=None, eos=0,
             max_seq=256, **rt):
    jcfg, jparams, cfg, tparams = model
    kw = dict(max_batch_size=batch, max_seq_len=max_seq, kv_page_size=PAGE,
              prefill_chunk_size=32, prefill_buckets=(32, 64))
    kw.update(rt)
    common = dict(eos_token_id=eos, kv_layout=layout, kv_total_pages=pages,
                  kv_cache_dtype=dtype)
    jeng = JEngine(jparams, jcfg, runtime=JRuntime(**kw),
                   act_dtype=jnp.float32, **common)
    teng = InferenceEngine(tparams, cfg, runtime=RuntimeConfig(**kw),
                           act_dtype=torch.float32, device="cpu", **common)
    return jeng, teng


LONG = _prompt(48, 11)                 # two chunks of 32
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], _prompt(45, 6)]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tiny_greedy_streams_match_jax(tiny, dtype, layout):
    """A two-chunk prompt, then one that shares its first 40 tokens (a
    prefix hit: a row copy on the contiguous layout, a shared page and its
    scales on the paged one), then three prompts decoded together, one of
    them in two chunks: the same tokens and prefix counts as the JAX
    engine's, and caches of the dtype's layout."""
    jeng, teng = _engines(tiny, dtype, layout, enable_prefix_cache=True)
    assert teng.caches[0].quantized and teng.kv_cache_dtype == dtype
    gj, gt = _gen(24)
    second = LONG[:40] + [121, 122, 123]
    got, want = [], []
    for eng, g, out in ((jeng, gj, want), (teng, gt, got)):
        out.append(eng.generate(LONG, g).token_ids)
        out.append(eng.generate(second, g).token_ids)
        out.extend(r.token_ids for r in eng.generate_batch(PROMPTS, g))
    assert got == want
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats
    assert teng.prefix_cache_stats["hits"] >= 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_tiny_paged_preemption_matches_jax(tiny, dtype):
    """A 5-page pool too small for two long requests: the younger is
    preempted at the same step in both engines and the older completes
    with the same tokens."""
    jeng, teng = _engines(tiny, dtype, "paged", batch=2, pages=5,
                          kv_reserve="lazy", kv_lazy_slack=16)
    gj, gt = _gen(120)
    done = []
    for eng, g in ((jeng, gj), (teng, gt)):
        eng.add_request([1, 2, 3, 4], g, request_id="old")
        eng.add_request([5, 6, 7, 8], g, request_id="young")
        out = {}
        for _ in range(400):
            eng.step()
            for r in eng.pop_finished():
                out.setdefault(r.request_id, []).append(
                    (r.stop_reason, r.token_ids))
            if eng.active_requests == 0:
                break
        done.append(out)
    assert done[1] == done[0]
    assert [s for s, _ in done[1]["young"]] == ["preempted"]


@pytest.fixture(scope="module")
def lm124():
    jparams, jcfg, _ = load_checkpoint(os.path.join(REPO, "lm124_ckpt"))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    cfg = T.TransformerConfig(**{f: getattr(jcfg, f) for f in
                                 jcfg.__dataclass_fields__})
    return jcfg, jparams, cfg, tparams


def _text_ids(text: str):
    return [c + 4 for c in text.encode()]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_lm124_greedy_streams_match_jax(lm124, dtype, layout):
    """The trained checkpoint (12 layers, GQA 12/6, head_dim 64): a
    40-token prompt in two chunks and a shorter one decoded beside it give
    the JAX engine's tokens."""
    jeng, teng = _engines(lm124, dtype, layout, batch=2, eos=None,
                          max_seq=128, prefill_buckets=(32, 64, 128))
    gj, gt = _gen(12)
    prompts = [_text_ids("the cat sat on the mat. the dog sat on the"),
               _text_ids("once upon a time")]
    want = [r.token_ids for r in jeng.generate_batch(prompts, gj)]
    assert [r.token_ids for r in teng.generate_batch(prompts, gt)] == want


def test_lm124_int8_engine_runs_with_untied_260_head(lm124):
    """int8 per-channel weights, the lm_head included: its N = 260 is no
    multiple of 8, which the CUDA dequant_matmul takes since this slice.
    On the CPU the engine runs its plain version; its tokens equal the
    JAX int8 engine's, which pins the path chip_smoke.py compares the card
    with."""
    jcfg, jparams, cfg, tparams = lm124
    jq = JT.quantize_params(jparams, JQuant())
    tq = T.quantize_params(tparams, T.QuantConfig())
    head = tq["lm_head"]["w"]
    assert isinstance(head, QuantizedTensor) and head.data.shape[1] == 260
    kw = dict(max_batch_size=2, max_seq_len=128, prefill_buckets=(32, 64))
    jeng = JEngine(jq, jcfg, runtime=JRuntime(**kw), act_dtype=jnp.float32)
    teng = InferenceEngine(tq, cfg, runtime=RuntimeConfig(**kw),
                           act_dtype=torch.float32, device="cpu")
    gj, gt = _gen(10)
    ids = _text_ids("the cat sat on the mat. ")
    got = teng.generate(ids, gt).token_ids
    assert len(got) == 10 and got == jeng.generate(ids, gj).token_ids


def test_lm124_preset_is_the_checkpoint_config(lm124):
    """The LM124 preset, which chip_smoke.py serves on the card with random
    weights to put #1's N = 260 instantiation on a model's path, is the
    trained checkpoint's own config."""
    from deeppowers_tpu_torch.models.presets import LM124, PRESETS
    _, _, cfg, _ = lm124
    assert LM124 == cfg and PRESETS["lm124"] is LM124


@pytest.mark.parametrize("n,variant", [(256, "n8"), (32000, "n8"),
                                       (260, "n4"), (2052, "n4"),
                                       (4099, "n1"), (770, "n1")])
def test_dequant_matmul_width_variant(n, variant):
    """The launch-count variant names the kernel instantiation a width
    takes: whole 8-byte groups, 4-byte loads with a tail, or byte loads
    (csrc/dequant_matmul.cu `row_align`)."""
    assert dm.width_variant(n) == variant


@pytest.mark.parametrize("field,value", [("seq_parallel_prefill", True)])
def test_unported_runtime_fields_raise(tiny, field, value):
    """The JAX engine acts on this field; the port does not yet, so a
    non-default value raises and names the field instead of being
    ignored."""
    assert field in UNPORTED_RUNTIME_DEFAULTS
    _, _, cfg, tparams = tiny
    with pytest.raises(NotImplementedError, match=field):
        InferenceEngine(tparams, cfg, device="cpu", act_dtype=torch.float32,
                        runtime=RuntimeConfig(max_batch_size=2,
                                              max_seq_len=64,
                                              **{field: value}))


@pytest.mark.parametrize("dtype", DTYPES)
def test_emit_top_logprobs_over_quantized_kv_matches_jax(tiny, dtype):
    """emit_top_logprobs = 5, once refused, runs: over each quantized store
    the greedy tokens and every token's top-5 ids equal the JAX engine's,
    the values within 1e-5 (f32), one list a token."""
    jeng, teng = _engines(tiny, dtype, "contiguous", emit_top_logprobs=5)
    assert "emit_top_logprobs" not in UNPORTED_RUNTIME_DEFAULTS
    gj, gt = _gen(12)
    want = jeng.generate_batch(PROMPTS, gj)
    got = teng.generate_batch(PROMPTS, gt)
    for w, g in zip(want, got):
        assert g.token_ids == w.token_ids
        assert len(g.top_tokens) == len(g.token_ids)
        assert [[i for i, _ in t] for t in g.top_tokens] == \
            [[i for i, _ in t] for t in w.top_tokens]
        np.testing.assert_allclose([[v for _, v in t] for t in g.top_tokens],
                                   [[v for _, v in t] for t in w.top_tokens],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_engine_reports_kv_bytes_per_dtype(tiny, layout):
    """kv_nbytes counts stores and scales: int4 stores half the bytes of
    int8, k8v4 three quarters, all far below bf16."""
    _, _, cfg, tparams = tiny
    sizes = {}
    for dtype in ["bf16"] + DTYPES:
        eng = InferenceEngine(tparams, cfg, device="cpu", kv_layout=layout,
                              kv_cache_dtype=dtype,
                              runtime=RuntimeConfig(max_batch_size=2,
                                                    max_seq_len=64,
                                                    kv_page_size=PAGE,
                                                    prefill_chunk_size=32))
        sizes[dtype] = eng.kv_nbytes
        assert sizes[dtype] == kvcache.nbytes(eng.caches)
    assert sizes["int4"] < sizes["k8v4"] < sizes["int8"] < sizes["bf16"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke_model():
    cfg = tiny_llama_config(vocab_size=260, max_seq_len=2048)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           dtype=torch.float32)
    return cfg, params


@pytest.mark.parametrize("dtype", DTYPES)
def test_chip_smoke_quantized_path_runs_on_cpu(smoke_model, dtype):
    """chip_smoke.py's quantized path phase on a tiny model on the CPU
    (plain versions): finite logits, the paged cache (random bytes and NaN
    scales in its unwritten rows) equal to the contiguous one, and within
    the phase's 5e-2 of the bf16 path."""
    cs = _chip_smoke()
    cfg, params = smoke_model
    ids, forced = list(range(5, 45)), [7, 8, 9]
    ref = cs.forced_logits(torch, T, kvcache, params, cfg, ids, forced, "cpu")
    out = [cs.forced_logits(torch, T, kvcache, params, cfg, ids, forced,
                            "cpu", paged=paged, kv_cache_dtype=dtype)
           for paged in (False, True)]
    assert all(torch.isfinite(g).all() for g in out[0] + out[1])
    assert all(torch.equal(a, b) for a, b in zip(*out))
    assert max(((g - r).norm() / r.norm()).item()
               for g, r in zip(out[0], ref)) <= 5e-2


def test_chip_smoke_k8v4_paged_traffic_preempts_hits_and_chunks(smoke_model):
    """chip_smoke.py's k8v4 paged serve phase checks that preemption, a
    prefix hit and a two-chunk prompt all occur over the k8v4 pool: its
    traffic and pool on a tiny model on the CPU through the scheduler."""
    cs = _chip_smoke()
    cfg, params = smoke_model
    tok = ByteTokenizer()
    engine = cs.paged_engine(params, cfg, "cpu", tok.eos_token_id, "k8v4")
    assert engine.caches[0].bits == 8 and engine.caches[0].vbits == 4
    sched = Scheduler(engine, encode=tok.encode, decode=tok.decode)
    gen = GenerationConfig(max_tokens=cs.PAGED_MAX_TOKENS, temperature=0.0)
    reqs = [Request(prompt=p, config=gen) for p in cs.paged_prompts()]
    for r in reqs:
        sched.submit(r)
    sched.start()
    try:
        assert all(r.wait(120.0) for r in reqs)
    finally:
        sched.stop()
    assert all(r.status.name == "COMPLETED" for r in reqs)
    assert sched.preempted_requests >= 1
    assert engine.prefix_cache_stats["hits"] >= 1
    assert max(engine.chunks.values()) >= 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py runs this "
                    "kernel on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [260, 4099])
def test_cuda_dequant_matmul_any_n(cuda_device, n):
    """#1 at a width no multiple of 8: the decode GEMV (M = 8) and the
    tiled prefill path (M = 512) against the plain version, 2e-2 of
    max|ref| as chip_smoke.py holds it; each launch counted under its
    width variant."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qw = quantize(torch.randn(768, n, generator=g, device=cuda_device) * 0.02)
    counts = dm.dequant_matmul.variant_launches
    before = counts[dm.width_variant(n)]
    for m in (8, 512):
        x = torch.randn(m, 768, generator=g, device=cuda_device).to(
            torch.bfloat16)
        got = dm.dequant_matmul(x, qw, out_dtype=torch.float32)
        ref = dm.dequant_matmul_plain(x, qw.data, qw.scales,
                                      out_dtype=torch.float32)
        assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()
    assert counts[dm.width_variant(n)] == before + 2
