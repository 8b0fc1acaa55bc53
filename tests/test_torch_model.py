"""The port's slice against the JAX package, whole: quantization, parameter
conversion, the model's prefill and decode steps, and the engine.

Everything runs at tiny size on the CPU in f32, from the same weights: the
JAX parameter tree is made once, turned into numpy, and converted with
params_from_numpy. Greedy decoding must give the same tokens.
"""

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
from deeppowers_tpu.quant import quantize as jax_quantize
from deeppowers_tpu.runtime import kvcache as jkv
from deeppowers_tpu.runtime.checkpoint import load_checkpoint
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine

from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_llama_config
from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
from deeppowers_tpu_torch.quant.quantize import dequantize, quantize
from deeppowers_tpu_torch.runtime import kvcache
from deeppowers_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    """JAX tree -> same tree with numpy leaves (QuantizedTensor kept as an
    object whose fields are numpy arrays)."""
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_llama()
    jparams = JT.quantize_params(
        JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32),
        JQuant())
    tparams = params_from_numpy(_np_tree(jparams), device="cpu")
    return jcfg, jparams, tiny_llama_config(), tparams


@pytest.mark.parametrize("shape,scale", [((64, 48), 1.0), ((256, 128), 0.02),
                                         ((33, 7), 5.0)])
def test_quantize_int8_equals_jax_exactly(shape, scale):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * scale).astype(np.float32)
    w[0, 0] = 0.0
    w[1, :] = 0.0                               # all-zero rows
    jq = jax_quantize(jnp.asarray(w), bits=8)
    tq = quantize(torch.from_numpy(w), bits=8)
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert tq.data.dtype == torch.int8 and tq.scales.dtype == torch.float32
    back = dequantize(tq).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jax.numpy.asarray(jq.data, jnp.float32) * jq.scales))


def test_params_from_numpy_roundtrips_tiny_tree(tiny):
    _, jparams, _, tparams = tiny
    jl = jax.tree_util.tree_leaves(_np_tree(jparams))
    flat = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            for v in node:
                walk(v)
        elif isinstance(node, QuantizedTensor):
            flat.extend([node.data, node.scales])
        else:
            flat.append(node)

    walk(tparams)
    assert len(flat) == len(jl)
    for a, b in zip(flat, jl):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    q = tparams["layers"][0]["attn"]["wq"]["w"]
    assert isinstance(q, QuantizedTensor) and q.bits == 8


def test_params_from_numpy_bf16_leaves():
    a = jnp.asarray(np.linspace(-3, 3, 24, dtype=np.float32)).astype(
        jnp.bfloat16).reshape(4, 6)
    t = params_from_numpy({"w": np.asarray(a)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a.astype(jnp.float32)))


def _j_prefill_decode(jcfg, jparams, ids, lens, steps):
    logits, kv = JT.forward_prefill(jparams, jcfg, jnp.asarray(ids),
                                    jnp.asarray(lens), dtype=jnp.float32)
    b, s = ids.shape
    caches = jkv.init_cache(jcfg.num_layers, b, jcfg.max_seq_len,
                            jcfg.kv_heads, jcfg.dim_head, dtype=jnp.float32)
    caches = tuple(jkv.write_prompts(c, k, v, jnp.arange(b))
                   for c, (k, v) in zip(caches, kv))
    lengths = jnp.asarray(lens)
    out = [np.asarray(logits)]
    for t in steps:
        lg, caches = JT.forward_decode(jparams, jcfg, jnp.asarray(t), caches,
                                       lengths, dtype=jnp.float32)
        out.append(np.asarray(lg))
        lengths = lengths + 1
    return out


def _t_prefill_decode(cfg, params, ids, lens, steps):
    logits, kv = T.forward_prefill(params, cfg, torch.from_numpy(ids),
                                   torch.from_numpy(lens), dtype=torch.float32)
    b, s = ids.shape
    caches = kvcache.init_cache(cfg.num_layers, b, cfg.max_seq_len,
                                cfg.kv_heads, cfg.dim_head, dtype=torch.float32)
    for c, (k, v) in zip(caches, kv):
        kvcache.write_prompts(c, k, v, torch.arange(b))
    lengths = torch.from_numpy(lens)
    out = [logits.numpy()]
    for t in steps:
        lg, caches = T.forward_decode(params, cfg, torch.from_numpy(t), caches,
                                      lengths, dtype=torch.float32)
        out.append(lg.numpy())
        lengths = lengths + 1
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_and_decode_logits_match_jax(tiny, fused):
    """Teacher-forced: same prompt and forced tokens through both models.
    f32 throughout; the only differences are summation order and the
    fused kernel's algebra (norm folded after the product), so 1e-4 of
    the logits' scale bounds them."""
    jcfg, jparams, cfg, tparams = tiny
    if fused:
        jparams = JT.fuse_params(jparams, jcfg)
        tparams = T.fuse_params(tparams, cfg)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 128, (2, 16)).astype(np.int32)
    lens = np.array([16, 11], np.int32)
    ids[1, 11:] = 0                               # the JAX engine pads with 0
    # The port gets out-of-vocabulary padding instead: jnp.take would read
    # NaN embeddings for it (and 0 * NaN then poisons decode attention);
    # the port reads it as id 0, so both sides must agree.
    tids = ids.astype(np.int64)
    tids[1, 11:] = jcfg.vocab_size
    steps = [rng.integers(0, 128, (2,)).astype(np.int32) for _ in range(4)]
    ref = _j_prefill_decode(jcfg, jparams, ids, lens, steps)
    got = _t_prefill_decode(cfg, tparams, tids, lens, steps)
    scale = np.abs(ref[0]).max()
    for i in range(2):                            # valid prefill rows only
        np.testing.assert_allclose(got[0][i, :lens[i]], ref[0][i, :lens[i]],
                                   atol=1e-4 * scale)
    assert np.isfinite(got[0]).all()
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, atol=1e-4 * scale)


def test_lm124_checkpoint_converts_and_matches_jax():
    """The in-repo trained checkpoint, loaded by the JAX package's own
    loader: conversion is exact and a prefill agrees."""
    jparams, jcfg, _ = load_checkpoint(os.path.join(REPO, "lm124_ckpt"))
    np_tree = _np_tree(jparams)
    tparams = params_from_numpy(np_tree, device="cpu")
    for name in ("embedding",):
        np.testing.assert_array_equal(tparams[name].numpy(), np_tree[name])
    np.testing.assert_array_equal(
        tparams["layers"][11]["mlp"]["w_out"]["w"].numpy(),
        np_tree["layers"][11]["mlp"]["w_out"]["w"])
    cfg = T.TransformerConfig(**{f: getattr(jcfg, f) for f in
                                 jcfg.__dataclass_fields__})
    text = b"the cat sat on the mat. "
    ids = np.array([[c + 4 for c in text]], np.int32)
    lens = np.array([ids.shape[1]], np.int32)
    ref = np.asarray(JT.forward_prefill(jparams, jcfg, jnp.asarray(ids),
                                        jnp.asarray(lens),
                                        dtype=jnp.float32)[0])
    got = T.forward_prefill(tparams, cfg, torch.from_numpy(ids.astype(np.int64)),
                            torch.from_numpy(lens), dtype=torch.float32)[0]
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4 * np.abs(ref).max())
    assert (got.numpy().argmax(-1) == ref.argmax(-1)).mean() > 0.95


def _engines(tiny, max_seq=64, eos=None, batch=4):
    jcfg, jparams, cfg, tparams = tiny
    jeng = JEngine(jparams, jcfg,
                   runtime=JRuntime(max_batch_size=batch, max_seq_len=max_seq,
                                    prefill_buckets=(16, 32, 64),
                                    scan_layers=True),
                   act_dtype=jnp.float32, eos_token_id=eos)
    teng = InferenceEngine(tparams, cfg,
                           runtime=RuntimeConfig(max_batch_size=batch,
                                                 max_seq_len=max_seq,
                                                 prefill_buckets=(16, 32, 64),
                                                 scan_layers=True),
                           act_dtype=torch.float32, eos_token_id=eos,
                           device="cpu")
    return jeng, teng


def test_generate_batch_greedy_matches_jax_engine(tiny):
    jeng, teng = _engines(tiny)
    rng = np.random.default_rng(1)
    prompts = [list(rng.integers(0, 128, n)) for n in (5, 12, 20, 3)]
    prompts = [[int(t) for t in p] for p in prompts]
    gen_j = JGen(max_tokens=10, temperature=0.0, do_sample=False)
    gen_t = GenerationConfig(max_tokens=10, temperature=0.0, do_sample=False)
    jr = jeng.generate_batch(prompts, gen_j)
    tr = teng.generate_batch(prompts, gen_t)
    assert [r.token_ids for r in tr] == [r.token_ids for r in jr]
    assert [r.stop_reason for r in tr] == [r.stop_reason for r in jr]
    for a, b in zip(tr, jr):
        np.testing.assert_allclose(a.logprobs, b.logprobs, atol=1e-3)


def test_capacity_guard_matches_jax_engine(tiny):
    """A prompt near the cache end retires at lengths >= max_seq - 1."""
    jeng, teng = _engines(tiny, max_seq=32, batch=2)
    prompt = [int(t) for t in np.random.default_rng(2).integers(0, 128, 24)]
    gen_j = JGen(max_tokens=50, temperature=0.0, do_sample=False)
    gen_t = GenerationConfig(max_tokens=50, temperature=0.0, do_sample=False)
    jr = jeng.generate(prompt, gen_j)
    tr = teng.generate(prompt, gen_t)
    assert tr.token_ids == jr.token_ids
    assert tr.stop_reason == jr.stop_reason == "max_seq"
    assert len(prompt) + len(tr.token_ids) - 1 <= 32 - 1


def test_eos_retirement_matches_jax_engine(tiny):
    """EOS = a token the greedy stream emits: both engines stop there."""
    jeng, teng = _engines(tiny)
    prompt = [7, 8, 9, 10]
    free = teng.generate(prompt, GenerationConfig(max_tokens=8, temperature=0.0,
                                                  do_sample=False)).token_ids
    eos = free[3]
    jeng, teng = _engines(tiny, eos=eos)
    jr = jeng.generate(prompt, JGen(max_tokens=8, temperature=0.0,
                                    do_sample=False))
    tr = teng.generate(prompt, GenerationConfig(max_tokens=8, temperature=0.0,
                                                do_sample=False))
    assert tr.token_ids == jr.token_ids
    assert tr.token_ids[-1] == eos and tr.stop_reason == jr.stop_reason == "eos"


def test_cache_is_zero_initialised():
    c = kvcache.init_cache(2, 3, 16, 2, 8, dtype=torch.bfloat16)
    assert all(bool((x.k == 0).all()) and bool((x.v == 0).all()) for x in c)


def test_entry_points_need_cuda_unless_cpu_is_asked(tiny, monkeypatch):
    _, _, cfg, tparams = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(tparams, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
