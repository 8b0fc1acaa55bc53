"""Greedy token streams of the port's engine over int4, per-group and
W8A8 / W4A8 weights against the JAX engine on the CPU (f32 activations),
and chip_smoke.py's Llama-2-7B phases rehearsed at a tiny size.

Both packages quantize the same float weights with their own
`quantize_params` (bit-exact, tests/test_torch_model.py); the JAX engine
runs the XLA path (`_dequant_weights`, `_w8a8_matmul`), the port the plain
versions of kernel #1. Setups as tests/test_torch_kvquant_engine.py:
tiny_llama_config (max_seq_len=256), page 32, chunk 32; and lm124_ckpt,
loaded through the JAX package's own loader.
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
from deeppowers_tpu.runtime.checkpoint import load_checkpoint
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine

from deeppowers_tpu_torch.config import (GenerationConfig, QuantConfig,
                                         QuantMode, RuntimeConfig)
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_llama_config
from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
from deeppowers_tpu_torch.runtime import kvcache
from deeppowers_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAGE = 32

# name: (QuantConfig fields, kv_cache_dtype, layouts)
RECIPES = {
    "w4a8_g32_k8v4": (dict(mode="int4", group_size=32, act_bits=8), "k8v4",
                      ("contiguous", "paged")),
    "w8a8_int8kv": (dict(mode="int8", act_bits=8), "int8", ("contiguous",)),
    "w4_g32_bf16kv": (dict(mode="int4", group_size=32), "bf16",
                      ("contiguous",)),
    "mixed": (dict(mode="mixed", group_size=32,
                   layer_overrides={"attention": "int8", "mlp": "int4"}),
              "bf16", ("contiguous",)),
}
CASES = [(name, layout) for name, (_, _, layouts) in RECIPES.items()
         for layout in layouts]


def _qcfgs(fields):
    """The same quantization config for the JAX package and the port."""
    fields = dict(fields)
    mode = fields.pop("mode")
    return (JQuant(mode=JMode(mode), **fields),
            QuantConfig(mode=QuantMode(mode), **fields))


def _prompt(n, seed, vocab=128):
    return [int(t) for t in np.random.default_rng(seed).integers(1, vocab, n)]


def _gen(n):
    return (JGen(max_tokens=n, temperature=0.0, do_sample=False),
            GenerationConfig(max_tokens=n, temperature=0.0, do_sample=False))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_llama(max_seq_len=256)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(21), dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tiny_llama_config(max_seq_len=256), tparams


def _engines(model, recipe, layout, *, batch=3, eos=0, max_seq=256, **rt):
    jcfg, jparams, cfg, tparams = model
    fields, kv_dtype, _ = RECIPES[recipe]
    jq, tq = _qcfgs(fields)
    kw = dict(max_batch_size=batch, max_seq_len=max_seq, kv_page_size=PAGE,
              prefill_chunk_size=32, prefill_buckets=(32, 64))
    kw.update(rt)
    common = dict(eos_token_id=eos, kv_layout=layout, kv_cache_dtype=kv_dtype)
    jeng = JEngine(JT.quantize_params(jparams, jq), jcfg,
                   runtime=JRuntime(**kw), act_dtype=jnp.float32, **common)
    teng = InferenceEngine(T.quantize_params(tparams, tq), cfg,
                           runtime=RuntimeConfig(**kw),
                           act_dtype=torch.float32, device="cpu", **common)
    return jeng, teng


LONG = _prompt(48, 11)                 # two chunks of 32
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], _prompt(45, 6)]


@pytest.mark.parametrize("recipe,layout", CASES)
def test_tiny_greedy_streams_match_jax(tiny, recipe, layout):
    """A two-chunk prompt alone, then three prompts decoded together (one
    in two chunks): the JAX engine's tokens, through the weight variants
    the recipe makes."""
    jeng, teng = _engines(tiny, recipe, layout)
    variants = {dm.variant(q) for q in _qleaves(teng.params)}
    want_variants = {"w4a8_g32_k8v4": {"w4a8g"}, "w8a8_int8kv": {"w8a8"},
                     "w4_g32_bf16kv": {"w4g"}, "mixed": {"w8g", "w4g"}}
    assert variants == want_variants[recipe]
    gj, gt = _gen(24)
    got, want = [], []
    for eng, g, out in ((jeng, gj, want), (teng, gt, got)):
        out.append(eng.generate(LONG, g).token_ids)
        out.extend(r.token_ids for r in eng.generate_batch(PROMPTS, g))
    assert got == want


def _qleaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _qleaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _qleaves(v)
    elif isinstance(tree, QuantizedTensor):
        yield tree


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


LM124_W4A8 = dict(mode="int4", group_size=128, act_bits=8)


def test_lm124_w4a8_g128_logits_and_tokens_match_jax(lm124):
    """The trained checkpoint quantized W4A8 g128 (its 260-wide head too):
    12 greedy tokens equal to the JAX engine's, and teacher-forced prefill
    logits against JAX's. Position 0 attends only to itself, so every
    matmul input there is the same in both packages: within 1e-5 of
    max|ref| (f32 summation order). Later positions go through the two
    packages' attention, which differ in the last f32 bits; int8
    activations turn such a difference into a whole quantization step
    now and then, and a trained model carries it on (see
    test_lm124_w4a8_logits_carry_last_bit_differences): rel L2 per
    position <= 5e-2, chip_smoke.py's path limit, where a wrong kernel is
    off by O(1)."""
    jcfg, jparams, cfg, tparams = lm124
    jq, tq = _qcfgs(LM124_W4A8)
    jp, tp = JT.quantize_params(jparams, jq), T.quantize_params(tparams, tq)
    assert {dm.variant(q) for q in _qleaves(tp)} == {"w4a8g"}
    ids = np.array([_text_ids("the cat sat on the mat. the dog")], np.int32)
    lens = np.array([ids.shape[1]], np.int32)
    ref = np.asarray(JT.forward_prefill(jp, jcfg, jnp.asarray(ids),
                                        jnp.asarray(lens),
                                        dtype=jnp.float32)[0])[0]
    got = T.forward_prefill(tp, cfg, torch.from_numpy(ids.astype(np.int64)),
                            torch.from_numpy(lens),
                            dtype=torch.float32)[0][0].numpy()
    scale = np.abs(ref).max()
    assert np.abs(got[0] - ref[0]).max() <= 1e-5 * scale
    rel = np.linalg.norm(got - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert rel.max() <= 5e-2
    kw = dict(max_batch_size=2, max_seq_len=128, prefill_buckets=(32, 64))
    jeng = JEngine(jp, jcfg, runtime=JRuntime(**kw), act_dtype=jnp.float32)
    teng = InferenceEngine(tp, cfg, runtime=RuntimeConfig(**kw),
                           act_dtype=torch.float32, device="cpu")
    gj, gt = _gen(12)
    prompt = _text_ids("once upon a time, ")
    assert teng.generate(prompt, gt).token_ids == \
        jeng.generate(prompt, gj).token_ids


def test_lm124_w4a8_logits_carry_last_bit_differences(lm124):
    """Why the W4A8 logits are held to 5e-2 and not to f32 rounding: in
    the port alone, a relative 1e-7 perturbation of the embeddings (the
    size of a last-bit difference) moves the W4A8 g128 prefill logits by
    more than 1e-3 rel L2 at some position, and the weight-only int4 g128
    logits by less than 1e-5."""
    _, _, cfg, tparams = lm124
    ids = torch.tensor([_text_ids("the cat sat on the mat. the dog")])
    lens = torch.tensor([ids.shape[1]], dtype=torch.int32)
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal(
        tuple(tparams["embedding"].shape)).astype(np.float32))
    moved = {}
    for act_bits in (0, 8):
        _, tq = _qcfgs(dict(LM124_W4A8, act_bits=act_bits))
        tp = T.quantize_params(tparams, tq)
        tp2 = dict(tp, embedding=tp["embedding"] * (1 + 1e-7 * noise))
        a, b = (T.forward_prefill(p, cfg, ids, lens, dtype=torch.float32)[0][0]
                for p in (tp, tp2))
        moved[act_bits] = ((a - b).norm(dim=-1) / a.norm(dim=-1)).max().item()
    assert moved[8] > 1e-3 and moved[0] < 1e-5, moved


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_llama2_7b_path_runs_on_cpu():
    """chip_smoke.py's path[llama2-7b] phase at a tiny size on the CPU:
    init_quantized_params with its recipe (W4A8 g128) and random scales,
    k8v4 KV, the teacher-forced logits finite and the W4A8 g128 variant the
    only weight variant on the path."""
    cs = _chip_smoke()
    cfg = tiny_llama_config(hidden_size=256, intermediate_size=384,
                            vocab_size=260, max_seq_len=2048)
    gen = torch.Generator().manual_seed(0)
    params = cs.random_scales(torch, cs.llama2_params(
        torch, T, cfg, gen, "cpu", dtype=torch.float32), gen)
    leaves = list(_qleaves(params))
    assert {dm.variant(q) for q in leaves} == {"w4a8g"}
    for q in leaves:        # every scale drawn apart, all positive
        assert q.scales.min() > 0 and q.scales.unique().numel() > 1
    out = cs.forced_logits(torch, T, kvcache, params, cfg, list(range(5, 45)),
                           [7, 8, 9], "cpu", kv_cache_dtype="k8v4")
    assert len(out) == 4 and all(torch.isfinite(o).all() for o in out)
