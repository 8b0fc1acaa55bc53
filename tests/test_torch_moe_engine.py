"""Greedy token streams of the port's engine on MoE models against the JAX
engine on the CPU (f32 activations), and chip_smoke.py's Mixtral path
rehearsed at a tiny size.

tiny_moe_config with max_seq_len 512: a 300-token prompt prefills in two
chunks of 256 tokens, so its forwards take the grouped branch (#10 and
#9 on cat experts, the routed rows of stacked ones), as do three prompts
of bucket 64 prefilled as one batch of 4 rows; short prompts prefill in
bucket 32 and every decode step takes the dense-combine branch (#1 on cat
experts).
Both engines fuse the quantized experts into the cat layout. Then
moelm_ckpt (8 experts top-2, trained), loaded through the JAX package's
own loader, at W4A8 g128.
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
from deeppowers_tpu.models.presets import tiny_moe_config as jax_tiny_moe
from deeppowers_tpu.runtime.checkpoint import load_checkpoint
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine

from deeppowers_tpu_torch.config import (GenerationConfig, QuantConfig,
                                         QuantMode, RuntimeConfig)
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_moe_config
from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
from deeppowers_tpu_torch.runtime import kvcache
from deeppowers_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (QuantConfig fields or None for float experts, kv_cache_dtype)
RECIPES = {
    "bf16_experts": (None, "bf16"),
    "w4a8_g32_int8kv": (dict(mode="int4", group_size=32, act_bits=8), "int8"),
    "w4_g32": (dict(mode="int4", group_size=32), "bf16"),
    "w8_g32": (dict(mode="int8", group_size=32), "bf16"),
}


def _qcfgs(fields):
    fields = dict(fields)
    mode = fields.pop("mode")
    return (JQuant(mode=JMode(mode), **fields),
            QuantConfig(mode=QuantMode(mode), **fields))


def _prompt(n, seed, vocab=128):
    return [int(t) for t in np.random.default_rng(seed).integers(1, vocab, n)]


def _gen(n):
    return (JGen(max_tokens=n, temperature=0.0, do_sample=False),
            GenerationConfig(max_tokens=n, temperature=0.0, do_sample=False))


def _tree(t):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, t),
                             device="cpu")


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_tiny_moe(max_seq_len=512)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(5), dtype=jnp.float32)
    return jcfg, jparams, tiny_moe_config(max_seq_len=512), _tree(jparams)


def _engines(model, recipe, layout):
    jcfg, jparams, cfg, tparams = model
    fields, kv_dtype = RECIPES[recipe]
    jp, tp = jparams, tparams
    if fields is not None:
        jq, tq = _qcfgs(fields)
        jp, tp = JT.quantize_params(jp, jq), T.quantize_params(tp, tq)
    kw = dict(max_batch_size=3, max_seq_len=512, kv_page_size=32,
              prefill_chunk_size=256, prefill_buckets=(32, 64, 256, 512))
    common = dict(eos_token_id=None, kv_layout=layout,
                  kv_cache_dtype=kv_dtype)
    jeng = JEngine(jp, jcfg, runtime=JRuntime(**kw), act_dtype=jnp.float32,
                   **common)
    teng = InferenceEngine(tp, cfg, runtime=RuntimeConfig(**kw),
                           act_dtype=torch.float32, device="cpu", **common)
    return jeng, teng


LONG = _prompt(300, 11)                # two chunks of 256
PROMPTS = [[1, 2, 3, 4, 5], [9, 8, 7], _prompt(20, 6)]


def _qleaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _qleaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _qleaves(v)
    elif isinstance(tree, QuantizedTensor):
        yield tree


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_tiny_moe_greedy_streams_match_jax(tiny, recipe, layout):
    """A 300-token prompt alone (two chunks of 256 tokens: the grouped
    branch), then three short prompts (bucket 32: dense-combine) decoded
    together: the JAX engine's tokens, the quantized experts in the cat
    layout in both engines."""
    jeng, teng = _engines(tiny, recipe, layout)
    moe = teng.params["layers"][0]["moe"]
    assert ("experts_cat" in moe) == (RECIPES[recipe][0] is not None)
    gj, gt = _gen(10)
    got, want = [], []
    for eng, g, out in ((jeng, gj, want), (teng, gt, got)):
        out.append(eng.generate(LONG, g).token_ids)
        out.extend(r.token_ids for r in eng.generate_batch(PROMPTS, g))
    assert got == want


def test_batched_prefill_pads_like_jax(tiny, monkeypatch):
    """Three prompts of one bucket admitted together prefill as one
    forward of 4 rows (the JAX engine's power of two), so b·s = 4 x 64 =
    256 takes the grouped branch in both packages, and their tokens are
    the JAX engine's."""
    jeng, teng = _engines(tiny, "w4a8_g32_int8kv", "contiguous")
    seen = []
    fwd = T.forward_prefill
    monkeypatch.setattr(
        "deeppowers_tpu_torch.runtime.engine.forward_prefill",
        lambda params, cfg, ids, *a, **kw: (seen.append(tuple(ids.shape)),
                                            fwd(params, cfg, ids, *a,
                                                **kw))[1])
    prompts = [_prompt(40 + i, 30 + i) for i in range(3)]
    gj, gt = _gen(4)
    got, want = [], []
    for eng, g, out in ((jeng, gj, want), (teng, gt, got)):
        with eng.deferred_admission():
            for i, p in enumerate(prompts):
                eng.begin_request(p, g, request_id=f"r{i}")
        done = {}
        while len(done) < len(prompts):
            eng.step()
            done.update((r.request_id, r.token_ids)
                        for r in eng.pop_finished())
        out.extend(done[f"r{i}"] for i in range(len(prompts)))
    assert seen == [(4, 64)]
    assert got == want


@pytest.fixture(scope="module")
def moelm():
    jparams, jcfg, _ = load_checkpoint(os.path.join(REPO, "moelm_ckpt"))
    cfg = T.TransformerConfig(**{f: getattr(jcfg, f) for f in
                                 jcfg.__dataclass_fields__})
    jq, tq = _qcfgs(dict(mode="int4", group_size=128, act_bits=8))
    jp = JT.quantize_params(jparams, jq)
    tp = T.quantize_params(_tree(jparams), tq)
    kw = dict(max_batch_size=2, max_seq_len=512,
              prefill_buckets=(32, 64, 128, 256, 512))
    engines = (JEngine(jp, jcfg, runtime=JRuntime(**kw),
                       act_dtype=jnp.float32),
               InferenceEngine(tp, cfg, runtime=RuntimeConfig(**kw),
                               act_dtype=torch.float32, device="cpu"))
    return jcfg, jp, cfg, tp, engines


def _text_ids(text: str):
    return [c + 4 for c in text.encode()]


STORY = ("once upon a time there was a little fox who lived in the woods. "
         "every morning the fox ran down to the river to drink, and every "
         "evening it came back to its den under the old oak tree. one day "
         "the fox met a rabbit by the water, and the two of them sat on the "
         "bank and watched the fish jump in the sun until it was late.")


def _forced(jcfg, jp, cfg, tp, ids, monkeypatch):
    """Teacher-forced prefill logits (S, V) of both packages and each
    one's router logits per MoE layer [(S, E)], recorded at `_dense`."""
    lens = np.array([ids.shape[1]], np.int32)
    jr, tr = [], []
    jdense, tdense = JT._dense, T._dense

    def tap(dense, out, wanted):
        def f(x, p, out_dtype=None):
            y = dense(x, p, out_dtype)
            if out_dtype == wanted and y.shape[-1] == cfg.num_experts:
                out.append(np.array(y))
            return y
        return f

    monkeypatch.setattr(JT, "_dense", tap(jdense, jr, jnp.float32))
    monkeypatch.setattr(T, "_dense", tap(tdense, tr, torch.float32))
    ref = np.asarray(JT.forward_prefill(jp, jcfg, jnp.asarray(ids),
                                        jnp.asarray(lens),
                                        dtype=jnp.float32)[0])[0]
    got = T.forward_prefill(tp, cfg, torch.from_numpy(ids.astype(np.int64)),
                            torch.from_numpy(lens),
                            dtype=torch.float32)[0][0].numpy()
    monkeypatch.undo()
    return ref, got, np.stack(jr), np.stack(tr)


@pytest.mark.parametrize("text", ["the cat sat on the mat. the dog", STORY])
def test_moelm_w4a8_g128_logits_and_tokens_match_jax(moelm, text,
                                                     monkeypatch):
    """The trained MoE checkpoint quantized W4A8 g128 (experts, router and
    head), teacher-forced prefill logits against JAX's, for a short prompt
    (dense-combine branch, #1) and a 318-byte one (b·s >= 256: the grouped
    branch, #10 and #9, whose a8 function is the Pallas body's); then 8
    greedy tokens from each engine. Position 0 attends only to itself, so
    every input of its products is the same in both packages: within 1e-5
    of max|ref|. Later positions go through the two packages' attention,
    which differ in the last f32 bits; int8 activations turn such a
    difference into a whole quantization step now and then, and the
    router logits part by up to a few 1e-2 in the last layers, so where a
    token's k-th and (k+1)-th router logits nearly tie, it can pick the
    other expert (a flipped route). Limits: at most 1% of the (token,
    layer) routes flipped (chip_smoke.py's path[mixtral-8x7b] limit), each
    of them a near-tie (JAX's k-th to (k+1)-th gap no larger than the
    router logits' largest difference at that token); rel L2 <= 5e-2 at
    every position whose routes all agree (lm124_ckpt's W4A8 limit,
    tests/test_torch_wquant_engine.py), where a wrong kernel is off by
    O(1); and equal greedy tokens up to a near-tie of the vocabulary
    (where they part, JAX's margin for its token over the port's no
    larger than the logits' difference there)."""
    jcfg, jp, cfg, tp, (jeng, teng) = moelm
    k = cfg.num_experts_per_tok
    ids = np.array([_text_ids(text)], np.int32)
    assert (ids.shape[1] >= 256) == (text is STORY)
    jf = JT.fuse_params(jp, jcfg, fuse_moe=True)
    tf = T.fuse_params(tp, cfg)
    assert {dm.variant(q) for q in _qleaves(tf)} == {"w4a8g"}
    ref, got, jr, tr = _forced(jcfg, jf, cfg, tf, ids, monkeypatch)
    assert jr.shape == tr.shape == (cfg.num_layers, ids.shape[1],
                                    cfg.num_experts)
    jsel = np.sort(np.asarray(jax.lax.top_k(jnp.asarray(jr), k)[1]), -1)
    tsel = np.sort(np.argsort(-tr, -1, kind="stable")[..., :k], -1)
    flipped = (jsel != tsel).any(-1)                        # (L, S)
    assert flipped.mean() <= 1e-2
    ranked = -np.sort(-jr, -1)
    gap = ranked[..., k - 1] - ranked[..., k]
    assert (gap <= np.abs(jr - tr).max(-1))[flipped].all()
    scale = np.abs(ref).max()
    assert np.abs(got[0] - ref[0]).max() <= 1e-5 * scale
    rel = np.linalg.norm(got - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    assert rel[~flipped.any(0)].max() <= 5e-2
    gj, gt = _gen(8)
    prompt = _text_ids(text)
    want = jeng.generate(prompt, gj).token_ids
    tokens = teng.generate(prompt, gt).token_ids
    if tokens != want:
        # the first token that differs: JAX's margin for its own choice
        # over the port's, teacher-forced on the common prefix, is no
        # larger than the two packages' logits differ there (a near-tie)
        i = next(j for j, (a, b) in enumerate(zip(tokens, want)) if a != b)
        ctx = np.array([prompt + want[:i]], np.int32)
        r, g, _, _ = _forced(jcfg, jf, cfg, tf, ctx, monkeypatch)
        assert r[-1, want[i]] - r[-1, tokens[i]] <= np.abs(
            g[-1] - r[-1]).max()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_mixtral_path_runs_on_cpu():
    """chip_smoke.py's path[mixtral-8x7b] at a tiny size on the CPU: its
    params (W4A8 g128 drawn quantized, random scales, cat-fused), int8 KV,
    a 300-token prompt and forced decode steps through `forced_logits`
    (its cache grown past 128 rows), with the routes recorded: finite
    logits, both MoE branches taken, every route of the expected count,
    and the W4A8 g128 variant the only weight variant."""
    cs = _chip_smoke()
    cfg = tiny_moe_config(hidden_size=256, intermediate_size=512,
                          num_experts=8, vocab_size=260, max_seq_len=2048)
    gen = torch.Generator().manual_seed(0)
    params = cs.mixtral_params(torch, T, cfg, gen, "cpu",
                               dtype=torch.float32, scales=True)
    assert {dm.variant(q) for q in _qleaves(params)} == {"w4a8g"}
    assert all("experts_cat" in layer["moe"] for layer in params["layers"])
    ids, forced = list(range(5, 305)), [7, 8, 9]
    with cs.recorded_routes(T) as routes:
        out = cs.forced_logits(torch, T, kvcache, params, cfg, ids, forced,
                               "cpu", kv_cache_dtype="int8")
    assert len(out) == 4 and all(torch.isfinite(o).all() for o in out)
    assert [r.shape for r in routes] == (
        [(300, 2)] * 2 + [(1, 2)] * 2 * len(forced))
    assert cs.flipped_routes(routes, routes) == (0, 300 * 2 + 3 * 2)
