"""Scan over layers (RuntimeConfig.scan_layers) in the port against the JAX
package: the plain version of kernel #8 (`scatter_rows_stacked`) against
the Pallas kernel in interpret mode; the stacked cache's operations
against deeppowers_tpu/runtime/kvcache_stacked.py; the engines' scan
decision, both raises included; greedy streams of the port's scan engine
against the JAX engine's (tests/test_scan_layers.py's cases); and that a
stacked layer's attention reads the stacked cache in place.

Inputs are made with numpy from seeds at tiny widths. Cache bytes, scales
and greedy tokens must be equal. The CUDA kernel runs only on a card (the
`cuda` marker below; chip_smoke.py holds it against this plain version at
full width).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.config import GenerationConfig as JGen
from deeppowers_tpu.config import QuantConfig as JQuant
from deeppowers_tpu.config import QuantMode as JMode
from deeppowers_tpu.config import RuntimeConfig as JRuntime
from deeppowers_tpu.models import presets as jpresets
from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.ops.pallas.kv_append import (
    scatter_rows_stacked as j_scatter_stacked)
from deeppowers_tpu.runtime import kvcache as jkv
from deeppowers_tpu.runtime import kvcache_stacked as jst
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine

from deeppowers_tpu_torch.config import GenerationConfig, QuantConfig
from deeppowers_tpu_torch.config import QuantMode, RuntimeConfig
from deeppowers_tpu_torch.models import presets
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.ops.kernels import kv_append as ka
from deeppowers_tpu_torch.runtime import kvcache
from deeppowers_tpu_torch.runtime import kvcache_stacked as st
from deeppowers_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(1)

STORES = ["bf16", "int8", "int4", "k8v4"]
BITS = {"bf16": (16, 16), "int8": (8, 8), "int4": (4, 4), "k8v4": (8, 4)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bf16(a) -> np.ndarray:
    """f32 values that bf16 holds exactly."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _jax_quant(x, bits):
    """JAX's quantizer of one side: int8, or int4 with two sub-block
    scales a head."""
    return jkv._quant_kv4(x, nh=2) if bits == 4 else jkv._quant_kv(x)


def _jax_stacked(store, n_layers, b, s, kh, d):
    return jst.init_cache(n_layers, b, s, kh, d, dtype=jnp.float32,
                          kv_cache_dtype=store)


def _port_stacked(store, n_layers, b, s, kh, d):
    return st.init_cache(n_layers, b, s, kh, d, dtype=torch.float32,
                         kv_cache_dtype=store)


def _assert_same(tc, jc):
    """Every store and scale of a port stacked cache equals the JAX one's,
    bit for bit."""
    for name in ("k", "v", "k_scale", "v_scale"):
        j, t = getattr(jc, name), getattr(tc, name)
        assert (j is None) == (t is None), name
        if j is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                          err_msg=name)


# ---------------------------------------------------------------------------
# kernel #8: scatter_rows_stacked
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("store", STORES)
def test_scatter_rows_stacked_plain_matches_pallas(store, t):
    """B*T rows into layer 2 of (4, 3, 32, F') stacked caches, one slot's
    position past the cache and one negative (both dropped): the plain
    version (which quantizes its bf16 rows itself) against the Pallas
    kernel in interpret mode fed JAX's quantized rows, bit for bit."""
    n_layers, b, s, kh, d = 4, 3, 32, 2, 16
    rng = np.random.default_rng(t * 10 + STORES.index(store))
    k_new = _bf16(rng.standard_normal((b, t, kh, d)))
    v_new = _bf16(rng.standard_normal((b, t, kh, d)))
    pos = (np.arange(b)[:, None] * 9 + np.arange(t)[None, :] + 1).astype(
        np.int32)
    pos[1, -1] = s + 3
    pos[2, 0] = -1
    jc = _jax_stacked(store, n_layers, b, s, kh, d)
    tc = _port_stacked(store, n_layers, b, s, kh, d)
    layer = 2
    kb, vb = BITS[store]
    if store == "bf16":
        rows = [jnp.asarray(x.reshape(b, t, kh * d)) for x in (k_new, v_new)]
        out = j_scatter_stacked([jc.k, jc.v], rows, jnp.int32(layer),
                                jnp.asarray(pos))
    else:
        (qk, sk), (qv, sv) = (_jax_quant(jnp.asarray(x), bits)
                              for x, bits in ((k_new, kb), (v_new, vb)))
        out = j_scatter_stacked([jc.k, jc.v], [qk, qv], jnp.int32(layer),
                                jnp.asarray(pos),
                                scales=[jc.k_scale, jc.v_scale],
                                scale_rows=[sk, sv])
    jc = jst.StackedKVCache(*(list(out) + [None, None])[:4], bits=jc.bits,
                            head_width=jc.head_width, v_bits=jc.v_bits)
    slots = torch.arange(b, dtype=torch.int32).repeat_interleave(t)
    ka.scatter_rows_stacked(tc.k, tc.v, _t(k_new.reshape(b * t, -1)),
                            _t(v_new.reshape(b * t, -1)),
                            tc.layer_ids[layer:layer + 1],
                            _t(pos.reshape(-1)), slots=slots,
                            **st.stack_args(tc))
    _assert_same(tc, jc)


def test_scatter_rows_stacked_plain_drops_a_layer_out_of_range():
    tc = _port_stacked("int8", 2, 2, 16, 2, 16)
    rows = torch.ones(2, 32)
    ka.scatter_rows_stacked(tc.k, tc.v, rows, rows,
                            torch.tensor([2], dtype=torch.int32),
                            torch.tensor([0, 1]), **st.stack_args(tc))
    assert not tc.k.any() and not tc.k_scale.any()


# ---------------------------------------------------------------------------
# the stacked cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("store", STORES)
def test_stacked_cache_ops_bit_exact_with_jax(store):
    """Prompts (one slot out of range, dropped), a chunk past the cache
    end, a decode append, a verify window's append, a prefix copy, the
    reads and nbytes: the port's stacked cache against JAX's
    kvcache_stacked on the CPU (its jnp scatters), bit for bit."""
    n_layers, b, s, kh, d = 3, 3, 32, 2, 16
    rng = np.random.default_rng(STORES.index(store))
    jc = _jax_stacked(store, n_layers, b, s, kh, d)
    tc = _port_stacked(store, n_layers, b, s, kh, d)

    def both(jfn, tfn, *arrays, **kw):
        nonlocal jc
        xs = [_bf16(a) for a in arrays]
        jc = jfn(jc, *[jnp.asarray(x) for x in xs], **kw)
        tfn(tc, *[_t(x) for x in xs], **kw)
        _assert_same(tc, jc)

    p = rng.standard_normal((2, 2, 12, kh, d))
    jc = jst.write_prompts_layer(jc, 1, jnp.asarray(_bf16(p[0])),
                                 jnp.asarray(_bf16(p[1])),
                                 jnp.asarray([2, b], jnp.int32))
    st.write_prompts_layer(tc, 1, _t(_bf16(p[0])), _t(_bf16(p[1])),
                           torch.tensor([2, b]))
    _assert_same(tc, jc)
    c = rng.standard_normal((2, 8, kh, d))
    both(lambda cc, k, v: jst.write_chunk_layer(cc, 0, k, v, 1, 28),
         lambda cc, k, v: st.write_chunk_layer(cc, 0, k, v, 1, 28),
         c[0], c[1])
    a = rng.standard_normal((2, b, kh, d))
    pos = np.array([12, 30, 5], np.int32)
    jc = jst.append_token_layer(jc, 2, jnp.asarray(_bf16(a[0])),
                                jnp.asarray(_bf16(a[1])), jnp.asarray(pos))
    st.append_token_layer(tc, 2, _t(_bf16(a[0])), _t(_bf16(a[1])), _t(pos))
    _assert_same(tc, jc)
    w = rng.standard_normal((2, b, 5, kh, d))
    wpos = (np.array([13, 29, 6])[:, None] + np.arange(5)).astype(np.int32)
    jc = jst.append_tokens_layer(jc, 2, jnp.asarray(_bf16(w[0])),
                                 jnp.asarray(_bf16(w[1])), jnp.asarray(wpos))
    st.append_tokens_layer(tc, 2, _t(_bf16(w[0])), _t(_bf16(w[1])),
                           _t(wpos))
    _assert_same(tc, jc)
    jc = jst.copy_prefix(jc, 2, 0, 9)
    st.copy_prefix(tc, 2, 0, 9)
    _assert_same(tc, jc)
    for i in range(n_layers):
        for jr, tr in ((jst.read_layer(jc, i, jnp.float32, 24),
                        st.read_layer(tc, i, torch.float32, 24)),
                       (jst.read_slot_layer(jc, i, 2, jnp.float32, 20),
                        st.read_slot_layer(tc, i, 2, torch.float32, 20)),
                       (jst.read_raw_layer(jc, i, 16),
                        st.read_raw_layer(tc, i, 16))):
            for j, t_ in zip(jr, tr):
                if j is None:
                    assert t_ is None
                else:
                    np.testing.assert_array_equal(t_.numpy(), np.asarray(j))
    assert st.nbytes(tc) == jst.nbytes(jc)


def test_stacked_layer_attention_reads_the_stacked_cache_in_place(
        monkeypatch):
    """A scan decode step hands every layer's attention views of the
    stacked stores and scales (the same storage, layer i's offset), never a
    copy: what JAX's `layer=` operand of kernel #3 buys on the TPU.
    chip_smoke.py's scan_path phase checks the card's profile for copies."""
    cfg = presets.tiny_llama_config(num_layers=3, max_seq_len=256)
    params = T.stack_layer_params(T.fuse_params(T.init_params(
        cfg, torch.Generator().manual_seed(0), dtype=torch.float32), cfg))
    b = 4
    cache = st.init_cache(cfg.num_layers, b, 256, cfg.kv_heads,
                          cfg.dim_head, dtype=torch.float32,
                          kv_cache_dtype="int8")
    seen = []
    real = kvcache.decode_attention

    def spy(q, k, v, lengths, **kw):
        for got, stack in ((k, cache.k), (v, cache.v),
                           (kw["k_scale"], cache.k_scale),
                           (kw["v_scale"], cache.v_scale)):
            assert got.untyped_storage().data_ptr() == \
                stack.untyped_storage().data_ptr()
        seen.append((k.data_ptr() - cache.k.data_ptr()) // k[0].numel())
        return real(q, k, v, lengths, **kw)

    monkeypatch.setattr(kvcache, "decode_attention", spy)
    toks = torch.tensor([3, 5, 7, 9], dtype=torch.int32)
    lens = torch.tensor([10, 40, 100, 200], dtype=torch.int32)
    T.forward_decode_scan(params, cfg, toks, cache, lens, dtype=torch.float32)
    assert seen == [0, b, 2 * b]               # layer i's slots, in place
    assert (cache.k_scale[:, 2, :, 100] > 0).all()   # every layer appended


@pytest.mark.parametrize("store", ["bf16", "int8"])
def test_forward_prefill_scan_matches_jax(store):
    """One padded prompt through `forward_prefill_scan` into slot 1 of a
    stacked cache (JAX :1516): the last logits within 1e-4 of their max
    of JAX's (f32 model), and the cache rows the prompt wrote, read back
    dequantized, within one quantization step of JAX's (1e-5 for bf16)."""
    jcfg, jparams, tcfg, tparams = _pair("tiny_llama_config", 3, 7)
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 128, 16).astype(np.int32)
    n = 11
    jc = jst.init_cache(3, 2, 64, jcfg.kv_heads, jcfg.dim_head,
                        dtype=jnp.float32, kv_cache_dtype=store)
    tc = st.init_cache(3, 2, 64, tcfg.kv_heads, tcfg.dim_head,
                       dtype=torch.float32, kv_cache_dtype=store)
    jc, jl = JT.forward_prefill_scan(JT.stack_layer_params(jparams), jcfg,
                                     jnp.asarray(ids), jnp.int32(n),
                                     jnp.int32(1), jc, dtype=jnp.float32)
    tc, tl = T.forward_prefill_scan(T.stack_layer_params(tparams), tcfg,
                                    _t(ids.astype(np.int64)), n, 1, tc,
                                    dtype=torch.float32)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4 * np.abs(jl).max(),
                               rtol=0)
    for i in range(3):
        for j, t_ in zip(jst.read_slot_layer(jc, i, 1, jnp.float32, n),
                         st.read_slot_layer(tc, i, 1, torch.float32, n)):
            j = np.asarray(j)
            step = np.abs(j).max() / 127 if store == "int8" else 1e-5
            np.testing.assert_allclose(t_.numpy(), j, atol=step * 1.01,
                                       rtol=0)


# ---------------------------------------------------------------------------
# the engines' scan decision
# ---------------------------------------------------------------------------

def _pair(make, n_layers, key, max_seq=64, quant=None):
    jcfg = getattr(jpresets, make)(num_layers=n_layers, max_seq_len=max_seq)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(key),
                             dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    tcfg = getattr(presets, make)(num_layers=n_layers, max_seq_len=max_seq)
    if quant is not None:
        mode, gs, skip = quant
        jparams = JT.quantize_params(jparams, JQuant(
            mode=getattr(JMode, mode.name), group_size=gs, skip_layers=skip))
        tparams = T.quantize_params(tparams, QuantConfig(
            mode=mode, group_size=gs, skip_layers=skip))
    return jcfg, jparams, tcfg, tparams


def _engines(pair, scan, *, layout="contiguous", batch=4, **rt):
    jcfg, jparams, tcfg, tparams = pair
    kw = dict(max_batch_size=batch, max_seq_len=tcfg.max_seq_len,
              prefill_buckets=(16, 32), scan_layers=scan, kv_page_size=32,
              prefill_chunk_size=32)
    kv = rt.pop("kv_cache_dtype", "bf16")
    kw.update(rt)
    jeng = JEngine(jparams, jcfg, runtime=JRuntime(**kw), eos_token_id=0,
                   act_dtype=jnp.float32, kv_layout=layout,
                   kv_cache_dtype=kv)
    teng = InferenceEngine(tparams, tcfg, runtime=RuntimeConfig(**kw),
                           eos_token_id=0, act_dtype=torch.float32,
                           device="cpu", kv_layout=layout, kv_cache_dtype=kv)
    return jeng, teng


@pytest.mark.parametrize("layout, n_layers, quant, want", [
    ("contiguous", 16, None, True),
    ("contiguous", 15, None, False),
    ("paged", 16, None, False),
    ("contiguous", 16, (QuantMode.INT8, 0, ("layers/1",)), False),
    ("contiguous", 16, (QuantMode.INT8, 0, ()), True),
])
def test_auto_scan_decision_matches_jax(layout, n_layers, quant, want):
    """scan_layers="auto": 16 or more homogeneous layers on the contiguous
    layout stack, in both packages; fewer layers, the paged layout and a
    model of mixed per-depth precision stay unrolled."""
    pair = _pair("tiny_llama_config", n_layers, 1, max_seq=128, quant=quant)
    jeng, teng = _engines(pair, "auto", layout=layout)
    assert teng.scan_layers == jeng.scan_layers == want
    assert isinstance(teng.caches, st.StackedKVCache) == want


def test_scan_true_raises_like_jax():
    """scan_layers=True raises ValueError on the paged layout and for a
    model of mixed per-depth precision, in both packages
    (tests/test_scan_layers.py:92, :101); stack_layer_params itself
    raises for the latter."""
    pair = _pair("tiny_llama_config", 3, 5, max_seq=128)
    rt = dict(max_batch_size=2, max_seq_len=128, kv_page_size=32,
              prefill_chunk_size=32, scan_layers=True)
    with pytest.raises(ValueError):
        JEngine(pair[1], pair[0], runtime=JRuntime(**rt),
                act_dtype=jnp.float32, kv_layout="paged")
    with pytest.raises(ValueError):
        InferenceEngine(pair[3], pair[2], runtime=RuntimeConfig(**rt),
                        device="cpu", act_dtype=torch.float32,
                        kv_layout="paged")
    mixed = _pair("tiny_llama_config", 3, 5,
                  quant=(QuantMode.INT8, 0, ("layers/1",)))
    with pytest.raises(ValueError):
        JT.stack_layer_params(mixed[1])
    with pytest.raises(ValueError):
        T.stack_layer_params(mixed[3])
    with pytest.raises(ValueError):
        JEngine(mixed[1], mixed[0], runtime=JRuntime(scan_layers=True),
                act_dtype=jnp.float32)
    with pytest.raises(ValueError):
        InferenceEngine(mixed[3], mixed[2],
                        runtime=RuntimeConfig(scan_layers=True),
                        device="cpu", act_dtype=torch.float32)


# ---------------------------------------------------------------------------
# greedy streams against the JAX engine
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 7, 3, 5, 9, 7, 3, 5, 9], [11, 3, 2], [42] * 7]
GEN_J = JGen(max_tokens=16, do_sample=False)
GEN_T = GenerationConfig(max_tokens=16, do_sample=False)


def _streams(jeng, teng, prompts=PROMPTS):
    want = [r.token_ids for r in jeng.generate_batch(prompts, GEN_J)]
    got = [r.token_ids for r in teng.generate_batch(prompts, GEN_T)]
    return got, want


@pytest.mark.parametrize("make", ["tiny_test_config", "tiny_llama_config",
                                  "tiny_moe_config"])
@pytest.mark.parametrize("scan", [True, "auto"])
def test_scan_streams_match_jax(make, scan):
    """tests/test_scan_layers.py::test_scan_matches_unrolled across the
    packages: 3 layers at scan_layers=True, 16 at "auto" (both stack)."""
    pair = _pair(make, 3 if scan is True else 16, 0)
    jeng, teng = _engines(pair, scan)
    assert jeng.scan_layers and teng.scan_layers
    got, want = _streams(jeng, teng)
    assert got == want


@pytest.mark.parametrize("mode, gs", [(QuantMode.INT8, 0),
                                      (QuantMode.INT4, 32)])
def test_scan_quantized_params_match_jax(mode, gs):
    pair = _pair("tiny_llama_config", 3, 1, quant=(mode, gs, ()))
    got, want = _streams(*_engines(pair, True))
    assert got == want


@pytest.mark.parametrize("store", ["int8", "k8v4"])
def test_scan_quantized_kv_matches_jax(store):
    pair = _pair("tiny_llama_config", 3, 2)
    got, want = _streams(*_engines(pair, True, kv_cache_dtype=store))
    assert got == want


def test_scan_chunked_prefill_and_prefix_copy_match_jax():
    """A 100-token prompt in chunks of 32, then one sharing its first 70
    tokens (a prefix copy of the stacked rows, then chunks from there),
    one after the other: the same tokens and prefix counts as the JAX
    scan engine's."""
    pair = _pair("tiny_llama_config", 3, 3, max_seq=256)
    jeng, teng = _engines(pair, True, enable_prefix_cache=True)
    long = [int(x) for x in np.random.RandomState(0).randint(1, 127, 100)]
    second = long[:70] + [5, 6, 7]
    for eng, gen in ((jeng, GEN_J), (teng, GEN_T)):
        eng.out = [eng.generate(p, gen).token_ids for p in (long, second)]
    assert teng.out == jeng.out
    assert teng.prefix_cache_stats == jeng.prefix_cache_stats
    assert teng.prefix_cache_stats["hits"] >= 1


def test_scan_speculative_matches_jax():
    """Prompt-lookup speculation (K = 4) on the stacked cache
    (tests/test_scan_layers.py::test_scan_speculative)."""
    pair = _pair("tiny_llama_config", 3, 4, max_seq=128)
    jeng, teng = _engines(pair, True, speculative_tokens=4,
                          speculative_ngram=2)
    got, want = _streams(jeng, teng)
    assert got == want
    assert teng.spec_steps > 0


def _chip_smoke():
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("moe", [False, True])
def test_chip_smoke_scan_teacher_forced_runs_on_cpu(moe):
    """chip_smoke.py's scan_path[llama2-7b] and scan_path[mixtral-8x7b] at a
    tiny size on the CPU: their W4A8 g128 params stacked (the cat experts
    too), a prompt of 300 tokens (the grouped MoE branch) and forced decode
    steps through `teacher_forced(scan=True)`, whose logits equal those of
    the stacked params' own scan forwards and agree with the unrolled path
    (rel L2 <= 5e-2, the path phases' limit), with one route per layer and
    token as on the unrolled path."""
    from deeppowers_tpu_torch.runtime import kvcache
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(0)
    if moe:
        cfg = presets.tiny_moe_config(hidden_size=256, intermediate_size=512,
                                      num_experts=8, vocab_size=260,
                                      max_seq_len=2048)
        params = cs.mixtral_params(torch, T, cfg, gen, "cpu",
                                   dtype=torch.float32, scales=True)
    else:
        cfg = presets.tiny_llama_config(num_layers=3, vocab_size=260,
                                        max_seq_len=2048)
        params = cs.random_scales(torch, cs.llama2_params(
            torch, T, cfg, gen, "cpu", dtype=torch.float32), gen)
    ids, forced = list(range(5, 305)), [7, 8, 9]
    out = {}
    for scan in (False, True):
        with cs.recorded_routes(T) as routes:
            out[scan] = cs.teacher_forced(torch, T, kvcache, params, cfg,
                                          ids, forced, "cpu", "int8", scan)
        assert [r.shape for r in routes] == (
            ([(300, 2)] * cfg.num_layers + [(1, 2)] * cfg.num_layers
             * len(forced)) if moe else [])
    assert len(out[True]) == 1 + len(forced)
    assert all(torch.isfinite(o).all() for o in out[True])
    again = cs.scan_forced_logits(torch, T, T.stack_layer_params(params),
                                  cfg, ids, forced, "cpu", "int8")
    for a, b in zip(out[True], again):
        assert torch.equal(a, b)
    for a, b in zip(out[True], out[False]):
        assert ((a - b).norm() / b.norm()).item() <= 5e-2
    assert cs.scan_variants("int8", True) == (
        ["scatter_rows_stacked[int8]", "decode_attention[int8]",
         "decode_attention[int8+rows]"],
        ["scatter_rows", "step_writers"])


# ---------------------------------------------------------------------------
# the CUDA kernel (card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py runs this "
                    "kernel on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("store", STORES)
def test_cuda_scatter_rows_stacked_matches_plain(cuda_device, store, t):
    """#8 into layer 7 of TinyLlama's (22, 8, 1024, F') stacked caches:
    bytes and scales equal to the plain version's, dropped positions
    included, one launch counted under the store."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(t)
    n_layers, b, s, kh, d = 22, 8, 1024, 4, 64
    cache = st.init_cache(n_layers, b, s, kh, d, kv_cache_dtype=store,
                          device=dev)
    rows = [torch.randn(b * t, kh * d, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    pos = (torch.arange(b, device=dev)[:, None] * 100
           + torch.arange(t, device=dev)[None, :]).reshape(-1)
    pos[3], pos[-1] = s + 2, -1
    slots = torch.arange(b, device=dev, dtype=torch.int32).repeat_interleave(t)
    ref = st.init_cache(n_layers, b, s, kh, d, kv_cache_dtype=store)
    before = ka.scatter_rows_stacked.variant_launches[store]
    ka.scatter_rows_stacked(cache.k, cache.v, *rows, cache.layer_ids[7:8],
                            pos, slots=slots, **st.stack_args(cache))
    ka.scatter_rows_stacked(ref.k, ref.v, *(r.cpu() for r in rows),
                            ref.layer_ids[7:8], pos.cpu(), slots=slots.cpu(),
                            **st.stack_args(ref))
    torch.cuda.synchronize()
    for name in ("k", "v", "k_scale", "v_scale"):
        a, r = getattr(cache, name), getattr(ref, name)
        if r is not None:
            assert torch.equal(a.cpu(), r), name
    assert ka.scatter_rows_stacked.variant_launches[store] == before + 1
