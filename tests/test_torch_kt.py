"""The chunk-transposed K mirror ("kt", `DPT_KV_KT`) in the port against
the JAX package, and the per-head decode kernel #11: the plain version of
kernel #7 (`decode_attention_kt` / `verify_attention_kt`) against the
Pallas kernel in interpret mode, output and mirror bytes; the mirror's
upkeep through the cache writes; `kt_auto`; `forward_decode` /
`forward_verify` over kt caches; greedy streams with `DPT_KV_KT=1`; the
plain version of #11 against `decode_attention_kernel` in interpret mode.

Inputs are made with numpy from seeds at small sizes (B <= 2, S <= 512:
the Pallas kt kernel is slow in interpret mode). Cache bytes and greedy
tokens must be equal; float results hold the tolerance each test states.
The CUDA kernels run only on a card (the `cuda` marker below;
chip_smoke.py holds them against these plain versions at full width).
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
from deeppowers_tpu.ops.pallas import decode_attention as jda
from deeppowers_tpu.runtime import kvcache as jkv
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine

from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_llama_config
from deeppowers_tpu_torch.ops.kernels import decode_attention as da
from deeppowers_tpu_torch.runtime import kvcache
from deeppowers_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bf16(a) -> np.ndarray:
    """f32 values that bf16 holds exactly."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _mk(b, kh, d, s, v_bits, seed=0, h=None):
    """Random int8 K (row-major and its kt transpose), V (int8 or packed),
    scales and bf16-exact q, as numpy arrays."""
    rng = np.random.default_rng(seed)
    h = h or kh
    f = kh * d
    fv = f // 2 if v_bits == 4 else f
    k = rng.integers(-127, 128, (b, s, f), dtype=np.int8)
    v = rng.integers(-127, 128, (b, s, fv), dtype=np.int8)
    ks = rng.uniform(0.01, 0.03, (b, kh, s)).astype(np.float32)
    vs = rng.uniform(0.01, 0.03, (b, 2 * kh if v_bits == 4 else kh,
                                  s)).astype(np.float32)
    q = np.asarray(jnp.asarray(rng.standard_normal((b, h, d)),
                               jnp.bfloat16).astype(jnp.float32))
    kt = np.ascontiguousarray(
        k.reshape(b, s // 128, 128, f).transpose(0, 1, 3, 2))
    return q, k, kt, v, ks, vs


def _jax_kt(q, kt, k, v, lens, ks, vs, v_bits, tokens=None):
    args = (jnp.asarray(kt), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lens, jnp.int32), jnp.asarray(ks), jnp.asarray(vs))
    qj = jnp.asarray(q, jnp.bfloat16)
    if tokens is None:
        out, kt_new = jda.decode_attention_kt(qj, *args, v_bits=v_bits)
    else:
        out, kt_new = jda.verify_attention_kt(qj, *args, v_bits=v_bits)
    return np.asarray(out.astype(jnp.float32)), np.asarray(kt_new)


def _port_kt(q, kt, k, v, lens, ks, vs, v_bits, tokens=None):
    fn = da.decode_attention_kt if tokens is None else da.verify_attention_kt
    ktt = _t(kt)
    out, kt_new = fn(_t(q).to(torch.bfloat16), ktt, _t(k), _t(v),
                     _t(np.asarray(lens, np.int32)), _t(ks), _t(vs),
                     v_bits=v_bits)
    assert kt_new is ktt                         # updated in place
    return out.float().numpy(), kt_new.numpy()


def _readable(kt, lens, tokens):
    """Chunks a later step may read: c < (len - tokens) // 128 after this
    step's flush, i.e. the chunks below each slot's length."""
    return [kt[i, :max(ln // 128, 0)] for i, ln in enumerate(lens)]


# the plain version against the Pallas kernel: bf16 outputs within 1e-2
# absolute (two bf16 roundings of each probability times V scale, in other
# groupings of the online softmax where the units differ)
TOL = 1e-2


@pytest.mark.parametrize("v_bits", [8, 4])
@pytest.mark.parametrize("lengths", [[130, 500], [1, 128]])
def test_kt_plain_matches_pallas(v_bits, lengths):
    """Mirrors tests/test_kt_attention.py::test_kt_matches_folded_kernel,
    with the Pallas kt kernel itself as the reference: output and the kt
    bytes of every readable chunk."""
    q, k, kt, v, ks, vs = _mk(2, 2, 128, 512, v_bits)
    ref, kt_ref = _jax_kt(q, kt.copy(), k, v, lengths, ks, vs, v_bits)
    got, kt_got = _port_kt(q, kt.copy(), k, v, lengths, ks, vs, v_bits)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    for a, b in zip(_readable(kt_got, lengths, 1),
                    _readable(kt_ref, lengths, 1)):
        np.testing.assert_array_equal(a, b)


def test_kt_plain_gqa_rep4():
    q, k, kt, v, ks, vs = _mk(2, 2, 128, 256, 8, seed=1, h=8)
    lens = [100, 250]
    ref, _ = _jax_kt(q, kt.copy(), k, v, lens, ks, vs, 8)
    got, _ = _port_kt(q, kt.copy(), k, v, lens, ks, vs, 8)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


def test_kt_plain_zero_length_slot():
    q, k, kt, v, ks, vs = _mk(2, 2, 128, 256, 8, seed=2)
    lens = [0, 200]
    ref, _ = _jax_kt(q, kt.copy(), k, v, lens, ks, vs, 8)
    got, _ = _port_kt(q, kt.copy(), k, v, lens, ks, vs, 8)
    assert (got[0] == 0).all()
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("v_bits", [8, 4])
def test_kt_plain_verify_window(v_bits):
    """T = 5 window rows (GQA rep 2) crossing a chunk boundary: output and
    the flushed chunk 0 of slot 0."""
    q, k, kt, v, ks, vs = _mk(2, 2, 64, 256, v_bits, seed=3)
    qw = np.asarray(jnp.asarray(np.random.default_rng(9).standard_normal(
        (2, 5, 4, 64)), jnp.bfloat16).astype(jnp.float32))
    cached = [126, 200]
    stale = kt.copy()
    stale[0, 0] = 0
    ref, kt_ref = _jax_kt(qw, stale.copy(), k, v, cached, ks, vs, v_bits,
                          tokens=5)
    got, kt_got = _port_kt(qw, stale.copy(), k, v, cached, ks, vs, v_bits,
                           tokens=5)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_array_equal(kt_got[0, 0], kt[0, 0])     # flushed
    np.testing.assert_array_equal(kt_got, kt_ref)


def test_kt_plain_stale_chunk_self_heals():
    """A stale chunk is not read on the step that completes it, is
    re-flushed from k there, and is read healed on the next step
    (tests/test_kt_attention.py::test_kt_flush_self_heals_stale_chunk)."""
    q, k, kt, v, ks, vs = _mk(1, 2, 128, 256, 8, seed=4)
    stale = kt.copy()
    stale[:, 0] = 0
    ref, kt_ref = _jax_kt(q, stale.copy(), k, v, [128], ks, vs, 8)
    got, kt_got = _port_kt(q, stale.copy(), k, v, [128], ks, vs, 8)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_array_equal(kt_got[0, 0], kt[0, 0])
    np.testing.assert_array_equal(kt_got, kt_ref)
    ref2, _ = _jax_kt(q, kt_ref, k, v, [129], ks, vs, 8)
    got2, _ = _port_kt(q, kt_got, k, v, [129], ks, vs, 8)
    np.testing.assert_allclose(got2, ref2, atol=TOL, rtol=0)


def test_kt_plain_ignores_nan_past_length():
    """NaN scales and values past each slot's length do not reach the
    output: they are selected away, never multiplied by 0."""
    q, k, kt, v, ks, vs = _mk(2, 2, 64, 256, 4, seed=5)
    lens = [70, 190]
    clean, _ = _port_kt(q, kt.copy(), k, v, lens, ks, vs, 4)
    for i, ln in enumerate(lens):
        ks[i, :, ln:] = np.nan
        vs[i, :, ln:] = np.nan
    got, _ = _port_kt(q, kt.copy(), k, v, lens, ks, vs, 4)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, clean)


# ---------------------------------------------------------------------------
# kernel #11: decode_attention_kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attention_kernel_plain_matches_pallas(quantized):
    """The plain version of #11 against `decode_attention_kernel` in
    interpret mode at block_s = 32, as tests/test_decode_attention.py:53,63
    runs it: bf16 caches, or int8 with per (head, position) scales; f32 q;
    within 1e-5 of the output's max (both compute in f32)."""
    rng = np.random.default_rng(11)
    b, s, kh, rep, d = 2, 64, 2, 2, 16
    q = rng.standard_normal((b, kh * rep, d)).astype(np.float32)
    lens = np.array([64, 30], np.int32)
    if quantized:
        kc = rng.integers(-127, 128, (b, s, kh, d), dtype=np.int8)
        vc = rng.integers(-127, 128, (b, s, kh, d), dtype=np.int8)
        ks = rng.uniform(0.01, 0.03, (b, kh, s)).astype(np.float32)
        vs = rng.uniform(0.01, 0.03, (b, kh, s)).astype(np.float32)
        sc_j, sc_t = (jnp.asarray(ks), jnp.asarray(vs)), (_t(ks), _t(vs))
    else:
        kc = np.asarray(jnp.asarray(rng.standard_normal((b, s, kh, d)),
                                    jnp.bfloat16))
        vc = np.asarray(jnp.asarray(rng.standard_normal((b, s, kh, d)),
                                    jnp.bfloat16))
        sc_j = sc_t = (None, None)
    ref = np.asarray(jda.decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        *sc_j, block_s=32))
    tk = (torch.from_numpy(kc.astype(np.float32)).to(torch.bfloat16)
          if not quantized else _t(kc))
    tv = (torch.from_numpy(vc.astype(np.float32)).to(torch.bfloat16)
          if not quantized else _t(vc))
    got = da.decode_attention_kernel(_t(q), tk, tv, _t(lens), *sc_t,
                                     block_s=32).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(),
                               rtol=0)


def test_decode_attention_kernel_plain_ignores_nan_past_length():
    """NaN V rows past a slot's length stay out of #11's plain output (the
    Pallas kernel multiplies p = 0 into its last block's stale rows, so
    NaN there gives NaN: a fault of the reference the port does not
    copy)."""
    rng = np.random.default_rng(12)
    b, s, kh, d = 2, 64, 2, 16
    q = _t(rng.standard_normal((b, 4, d)).astype(np.float32))
    kc = _t(rng.standard_normal((b, s, kh, d)).astype(np.float32))
    vc = _t(rng.standard_normal((b, s, kh, d)).astype(np.float32))
    lens = _t(np.array([40, 17], np.int32))
    clean = da.decode_attention_kernel(q, kc, vc, lens)
    vc[0, 40:] = float("nan")
    vc[1, 17:] = float("nan")
    got = da.decode_attention_kernel(q, kc, vc, lens)
    assert torch.equal(got, clean)


# ---------------------------------------------------------------------------
# the mirror's upkeep, kt_auto, the forwards and the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("env", ["", "0", "1"])
def test_kt_auto_matches_jax(monkeypatch, env):
    """kt_auto over stores, kv heads and DPT_KV_KT: the port's answer is
    JAX's on a non-TPU backend (off unless DPT_KV_KT=1, and never for a
    store without int8 K or kv heads above 8 not a multiple of 8)."""
    monkeypatch.setenv("DPT_KV_KT", env)
    for store in ("bf16", "int8", "int4", "k8v4"):
        for kh, d in ((1, 64), (4, 64), (8, 128), (12, 128), (16, 128),
                      (32, 128)):
            assert kvcache.kt_auto(store, kh, d) == \
                jkv.kt_auto(store, kh, d), (store, kh, d)


def _kt_caches(store, b, s, kh, d, kv_kt=True):
    jc = jkv.init_cache(1, b, s, kh, d, kv_cache_dtype=store,
                        kv_kt=kv_kt)[0]
    tc = kvcache.init_cache(1, b, s, kh, d, kv_cache_dtype=store,
                            kv_kt=kv_kt)[0]
    return jc, tc


def _same_readable(tc, jc, lens):
    """k, v, scales bit for bit, and kt over each slot's chunks below its
    length (the rows a reader may take from the mirror)."""
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    jkt = np.asarray(jc.kt)
    for i, ln in enumerate(lens):
        np.testing.assert_array_equal(tc.kt[i, :ln // 128].numpy(),
                                      jkt[i, :ln // 128])


@pytest.mark.parametrize("store", ["int8", "k8v4"])
def test_kt_upkeep_matches_jax(store):
    """The mirror after write_prompts (a 300-row padded prompt), a
    write_chunk at an unaligned start, and a copy_prefix with a partly
    covered boundary chunk: equal to JAX's over readable chunks; kt is
    allocated only for int8-K stores with max_seq % 128 == 0; nbytes counts
    it as JAX does."""
    b, s, kh, d = 2, 512, 2, 16
    rng = np.random.default_rng(7)
    jc, tc = _kt_caches(store, b, s, kh, d)
    assert tc.kt.shape == (b, s // 128, kh * d, 128)
    p = _bf16(rng.standard_normal((2, 1, 300, kh, d)))
    jc = jkv.write_prompts(jc, jnp.asarray(p[0]), jnp.asarray(p[1]),
                           jnp.asarray([1], jnp.int32))
    kvcache.write_prompts(tc, _t(p[0]), _t(p[1]), torch.tensor([1]))
    _same_readable(tc, jc, [0, 300])
    c = _bf16(rng.standard_normal((2, 140, kh, d)))
    jc = jkv.write_chunk(jc, jnp.asarray(c[0]), jnp.asarray(c[1]), 0, 100)
    kvcache.write_chunk(tc, _t(c[0]), _t(c[1]), 0, 100)
    _same_readable(tc, jc, [240, 300])
    jc = jkv.copy_prefix(jc, 1, 0, jnp.int32(200))
    kvcache.copy_prefix(tc, 1, 0, 200)
    _same_readable(tc, jc, [200, 300])
    assert kvcache.nbytes([tc]) == jkv.nbytes([jc])
    assert kvcache.init_cache(1, b, 200, kh, d, kv_cache_dtype=store,
                              kv_kt=True)[0].kt is None
    assert kvcache.init_cache(1, b, s, kh, d, kv_cache_dtype="int4",
                              kv_kt=True)[0].kt is None


def _fwd_pair(store):
    """A 2-layer model (JAX test_kt_attention.py's `_cfg`) in both
    packages, f32, with kt caches and two prompts written: 126 and 100
    rows (JAX) and their port copies."""
    jcfg = JT.TransformerConfig(vocab_size=128, hidden_size=64, num_layers=2,
                                num_heads=4, num_kv_heads=2,
                                intermediate_size=128, max_seq_len=512)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    tcfg = T.TransformerConfig(vocab_size=128, hidden_size=64, num_layers=2,
                               num_heads=4, num_kv_heads=2,
                               intermediate_size=128, max_seq_len=512)
    b, s = 2, 256
    jcs = jkv.init_cache(2, b, s, 2, 16, kv_cache_dtype=store, kv_kt=True)
    tcs = kvcache.init_cache(2, b, s, 2, 16, kv_cache_dtype=store,
                             kv_kt=True, dtype=torch.float32)
    prompt = np.random.default_rng(1).integers(0, 128, (2, 127))
    lens = np.array([126, 100], np.int32)
    _, jkvs = JT.forward_prefill(jparams, jcfg, jnp.asarray(prompt),
                                 jnp.asarray(lens), dtype=jnp.float32)
    _, tkvs = T.forward_prefill(tparams, tcfg, _t(prompt), _t(lens),
                                dtype=torch.float32)
    jcs = list(jcs)
    for i, ((jk, jv), (tk, tv)) in enumerate(zip(jkvs, tkvs)):
        for slot in range(b):
            jcs[i] = jkv.write_prompt(jcs[i], jk[slot], jv[slot], slot)
            kvcache.write_prompt(tcs[i], tk[slot], tv[slot], slot)
    return jcfg, jparams, tuple(jcs), tcfg, tparams, tcs, lens


@pytest.mark.parametrize("store", ["int8", "k8v4"])
def test_forward_decode_and_verify_with_kt_match_jax(store):
    """Four decode steps across the 128 boundary, then a verify window of
    3 that one slot crosses 128 with, then a decode step after it (JAX
    test_kt_attention.py's forward tests), over kt caches in both
    packages: logits within 2e-3 of their max (f32 model, the kt
    function's bf16 q and probabilities in both), the same greedy tokens,
    and every readable chunk of the port's mirror equal to its k rows
    (the two models' prompt K part in the last f32 bit, which can move a
    quantized byte, so the stores are compared by test_kt_upkeep)."""
    jcfg, jparams, jcs, tcfg, tparams, tcs, lens = _fwd_pair(store)
    toks = np.array([5, 7], np.int32)
    for step in range(4):
        ln = lens + step
        jl, jcs = JT.forward_decode(jparams, jcfg, jnp.asarray(toks), jcs,
                                    jnp.asarray(ln), dtype=jnp.float32)
        tl, _ = T.forward_decode(tparams, tcfg, _t(toks), tcs, _t(ln),
                                 dtype=torch.float32)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl,
                                   atol=2e-3 * np.abs(jl).max(), rtol=0)
        assert (tl.numpy().argmax(-1) == jl.argmax(-1)).all()
        toks = jl.argmax(-1).astype(np.int32)
    ln = lens + 4
    win = np.array([[3, 9, 11], [4, 8, 12]], np.int32)
    win[:, 0] = toks
    jl, jcs = JT.forward_verify(jparams, jcfg, jnp.asarray(win), jcs,
                                jnp.asarray(ln), dtype=jnp.float32)
    tl, _ = T.forward_verify(tparams, tcfg, _t(win), tcs, _t(ln),
                             dtype=torch.float32)
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, atol=2e-3 * np.abs(jl).max(),
                               rtol=0)
    jl2, jcs = JT.forward_decode(jparams, jcfg, jnp.asarray(win[:, 1]), jcs,
                                 jnp.asarray(ln + 1), dtype=jnp.float32)
    tl2, _ = T.forward_decode(tparams, tcfg, _t(win[:, 1]), tcs, _t(ln + 1),
                              dtype=torch.float32)
    jl2 = np.asarray(jl2)
    np.testing.assert_allclose(tl2.numpy(), jl2,
                               atol=2e-3 * np.abs(jl2).max(), rtol=0)
    for tc in tcs:              # each readable chunk is its k rows' mirror
        for i, n in enumerate(ln + 1):
            for c in range(n // 128):
                assert torch.equal(tc.kt[i, c],
                                   tc.k[i, c * 128:(c + 1) * 128].t())


def _kt_engines(monkeypatch, store, **rt):
    monkeypatch.setenv("DPT_KV_KT", "1")
    jcfg = jax_tiny_llama(max_seq_len=256)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(21), dtype=jnp.float32)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    kw = dict(max_batch_size=2, max_seq_len=256, prefill_chunk_size=128,
              prefill_buckets=(64, 128, 256))
    kw.update(rt)
    common = dict(eos_token_id=0, kv_cache_dtype=store)
    jeng = JEngine(jparams, jcfg, runtime=JRuntime(**kw),
                   act_dtype=jnp.float32, **common)
    teng = InferenceEngine(tparams, tiny_llama_config(max_seq_len=256),
                           runtime=RuntimeConfig(**kw),
                           act_dtype=torch.float32, device="cpu", **common)
    assert jeng.caches[0].kt is not None and teng.caches[0].kt is not None
    assert not teng.scan_layers
    return jeng, teng


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(1, 128, n)]


@pytest.mark.parametrize("store", ["int8", "k8v4"])
def test_kt_engine_streams_match_jax(monkeypatch, store):
    """DPT_KV_KT=1 in both packages (tiny-llama, max_seq 256): two prompts
    past 128 rows decoded together, one of them in two chunks, across the
    next chunk boundary; the same greedy tokens as the JAX engine's."""
    jeng, teng = _kt_engines(monkeypatch, store)
    prompts = [_prompt(150, 1), _prompt(120, 2)]
    gj = JGen(max_tokens=20, temperature=0.0, do_sample=False)
    gt = GenerationConfig(max_tokens=20, temperature=0.0, do_sample=False)
    want = [r.token_ids for r in jeng.generate_batch(prompts, gj)]
    got = [r.token_ids for r in teng.generate_batch(prompts, gt)]
    assert got == want


def test_kt_engine_speculative_streams_match_jax(monkeypatch):
    """DPT_KV_KT=1 with prompt lookup (K = 4): windows cross a chunk
    boundary and rejected drafts leave the chunk stale until the next
    flush; the same greedy tokens as the JAX engine's."""
    jeng, teng = _kt_engines(monkeypatch, "int8", speculative_tokens=4,
                             speculative_ngram=2)
    prompt = (_prompt(20, 3) * 7)[:124]
    gj = JGen(max_tokens=24, temperature=0.0, do_sample=False)
    gt = GenerationConfig(max_tokens=24, temperature=0.0, do_sample=False)
    assert teng.generate(prompt, gt).token_ids == \
        jeng.generate(prompt, gj).token_ids
    assert teng.spec_steps > 0


# ---------------------------------------------------------------------------
# the CUDA kernels (card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py runs these "
                    "kernels on the card)")
    return torch.device("cuda")


#: the 8 slots' lengths (the window's T rows included) at T: "serve" mixes
#: short and long slots; "edges" has an empty slot at T = 1 (a window
#: alone at T = 5), lengths at and just past chunk ends, and a full cache
KT_CASES = {
    "serve": lambda t: [n + t for n in (0, 126, 127, 250, 256, 300, 511,
                                        700)],
    "edges": lambda t: [0 if t == 1 else t, 128, 129, 640, 641, 127 + t,
                        1024, 768 + t]}


def _kt_inputs(dev, g, b, s, kh, d, h, v_bits, t, lengths):
    """Random int8 K, V (int8 or packed int4), scales with NaN past each
    length, the mirror holding the committed chunks and stale bytes in
    every other chunk, and bf16 q, on the card."""
    f = kh * d
    k = torch.randint(-127, 128, (b, s, f), generator=g, device=dev,
                      dtype=torch.int8)
    v = torch.randint(-127, 128, (b, s, f // 2 if v_bits == 4 else f),
                      generator=g, device=dev, dtype=torch.int8)
    ks = torch.rand(b, kh, s, generator=g, device=dev) * 0.02 + 0.01
    vs = torch.rand(b, 2 * kh if v_bits == 4 else kh, s, generator=g,
                    device=dev) * 0.02 + 0.01
    lens = torch.tensor(lengths, device=dev)
    past = torch.arange(s, device=dev)[None, :] >= lens[:, None]
    for sc in (ks, vs):
        sc.masked_fill_(past[:, None, :], float("nan"))
    kt = torch.randint(-127, 128, (b, s // 128, f, 128), generator=g,
                       device=dev, dtype=torch.int8)
    for i, n in enumerate(lens.tolist()):
        full = max((n - t) // 128, 0)
        kt[i, :full] = k[i, :full * 128].reshape(full, 128, f).transpose(1, 2)
    q = torch.randn(b, t, h, d, generator=g, device=dev).to(torch.bfloat16)
    return q, kt, k, v, ks, vs, lens


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(KT_CASES))
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("v_bits", [8, 4])
@pytest.mark.parametrize("kh, d, h", [(32, 128, 32), (4, 64, 32)])
def test_cuda_kt_matches_plain(cuda_device, kh, d, h, v_bits, t, case):
    """#7 at Llama-2-7B's heads (D = 128, R = 1 or 5 a kv head) and
    TinyLlama's (D = 64, R = 8 or 40), 8 slots over S = 1024, committed
    chunks mirrored and stale bytes in the rest, NaN in the scales past
    each length: each row within 1e-2 of the plain version's max, finite
    (an empty slot's rows 0), and the kt bytes after the launch (the whole
    tail chunks flushed, stale ones healed) equal to the plain
    version's."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(kh + v_bits + t)
    b, s = 8, 1024
    q, kt, k, v, ks, vs, lens = _kt_inputs(dev, g, b, s, kh, d, h, v_bits, t,
                                           KT_CASES[case](t))
    kt_ref = kt.cpu()
    cpu = [x.cpu() for x in (k, v, ks, vs)]
    if t == 1:
        out, _ = da.decode_attention_kt(q[:, 0], kt, k, v, lens, ks, vs,
                                        v_bits=v_bits)
        ref, _ = da.decode_attention_kt(q[:, 0].cpu(), kt_ref, cpu[0], cpu[1],
                                        lens.cpu(), cpu[2], cpu[3],
                                        v_bits=v_bits)
    else:
        out, _ = da.verify_attention_kt(q, kt, k, v, lens - t, ks, vs,
                                        v_bits=v_bits)
        ref, _ = da.verify_attention_kt(q.cpu(), kt_ref, cpu[0], cpu[1],
                                        (lens - t).cpu(), cpu[2], cpu[3],
                                        v_bits=v_bits)
    torch.cuda.synchronize()
    got, want = out.float().cpu().numpy(), ref.float().numpy()
    assert np.isfinite(got).all()
    ratio = np.abs(got - want).max(-1) / np.maximum(np.abs(want).max(-1),
                                                    1e-30)
    assert ratio.max() <= 1e-2
    assert torch.equal(kt.cpu(), kt_ref)
    empty = (lens == 0).cpu().numpy()
    assert (got.reshape(b, -1)[empty] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("kh, d, h", [(32, 128, 32), (4, 64, 32)])
def test_cuda_kt_is_one_launch(cuda_device, kh, d, h, t):
    """One kernel a call at a k8v4 step (no combine kernel, no scratch
    memsets), the same bytes on a second call, and one count under its
    store and window."""
    dev, b, s = cuda_device, 8, 1024
    g = torch.Generator(device=dev).manual_seed(7 + t)
    q, kt, k, v, ks, vs, lens = _kt_inputs(dev, g, b, s, kh, d, h, 4, t,
                                           KT_CASES["serve"](t))
    q = q[:, 0] if t == 1 else q.transpose(1, 2).reshape(b, h * t, d)
    key = "k8v4" if t == 1 else f"k8v4:t{t}"
    before = da.decode_attention_kt.variant_launches[key]
    call = lambda: da.decode_attention_kt(  # noqa: E731
        q, kt, k, v, lens, ks, vs, tokens=t, v_bits=4)[0]
    first = call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        again = call()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memcpy" not in e.name.lower()]
    assert len([n for n in kernels if "attention_kernel" in n]) == 1, kernels
    assert not any("combine_kernel" in n or "memset" in n.lower()
                   for n in kernels), kernels
    assert torch.equal(first, again)
    assert da.decode_attention_kt.variant_launches[key] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_decode_attention_kernel_matches_plain(cuda_device, quantized):
    """#11 at TinyLlama's heads: each row within 1e-2 of the plain
    version's max, counted under its own name."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(int(quantized))
    b, s, kh, d, h = 8, 1024, 4, 64, 32
    q = torch.randn(b, h, d, generator=g, device=dev).to(torch.bfloat16)
    lens = torch.tensor([48, 96, 132, 232, 332, 482, 632, 932], device=dev)
    if quantized:
        kc, vc = (torch.randint(-127, 128, (b, s, kh, d), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        sc = tuple(torch.rand(b, kh, s, generator=g, device=dev) * 0.02
                   for _ in range(2))
    else:
        kc, vc = (torch.randn(b, s, kh, d, generator=g, device=dev).to(
            torch.bfloat16) for _ in range(2))
        sc = (None, None)
    name = "int8" if quantized else "bf16"
    before = da.decode_attention_kernel.variant_launches[name]
    out = da.decode_attention_kernel(q, kc, vc, lens, *sc)
    ref = da.decode_attention_kernel(
        q.cpu(), kc.cpu(), vc.cpu(), lens.cpu(),
        *(x.cpu() if x is not None else None for x in sc))
    torch.cuda.synchronize()
    got, want = out.float().cpu().numpy(), ref.float().numpy()
    ratio = np.abs(got - want).max(-1) / np.abs(want).max(-1)
    assert ratio.max() <= 1e-2
    assert da.decode_attention_kernel.variant_launches[name] == before + 1
    assert torch.equal(out, da.decode_attention_kernel(q, kc, vc, lens, *sc))
    zero = da.decode_attention_kernel(q, kc, vc, lens * 0, *sc)
    assert (zero == 0).all()                     # length 0: a zero row
