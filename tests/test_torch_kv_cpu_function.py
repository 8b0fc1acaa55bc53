"""The CPU function of decode and verify attention over int4 and k8v4 KV in
bf16, against the JAX package's off-TPU function.

Off the TPU the JAX package dequantizes an int4 or k8v4 cache into the
activation dtype (`kvcache.read(cache, dtype)`, runtime/kvcache.py:200-244,
565-580) and attends with `attention_decode` / `attention_verify`, which
round q * scale to that dtype (ops/attention.py:146, 255). Under
`cpu_attention_function("xla")`, the default, the port's CPU tensors take
the same function (`decode_attention_plain(xla=True)`): bf16 decode rows
bit for bit, contiguous and paged, at TinyLlama's head width (64) and the
7B's (128); verify rows too, in XLA's dot order with its exp and
softmax sum (ops/xla_cpu.py).
`cpu_attention_function("kernel")` keeps the f32 function the kernels are
held to. Then bf16 decode of tiny-llama through int4 and k8v4
caches, teacher-forced on the JAX engine's forward, under the tie window
of tests/test_torch_weight_only_bf16.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.models.presets import tiny_llama_config as jax_tiny_llama
from deeppowers_tpu.ops import attention as jatt
from deeppowers_tpu.runtime import kvcache as jkv
from deeppowers_tpu.runtime import kvcache_paged as jkvp

from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_llama_config
from deeppowers_tpu_torch.ops.kernels import decode_attention as da
from deeppowers_tpu_torch.runtime import kvcache as tkv

torch.set_num_threads(1)

BITS = {"int4": (4, 4), "k8v4": (8, 4)}
LENS = [1, 100, 130, 256]
PAGE = 64
D_VERIFY = 64
#: as tests/test_torch_weight_only_bf16.py holds bf16 decode to JAX's
LOGIT_TOL = 1e-2
TIE_GAP = 9e-3


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bf16(a) -> torch.Tensor:
    return _t(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(
        torch.bfloat16)


def _jax_cache(rng, store, b, s, kh, d):
    """A contiguous JAX cache of `store`, written through JAX's quantizers
    with model-like rows (unit normal, magnitudes within 4x a row)."""
    k, v = ((rng.standard_normal((b, s, kh, d)) * rng.uniform(
        0.5, 2, (b, s, kh, 1))).astype(np.float32) for _ in range(2))
    c = jkv.init_cache(1, b, s, kh, d, dtype=jnp.bfloat16,
                       kv_cache_dtype=store)[0]
    return jkv.write_prompts(c, jnp.asarray(k, jnp.bfloat16),
                             jnp.asarray(v, jnp.bfloat16), jnp.arange(b))


def _paged(c, rng, b, s):
    """The contiguous cache's rows and scales over shuffled pages of a JAX
    pool: (JAX paged cache, the same as the port's tensors)."""
    wp = s // PAGE
    p = b * wp + 1
    ids = rng.permutation(np.arange(1, p)).reshape(b, wp).astype(np.int32)
    kq, vq = np.asarray(c.k), np.asarray(c.v)
    ks, vs = np.asarray(c.k_scale), np.asarray(c.v_scale)
    pools = [np.zeros((p, PAGE, a.shape[2]), a.dtype) for a in (kq, vq)]
    spools = [np.zeros((p, a.shape[1], PAGE), np.float32) for a in (ks, vs)]
    for i in range(b):
        for j in range(wp):
            sl = slice(j * PAGE, (j + 1) * PAGE)
            pools[0][ids[i, j]], pools[1][ids[i, j]] = kq[i, sl], vq[i, sl]
            spools[0][ids[i, j]], spools[1][ids[i, j]] = ks[i, :, sl], \
                vs[i, :, sl]
    jc = jkvp.PagedLayerKVCache(
        k_pool=jnp.asarray(pools[0]), v_pool=jnp.asarray(pools[1]),
        k_scale=jnp.asarray(spools[0]), v_scale=jnp.asarray(spools[1]),
        table=jnp.asarray(ids), head_width=c.head_width, bits=c.bits,
        v_bits=c.v_bits)
    return jc, [_t(a) for a in pools + spools + [ids]]


def _store_kw(store):
    kb, vb = BITS[store]
    return dict(kv_bits=kb, v_bits=vb)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("store", sorted(BITS))
def test_bf16_decode_rows_match_jax_cpu(store, layout, d):
    """bf16 decode rows of an int4 / k8v4 store on the CPU, bit for bit
    with JAX's off-TPU function (the dequantized read in bf16, then
    `attention_decode`)."""
    rng = np.random.default_rng(d + len(store) + len(layout))
    b, h, kh, s = 4, 8, 2, 256
    jc = _jax_cache(rng, store, b, s, kh, d)
    q = jnp.asarray(rng.standard_normal((b, h, d)), jnp.bfloat16)
    lens = np.array(LENS, np.int32)
    if layout == "paged":
        jc, (kp, vp, ksp, vsp, tab) = _paged(jc, rng, b, s)
        got = da.decode_attention_paged(
            _bf16(q), kp, vp, tab, torch.tensor(lens), k_scale=ksp,
            v_scale=vsp, **_store_kw(store))
    else:
        got = da.decode_attention(
            _bf16(q), _t(jc.k), _t(jc.v), torch.tensor(lens),
            k_scale=_t(jc.k_scale), v_scale=_t(jc.v_scale),
            **_store_kw(store))
    kc, vc = jkv.read(jc, jnp.bfloat16)
    ref = jatt.attention_decode(q, kc, vc, jnp.asarray(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def _bf16_steps(got, ref) -> np.ndarray:
    """How many bf16 values apart got and ref are (both bf16 values held in
    f32, of one sign or zero)."""
    bits = [torch.from_numpy(np.array(a)).to(torch.bfloat16)
            .view(torch.int16).long().numpy() for a in (got, ref)]
    return np.abs(bits[0] - bits[1])


#: the share of a window's elements that may be JAX's bf16 neighbour:
#: none, since the port's verify rows follow XLA's dot order, exp, row-sum
#: order and division (ops/xla_cpu.py); the parent's torch.softmax and
#: folded dots left up to 6 of 20480
VERIFY_ORDER_SHARE = 0


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("store", sorted(BITS))
def test_bf16_verify_rows_match_jax_cpu(store, layout, d):
    """bf16 verify rows (a window of 5 a slot) of an int4 / k8v4 store on
    the CPU, contiguous and paged, against JAX's off-TPU `attention_verify`
    over the dequantized read: every element JAX's (at most
    VERIFY_ORDER_SHARE, now 0, its bf16 neighbour). The f32 function the
    kernels are held to parts from JAX's in about half of the elements."""
    rng = np.random.default_rng(len(store) * 7 + len(layout) + d)
    b, t, h, kh, s = 4, 5, 8, 2, 256
    q = jnp.asarray(rng.standard_normal((b, t, h, d)), jnp.bfloat16)
    before = np.array([0, 60, 125, 251], np.int32)    # tokens before it
    jc = _jax_cache(rng, store, b, s, kh, d)
    kw = dict(k_scale=_t(jc.k_scale), v_scale=_t(jc.v_scale),
              **_store_kw(store))
    args = (_t(jc.k), _t(jc.v), torch.tensor(before + t))
    f32 = da.unfold_tokens(da.decode_attention_plain(
        da.fold_tokens(_bf16(q)), *args, tokens=t, **kw), t)
    kc, vc = jkv.read(jc, jnp.bfloat16)
    if layout == "paged":
        jp, (kp, vp, ksp, vsp, tab) = _paged(jc, rng, b, s)
        got = da.verify_attention_paged(
            _bf16(q), kp, vp, tab, torch.tensor(before), k_scale=ksp,
            v_scale=vsp, **_store_kw(store))
        kc, vc = jkv.read(jp, jnp.bfloat16)
    else:
        got = da.verify_attention(_bf16(q), *args[:2], torch.tensor(before),
                                  **kw)
    got = got.float().numpy()
    ref = np.asarray(jatt.attention_verify(q, kc, vc, jnp.asarray(before))
                     .astype(jnp.float32))
    assert _bf16_steps(got, ref).max() <= 1
    assert (got != ref).mean() <= VERIFY_ORDER_SHARE
    assert (f32.float().numpy() != ref).mean() > 0.3


@pytest.mark.parametrize("store", sorted(BITS))
def test_kernel_function_keeps_f32(store, monkeypatch):
    """Under `cpu_attention_function("kernel")` a CPU tensor takes the f32
    function the kernels are held to (`decode_attention_plain` without
    `xla`, with DPT_ATTN_INT8=0; the int8-dot plain version otherwise),
    which parts from the bf16 one at the 7B's head width."""
    monkeypatch.setenv("DPT_ATTN_INT8", "0")
    rng = np.random.default_rng(3)
    b, h, kh, d, s = 4, 8, 2, 128, 256
    jc = _jax_cache(rng, store, b, s, kh, d)
    q = _bf16(jnp.asarray(rng.standard_normal((b, h, d)), jnp.bfloat16))
    args = (q, _t(jc.k), _t(jc.v), torch.tensor(LENS))
    kw = dict(k_scale=_t(jc.k_scale), v_scale=_t(jc.v_scale),
              **_store_kw(store))
    f32 = da.decode_attention_plain(*args, **kw)
    xla = da.decode_attention_plain(*args, xla=True, **kw)
    old = da.cpu_attention_function("kernel")
    try:
        assert torch.equal(da.decode_attention(*args, **kw), f32)
    finally:
        da.cpu_attention_function(old)
    assert torch.equal(da.decode_attention(*args, **kw), xla)
    assert not torch.equal(f32, xla)


PROMPT_LENS, PAD, STEPS = (5, 12, 20, 3), 32, 24


@pytest.mark.parametrize("store", sorted(BITS))
def test_bf16_tiny_llama_decode_matches_jax(store):
    """tiny-llama with bf16 weights and activations, 4 prompts prefilled
    into an int4 / k8v4 cache, then 24 decode steps teacher-forced on the
    JAX forward's greedy tokens through both packages' caches: each step's
    logits within LOGIT_TOL of JAX's, the port's greedy token JAX's but
    where JAX's top two lie within TIE_GAP (the standing near-tie
    Decision)."""
    jcfg = jax_tiny_llama()
    cfg = tiny_llama_config()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(4), dtype=jnp.bfloat16)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    assert tp["embedding"].dtype == torch.bfloat16
    rng = np.random.default_rng(1)
    prompts = [[int(x) for x in rng.integers(0, 128, n)]
               for n in PROMPT_LENS]
    b = len(prompts)
    ids = np.array([p + [0] * (PAD - len(p)) for p in prompts])
    lens = np.array(PROMPT_LENS, np.int32)
    jl, jkvs = JT.forward_prefill(jp, jcfg, jnp.asarray(ids),
                                  jnp.asarray(lens), dtype=jnp.bfloat16)
    with torch.no_grad():
        _, tkvs = T.forward_prefill(tp, cfg, torch.from_numpy(ids),
                                    torch.from_numpy(lens),
                                    dtype=torch.bfloat16)
    jc = jkv.init_cache(jcfg.num_layers, b, 64, jcfg.kv_heads,
                        jcfg.dim_head, dtype=jnp.bfloat16,
                        kv_cache_dtype=store)
    tc = tkv.init_cache(cfg.num_layers, b, 64, cfg.kv_heads, cfg.dim_head,
                        kv_cache_dtype=store)
    jc = tuple(jkv.write_prompts(c, k, v, jnp.arange(b))
               for c, (k, v) in zip(jc, jkvs))
    for c, (k, v) in zip(tc, tkvs):
        tkv.write_prompts(c, k, v, torch.arange(b))
    step = jax.jit(lambda t, c, n: JT.forward_decode(jp, jcfg, t, c, n,
                                                     dtype=jnp.bfloat16))
    tok = np.asarray(jl, np.float32)[np.arange(b), lens - 1].argmax(
        -1).astype(np.int32)
    ties = 0
    for _ in range(STEPS):
        ja, jc = step(jnp.asarray(tok), jc, jnp.asarray(lens))
        with torch.no_grad():
            ta, _ = T.forward_decode(tp, cfg, torch.from_numpy(tok), tc,
                                     torch.from_numpy(lens),
                                     dtype=torch.bfloat16)
        ja, ta = np.asarray(ja, np.float32), ta.float().numpy()
        assert np.abs(ta - ja).max() <= LOGIT_TOL
        top2 = np.sort(ja, -1)[:, -2:]
        tie = top2[:, 1] - top2[:, 0] < TIE_GAP
        assert ((ta.argmax(-1) == ja.argmax(-1)) | tie).all()
        ties += int(tie.sum())
        tok = ja.argmax(-1).astype(np.int32)
        lens = lens + 1
    assert ties < b * STEPS
