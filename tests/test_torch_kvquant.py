"""The port's quantized KV cache (int8, int4, k8v4) against the JAX package:
the quantizers, every cache function on both layouts, and the plain
versions of the quantized kernels #2, #3, #5 and #6 against the Pallas
kernels (interpret mode on the CPU) and JAX's own CPU functions.

Bytes and scales must be equal bit for bit (torch.equal / numpy equality);
attention is held per (slot, head) row against that row's max|ref|, with
the tolerance each test states. Inputs are made with numpy from seeds at
tiny widths. The CUDA kernels run only on a card (the `cuda` marker
below; chip_smoke.py holds them against these plain versions at full
width).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.ops import attention as jatt
from deeppowers_tpu.ops.pallas.decode_attention import (
    decode_attention_mxu, decode_attention_paged_mxu)
from deeppowers_tpu.ops.pallas.kv_append import scatter_pool_rows as jscatter_pool
from deeppowers_tpu.ops.pallas.kv_append import scatter_rows as jscatter_rows
from deeppowers_tpu.runtime import kvcache as jkv
from deeppowers_tpu.runtime import kvcache_paged as jkvp

from deeppowers_tpu_torch.ops.attention import (attention_decode_auto,
                                                attention_decode_quantized)
from deeppowers_tpu_torch.ops.kernels import decode_attention as da
from deeppowers_tpu_torch.ops.kernels import kv_append as ka
from deeppowers_tpu_torch.quant import kvquant
from deeppowers_tpu_torch.runtime import kvcache, kvcache_paged

torch.set_num_threads(1)

DTYPES = ["int8", "int4", "k8v4"]
BITS = {"int8": (8, 8), "int4": (4, 4), "k8v4": (8, 4)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _eq(got: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert got.dtype == torch.from_numpy(ref[:0].copy()).dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def _kv_rows(rng, *shape):
    """Rows with per-head magnitudes over three decades, an all-zero head
    and exact .5 ties against a power-of-two scale."""
    x = (rng.standard_normal(shape) * rng.uniform(
        0.01, 10, shape[:-1] + (1,))).astype(np.float32)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    d = shape[-1]
    # absmax 63.5 -> int8 scale 0.5: every value k * 0.25 sits on a tie
    flat[1] = (np.arange(d) % 254 - 127) * 0.25
    flat[1, 0] = 63.5
    return x


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["int8", "int4_nh1", "int4_nh2"])
def test_quantizers_bit_exact_with_jax(which):
    """Bytes and scales equal JAX's `_quant_kv` / `_quant_kv4`: an all-zero
    head (scale 1e-8 / qmax), exact .5 ties (half to even), values at the
    clip edges, and the round trip through the dequantizers."""
    rng = np.random.default_rng(0)
    x = _kv_rows(rng, 24, 4, 64)
    x[2, 0, :4] = [1e-30, -1e-30, 3.0, -3.0]
    if which == "int8":
        qj, sj = jkv._quant_kv(jnp.asarray(x))
        qt, st = kvquant.quant_kv(_t(x))
    else:
        nh = int(which[-1])
        qj, sj = jkv._quant_kv4(jnp.asarray(x), nh=nh)
        qt, st = kvquant.quant_kv4(_t(x), nh=nh)
    _eq(qt, qj)
    _eq(st, sj)
    lo, hi = (-128, 127) if which == "int8" else (-8, 7)
    vals = (qt.numpy().astype(np.int32) if which == "int8" else np.concatenate(
        [t.numpy() for t in kvquant.unpack4(qt)], -1))
    assert vals.min() == lo or vals.max() == hi
    # dequantize (…, S, K, w) views with (…, K*nh, S) head-major scales
    q4 = np.asarray(qj).reshape(1, 24, 4, -1)
    sc = np.swapaxes(np.asarray(sj), 0, 1)[None]
    if which == "int8":
        ref = jkv._dequant_kv(jnp.asarray(q4), jnp.asarray(sc), jnp.float32)
        got = kvquant.dequant_kv(_t(q4), _t(sc), torch.float32)
    else:
        ref = jkv._dequant_kv4(jnp.asarray(q4), jnp.asarray(sc), jnp.float32)
        got = kvquant.dequant_kv4(_t(q4), _t(sc), torch.float32)
    _eq(got, ref)


def test_int4_ties_round_half_to_even():
    """absmax 7 gives scale 1: x = 2.5 -> 2, 3.5 -> 4, -0.5 -> 0."""
    x = np.zeros((1, 1, 8), np.float32)
    x[0, 0, :4] = [2.5, 3.5, -0.5, 7.0]
    x[0, 0, 4:] = [-7.0, 1.5, -1.5, 0.5]
    qt, st = kvquant.quant_kv4(_t(x), nh=1)
    lo, hi = kvquant.unpack4(qt)
    assert st.item() == 1.0
    assert lo.tolist() == [[2, 4, 0, 7]] and hi.tolist() == [[-7, 2, -2, 0]]
    _eq(qt, jkv._quant_kv4(jnp.asarray(x), nh=1)[0])


# ---------------------------------------------------------------------------
# cache functions on both layouts
# ---------------------------------------------------------------------------

def _same_cache(tc, jc) -> None:
    if isinstance(tc, kvcache_paged.PagedLayerKVCache):
        pairs = [(tc.k_pool, jc.k_pool), (tc.v_pool, jc.v_pool)]
    else:
        pairs = [(tc.k, jc.k), (tc.v, jc.v)]
    pairs += [(tc.k_scale, jc.k_scale), (tc.v_scale, jc.v_scale)]
    for got, ref in pairs:
        _eq(got, ref)
    assert (tc.bits, tc.vbits, tc.head_width) == (jc.bits, jc.vbits,
                                                  jc.head_width)


def _same_views(tc, jc, slot, window) -> None:
    for got, ref in zip(kvcache.read(tc, torch.float32),
                        jkv.read(jc, jnp.float32)):
        _eq(got, ref)
    if isinstance(tc, kvcache_paged.PagedLayerKVCache):
        refs = jkvp.slot_view(jc, slot, jnp.float32, window)
    else:
        refs = jkv.read(jkv.slice_slot(jkv.slice_window(jc, window), slot),
                        jnp.float32)
    for got, ref in zip(kvcache.slot_view(tc, slot, window, torch.float32),
                        refs):
        _eq(got, ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_contiguous_cache_ops_bit_exact_with_jax(dtype):
    """init, write_prompts (a dropped slot), write_chunk (a tail past the
    cache), copy_prefix, append_token (a dropped position), read and
    slot_view: the same bytes, scales and dequantized views as JAX's."""
    rng = np.random.default_rng(1)
    b, s, kh, d = 3, 64, 2, 16
    (jc,) = jkv.init_cache(1, b, s, kh, d, dtype=jnp.float32,
                           kv_cache_dtype=dtype)
    (tc,) = kvcache.init_cache(1, b, s, kh, d, dtype=torch.float32,
                               kv_cache_dtype=dtype)
    _same_cache(tc, jc)
    kn, vn = _kv_rows(rng, 3, 24, kh, d), _kv_rows(rng, 3, 24, kh, d)
    slots = np.array([2, 5, 0], np.int32)                  # 5 is dropped
    jc = jkv.write_prompts(jc, jnp.asarray(kn), jnp.asarray(vn),
                           jnp.asarray(slots))
    kvcache.write_prompts(tc, _t(kn), _t(vn), _t(slots))
    _same_cache(tc, jc)
    kc, vc = _kv_rows(rng, 32, kh, d), _kv_rows(rng, 32, kh, d)
    for slot, start in ((1, 8), (1, 48)):                  # 48 + 32 > 64
        jc = jkv.write_chunk(jc, jnp.asarray(kc), jnp.asarray(vc), slot,
                             start)
        kvcache.write_chunk(tc, _t(kc), _t(vc), slot, start)
    _same_cache(tc, jc)
    jc = jkv.copy_prefix(jc, 2, 1, 20)
    kvcache.copy_prefix(tc, 2, 1, 20)
    _same_cache(tc, jc)
    ka_, va_ = _kv_rows(rng, b, kh, d), _kv_rows(rng, b, kh, d)
    pos = np.array([24, 64, 63], np.int32)                 # 64 is dropped
    jc = jkv.append_token(jc, jnp.asarray(ka_), jnp.asarray(va_),
                          jnp.asarray(pos))
    kvcache.append_token(tc, _t(ka_), _t(va_), _t(pos))
    _same_cache(tc, jc)
    _same_views(tc, jc, 1, 40)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_cache_ops_bit_exact_with_jax(dtype):
    """init, write_chunk (page-aligned, padded tail quantized as zeros),
    append_token across a page edge with an invalid position, read and
    slot_view through a shared, partly unallocated table: the same pools,
    scale pools and views as JAX's. A page shared by two slots shares its
    scales by construction."""
    rng = np.random.default_rng(2)
    b, s, kh, d, ps = 2, 64, 2, 16, 16
    table = np.zeros((b, s // ps), np.int32)
    table[0, :3] = [5, 2, 7]
    table[1, :2] = [5, 3]                                  # page 5 shared
    (jc,) = jkvp.init_paged_cache(1, b, s, kh, d, page_size=ps,
                                  total_pages=9, dtype=jnp.float32,
                                  kv_cache_dtype=dtype)
    (jc,) = jkvp.with_table((jc,), jnp.asarray(table))
    tcs = kvcache_paged.init_paged_cache(1, b, s, kh, d, page_size=ps,
                                         total_pages=9, dtype=torch.float32,
                                         kv_cache_dtype=dtype)
    kvcache_paged.with_table(tcs, table)
    (tc,) = tcs
    _same_cache(tc, jc)
    kc, vc = _kv_rows(rng, 37, kh, d), _kv_rows(rng, 37, kh, d)
    jc = jkv.write_chunk(jc, jnp.asarray(kc), jnp.asarray(vc), 0, 0)
    kvcache.write_chunk(tc, _t(kc), _t(vc), 0, 0)
    _same_cache(tc, jc)
    ka_, va_ = _kv_rows(rng, b, kh, d), _kv_rows(rng, b, kh, d)
    pos = np.array([37, 64], np.int32)                     # 64: invalid
    jc = jkvp.append_token(jc, jnp.asarray(ka_), jnp.asarray(va_),
                           jnp.asarray(pos))
    kvcache.append_token(tc, _t(ka_), _t(va_), _t(pos))
    _same_cache(tc, jc)
    _same_views(tc, jc, 0, 48)
    k1, _ = kvcache.slot_view(tc, 1, 16, torch.float32)
    k0, _ = kvcache.slot_view(tc, 0, 16, torch.float32)
    assert torch.equal(k1, k0)                    # page 5 through both tables


def test_nbytes_counts_stores_and_scales():
    """JAX `nbytes`: int8 stores plus f32 scales; the paged table, shared by
    the layers in the port, counts once."""
    c = kvcache.init_cache(2, 2, 32, 2, 16, kv_cache_dtype="k8v4")
    want = 2 * (2 * 32 * 32 + 2 * 32 * 16 + 4 * 2 * 2 * 32 + 4 * 2 * 4 * 32)
    assert kvcache.nbytes(c) == want == jkv.nbytes(jkv.init_cache(
        2, 2, 32, 2, 16, kv_cache_dtype="k8v4"))
    p = kvcache_paged.init_paged_cache(2, 2, 32, 2, 16, page_size=16,
                                       kv_cache_dtype="int8")
    assert kvcache.nbytes(p) == 2 * (2 * 5 * 16 * 32 + 2 * 4 * 5 * 2 * 16) \
        + 4 * 2 * 2


def test_unknown_kv_cache_dtype_raises():
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        kvcache.init_cache(1, 1, 8, 1, 8, kv_cache_dtype="fp8")


# ---------------------------------------------------------------------------
# kernels #2 and #6: plain quantized versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _jax_quant(x, bits):
    return (jkv._quant_kv(x) if bits == 8 else jkv._quant_kv4(x, nh=2))


@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_rows_quantized_plain_equals_pallas(dtype):
    """Unquantized rows in, quantized bytes and scale columns out: equal to
    XLA's quantization scattered by the Pallas kernel, a dropped position
    included; every other row and column untouched."""
    rng = np.random.default_rng(3)
    b, s, kh, d = 4, 64, 2, 64
    kb, vb = BITS[dtype]
    (jc,) = jkv.init_cache(1, b, s, kh, d, kv_cache_dtype=dtype)
    (tc,) = kvcache.init_cache(1, b, s, kh, d, kv_cache_dtype=dtype)
    pre_k, pre_v = _kv_rows(rng, b, s, kh, d), _kv_rows(rng, b, s, kh, d)
    jc = jkv.write_prompts(jc, jnp.asarray(pre_k), jnp.asarray(pre_v),
                           jnp.arange(b, dtype=jnp.int32))
    kvcache.write_prompts(tc, _t(pre_k), _t(pre_v), torch.arange(b))
    before = [t.clone() for t in (tc.k, tc.v, tc.k_scale, tc.v_scale)]
    kr, vr = _kv_rows(rng, b, kh, d), _kv_rows(rng, b, kh, d)
    pos = np.array([3, 63, 64, 17], np.int32)
    (qk, sk), (qv, sv) = (_jax_quant(jnp.asarray(kr), kb),
                          _jax_quant(jnp.asarray(vr), vb))
    ref = jscatter_rows([jc.k, jc.v], [qk, qv], jnp.asarray(pos),
                        scales=[jc.k_scale, jc.v_scale], scale_rows=[sk, sv])
    ka.scatter_rows(tc.k, tc.v, _t(kr).reshape(b, -1), _t(vr).reshape(b, -1),
                    _t(pos), k_scale=tc.k_scale, v_scale=tc.v_scale,
                    kv_bits=kb, v_bits=vb)
    for got, want in zip((tc.k, tc.v, tc.k_scale, tc.v_scale), ref):
        _eq(got, want)
    assert torch.equal(tc.k[2], before[0][2]) and \
        torch.equal(tc.v_scale[2], before[3][2])           # dropped slot
    assert ka.scatter_rows.launches == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_scatter_pool_rows_quantized_plain_equals_pallas(dtype):
    """The same into (P, page, F') pools and (P, R, page) scale pools at
    absolute rows: invalid rows (one aimed at a live row) leave the pools
    and the scale pools untouched."""
    rng = np.random.default_rng(4)
    p, ps, kh, d, b = 6, 16, 2, 64, 5
    kb, vb = BITS[dtype]
    fk, fv = (kh * d // 2 if kb == 4 else kh * d,
              kh * d // 2 if vb == 4 else kh * d)
    rk, rv = kh * (2 if kb == 4 else 1), kh * (2 if vb == 4 else 1)
    pools = [rng.integers(-128, 128, (p, ps, fk)).astype(np.int8),
             rng.integers(-128, 128, (p, ps, fv)).astype(np.int8),
             rng.uniform(0.01, 1, (p, rk, ps)).astype(np.float32),
             rng.uniform(0.01, 1, (p, rv, ps)).astype(np.float32)]
    kr, vr = _kv_rows(rng, b, kh, d), _kv_rows(rng, b, kh, d)
    rows = np.array([17, 0, 95, 40, 41], np.int32)
    valid = np.array([True, False, True, False, True])
    (qk, sk), (qv, sv) = (_jax_quant(jnp.asarray(kr), kb),
                          _jax_quant(jnp.asarray(vr), vb))
    ref = jscatter_pool([jnp.asarray(pools[0]), jnp.asarray(pools[1])],
                        [qk, qv], [jnp.asarray(pools[2]),
                                   jnp.asarray(pools[3])], [sk, sv],
                        jnp.asarray(rows), jnp.asarray(valid))
    got = [_t(a) for a in pools]
    ka.scatter_pool_rows(got[0], got[1], _t(kr).reshape(b, -1),
                         _t(vr).reshape(b, -1), _t(rows), _t(valid),
                         k_scale=got[2], v_scale=got[3], kv_bits=kb,
                         v_bits=vb)
    for g, want in zip(got, ref):
        _eq(g, want)
    assert np.array_equal(got[0].view(-1, fk)[40].numpy(),
                          pools[0].reshape(-1, fk)[40])
    assert got[2][2, :, 8].numpy().tolist() == pools[2][2, :, 8].tolist()


# ---------------------------------------------------------------------------
# kernels #3 and #5: plain quantized versions
# ---------------------------------------------------------------------------

def _row_ratio(got, ref) -> np.ndarray:
    """Per (slot, head) row: max|got - ref| over that row's max|ref| (an
    all-zero row, from an all-zero head, must match exactly)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max(-1) / np.maximum(np.abs(ref).max(-1), 1e-30)


def _quantized_cache(rng, dtype, b, s, kh, d, lengths, stale=None):
    """A contiguous cache of `dtype` written through the JAX quantizers,
    with stale rows past each length (their values, and with `stale` set
    their scales, replaced)."""
    kb, vb = BITS[dtype]
    # model-like K/V: unit normal, per-row magnitudes within 4x (rows over
    # three decades make the softmax one-hot and blind to the check)
    k, v = ((rng.standard_normal((b, s, kh, d)) * rng.uniform(
        0.5, 2, (b, s, kh, 1))).astype(np.float32) for _ in range(2))
    (qk, sk), (qv, sv) = (_jax_quant(jnp.asarray(k), kb),
                          _jax_quant(jnp.asarray(v), vb))
    qk, qv = np.array(qk), np.array(qv)
    sk, sv = (np.array(jnp.swapaxes(a, 1, 2)) for a in (sk, sv))
    if stale is not None:
        for i, n in enumerate(lengths):
            for a in (sk, sv):
                a[i, :, n:] = stale
    return qk, qv, sk, sv


def _jax_cpu_decode(dtype, q, qk, qv, sk, sv, lens, kh):
    """JAX's CPU decode path for a quantized cache (transformer.py:1309-1330):
    int8 through attention_decode_quantized on the raw stores, int4 and
    k8v4 through kvcache.read (dequantized) and attention_decode."""
    b, s = qk.shape[:2]
    kb, vb = BITS[dtype]
    jc = jkv.LayerKVCache(k=jnp.asarray(qk), v=jnp.asarray(qv),
                          k_scale=jnp.asarray(sk), v_scale=jnp.asarray(sv),
                          bits=kb, v_bits=0 if vb == kb else vb,
                          head_width=qk.shape[2] // kh)
    if dtype == "int8":
        kq, vq, ks, vs = jkv.read_raw(jc)
        return jatt.attention_decode_quantized(jnp.asarray(q), kq, vq, ks, vs,
                                               jnp.asarray(lens))
    kc, vc = jkv.read(jc, jnp.asarray(q).dtype)
    return jatt.attention_decode(jnp.asarray(q), kc, vc, jnp.asarray(lens))


LENS = [1, 100, 130, 256]


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_quantized_plain_matches_jax_cpu(dtype):
    """The plain #3 is JAX's CPU function for the dtype: f32 inputs, the
    same roundings (bf16 q * scale and probabilities for int8), so only
    the summation order differs: 1e-5 of each row's max|ref|."""
    rng = np.random.default_rng(5)
    b, h, kh, d, s = 4, 8, 2, 64, 256
    qk, qv, sk, sv = _quantized_cache(rng, dtype, b, s, kh, d, LENS)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    ref = _jax_cpu_decode(dtype, q, qk, qv, sk, sv, np.array(LENS), kh)
    kb, vb = BITS[dtype]
    got = attention_decode_auto(_t(q), _t(qk).reshape(b, s, kh, -1),
                                _t(qv).reshape(b, s, kh, -1),
                                torch.tensor(LENS), _t(sk), _t(sv),
                                kv_bits=kb, v_bits=vb)
    assert _row_ratio(got.numpy(), ref).max() <= 1e-5
    if dtype == "int8":
        alias = attention_decode_quantized(
            _t(q), _t(qk).reshape(b, s, kh, d), _t(qv).reshape(b, s, kh, d),
            _t(sk), _t(sv), torch.tensor(LENS))
        assert torch.equal(alias, got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_quantized_plain_matches_pallas(dtype):
    """bf16 q against Pallas decode_attention_mxu in interpret mode, rows
    past each length stale. With int8_dots=False the Pallas kernel rounds
    q * scale and the scale-folded probabilities to bf16; the plain int8
    version does the same, the plain int4 and k8v4 versions dequantize in
    f32 and keep f32 probabilities: 1e-2 of each row's max|ref|, the limit
    chip_smoke.py holds the kernel to (measured up to 7.7e-3 over three
    seeds). The default int8_dots=True requantizes q per row and the
    probabilities per row to int8 for the MXU (decode_attention.py:196-216,
    :283-301): 127 levels of a row's largest probability leave the small
    ones a few levels each, measured up to 5.2e-2 over three seeds, so
    8e-2. A wrong version, each V scale doubled for the last slot, must
    fail 1e-2."""
    rng = np.random.default_rng(6)
    b, h, kh, d, s = 4, 8, 2, 64, 256
    kb, vb = BITS[dtype]
    qk, qv, sk, sv = _quantized_cache(rng, dtype, b, s, kh, d, LENS)
    q = jnp.asarray(rng.standard_normal((b, h, d)), jnp.bfloat16)
    q_t = _t(q.astype(jnp.float32)).to(torch.bfloat16)
    args = [jnp.asarray(a) for a in (qk.reshape(b, s, kh, -1),
                                     qv.reshape(b, s, kh, -1))]
    lens = jnp.asarray(LENS, jnp.int32)
    got = da.decode_attention_plain(q_t, _t(qk), _t(qv), torch.tensor(LENS),
                                    k_scale=_t(sk), v_scale=_t(sv),
                                    kv_bits=kb, v_bits=vb).float().numpy()
    for dots, tol in ((False, 1e-2), (True, 8e-2)):
        ref = decode_attention_mxu(q, *args, lens, jnp.asarray(sk),
                                   jnp.asarray(sv), kv_bits=kb, v_bits=vb,
                                   int8_dots=dots).astype(jnp.float32)
        assert np.isfinite(got).all()
        assert _row_ratio(got, ref).max() <= tol, dots
    wrong_sv = sv.copy()
    wrong_sv[-1] *= 2.0
    wrong = da.decode_attention_plain(q_t, _t(qk), _t(qv),
                                      torch.tensor(LENS), k_scale=_t(sk),
                                      v_scale=_t(wrong_sv), kv_bits=kb,
                                      v_bits=vb).float().numpy()
    ref = decode_attention_mxu(q, *args, lens, jnp.asarray(sk),
                               jnp.asarray(sv), kv_bits=kb, v_bits=vb,
                               int8_dots=False).astype(jnp.float32)
    assert _row_ratio(wrong, ref)[-1].min() > 1e-2


def _pool_of(qk, qv, sk, sv, lengths, ps, p, rng, stale):
    """Scatter a contiguous quantized cache's slots over shuffled pages of a
    pool; rows and scale entries past each length get `stale`."""
    b, s = qk.shape[:2]
    wp = s // ps
    ids = rng.permutation(np.arange(1, p))[:b * wp].reshape(b, wp)
    pools = [np.zeros((p, ps) + a.shape[2:], a.dtype) for a in (qk, qv)]
    spools = [np.zeros((p, a.shape[1], ps), np.float32) for a in (sk, sv)]
    for i in range(b):
        for j in range(wp):
            sl = slice(j * ps, (j + 1) * ps)
            pools[0][ids[i, j]], pools[1][ids[i, j]] = qk[i, sl], qv[i, sl]
            spools[0][ids[i, j]] = sk[i, :, sl]
            spools[1][ids[i, j]] = sv[i, :, sl]
        for pos in range(lengths[i], s):
            pg, r = ids[i, pos // ps], pos % ps
            for a in spools:
                a[pg, :, r] = stale
    return pools, spools, ids.astype(np.int32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_paged_quantized_plain_matches_pallas(dtype):
    """#5's plain version over scattered pages of 128 rows, NaN in every
    stale scale entry: finite, equal to #3's plain version over the
    contiguous view with the stale scales zeroed, and within 1e-2 of each
    row's max|ref| of Pallas decode_attention_paged_mxu in interpret mode
    (bf16 dots, the stale scales zeroed for it: its quantized path
    re-masks stale rows, but a NaN scale times a zero probability is NaN).
    Two wrong versions must fail the limit: the last slot one page short,
    and its live K scales doubled."""
    rng = np.random.default_rng(7)
    b, h, kh, d, s, ps = 4, 8, 2, 64, 256, 128
    lens = [1, 100, 130, 256]
    kb, vb = BITS[dtype]
    qk, qv, sk, sv = _quantized_cache(rng, dtype, b, s, kh, d, lens, 0.0)
    pools, spools, table = _pool_of(qk, qv, sk, sv, lens, ps, 11, rng, np.nan)
    q = jnp.asarray(rng.standard_normal((b, h, d)), jnp.bfloat16)
    q_t = _t(q.astype(jnp.float32)).to(torch.bfloat16)
    kw = dict(kv_bits=kb, v_bits=vb)
    got = da.decode_attention_paged(
        q_t, _t(pools[0]), _t(pools[1]), _t(table), torch.tensor(lens),
        k_scale=_t(spools[0]), v_scale=_t(spools[1]), **kw)
    assert torch.isfinite(got).all()
    flat = da.decode_attention(q_t, _t(qk), _t(qv), torch.tensor(lens),
                               k_scale=_t(sk), v_scale=_t(sv), **kw)
    assert torch.equal(got, flat)
    clean = [np.nan_to_num(a, nan=0.0) for a in spools]
    ref = decode_attention_paged_mxu(
        q, *(jnp.asarray(a) for a in pools), jnp.asarray(table),
        jnp.asarray(lens, jnp.int32), *(jnp.asarray(a) for a in clean),
        **kw).astype(jnp.float32)
    assert _row_ratio(got.float().numpy(), ref).max() <= 1e-2
    short = np.asarray(lens)
    short[-1] -= ps
    wrong = da.decode_attention_paged_plain(
        q_t, _t(pools[0]), _t(pools[1]), _t(table), _t(short),
        k_scale=_t(spools[0]), v_scale=_t(spools[1]), **kw)
    assert _row_ratio(wrong.float().numpy(), ref)[-1].min() > 1e-2
    wrong_ks = spools[0].copy()
    wrong_ks[table[-1]] *= 2.0
    wrong = da.decode_attention_paged_plain(
        q_t, _t(pools[0]), _t(pools[1]), _t(table), torch.tensor(lens),
        k_scale=_t(wrong_ks), v_scale=_t(spools[1]), **kw)
    assert _row_ratio(wrong.float().numpy(), ref)[-1].min() > 1e-2
    assert da.decode_attention_paged.launches == 0


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
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_quantized_kernels_match_plain(cuda_device, dtype, monkeypatch):
    """#2 and #6 exact (bytes and scale bits), #3 and #5 within 1e-2 of each
    row's max|ref| with NaN in stale pool rows and stale scales. #3's
    bf16-dot kernel (DPT_ATTN_INT8=0; the int8-dot variant is
    tests/test_torch_decode_attention.py's)."""
    monkeypatch.setenv("DPT_ATTN_INT8", "0")
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(0)
    kb, vb = BITS[dtype]
    b, kh, d, s, ps, p = 8, 4, 64, 1024, 128, 65
    (tc,) = kvcache.init_cache(1, b, s, kh, d, kv_cache_dtype=dtype,
                               device=dev)
    (ref,) = kvcache.init_cache(1, b, s, kh, d, kv_cache_dtype=dtype,
                                device=dev)
    rows = [torch.randn(b, kh * d, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2)]
    pos = torch.tensor([16, 64, 100, 200, 300, 450, 600, 1024], device=dev)
    kw = dict(kv_bits=kb, v_bits=vb)
    ka.scatter_rows(tc.k, tc.v, *rows, pos, k_scale=tc.k_scale,
                    v_scale=tc.v_scale, **kw)
    ka.scatter_rows_plain(ref.k, ref.v, *rows, pos, k_scale=ref.k_scale,
                          v_scale=ref.v_scale, **kw)
    for a, c in ((tc.k, ref.k), (tc.v, ref.v), (tc.k_scale, ref.k_scale),
                 (tc.v_scale, ref.v_scale)):
        assert torch.equal(a, c)
    pc = kvcache_paged.init_paged_cache(1, b, s, kh, d, page_size=ps,
                                        total_pages=p, kv_cache_dtype=dtype,
                                        device=dev)[0]
    pr = kvcache_paged.init_paged_cache(1, b, s, kh, d, page_size=ps,
                                        total_pages=p, kv_cache_dtype=dtype,
                                        device=dev)[0]
    prow = torch.tensor([130, 901, 300, 8319, 1000, 42, 256, 717], device=dev,
                        dtype=torch.int32)
    pvalid = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], device=dev,
                          dtype=torch.bool)
    ka.scatter_pool_rows(pc.k_pool, pc.v_pool, *rows, prow, pvalid,
                         k_scale=pc.k_scale, v_scale=pc.v_scale, **kw)
    ka.scatter_pool_rows_plain(pr.k_pool, pr.v_pool, *rows, prow, pvalid,
                               k_scale=pr.k_scale, v_scale=pr.v_scale, **kw)
    for a, c in ((pc.k_pool, pr.k_pool), (pc.v_pool, pr.v_pool),
                 (pc.k_scale, pr.k_scale), (pc.v_scale, pr.v_scale)):
        assert torch.equal(a, c)
    lens = torch.tensor([48, 96, 132, 232, 332, 482, 632, 932], device=dev)
    q = torch.randn(b, 32, d, generator=g, device=dev).to(torch.bfloat16)
    for c in (tc,):
        c.k.copy_(torch.randint(-128, 128, c.k.shape, generator=g,
                                device=dev, dtype=torch.int8))
        c.v.copy_(torch.randint(-128, 128, c.v.shape, generator=g,
                                device=dev, dtype=torch.int8))
        c.k_scale.uniform_(0.001, 0.02, generator=g)
        c.v_scale.uniform_(0.001, 0.02, generator=g)
    stale = torch.arange(s, device=dev)[None, :] >= lens[:, None]
    for sc in (tc.k_scale, tc.v_scale):           # NaN past each length
        sc.masked_fill_(stale[:, None, :], float("nan"))
    out = da.decode_attention(q, tc.k, tc.v, lens, k_scale=tc.k_scale,
                              v_scale=tc.v_scale, **kw)
    want = da.decode_attention_plain(q, tc.k, tc.v, lens, k_scale=tc.k_scale,
                                     v_scale=tc.v_scale, **kw)
    err = (out.float() - want.float()).abs().amax(-1)
    assert torch.isfinite(out).all()
    assert (err / want.float().abs().amax(-1)).max() <= 1e-2
    assert torch.equal(out, da.decode_attention(
        q, tc.k, tc.v, lens, k_scale=tc.k_scale, v_scale=tc.v_scale, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_prefill_writes_match_plain(cuda_device, dtype):
    """A prefill's rows through #2 (a (2, 512) group into slots 3 and 9 of
    8, 9 dropped) and through #6 (512 rows into four pages): bytes and
    scale bits equal to the plain versions'."""
    dev = cuda_device
    g = torch.Generator(device=dev).manual_seed(1)
    kb, vb = BITS[dtype]
    b, kh, d, s, ps, p = 8, 4, 64, 1024, 128, 65
    kw = dict(kv_bits=kb, v_bits=vb)
    rows = [torch.randn(1024, kh * d, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2)]
    slots = torch.tensor([3, 9], device=dev,
                         dtype=torch.int32).repeat_interleave(512)
    pos = torch.arange(512, device=dev, dtype=torch.int32).repeat(2)
    (tc,) = kvcache.init_cache(1, b, s, kh, d, kv_cache_dtype=dtype,
                               device=dev)
    (ref,) = kvcache.init_cache(1, b, s, kh, d, kv_cache_dtype=dtype,
                                device=dev)
    ka.scatter_rows(tc.k, tc.v, *rows, pos, slots=slots, k_scale=tc.k_scale,
                    v_scale=tc.v_scale, **kw)
    ka.scatter_rows_plain(ref.k, ref.v, *rows, pos, slots=slots,
                          k_scale=ref.k_scale, v_scale=ref.v_scale, **kw)
    for a, c in ((tc.k, ref.k), (tc.v, ref.v), (tc.k_scale, ref.k_scale),
                 (tc.v_scale, ref.v_scale)):
        assert torch.equal(a, c)
    pc, pr = (kvcache_paged.init_paged_cache(
        1, b, s, kh, d, page_size=ps, total_pages=p, kv_cache_dtype=dtype,
        device=dev)[0] for _ in range(2))
    prow = (torch.tensor([9, 4, 30, 2], device=dev)[:, None] * ps
            + torch.arange(ps, device=dev)).reshape(-1).to(torch.int32)
    ok = torch.ones_like(prow, dtype=torch.bool)
    ka.scatter_pool_rows(pc.k_pool, pc.v_pool, rows[0][:512], rows[1][:512],
                         prow, ok, k_scale=pc.k_scale, v_scale=pc.v_scale,
                         **kw)
    ka.scatter_pool_rows_plain(pr.k_pool, pr.v_pool, rows[0][:512],
                               rows[1][:512], prow, ok, k_scale=pr.k_scale,
                               v_scale=pr.v_scale, **kw)
    for a, c in ((pc.k_pool, pr.k_pool), (pc.v_pool, pr.v_pool),
                 (pc.k_scale, pr.k_scale), (pc.v_scale, pr.v_scale)):
        assert torch.equal(a, c)
