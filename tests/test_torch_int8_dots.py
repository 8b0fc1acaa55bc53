"""The int8-dot path of kernel #3 (the TPU kernel's default for a K stored
as int8 bytes) and the one-row weight-only product, on the CPU, against
the JAX package.

#3's int8-dot plain version (`decode_attention_int8_dots_plain`) is held
against Pallas `decode_attention_mxu` with int8_dots=True in interpret
mode for int8, int4 and k8v4 stores, decode and a verify window of 5,
per-layer and stacked (`layer=`) caches, with and without the step's new
rows, at lengths 0, inside a block, at a block's end and across a block
boundary (an explicit block_s of 128 over S = 256). Rows past each length
hold stale bytes and their scales NaN for the port (zeros for Pallas,
which multiplies a zero probability into a stale V scale). The limit is
LIMIT of a row's max|ref|: measured at most 1.7e-4 (one element one bf16
step apart, int4 at tokens 5); every other output bit-equal. Two wrong
versions must fail it: p requantized per 128 positions where the JAX
block is 256, and the 8 * rowsum rebias of the nibbles left out. The
switch DPT_ATTN_INT8 resolves as the JAX package resolves it, and the
CPU's function stays the JAX package's CPU function unless
`cpu_attention_function("kernel")` asks for the card's.

The one-row weight-only product (ops/matmul.py `_xla_matmul`) is held
against the jitted JAX ops at one row for bf16 outputs: at least
EQUAL_SHARE of the outputs bit-equal (the shares are printed), where the
multi-row function leaves far fewer.

Inputs are made with numpy from seeds at tiny widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.ops import matmul as jmm
from deeppowers_tpu.ops.pallas.decode_attention import decode_attention_mxu
from deeppowers_tpu.quant import quantize as jax_quantize
from deeppowers_tpu.runtime import kvcache as jkv

from deeppowers_tpu_torch.ops import matmul as tmm
from deeppowers_tpu_torch.ops.kernels import decode_attention as da
from deeppowers_tpu_torch.quant import kvquant
from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor

torch.set_num_threads(1)

BITS = {"int8": (8, 8), "int4": (4, 4), "k8v4": (8, 4)}
#: a row's max error over its max|ref|
LIMIT = 1e-3
B, H, KH, D, S = 4, 8, 2, 64, 256
#: 0, inside the first 128-block, at its end, across into the second
LENS = [0, 77, 128, 200]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _row_ratio(got, ref) -> np.ndarray:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max(-1) / np.maximum(np.abs(ref).max(-1), 1e-30)


def _cache(rng, store, lens, lead=()):
    """Stores and head-major scales written through the JAX quantizers
    ((lead..., B, S, F') and (lead..., B, R, S)); past each length of the
    last layer the rows hold random bytes and the scales NaN. Returns
    (port's k, v, ks, vs; Pallas's ks, vs with those scales 0)."""
    kb, vb = BITS[store]
    out = []
    for bits in (kb, vb):
        x = (rng.standard_normal(lead + (B, S, KH, D))
             * rng.uniform(0.5, 2, lead + (B, S, KH, 1))).astype(np.float32)
        q, sc = (jkv._quant_kv(jnp.asarray(x)) if bits == 8
                 else jkv._quant_kv4(jnp.asarray(x), nh=2))
        q = np.array(q).reshape(lead + (B, S, -1))
        sc = np.array(jnp.swapaxes(sc, -1, -2))
        for i, n in enumerate(lens):
            q[..., i, n:, :] = rng.integers(-128, 128, q[..., i, n:, :].shape)
            sc[..., i, :, n:] = np.nan
        out.append((q, sc))
    (qk, sk), (qv, sv) = out
    clean = [np.nan_to_num(a, nan=0.0) for a in (sk, sv)]
    return qk, qv, sk, sv, clean


def _pallas(store, q, qk, qv, sk, sv, lens, tokens, block_s=128, layer=None):
    kb, vb = BITS[store]
    if layer is None:
        qk = qk.reshape(B, S, KH, -1)
        qv = qv.reshape(B, S, KH, -1)
    out = decode_attention_mxu(
        q, jnp.asarray(qk), jnp.asarray(qv), jnp.asarray(lens, jnp.int32),
        jnp.asarray(sk), jnp.asarray(sv), kv_bits=kb, v_bits=vb,
        tokens=tokens, int8_dots=True, block_s=block_s,
        layer=None if layer is None else jnp.int32(layer))
    return np.array(out.astype(jnp.float32))


def _query(rng, tokens):
    q = jnp.asarray(rng.standard_normal((B, H * tokens, D)), jnp.bfloat16)
    return q, _t(q.astype(jnp.float32)).to(torch.bfloat16)


def _lens(tokens):
    return [n if n == 0 else max(n, tokens) for n in LENS]


@pytest.mark.parametrize("stacked", [False, True], ids=["layer", "stacked"])
@pytest.mark.parametrize("tokens", [1, 5])
@pytest.mark.parametrize("store", sorted(BITS))
def test_int8_dots_plain_matches_pallas(store, tokens, stacked):
    """The plain version against Pallas interpret mode (int8_dots=True,
    block_s 128): finite, each row within LIMIT of its max|ref|; on the
    stacked cache the port reads layer 1's views of the (2, B, S, F')
    tensors where Pallas takes `layer`. Then the same rows written by the
    call itself (`new`) give the same bytes and the same output."""
    rng = np.random.default_rng(10 * tokens + 2 * stacked
                                + sorted(BITS).index(store))
    kb, vb = BITS[store]
    lens = _lens(tokens)
    lead = (2,) if stacked else ()
    qk, qv, sk, sv, clean = _cache(rng, store, lens, lead)
    q, q_t = _query(rng, tokens)
    ref = _pallas(store, q, qk, qv, *clean, lens, tokens,
                  layer=1 if stacked else None)
    pick = (lambda a: _t(a)[1]) if stacked else _t
    args = [pick(a) for a in (qk, qv)]
    kw = dict(k_scale=pick(sk), v_scale=pick(sv), kv_bits=kb, v_bits=vb,
              tokens=tokens, block_s=128)
    got = da.decode_attention_int8_dots_plain(q_t, *args, torch.tensor(lens),
                                              **kw)
    assert torch.isfinite(got).all()
    assert _row_ratio(got.float().numpy(), ref).max() <= LIMIT
    # the step's rows, written by the call before it attends
    k_new, v_new = (torch.from_numpy(rng.standard_normal(
        (B, tokens, KH * D)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(2))
    pos = torch.tensor([[n - tokens + j if n else -1 for j in range(tokens)]
                        for n in lens], dtype=torch.int32)
    new = da.NewRows(k_new, v_new, pos)
    a1 = [x.clone() for x in args] + [kw["k_scale"].clone(),
                                       kw["v_scale"].clone()]
    a2 = [x.clone() for x in a1]
    kw1 = dict(kw, k_scale=a1[2], v_scale=a1[3])
    kw2 = dict(kw, k_scale=a2[2], v_scale=a2[3])
    folded = da.decode_attention_int8_dots_plain(
        q_t, a1[0], a1[1], torch.tensor(lens), new=new, **kw1)
    da.scatter_rows_plain(a2[0], a2[1], k_new.reshape(B * tokens, -1),
                          v_new.reshape(B * tokens, -1), pos.reshape(-1),
                          slots=torch.arange(B).repeat_interleave(tokens),
                          k_scale=a2[2], v_scale=a2[3], kv_bits=kb,
                          v_bits=vb)
    assert all(torch.equal(x.view(torch.int32) if x.is_floating_point()
                           else x, y.view(torch.int32)
                           if y.is_floating_point() else y)
               for x, y in zip(a1, a2))
    after = da.decode_attention_int8_dots_plain(
        q_t, a2[0], a2[1], torch.tensor(lens), **kw2)
    assert torch.equal(folded, after)


@pytest.mark.parametrize("store", ["int4", "k8v4"])
def test_int8_dots_wrong_versions_fail_the_limit(store, monkeypatch):
    """Against Pallas at its own block (S = 256 in one block), two wrong
    versions of the plain function fail LIMIT: p requantized per 128
    positions, and the nibbles read as v + 8 with no 8 * rowsum rebias
    (int4 K and V; k8v4's V). The right one passes at the same inputs."""
    rng = np.random.default_rng(40 + len(store))
    kb, vb = BITS[store]
    lens = [256, 200, 130, 256]
    qk, qv, sk, sv, clean = _cache(rng, store, lens)
    q, q_t = _query(rng, 1)
    ref = _pallas(store, q, qk, qv, *clean, lens, 1, block_s=None)
    kw = dict(k_scale=_t(sk), v_scale=_t(sv), kv_bits=kb, v_bits=vb)

    def plain(**extra):
        return da.decode_attention_int8_dots_plain(
            q_t, _t(qk), _t(qv), torch.tensor(lens), **kw,
            **extra).float().numpy()
    assert da.int8_dots_block(S, qk.shape[-1]) == S
    assert _row_ratio(plain(), ref).max() <= LIMIT
    assert _row_ratio(plain(block_s=128), ref).max() > LIMIT
    unpack = da.unpack4
    monkeypatch.setattr(da, "unpack4",
                        lambda x: tuple(n + 8 for n in unpack(x)))
    assert _row_ratio(plain(), ref).max() > LIMIT


def test_int8_dots_block_is_jax_auto_block():
    """`int8_dots_block` is JAX `_auto_block_s` at int8 bytes: 1024 at
    TinyLlama's and Mixtral's heads over 1024 positions, 512 at the 7B's
    k8v4 (F = 4096), the whole S when it fits, an explicit block kept."""
    from deeppowers_tpu.ops.pallas.decode_attention import _auto_block_s
    for s in (100, 256, 1024, 4096):
        for f in (128, 256, 1024, 2048, 4096):
            assert da.int8_dots_block(s, f) == _auto_block_s(s, f, 1, None)
            assert da.int8_dots_block(s, f, 128) == _auto_block_s(s, f, 1,
                                                                  128)
    assert da.int8_dots_block(1024, 4 * 64) == 1024        # TinyLlama int8
    assert da.int8_dots_block(1024, 4 * 32) == 1024        # TinyLlama int4
    assert da.int8_dots_block(1024, 32 * 128) == 512       # the 7B's k8v4
    assert da.int8_dots_block(1024, 8 * 128) == 1024       # Mixtral int8


@pytest.mark.parametrize("env", [None, "1", "0", "yes"])
def test_int8_dots_switch_resolves_as_jax(env, monkeypatch):
    """DPT_ATTN_INT8: "0" off, anything else or unset on, for a K stored
    as int8 bytes, at the JAX call sites' lengths (int8 and stacked caches
    from S = 128, int4 and k8v4 at any S); JAX's own resolution of
    int8_dots=None gives the same output as the value the port resolves
    (unset and "0")."""
    if env is None:
        monkeypatch.delenv("DPT_ATTN_INT8", raising=False)
    else:
        monkeypatch.setenv("DPT_ATTN_INT8", env)
    on = env != "0"
    for name in ("int8", "int4", "k8v4"):
        assert da.int8_dots_default(name, 128) is on
        assert da.int8_dots_default(name, 128, stacked=True) is on
        assert da.int8_dots_default(name, 64) is (on and name != "int8")
        assert da.int8_dots_default(name, 64, stacked=True) is False
    assert da.int8_dots_default("bf16", 1024) is False
    if env not in (None, "0"):
        return
    # JAX resolves int8_dots=None when it traces: a trace of the other
    # setting must not answer from the cache
    decode_attention_mxu.clear_cache()
    rng = np.random.default_rng(7)
    qk, qv, sk, sv, clean = _cache(rng, "k8v4", [256, 40, 130, 9])
    q, _ = _query(rng, 1)
    args = (q, jnp.asarray(qk.reshape(B, S, KH, -1)),
            jnp.asarray(qv.reshape(B, S, KH, -1)),
            jnp.asarray([256, 40, 130, 9], jnp.int32),
            *(jnp.asarray(a) for a in clean))
    got = decode_attention_mxu(*args, v_bits=4, int8_dots=None)
    want = decode_attention_mxu(*args, v_bits=4,
                                int8_dots=da.int8_dots_default("k8v4", S))
    np.testing.assert_array_equal(np.array(got.astype(jnp.float32)),
                                  np.array(want.astype(jnp.float32)))


@pytest.mark.parametrize("env", [None, "0"])
def test_cpu_attention_function(env, monkeypatch):
    """A CPU tensor takes `decode_attention_plain` (the JAX package's CPU
    function) whatever the switch; under `cpu_attention_function("kernel")`
    it takes the int8-dot plain version where the card takes the variant
    (unset switch) and the old plain function with DPT_ATTN_INT8=0, bit
    for bit; "xla" (the former choice) comes back, any other name
    raises."""
    if env is None:
        monkeypatch.delenv("DPT_ATTN_INT8", raising=False)
    else:
        monkeypatch.setenv("DPT_ATTN_INT8", env)
    rng = np.random.default_rng(8)
    lens = [256, 40, 130, 9]
    qk, qv, sk, sv, _ = _cache(rng, "int8", lens)
    _, q_t = _query(rng, 1)
    args = (q_t, _t(qk), _t(qv), torch.tensor(lens))
    kw = dict(k_scale=_t(sk), v_scale=_t(sv))
    old = da.decode_attention_plain(*args, **kw)
    dots = da.decode_attention_int8_dots_plain(*args, **kw)
    assert not torch.equal(old, dots)
    assert torch.equal(da.decode_attention(*args, **kw), old)
    assert da.cpu_attention_function("kernel") == "xla"
    try:
        got = da.decode_attention(*args, **kw)
        forced = da.decode_attention(*args, int8_dots=False, **kw)
    finally:
        assert da.cpu_attention_function("xla") == "kernel"
    assert torch.equal(got, old if env == "0" else dots)
    assert torch.equal(forced, old)
    with pytest.raises(ValueError):
        da.cpu_attention_function("pallas")
    assert da.decode_attention.launches == 0


# ---------------------------------------------------------------------------
# the one-row weight-only product
# ---------------------------------------------------------------------------

#: (bits, group): int8 and int4 per-channel, int8 g = 32, int4 g = 32
WEIGHTS = [(8, 0), (4, 0), (8, 32), (4, 32)]
OPS = ["quantized_matmul", "rms_matmul", "glu_matmul_silu", "glu_matmul_gelu",
       "matmul_residual"]
K, N = 256, 384
EQUAL_SHARE = 0.999


def _bf16_pair(a):
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, _t(j.astype(jnp.float32)).to(torch.bfloat16)


def _one_row(op, qw, pw, rng, lead):
    """(JAX's jitted result, the port's) of one op on one row of bf16
    inputs shaped lead + (K,), the weight a jit argument."""
    xj, xt = _bf16_pair(rng.standard_normal(lead + (K,)))
    guj, gut = _bf16_pair(rng.standard_normal(lead + (2 * K,)))
    gj, gt = _bf16_pair(1.0 + 0.2 * rng.standard_normal(K))
    bj, bt = _bf16_pair(0.1 * rng.standard_normal(N))
    rj, rt = _bf16_pair(rng.standard_normal(lead + (N,)))
    if op == "quantized_matmul":
        ref = jax.jit(lambda x, w: jmm.quantized_matmul(x, w))(xj, qw)
        got = lambda: tmm.quantized_matmul(xt, pw)  # noqa: E731
    elif op == "rms_matmul":
        ref = jax.jit(lambda x, w: jmm.rms_matmul(x, gj, w, eps=1e-5,
                                                  bias=bj))(xj, qw)
        got = lambda: tmm.rms_matmul(xt, gt, pw, eps=1e-5,  # noqa: E731
                                     bias=bt)
    elif op.startswith("glu_matmul"):
        act = op.rsplit("_", 1)[1]
        ref = jax.jit(lambda x, w: jmm.glu_matmul(
            x, w, act=act, residual=rj, bias=bj))(guj, qw)
        got = lambda: tmm.glu_matmul(gut, pw, act=act,  # noqa: E731
                                     residual=rt, bias=bt)
    else:
        ref = jax.jit(lambda x, w: jmm.matmul_residual(x, w, rj,
                                                       bias=bj))(xj, qw)
        got = lambda: tmm.matmul_residual(xt, pw, rt,  # noqa: E731
                                          bias=bt)
    return np.array(ref.astype(jnp.float32)), got


@pytest.mark.parametrize("lead", [(1,), (1, 1)], ids=["1xK", "1x1xK"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("bits,group", WEIGHTS)
def test_one_row_weight_only_matches_jax_cpu_path(bits, group, op, lead,
                                                  monkeypatch):
    """One row of bf16 activations against the jitted JAX op: at least
    EQUAL_SHARE of the outputs bit-equal, none more than one bf16 step
    apart. At (1, K) the multi-row function (`_one_row` patched to False)
    stays further: its share is printed beside the one-row function's, and
    for the per-channel weights, whose products XLA keeps in f32 there, it
    falls below EQUAL_SHARE. At (1, 1, K), a decode step of one slot, XLA
    keeps the multi-row function, and so does the port."""
    rng = np.random.default_rng(500 + 10 * bits + group + OPS.index(op))
    qw = jax_quantize(jnp.asarray(rng.standard_normal((K, N)) * 0.05,
                                  jnp.float32), bits=bits, group_size=group)
    pw = QuantizedTensor(_t(qw.data), _t(qw.scales), None, bits, group, 0)
    ref, got = _one_row(op, qw, pw, rng, lead)
    one = got().float().numpy()
    monkeypatch.setattr(tmm, "_one_row", lambda x: False)
    multi = got().float().numpy()
    share, before = (one == ref).mean(), (multi == ref).mean()
    print(f"{bits}/{group} {op} {lead}: one-row function {share:.4f} "
          f"bit-equal, multi-row function {before:.4f}")
    assert np.isfinite(one).all()
    assert share >= EQUAL_SHARE
    big = np.maximum(np.abs(one), np.abs(ref))
    ulp = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
    assert (np.abs(one - ref) / ulp).max() <= 1
    if group == 0 and len(lead) == 1:
        assert before < EQUAL_SHARE
    if len(lead) == 2:
        np.testing.assert_array_equal(one, multi)
