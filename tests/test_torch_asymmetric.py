"""Asymmetric (zero-point) weights through kernel #1, against the JAX
package on the CPU.

The JAX package computes zero points on every device through its XLA
path (`_dequant_weights`, deeppowers_tpu/ops/matmul.py:28-41; the route
:92, :106-116; never its Pallas kernel): q - z in int32, converted to the
dequantized weight's dtype (bf16 for a bf16 output, where |q - z| > 256
rounds, since z is unclipped), times the scale in that dtype, f32 sums,
one cast; a zero-point weight with act_bits 8 takes the same weight-only
function. The port's CPU tensors take that function (`_xla_matmul`); its
card kernels build bf16(q - z) and keep the scale in f32 at the group
flush, which their plain version `dequant_matmul_plain` computes.

Held here: the four ops against the jitted JAX ops for int8 and int4,
per-channel, g32 and g128, bf16 and f32, every weight with columns of
all-positive weights (z far outside the codes), to the standard of the
symmetric XLA-route tests (bf16: at least 99.9% of the outputs bit-equal,
none more than one bf16 ulp apart; f32: 1e-5 relative); the single-row
cases XLA fuses; the plain version's zero-point function; greedy streams
of asymmetric engines against JAX's (tiny-llama, and tiny-moe with an
asymmetric router); and, on the card (`cuda`), the zero-point GEMV and
tensor-core kernel against the plain version. Inputs are made with numpy
from seeds.
"""

import dataclasses
import functools
import importlib

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
from deeppowers_tpu.ops import matmul as jmm
from deeppowers_tpu.runtime import kvcache as jkvc
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine

from deeppowers_tpu_torch.config import (GenerationConfig, QuantConfig,
                                         QuantMode, RuntimeConfig)
from deeppowers_tpu_torch.models import presets
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.ops import matmul as tmm
from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
from deeppowers_tpu_torch.quant.quantize import dequantize, quantize
from deeppowers_tpu_torch.runtime import kvcache as tkvc
from deeppowers_tpu_torch.runtime.engine import InferenceEngine

jq = importlib.import_module("deeppowers_tpu.quant.quantize")

torch.set_num_threads(1)

M, K, N = 8, 256, 384
OPS = ["quantized_matmul", "rms_matmul", "glu_matmul", "matmul_residual"]
WEIGHTS = [(8, 0), (8, 32), (8, 128), (4, 0), (4, 32), (4, 128)]
#: bf16: bit-equal share at least, and the largest gap in bf16 ulps (the
#: symmetric XLA-route tests' standard); f32: relative to max |ref|
EQUAL_SHARE = 0.999
MAX_ULPS = 1
F32_REL = 1e-5


def _asym_weight(rng, k=K, n=N, bits=8, group=0):
    """JAX's asymmetric quantization of a (K, N) matrix whose first 16
    columns are all positive (z far below the codes' range) and whose
    next 16 are all negative, and the port's tree of the same arrays."""
    w = rng.standard_normal((k, n)) * 0.05
    w[:, :16] = np.abs(w[:, :16]) + 0.5
    w[:, 16:32] = -np.abs(w[:, 16:32]) - 0.3
    qw = jq.quantize(jnp.asarray(w, jnp.float32), bits=bits,
                     group_size=group, symmetric=False)
    pw = QuantizedTensor(torch.from_numpy(np.array(qw.data)),
                         torch.from_numpy(np.array(qw.scales)),
                         torch.from_numpy(np.array(qw.zero_points)), bits,
                         group, 0)
    return qw, pw


def _pair(a, dtype):
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _ulps(a, b):
    big = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.where(big > 0, big, 1.0))) - 7)
    return np.abs(a - b) / ulp


def _op_pair(op, qw, pw, rng, shape, dtype):
    """(JAX's jitted result, the port's) of one op, as f32 numpy."""
    lead = shape[:-1]
    xj, xt = _pair(rng.standard_normal(shape), dtype)
    guj, gut = _pair(rng.standard_normal(lead + (2 * K,)), dtype)
    gj, gt = _pair(1.0 + 0.2 * rng.standard_normal(K), dtype)
    bj, bt = _pair(0.1 * rng.standard_normal(N), dtype)
    rj, rt = _pair(rng.standard_normal(lead + (N,)), dtype)
    if op == "quantized_matmul":
        ref = jax.jit(lambda x, w: jmm.quantized_matmul(x, w))(xj, qw)
        got = tmm.quantized_matmul(xt, pw)
    elif op == "rms_matmul":
        ref = jax.jit(lambda x, w: jmm.rms_matmul(x, gj, w, eps=1e-5,
                                                  bias=bj))(xj, qw)
        got = tmm.rms_matmul(xt, gt, pw, eps=1e-5, bias=bt)
    elif op == "glu_matmul":
        ref = jax.jit(lambda x, w: jmm.glu_matmul(
            x, w, act="silu", residual=rj, bias=bj))(guj, qw)
        got = tmm.glu_matmul(gut, pw, act="silu", residual=rt, bias=bt)
    else:
        ref = jax.jit(lambda x, w: jmm.matmul_residual(x, w, rj,
                                                       bias=bj))(xj, qw)
        got = tmm.matmul_residual(xt, pw, rt, bias=bt)
    return np.array(ref.astype(jnp.float32)), got.float().numpy()


def _hold(ref, got, dtype):
    assert np.isfinite(got).all()
    if dtype == jnp.bfloat16:
        assert (got == ref).mean() >= EQUAL_SHARE
        assert _ulps(got, ref).max() <= MAX_ULPS
    else:
        assert np.abs(got - ref).max() <= F32_REL * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("bits,group", WEIGHTS)
def test_asymmetric_ops_match_jax(bits, group, op, dtype):
    """Each op on M rows against the jitted JAX op on the CPU."""
    rng = np.random.default_rng(500 + 10 * bits + group + OPS.index(op))
    qw, pw = _asym_weight(rng, bits=bits, group=group)
    # the all-positive columns' zero points lie far below the codes
    assert int(np.asarray(qw.zero_points).min()) < (-128 if bits == 8 else -8)
    ref, got = _op_pair(op, qw, pw, rng, (M, K), dtype)
    _hold(ref, got, dtype)


@pytest.mark.parametrize("shape", [(1, K), (1, 1, K), (2, K)],
                         ids=["row", "row3", "two"])
@pytest.mark.parametrize("bits,group", [(8, 0), (4, 0), (4, 128)])
def test_asymmetric_single_rows_match_jax(bits, group, shape):
    """One rank-2 row, which XLA's CPU compiler fuses into a vector-matrix
    dot (per-channel: bf16(q - z) * bf16(s) kept in f32), a rank-3 row
    (rounded as two rows are) and two rows, in bf16."""
    rng = np.random.default_rng(600 + bits + group + len(shape))
    qw, pw = _asym_weight(rng, bits=bits, group=group)
    for op in OPS:
        ref, got = _op_pair(op, qw, pw, rng, shape, jnp.bfloat16)
        _hold(ref, got, jnp.bfloat16)


@pytest.mark.parametrize("bits,group", [(8, 0), (4, 32)])
def test_asymmetric_a8_weight_takes_the_weight_only_function(bits, group):
    """A zero-point weight marked act_bits 8 computes as JAX's route
    computes it (:92: no a8 product for zero points) on the CPU's XLA
    function and on the plain version, and counts as a weight-only
    variant."""
    rng = np.random.default_rng(700 + bits)
    qw, pw = _asym_weight(rng, bits=bits, group=group)
    qw8 = dataclasses.replace(qw, act_bits=8)
    pw8 = dataclasses.replace(pw, act_bits=8)
    for dtype in (jnp.bfloat16, jnp.float32):
        ref, got = _op_pair("glu_matmul", qw8, pw8, rng, (M, K), dtype)
        _hold(ref, got, dtype)
    assert dm.variant(pw8) == dm.variant(pw) == (
        f"w{bits}" + ("g" if group else "") + "z")
    xt = torch.randn(M, K).to(torch.bfloat16)
    torch.testing.assert_close(
        dm.dequant_matmul(xt, pw8),
        dm.dequant_matmul_plain(xt, pw.data, pw.scales, bits=bits,
                                zero_points=pw.zero_points), rtol=0, atol=0)


@pytest.mark.parametrize("bits,group", WEIGHTS)
def test_plain_version_zero_point_function(bits, group):
    """`dequant_matmul_plain` with zero points: each weight operand
    bf16(q - z) (f32 q - z for f32 inputs) times its group's scale; the
    prologue composed with the product-only plain version gives the same
    bits; in f32 it equals the product with `dequantize` (the port's, which
    JAX's equals) within f32 sums; `cpu_weight_only_function("kernel")`
    takes it."""
    rng = np.random.default_rng(800 + bits + group)
    _, pw = _asym_weight(rng, bits=bits, group=group)
    x = torch.from_numpy(rng.standard_normal((M, 2 * K)).astype(np.float32))
    g = torch.from_numpy((1 + 0.1 * rng.standard_normal(K)).astype(
        np.float32))
    for xx in (x, x.to(torch.bfloat16)):
        for kw in ({}, {"rms_weight": g}, {"glu": True}):
            a_in = xx if kw.get("glu") else xx[:, :K]
            got = dm.dequant_matmul_plain(
                a_in, pw.data, pw.scales, bits=bits,
                zero_points=pw.zero_points, out_dtype=torch.float32, **kw)
            a, rf = dm.stage_activations_plain(a_in, K, **kw)
            two = dm.dequant_product_plain(
                a, pw.data, pw.scales, bits=bits, zero_points=pw.zero_points,
                rf=rf, out_dtype=torch.float32)
            torch.testing.assert_close(got, two, rtol=0, atol=0)
    xf = x[:, :K]
    ref = xf @ dequantize(pw)
    got = dm.dequant_matmul_plain(xf, pw.data, pw.scales, bits=bits,
                                  zero_points=pw.zero_points,
                                  out_dtype=torch.float32)
    assert (got - ref).abs().max() <= F32_REL * ref.abs().max()
    xb = xf.to(torch.bfloat16)
    old = tmm.cpu_weight_only_function("kernel")
    try:
        torch.testing.assert_close(
            tmm.quantized_matmul(xb, pw),
            dm.dequant_matmul_plain(xb, pw.data, pw.scales, bits=bits,
                                    zero_points=pw.zero_points),
            rtol=0, atol=0)
    finally:
        tmm.cpu_weight_only_function(old)


def test_codes_round_as_jax_converts_them():
    """bf16(q - z) for |q - z| past 256 rounds to even as JAX's int32 ->
    bf16 conversion does (a zero point of -1000 against every int8 code)."""
    q = torch.arange(-128, 128, dtype=torch.int8).reshape(256, 1)
    z = torch.tensor([[-1000]], dtype=torch.int32)
    got = dm._codes(q, z, 1, torch.bfloat16)
    want = np.asarray((jnp.arange(-128, 128, dtype=jnp.int32) + 1000)
                      .astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want)
    assert not np.array_equal(want, np.arange(-128, 128) + 1000.0)


def test_variant_keys_of_asymmetric_weights():
    for bits, group, name in ((8, 0, "w8z"), (8, 32, "w8gz"), (4, 0, "w4z"),
                              (4, 128, "w4gz")):
        qw = quantize(torch.randn(256, 24), bits=bits, group_size=group,
                      symmetric=False)
        assert dm.variant(qw) == name
        assert dm.launch_keys(1, qw)[1:] == (name, "gemv")


def test_stacked_layers_carry_zero_points():
    """`stack_layer_params` (the scan engine) stacks the zero points of
    asymmetric layers, and each layer's view gives them back."""
    cfg = presets.tiny_llama_config()
    params = T.quantize_params(
        T.init_params(cfg, torch.Generator().manual_seed(0),
                      dtype=torch.float32, device="cpu"),
        QuantConfig(mode=QuantMode.INT4, group_size=32, symmetric=False))
    stacked = T.stack_layer_params(T.fuse_params(params, cfg))
    layers = list(T._scan_layers(stacked))
    assert len(layers) == cfg.num_layers
    for i, layer in enumerate(layers):
        for name in ("wq", "wk", "wv", "wo"):
            got = layer["attn"][name]["w"]
            want = params["layers"][i]["attn"][name]["w"]
            assert got.zero_points is not None
            assert torch.equal(got.zero_points, want.zero_points)
            assert torch.equal(got.data, want.data)


# ---------------------------------------------------------------------------
# greedy streams
# ---------------------------------------------------------------------------

def _tree(t):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, t),
                             device="cpu")


def _qleaves(tree):
    if isinstance(tree, QuantizedTensor):
        return [tree]
    if isinstance(tree, dict):
        return [q for v in tree.values() for q in _qleaves(v)]
    if isinstance(tree, (list, tuple)):
        return [q for v in tree for q in _qleaves(v)]
    return []


def _prompt(n, seed, vocab=128):
    return [int(t) for t in np.random.default_rng(seed).integers(1, vocab, n)]


#: (JAX preset, port preset, QuantConfig fields)
ENGINES = {
    "tiny-llama-int4g32": ("tiny_llama_config", dict(mode="int4",
                                                     group_size=32)),
    "tiny-llama-int8": ("tiny_llama_config", dict(mode="int8")),
    "tiny-moe-int8": ("tiny_moe_config", dict(mode="int8")),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_asymmetric_engine_greedy_streams_match_jax(name):
    """f32 activations: a two-chunk prompt alone, then three prompts
    decoded together, through JAX's engine and the port's on the same
    asymmetric weights (each package quantizes the same float weights):
    the same tokens. tiny-moe's router is asymmetric (its experts are
    symmetric, as JAX's `quantize_stacked` makes them)."""
    preset, fields = ENGINES[name]
    fields = dict(fields)
    mode = fields.pop("mode")
    jcfg = getattr(jpresets, preset)(max_seq_len=256)
    cfg = getattr(presets, preset)(max_seq_len=256)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(31), dtype=jnp.float32)
    jp = JT.quantize_params(jparams, JQuant(mode=JMode(mode), symmetric=False,
                                            **fields))
    tp = T.quantize_params(_tree(jparams), QuantConfig(
        mode=QuantMode(mode), symmetric=False, **fields))
    asym = [q for q in _qleaves(tp) if q.zero_points is not None]
    assert asym and all(q.data.dim() == 2 for q in asym)
    if cfg.num_experts:
        assert tp["layers"][0]["moe"]["router"]["w"].zero_points is not None
    kw = dict(max_batch_size=3, max_seq_len=256, prefill_chunk_size=32,
              prefill_buckets=(32, 64))
    jeng = JEngine(jp, jcfg, runtime=JRuntime(**kw), act_dtype=jnp.float32,
                   eos_token_id=None)
    teng = InferenceEngine(tp, cfg, runtime=RuntimeConfig(**kw),
                           act_dtype=torch.float32, device="cpu",
                           eos_token_id=None)
    gj = JGen(max_tokens=12, temperature=0.0, do_sample=False)
    gt = GenerationConfig(max_tokens=12, temperature=0.0, do_sample=False)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], _prompt(45, 6)]
    got, want = [], []
    for eng, g, out in ((jeng, gj, want), (teng, gt, got)):
        out.append(eng.generate(_prompt(48, 11), g).token_ids)
        out.extend(r.token_ids for r in eng.generate_batch(prompts, g))
    assert got == want


#: the bf16 streams' limits (tests/test_torch_weight_only_bf16.py's): the
#: decode logits within LOGIT_TOL, a greedy token apart only where JAX's
#: own top two lie within TIE_GAP
LOGIT_TOL = 1e-2
TIE_GAP = 9e-3


@pytest.mark.parametrize("bits,group", [(4, 32), (8, 0)])
def test_asymmetric_bf16_streams_match_jax(bits, group):
    """bf16 activations on tiny-llama, weights asymmetric and unfused (the
    fuse keeps zero-point parts apart in both packages): the prefill
    logits equal JAX's bit for bit; teacher-forced decode steps lie within
    LOGIT_TOL of JAX's and their greedy tokens are JAX's, near ties
    apart."""
    jcfg = jpresets.tiny_llama_config()
    cfg = presets.tiny_llama_config()
    jparams = JT.quantize_params(
        JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32),
        JQuant(mode=JMode.NONE))
    np_tree = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             if jnp.asarray(a).dtype == jnp.float32 else a),
        jparams)
    mode = "int8" if bits == 8 else "int4"
    jp = JT.fuse_params(JT.quantize_params(
        jax.tree_util.tree_map(jnp.asarray, np_tree),
        JQuant(mode=JMode(mode), group_size=group, symmetric=False)), jcfg)
    tp = T.fuse_params(T.quantize_params(
        params_from_numpy(np_tree, device="cpu"),
        QuantConfig(mode=QuantMode(mode), group_size=group,
                    symmetric=False)), cfg)
    assert "wq" in tp["layers"][0]["attn"] and "wq" in jp["layers"][0]["attn"]
    rng = np.random.default_rng(2)
    lens = np.array((5, 12, 20, 3), np.int32)
    b = len(lens)
    ids = np.zeros((b, 32), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(0, 128, n)
    jl, jkv = JT.forward_prefill(jp, jcfg, jnp.asarray(ids, jnp.int32),
                                 jnp.asarray(lens), dtype=jnp.bfloat16)
    with torch.no_grad():
        tl, tkv = T.forward_prefill(tp, cfg, torch.from_numpy(ids),
                                    torch.from_numpy(lens),
                                    dtype=torch.bfloat16)
    jl, tl = np.asarray(jl), tl.numpy()
    for i, n in enumerate(lens):
        np.testing.assert_array_equal(tl[i, :n], jl[i, :n])
    jc = jkvc.init_cache(jcfg.num_layers, b, 64, jcfg.kv_heads,
                         jcfg.dim_head, dtype=jnp.bfloat16)
    tc = tkvc.init_cache(cfg.num_layers, b, 64, cfg.kv_heads, cfg.dim_head)
    jc = tuple(jkvc.write_prompts(c, k, v, jnp.arange(b))
               for c, (k, v) in zip(jc, jkv))
    for c, (k, v) in zip(tc, tkv):
        tkvc.write_prompts(c, k, v, torch.arange(b))
    step = jax.jit(lambda t, c, n: JT.forward_decode(jp, jcfg, t, c, n,
                                                     dtype=jnp.bfloat16))
    tok = jl[np.arange(b), lens - 1].argmax(-1).astype(np.int32)
    for _ in range(16):
        ja, jc = step(jnp.asarray(tok), jc, jnp.asarray(lens))
        with torch.no_grad():
            ta, _ = T.forward_decode(tp, cfg, torch.from_numpy(tok), tc,
                                     torch.from_numpy(lens),
                                     dtype=torch.bfloat16)
        ja, ta = np.asarray(ja), ta.numpy()
        assert np.abs(ta - ja).max() <= LOGIT_TOL
        top2 = np.sort(ja, -1)[:, -2:]
        tie = top2[:, 1] - top2[:, 0] < TIE_GAP
        assert ((ta.argmax(-1) == ja.argmax(-1)) | tie).all()
        tok = ja.argmax(-1).astype(np.int32)
        lens = lens + 1


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: "
                    "python -m pytest -m cuda tests/test_torch_asymmetric.py)")
    return torch.device("cuda")


#: (K, N): TinyLlama's attention and MLP shapes, lm124's 260-wide head,
#: a ragged int4 plane boundary (K/2 = 1040: groups of 128 straddle it)
#: and N no multiple of 16
CUDA_SHAPES = [(2048, 2560), (5632, 2048), (768, 260), (2080, 264),
               (1024, 4099)]
CUDA_FUSIONS = ["plain", "rms_bias", "glu_residual"]


@functools.lru_cache(maxsize=None)
def _card_weight(k, n, bits, group, device):
    _, pw = _asym_weight(np.random.default_rng(k + n + bits + group), k, n,
                         bits, group)
    return pw.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("fusion", CUDA_FUSIONS)
@pytest.mark.parametrize("bits,group", WEIGHTS)
@pytest.mark.parametrize("k,n", CUDA_SHAPES)
@pytest.mark.parametrize("m", [1, 8, 17, 64, 512])
def test_cuda_zero_point_kernels_match_plain(cuda_device, m, k, n, bits,
                                             group, fusion):
    """The zero-point GEMV (M <= 8) and tensor-core kernel (above) against
    `dequant_matmul_plain` on the same bf16 inputs, f32 and bf16 out, each
    row within 2e-2 of its max |ref| (#1's gate), with all-positive and
    all-negative columns; one launch a call under the "z" variant key."""
    if group and k % group:
        pytest.skip("the group does not divide K")
    qw = _card_weight(k, n, bits, group, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(m + k)
    glu = fusion == "glu_residual"
    x = torch.randn(m, 2 * k if glu else k, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    kw = {}
    if fusion == "rms_bias":
        kw["rms_weight"] = (torch.randn(k, generator=g, device=cuda_device)
                            * 0.1 + 1).to(torch.bfloat16)
        kw["bias"] = torch.randn(n, generator=g, device=cuda_device)
    if glu:
        kw["glu"] = True
        kw["residual"] = torch.randn(m, n, generator=g,
                                     device=cuda_device).to(torch.bfloat16)
    key = dm.variant(qw)
    assert key.endswith("z")
    before = dm.dequant_matmul.variant_launches[key]
    for od in (torch.float32, torch.bfloat16):
        got = dm.dequant_matmul(x, qw, out_dtype=od, **kw)
        ref = dm.dequant_matmul_plain(x, qw.data, qw.scales, bits=bits,
                                      zero_points=qw.zero_points,
                                      out_dtype=od, **kw)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs().amax(-1)
        assert torch.isfinite(got).all()
        assert (diff <= 2e-2 * ref.float().abs().amax(-1)).all()
    assert dm.dequant_matmul.variant_launches[key] == before + 2


def test_asymmetric_scan_engine_streams_match_the_unrolled_engine():
    """The scan engine (stacked layers, `scan_layers=True`) over asymmetric
    weights, whose stacked parts carry their zero points: the unrolled
    engine's greedy tokens (f32)."""
    cfg = presets.tiny_llama_config(max_seq_len=256)
    params = T.quantize_params(
        T.init_params(cfg, torch.Generator().manual_seed(3),
                      dtype=torch.float32, device="cpu"),
        QuantConfig(mode=QuantMode.INT4, group_size=32, symmetric=False))
    gt = GenerationConfig(max_tokens=10, temperature=0.0, do_sample=False)
    prompts = [[1, 2, 3, 4, 5], _prompt(40, 7)]
    out = []
    for scan in (False, True):
        eng = InferenceEngine(params, cfg, runtime=RuntimeConfig(
            max_batch_size=2, max_seq_len=256, prefill_buckets=(64,),
            scan_layers=scan), act_dtype=torch.float32, device="cpu",
            eos_token_id=None)
        assert bool(eng.scan_layers) == scan
        out.append([r.token_ids for r in eng.generate_batch(prompts, gt)])
    assert out[0] == out[1]


def test_chip_smoke_calibrated_helpers_run_on_cpu(monkeypatch):
    """chip_smoke.py's calibrated phase rehearsed on the CPU at tiny-llama
    size: the asymmetric weights (zero points on every matrix, attention
    int8 and the rest int4) through the teacher-forced path with both CPU
    functions; GPTQ from `gptq_weights` (2 x 64 calibration tokens) below
    round-to-nearest's output error on every matrix kind, and the list of
    its fused matrices that `check_matrices` walks on the card; the served
    run of the asymmetric weights (its launch gates need the card)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    from deeppowers_tpu_torch.runtime import kvcache

    cfg = presets.tiny_llama_config(vocab_size=260, max_seq_len=1024)
    gen = torch.Generator().manual_seed(0)
    params = cs.asym_params(torch, T, cfg, gen, "cpu")
    leaves = _qleaves(params)
    assert leaves and all(q.zero_points is not None for q in leaves)
    assert {q.bits for q in _qleaves(params["layers"][0]["attn"])} == {8}
    assert {q.bits for q in _qleaves(params["layers"][0]["mlp"])} == {4}
    ids, forced = list(range(3, 40)), [5, 6, 7]
    ref = cs.forced_logits(torch, T, kvcache, params, cfg, ids, forced, "cpu")
    old = tmm.cpu_weight_only_function("kernel")
    try:
        got = cs.forced_logits(torch, T, kvcache, params, cfg, ids, forced,
                               "cpu")
    finally:
        tmm.cpu_weight_only_function(old)
    rel = max(((g - r).norm() / r.norm()).item() for g, r in zip(got, ref))
    assert rel <= 5e-2
    monkeypatch.setattr(cs, "GPTQ_CALIB", (2, 64))
    fparams, gq, rtn, stats, secs = cs.gptq_weights(torch, T, cfg, gen,
                                                    "cpu")
    errs = {"gptq": cs.output_errors(torch, fparams, gq, stats, cfg),
            "rtn": cs.output_errors(torch, fparams, rtn, stats, cfg)}
    for kind in cs.GPTQ_KINDS:
        assert errs["gptq"][kind] < errs["rtn"][kind], (kind, errs)
    assert {q.act_bits for q in _qleaves(gq)} == {8}
    assert secs["gptq_s"] > 0
    # check_matrices' list: every fused matrix of every layer, and the head
    mats = cs.quantized_matrices(T.fuse_params(gq, cfg))
    assert len(mats) == 4 * cfg.num_layers + 1
    assert mats[0][0] == "layers/0/attn/wqkv/w" and mats[-1][0] == "lm_head/w"
    out, launches = cs.served_run(
        torch, params, cfg, {"dequant_matmul": dm.dequant_matmul},
        "calibrated[asym]", [], [], device="cpu")
    assert len(out["stop_reasons"]) == len(cs.PROMPT_BYTES)
    assert out["tokens"] >= len(cs.PROMPT_BYTES)
