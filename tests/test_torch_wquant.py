"""Kernel #1's weight variants in the port: int4 (half-split, ragged K),
per-group scales (a group may straddle int4's nibble planes) and dynamic
int8 activations (W8A8 / W4A8), against the JAX package.

The plain versions run here (CPU tensors take them): against the Pallas
kernel in interpret mode, as tests/test_pallas_kernels.py runs it, and
against the JAX XLA path (`quantized_matmul`, `rms_matmul`, `glu_matmul`
on the CPU), which is the function the port computes for act_bits = 8.
Also the per-row activation quantizer bit for bit, `init_quantized_params`
and the presets. Inputs are made with numpy from fixed seeds. The CUDA
kernels run only on a card (the `cuda` marker; chip_smoke.py holds each
variant against its plain version at Llama-2-7B's shapes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.config import QuantConfig as JQuant
from deeppowers_tpu.config import QuantMode as JMode
from deeppowers_tpu.models import presets as jax_presets
from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.ops import matmul as jmm
from deeppowers_tpu.ops.pallas.dequant_matmul import dequant_matmul_fused
from deeppowers_tpu.quant import quantize as jax_quantize

from deeppowers_tpu_torch.config import QuantConfig, QuantMode
from deeppowers_tpu_torch.models import presets
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.ops import matmul as tmm
from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
from deeppowers_tpu_torch.quant.quantize import quantize, quantize_rows

torch.set_num_threads(1)

# (rms, glu, residual, bias, out f32): every fusion of the kernel, as
# tests/test_torch_kernels.py holds the int8 per-channel weight
FUSIONS = {
    "plain_f32_out": (False, False, False, False, True),
    "plain_bf16_out": (False, False, False, False, False),
    "rms": (True, False, False, False, True),
    "glu_residual": (False, True, True, False, True),
    "residual": (False, False, True, False, True),
    "bias": (False, False, False, True, True),
    "rms_bias_bf16_out": (True, False, False, True, False),
}


def _bf16_pair(a: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _f32_pair(a: np.ndarray):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _port_qw(qw) -> QuantizedTensor:
    return QuantizedTensor(torch.from_numpy(np.array(qw.data)),
                           torch.from_numpy(np.array(qw.scales)), None,
                           qw.bits, qw.group_size, qw.act_bits)


def _weight(rng, k, n, bits, group, act_bits=0):
    w = jnp.asarray(rng.standard_normal((k, n)) * 0.05, jnp.float32)
    return dataclasses.replace(jax_quantize(w, bits=bits, group_size=group),
                               act_bits=act_bits)


def _fusion_args(rng, case, m, k, n, pair):
    """Inputs of one FUSIONS case as (x, kwargs) for JAX and for torch."""
    rms, glu, res, bias, _ = FUSIONS[case]
    xj, xt = pair(rng.standard_normal((m, 2 * k if glu else k)))
    kw_j, kw_t = {}, {}
    if rms:
        gj, gt = pair(1.0 + 0.2 * rng.standard_normal(k))
        kw_j.update(rms_weight=gj, rms_eps=1e-5)
        kw_t.update(rms_weight=gt, rms_eps=1e-5)
    if glu:
        kw_j["glu"] = kw_t["glu"] = True
    if res:
        kw_j["residual"], kw_t["residual"] = pair(rng.standard_normal((m, n)))
    if bias:
        kw_j["bias"], kw_t["bias"] = pair(0.1 * rng.standard_normal(n))
    return (xj, kw_j), (xt, kw_t)


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / np.abs(ref).max())


@pytest.mark.parametrize("case", sorted(FUSIONS))
@pytest.mark.parametrize("bits,group", [(4, 0), (4, 32), (4, 128), (8, 0),
                                        (8, 32), (8, 128)])
def test_weight_only_plain_matches_pallas(bits, group, case):
    """Weight-only int4 / int8, per-channel and per-group, every fusion:
    the plain version against the Pallas kernel in interpret mode, its K
    block no larger than a group, which puts it in its post-scale mode
    (each group's f32 partial times the group's scale: the port's
    arithmetic; its pre-scale mode rounds q * s to bf16 first). Same bf16
    activation block on both sides; left over: f32 summation order, silu's
    last f32 bit flipping a bf16 rounding, and the bf16 output rounding
    when the output is bf16."""
    rng = np.random.default_rng(100 + 10 * bits + group)
    m, k, n = 8, 256, 384
    qw = _weight(rng, k, n, bits, group)
    (xj, kw_j), (xt, kw_t) = _fusion_args(rng, case, m, k, n, _bf16_pair)
    f32 = FUSIONS[case][4]
    ref = dequant_matmul_fused(xj, qw, out_dtype=jnp.float32 if f32 else
                               jnp.bfloat16, block_n=256,
                               block_k=min(128, group or 128), **kw_j)
    got = dm.dequant_matmul(xt, _port_qw(qw), out_dtype=torch.float32 if f32
                            else torch.bfloat16, **kw_t)
    assert got.shape == (m, n)
    assert _rel(got.float().numpy(), ref.astype(jnp.float32)) < (
        1e-3 if f32 else 1e-2)


@pytest.mark.parametrize("act_bits", [0, 8])
def test_int4_ragged_k_plain_matches_pallas(act_bits):
    """int4 with K/2 = 160, no multiple of the 128-row K block: the Pallas
    kernel zero-pads its last block; the plain version has no blocks. a8
    differs by the Pallas kernel's per-(row, K-block) activation scale
    (2e-2, test_act_i8_kernel_close_to_fp's limit against fp)."""
    rng = np.random.default_rng(7)
    m, k, n = 8, 320, 256
    qw = _weight(rng, k, n, 4, 32, act_bits)
    xj, xt = _bf16_pair(rng.standard_normal((m, k)))
    ref = dequant_matmul_fused(xj, qw, out_dtype=jnp.float32, block_n=256,
                               block_k=128)
    got = dm.dequant_matmul(xt, _port_qw(qw), out_dtype=torch.float32)
    assert _rel(got.numpy(), ref) < (1e-3 if act_bits == 0 else 2e-2)


@pytest.mark.parametrize("act_bits", [0, 8])
def test_straddling_group_matches_xla(act_bits):
    """int4 with K = 96 and g = 32: the nibble planes meet at row 48, inside
    group 1, which the Pallas kernel refuses (`_dispatch` :399-406) and
    the XLA path computes; f32 activations, 1e-5 of max|ref|."""
    rng = np.random.default_rng(8)
    qw = _weight(rng, 96, 128, 4, 32, act_bits)
    assert qw.scales.shape == (3, 128)
    xj, xt = _f32_pair(rng.standard_normal((5, 96)))
    ref = jmm.quantized_matmul(xj, qw, out_dtype=jnp.float32)
    got = tmm.quantized_matmul(xt, _port_qw(qw), out_dtype=torch.float32)
    assert _rel(got.numpy(), ref) < 1e-5


A8_WEIGHTS = [(8, 0), (8, 32), (4, 0), (4, 32)]


@pytest.mark.parametrize("op", ["matmul", "rms", "glu_residual", "rms_bias"])
@pytest.mark.parametrize("bits,group", A8_WEIGHTS)
def test_a8_plain_matches_xla(bits, group, op):
    """W8A8 / W4A8 against the JAX XLA path (`_w8a8_matmul`, behind
    `rms_matmul` / `glu_matmul`) on f32 activations, within 1e-5 of
    max|ref|: the quantized activations and the integer products are the
    same, only the f32 order of the group sums differs."""
    rng = np.random.default_rng(200 + 10 * bits + group)
    m, k, n = 6, 256, 192
    qw = _weight(rng, k, n, bits, group, act_bits=8)
    pw = _port_qw(qw)
    glu = op == "glu_residual"
    xj, xt = _f32_pair(rng.standard_normal((m, 2 * k if glu else k)))
    if op == "matmul":
        ref = jmm.quantized_matmul(xj, qw, out_dtype=jnp.float32)
        got = tmm.quantized_matmul(xt, pw, out_dtype=torch.float32)
    elif glu:
        rj, rt = _f32_pair(rng.standard_normal((m, n)))
        ref = jmm.glu_matmul(xj, qw, residual=rj)
        got = tmm.glu_matmul(xt, pw, residual=rt)
    else:
        gj, gt = _f32_pair(1.0 + 0.2 * rng.standard_normal(k))
        bj, bt = (None, None) if op == "rms" else _f32_pair(
            0.1 * rng.standard_normal(n))
        ref = jmm.rms_matmul(xj, gj, qw, eps=1e-5, bias=bj)
        got = tmm.rms_matmul(xt, gt, pw, eps=1e-5, bias=bt)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("case", ["plain_f32_out", "rms", "glu_residual",
                                  "rms_bias_bf16_out"])
@pytest.mark.parametrize("bits,group", [(4, 0), (4, 128), (8, 0), (8, 128)])
def test_a8_plain_close_to_pallas(bits, group, case):
    """W8A8 / W4A8 with bf16 activations against the Pallas kernel in
    interpret mode, which scales activations per (row, K block) where the
    port scales per row, and quantizes x * g before the norm: within the
    2e-2 that test_act_i8_kernel_close_to_fp allows it against fp."""
    rng = np.random.default_rng(300 + 10 * bits + group)
    m, k, n = 16, 512, 256
    qw = _weight(rng, k, n, bits, group, act_bits=8)
    (xj, kw_j), (xt, kw_t) = _fusion_args(rng, case, m, k, n, _bf16_pair)
    f32 = FUSIONS[case][4]
    ref = dequant_matmul_fused(xj, qw, out_dtype=jnp.float32 if f32 else
                               jnp.bfloat16, **kw_j)
    got = dm.dequant_matmul(xt, _port_qw(qw), out_dtype=torch.float32 if f32
                            else torch.bfloat16, **kw_t)
    assert _rel(got.float().numpy(), ref.astype(jnp.float32)) < 2e-2


@jax.jit
def _jax_quantize_rows(x):
    """The first lines of JAX `_w8a8_matmul` (deeppowers_tpu/ops/matmul.py
    :57-59), jitted as the JAX engine runs them. A copy, because the
    package keeps the bytes and the row scales inside that function and
    returns only products of them; test_quantize_rows_matches_the_package
    holds the port to the package's own function through those products."""
    xf = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    xs = jnp.maximum(absmax, 1e-8) / 127.0
    return jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8), xs


def _tie_rows(rng, m, k):
    """Rows whose values land on exact .5 ties of x / xs: each row's
    scale s is drawn, its values are (j + 0.5) * s for integers j, and one
    value 127 * s sets the absmax (so xs = fl(127 * s * fl(1/127)), which
    is s or a neighbour of it)."""
    s = rng.uniform(0.01, 10.0, (m, 1)).astype(np.float32)
    j = rng.integers(-127, 127, (m, k)).astype(np.float32)
    x = ((j + 0.5) * s).astype(np.float32)
    x[:, 0] = 127 * s[:, 0]
    return x


def test_quantize_rows_bit_exact_with_jax():
    """Bytes and row scales equal JAX's for random rows of many magnitudes,
    a zero row and rows of exact .5 ties."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((64, 96))
         * 10.0 ** rng.uniform(-4, 4, (64, 1))).astype(np.float32)
    x[3] = 0.0
    x = np.concatenate([x, _tie_rows(rng, 64, 96)])
    qj, sj = _jax_quantize_rows(jnp.asarray(x))
    qt, st = quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (qt[3] == 0).all() and st[3, 0] > 0
    ties = np.abs(np.asarray(qj[64:], np.float32) * np.asarray(sj[64:])
                  - x[64:])
    assert (ties > 0).any()                       # some ties were rounded
    q_bf, s_bf = quantize_rows(torch.from_numpy(x).to(torch.bfloat16))
    qj_bf, sj_bf = _jax_quantize_rows(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(q_bf.numpy(), np.asarray(qj_bf))
    np.testing.assert_array_equal(s_bf.numpy(), np.asarray(sj_bf))


def test_quantize_rows_matches_the_package():
    """The JAX package's own W8A8 path (`quantized_matmul` -> `_w8a8_matmul`
    under jit, as its engine runs it) through an int8 identity weight with
    unit scales returns f32(xq) * xs for each value: the port's bytes times
    its row scales equal it bit for bit, for f32 and bf16 rows of many
    magnitudes, a zero row and rows of exact .5 ties."""
    from deeppowers_tpu.quant.qtypes import QuantizedTensor as JQT
    rng = np.random.default_rng(11)
    k = 96
    x = (rng.standard_normal((32, k))
         * 10.0 ** rng.uniform(-4, 4, (32, 1))).astype(np.float32)
    x[5] = 0.0
    x = np.concatenate([x, _tie_rows(rng, 32, k)])
    eye = JQT(jnp.eye(k, dtype=jnp.int8), jnp.ones((1, k), jnp.float32), None,
              8, 0, 8)
    through = jax.jit(lambda v: jmm.quantized_matmul(
        v, eye, out_dtype=jnp.float32, prefer_pallas=False))
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(through(jnp.asarray(x).astype(dt_j)))
        q, xs = quantize_rows(torch.from_numpy(x).to(dt_t))
        np.testing.assert_array_equal((q.float() * xs).numpy(), ref)


def test_quantize_activations_plain_is_the_unfused_ops():
    """On the CPU the quantizer wrapper is the plain version: rms_norm or
    act(gate) * up in x's dtype, then quantize_rows; no launch counted."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    before = dm.quantize_activations.launches
    q, xs = dm.quantize_activations(x, 64, glu=True)
    qr, xr = quantize_rows(torch.nn.functional.silu(x[:, :64]) * x[:, 64:])
    assert torch.equal(q, qr) and torch.equal(xs, xr)
    q, xs = dm.quantize_activations(x[:, :64], 64, rms_weight=g)
    qr, xr = quantize_rows(T.rms_norm(x[:, :64], g))
    assert torch.equal(q, qr) and torch.equal(xs, xr)
    assert dm.quantize_activations.launches == before


@pytest.mark.parametrize("bits,group,act_bits,name", [
    (8, 0, 0, "w8"), (8, 32, 0, "w8g"), (8, 0, 8, "w8a8"),
    (8, 32, 8, "w8a8g"), (4, 0, 0, "w4"), (4, 32, 0, "w4g"),
    (4, 0, 8, "w4a8"), (4, 32, 8, "w4a8g")])
def test_variant_names(bits, group, act_bits, name):
    qw = quantize(torch.randn(64, 24), bits=bits, group_size=group)
    qw.act_bits = act_bits
    assert dm.variant(qw) == name


def test_asymmetric_weight_raises():
    """Zero points (once refused here): the JAX XLA path computes them, and
    so does the wrapper now. On a CPU tensor its plain version (each
    operand q - z, f32 here) equals JAX's `quantized_matmul` on the same
    codes within f32 sums, and JAX's and the port's asymmetric codes are
    the same. (tests/test_torch_asymmetric.py holds the rest.)"""
    rng = np.random.default_rng(9)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    w[:, :4] += 2.0                     # all-positive columns
    qw = quantize(torch.from_numpy(w), bits=4, group_size=32,
                  symmetric=False)
    jw = jax_quantize(jnp.asarray(w), bits=4, group_size=32, symmetric=False)
    np.testing.assert_array_equal(qw.data.numpy(), np.asarray(jw.data))
    np.testing.assert_array_equal(qw.zero_points.numpy(),
                                  np.asarray(jw.zero_points))
    x = rng.standard_normal((2, 64)).astype(np.float32)
    got = dm.dequant_matmul(torch.from_numpy(x), qw, out_dtype=torch.float32)
    ref = np.asarray(jmm.quantized_matmul(jnp.asarray(x), jw))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


# (K, N) of the matrices a served model's decode step takes through #1's
# GEMV: TinyLlama-1.1B, Llama-2-7B, Mixtral-8x7B (attention, the router-
# free cat experts' w_gu and w_out, head), lm124_ckpt's GPT-2 shapes with
# its 260-wide head, and ragged ones (int4's plane boundary inside a group,
# N no multiple of 16, K no multiple of 64)
GEMV_SHAPES = {
    "tinyllama": [(2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048),
                  (2048, 32000)],
    "llama2-7b": [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
                  (4096, 32000)],
    "mixtral": [(4096, 6144), (4096, 4096), (4096, 229376), (114688, 4096),
                (4096, 32000)],
    "lm124": [(768, 2304), (768, 768), (768, 3072), (3072, 768), (768, 260)],
    "ragged": [(96, 128), (1408, 260), (1344, 4099), (1000, 264)],
}


@pytest.mark.parametrize("model", sorted(GEMV_SHAPES))
def test_gemv_plan_keeps_groups_whole_and_fills_the_card(model):
    """The decode GEMV's K split, for every weight variant: at most
    GEMV_SPLITS chunks (one cluster a column tile) of a whole
    number of 64-row stages tile the stored rows, whole quads for a8; no
    chunk crosses a scale group in either int4 nibble plane (a group that
    straddles the planes keeps K whole), and the segment between two
    flushes lies in one group of each plane; the rows staged at once fit
    the block's activation budget; and the grid aims at a block an SM of
    an H100 (132): the split is the most that whole groups allow up to
    that aim."""
    for k, n in GEMV_SHAPES[model]:
        for bits in (8, 4):
            for group in (0, 32, 128):
                if group and k % group:
                    continue
                rows = k // 2 if bits == 4 else k
                rows_g = k // group if group else 1
                for a8 in (False, True):
                    p = dm.gemv_plan(k, n, bits, rows_g, a8)
                    assert p.n_tiles == -(-n // dm.GEMV_NT)
                    assert p.chunk % dm.GEMV_BK == 0
                    assert p.splits == -(-rows // p.chunk)
                    assert 1 <= p.splits <= dm.GEMV_SPLITS
                    planes = 2 if bits == 4 else 1
                    assert p.sub % dm.GEMV_BK == 0 and p.sub <= p.chunk
                    assert dm.GEMV_MAX_M * planes * p.sub * (
                        1 if a8 else 2) <= dm.GEMV_ACT_BYTES
                    want = min(dm.GEMV_SPLITS,
                               -(-dm.GEMV_BLOCKS // p.n_tiles))
                    assert p.splits <= want
                    straddle = bits == 4 and group and rows % group
                    quantum = (dm.GEMV_BK if not group else
                               np.lcm(p.seg, dm.GEMV_BK))
                    if straddle:
                        assert p.splits == 1
                    else:
                        assert p.chunk % quantum == 0
                        assert p.chunk == quantum or -(-rows // (
                            p.chunk - quantum)) > want
                    if not group:
                        continue
                    assert p.seg % 16 == 0
                    offs = [0, k // 2] if bits == 4 else [0]
                    for g0 in range(0, k, group):
                        # each group's stored rows, in each plane,
                        # lie in one chunk
                        for off in offs:
                            a = max(g0, off) - off
                            b = min(g0 + group, off + rows) - off
                            if a < b:
                                assert a // p.chunk == (b - 1) // p.chunk
                    for start in range(0, rows, p.seg):
                        end = min(rows, start + p.seg)
                        for off in offs:
                            assert (start + off) // group == \
                                (end - 1 + off) // group


@pytest.mark.parametrize("qcfg", [
    dict(mode="int8"), dict(mode="int4", group_size=32, act_bits=8),
    dict(mode="int8", group_size=32, act_bits=8), dict(mode="int4")])
def test_init_quantized_params_tree_matches_jax(qcfg):
    """tiny-llama: the same tree as JAX's (keys, shapes, dtypes, scale
    rows and values, bits, group_size, act_bits)."""
    cfg = presets.tiny_llama_config()
    jcfg = jax_presets.tiny_llama_config()
    mode = qcfg.pop("mode")
    jt = JT.init_quantized_params(jcfg, JQuant(mode=JMode(mode), **qcfg),
                                  jax.random.PRNGKey(0), dtype=jnp.float32)
    tt = T.init_quantized_params(cfg, QuantConfig(mode=QuantMode(mode),
                                                  **qcfg),
                                 torch.Generator().manual_seed(0),
                                 dtype=torch.float32)
    jl = jax.tree_util.tree_leaves_with_path(jt)
    tl = _leaves(tt)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == list(tl)
    for (_, a), (path, b) in zip(jl, tl.items()):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path
        if path.endswith("[<flat index 1>]"):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jq = [q for q in jax.tree_util.tree_leaves(
        jt, is_leaf=lambda v: hasattr(v, "bits"))if hasattr(q, "bits")]
    tq = [q for q in _qleaves(tt)]
    assert [(q.bits, q.group_size, q.act_bits) for q in jq] == \
        [(q.bits, q.group_size, q.act_bits) for q in tq]
    assert {q.act_bits for q in tq} == {qcfg.get("act_bits", 0)}


def _qleaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _qleaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _qleaves(v)
    elif isinstance(tree, QuantizedTensor):
        yield tree


def _leaves(tree, path=""):
    """{path: tensor} with JAX's `keystr` paths, in its flattening order
    (dict keys sorted; a QuantizedTensor's leaves are data, scales)."""
    out = {}
    if isinstance(tree, dict):
        for key in sorted(tree):
            out.update(_leaves(tree[key], f"{path}['{key}']"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}[{i}]"))
    elif isinstance(tree, QuantizedTensor):
        out[f"{path}[<flat index 0>]"] = tree.data
        out[f"{path}[<flat index 1>]"] = tree.scales
    else:
        out[path] = tree
    return out


def test_init_quantized_params_llama2_7b_shapes_match_jax():
    """Llama-2-7B W4A8 g128: the port's tree, made on the meta device,
    has the shapes and dtypes of JAX's (jax.eval_shape, nothing
    allocated); 3.5 GB of int4 data and scales."""
    qc = dict(group_size=128, act_bits=8)
    jt = jax.eval_shape(lambda key: JT.init_quantized_params(
        jax_presets.LLAMA2_7B, JQuant(mode=JMode.INT4, **qc), key),
        jax.random.PRNGKey(0))
    tt = T.init_quantized_params(presets.LLAMA2_7B,
                                 QuantConfig(mode=QuantMode.INT4, **qc),
                                 torch.Generator().manual_seed(0),
                                 device="meta")
    jl = jax.tree_util.tree_leaves_with_path(jt)
    tl = _leaves(tt)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == list(tl)
    assert [(tuple(a.shape), str(a.dtype)) for _, a in jl] == [
        (tuple(b.shape), str(b.dtype).replace("torch.", ""))
        for b in tl.values()]
    qbytes = sum(q.nbytes for q in _qleaves(tt))
    assert 3.4e9 < qbytes < 3.6e9


def test_init_quantized_params_logits_match_jax():
    """JAX's W4A8 g32 tree, carried over by params_from_numpy, gives the
    same prefill logits in both packages (f32 activations)."""
    jcfg = jax_presets.tiny_llama_config()
    jt = JT.init_quantized_params(
        jcfg, JQuant(mode=JMode.INT4, group_size=32, act_bits=8),
        jax.random.PRNGKey(3), dtype=jnp.float32)
    tt = params_from_numpy(jax.tree_util.tree_map(np.asarray, jt),
                           device="cpu")
    ids = np.array([[5, 9, 17, 33, 2, 70, 11, 4]], np.int32)
    lens = np.array([8], np.int32)
    ref = np.asarray(JT.forward_prefill(jt, jcfg, jnp.asarray(ids),
                                        jnp.asarray(lens),
                                        dtype=jnp.float32)[0])
    got = T.forward_prefill(tt, presets.tiny_llama_config(),
                            torch.from_numpy(ids.astype(np.int64)),
                            torch.from_numpy(lens), dtype=torch.float32)[0]
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["llama2-7b", "gpt2", "gpt2-medium"])
def test_presets_equal_jax(name):
    assert dataclasses.asdict(presets.PRESETS[name]) == dataclasses.asdict(
        jax_presets.PRESETS[name])


def test_init_quantized_params_moe_tree_matches_jax():
    """tiny-moe W4A8 g32 (MoE layers are ported): the same tree as JAX's,
    stacked experts (E, K/2, N) with (E, K/g, N) scales and a float
    router, with the same keys, shapes, dtypes, scale values, bits, group
    sizes and act_bits."""
    qc = dict(group_size=32, act_bits=8)
    jt = JT.init_quantized_params(jax_presets.tiny_moe_config(),
                                  JQuant(mode=JMode.INT4, **qc),
                                  jax.random.PRNGKey(0), dtype=jnp.float32)
    tt = T.init_quantized_params(presets.tiny_moe_config(),
                                 QuantConfig(mode=QuantMode.INT4, **qc),
                                 torch.Generator().manual_seed(0),
                                 dtype=torch.float32)
    jl = jax.tree_util.tree_leaves_with_path(jt)
    tl = _leaves(tt)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == list(tl)
    for (_, a), (path, b) in zip(jl, tl.items()):
        assert (tuple(a.shape), str(a.dtype)) == (
            tuple(b.shape), str(b.dtype).replace("torch.", "")), path
        if path.endswith("[<flat index 1>]"):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tt["layers"][0]["moe"]["experts"]["w_out"]["w"].data.shape == (
        4, 64, 64)
    assert {(q.bits, q.group_size, q.act_bits) for q in _qleaves(tt)} == {
        (4, 32, 8)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py runs these "
                    "kernels on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bits,group,act_bits", [
    (8, 0, 0), (4, 0, 0), (4, 128, 0), (8, 128, 0), (8, 0, 8), (8, 128, 8),
    (4, 0, 8), (4, 128, 8)])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 40, 64, 100, 512])
@pytest.mark.parametrize("fusion", ["plain", "rms", "glu_residual"])
@pytest.mark.parametrize("n", [260, 264, 4099])
def test_cuda_variant_matches_plain(cuda_device, bits, group, act_bits, m,
                                    fusion, n):
    """Each weight variant of #1 on the card, GEMV (M <= GEMV_MAX_M) and
    tensor-core route, against its plain version on the same inputs (2e-2
    of max|ref|, as chip_smoke.py holds it). Grouped: K = 1408 puts int4's
    plane boundary (704) inside group 5 of 128; per-channel: K = 1344 (42
    K stages of 32). No N here is a multiple of 16: 264 copies 8 bytes a
    row segment, 260 four, 4099 one, each with a partial column tile."""
    g = torch.Generator(device=cuda_device).manual_seed(m)
    k = 1408 if group else 1344
    qw = quantize(torch.randn(k, n, generator=g, device=cuda_device) * 0.02,
                  bits=bits, group_size=group)
    qw.act_bits = act_bits
    kx = 2 * k if fusion == "glu_residual" else k
    x = torch.randn(m, kx, generator=g, device=cuda_device).to(torch.bfloat16)
    kw = {}
    if fusion == "rms":
        kw["rms_weight"] = (torch.randn(k, generator=g, device=cuda_device)
                            * 0.1 + 1).to(torch.bfloat16)
    if fusion == "glu_residual":
        kw.update(glu=True, residual=torch.randn(
            m, n, generator=g, device=cuda_device).to(torch.bfloat16))
    before = dm.dequant_matmul.variant_launches[dm.variant(qw)]
    got = dm.dequant_matmul(x, qw, out_dtype=torch.float32, **kw)
    ref = dm.dequant_matmul_plain(x, qw.data, qw.scales, bits=bits,
                                  act_bits=act_bits, out_dtype=torch.float32,
                                  **kw)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()
    assert dm.dequant_matmul.variant_launches[dm.variant(qw)] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bits,group,act_bits", [
    (8, 0, 0), (4, 0, 0), (4, 128, 0), (8, 128, 0), (8, 0, 8), (8, 128, 8),
    (4, 0, 8), (4, 128, 8)])
@pytest.mark.parametrize("m", list(range(1, 9)))
@pytest.mark.parametrize("fusion", ["plain", "bias", "rms_residual",
                                    "glu_bias_residual"])
@pytest.mark.parametrize("n", [260, 264, 4099, 34000])
def test_cuda_gemv_matches_plain(cuda_device, bits, group, act_bits, m,
                                 fusion, n):
    """#1's decode GEMV on the card, every weight variant at every M up to
    GEMV_MAX_M, against its plain version on the same inputs (2e-2 of each
    row's max|ref|, chip_smoke.py's gate): with and without bias, residual
    and the RMSNorm and GLU folds; N = 260 / 264 / 4099 (cp.async copies 4,
    8 and 1 bytes wide, a partial column tile, K split with the reduction
    in the kernel) and N = 34000 (TMA, enough column tiles that K is not
    split). Grouped: K = 1408 (int4's plane boundary inside group 5);
    per-channel: K = 1344. One launch of the "gemv" route each."""
    g = torch.Generator(device=cuda_device).manual_seed(1000 + m + n)
    k = 1408 if group else 1344
    qw = quantize(torch.randn(k, n, generator=g, device=cuda_device) * 0.02,
                  bits=bits, group_size=group)
    qw.act_bits = act_bits
    glu = fusion.startswith("glu")
    x = torch.randn(m, 2 * k if glu else k, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    kw = {}
    if "bias" in fusion:
        kw["bias"] = torch.randn(n, generator=g, device=cuda_device)
    if "residual" in fusion:
        kw["residual"] = torch.randn(m, n, generator=g,
                                     device=cuda_device).to(torch.bfloat16)
    if "rms" in fusion:
        kw["rms_weight"] = (torch.randn(k, generator=g, device=cuda_device)
                            * 0.1 + 1).to(torch.bfloat16)
    if glu:
        kw["glu"] = True
    before = dm.dequant_matmul.variant_launches["gemv"]
    for od in (torch.float32, torch.bfloat16):
        got = dm.dequant_matmul(x, qw, out_dtype=od, **kw)
        ref = dm.dequant_matmul_plain(x, qw.data, qw.scales, bits=bits,
                                      act_bits=act_bits, out_dtype=od, **kw)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs().amax(-1)
        assert torch.isfinite(got).all()
        assert (diff <= 2e-2 * ref.float().abs().amax(-1)).all()
    assert dm.dequant_matmul.variant_launches["gemv"] == before + 2


@pytest.mark.cuda
def test_cuda_quantize_activations_bit_exact(cuda_device):
    """The quantizer kernel's bytes and row scales equal the plain
    version's on the same bf16 rows (a zero row included)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(9, 4096, generator=g, device=cuda_device).to(
        torch.bfloat16)
    x[4] = 0
    q, xs = dm.quantize_activations(x, 4096)
    qr, xr = quantize_rows(x)
    assert torch.equal(q, qr) and torch.equal(xs, xr)


@pytest.mark.cuda
def test_cuda_asymmetric_and_unaligned_groups_raise(cuda_device):
    """Asymmetric weights (once refused) run on the card: the GEMV and the
    tensor-core kernel against the plain version; groups of 16 rows still
    raise."""
    asym = quantize(torch.randn(64, 32, device=cuda_device), bits=8,
                    symmetric=False)
    for m in (2, 40):
        x = torch.randn(m, 64, device=cuda_device).to(torch.bfloat16)
        got = dm.dequant_matmul(x, asym, out_dtype=torch.float32)
        ref = dm.dequant_matmul_plain(x, asym.data, asym.scales,
                                      zero_points=asym.zero_points,
                                      out_dtype=torch.float32)
        diff = (got - ref).abs().amax(-1)
        assert (diff <= 2e-2 * ref.abs().amax(-1)).all()
    x = torch.randn(2, 64, device=cuda_device).to(torch.bfloat16)
    g16 = quantize(torch.randn(64, 32, device=cuda_device), bits=8,
                   group_size=16)
    with pytest.raises(NotImplementedError, match="groups"):
        dm.dequant_matmul(x, g16)
