"""MoE in the port (Mixtral: top-k routing over stacked experts) against
the JAX package, on the CPU at tiny sizes.

Kernels #9 and #10 (`grouped_dequant_matmul`, `_ncat`): their plain
versions against the Pallas kernels in interpret mode, as the JAX engine
runs them on the CPU (JAX has no XLA twin of them), over ragged expert
segments with an empty expert and dead tail tiles. Then the stacked
quantizer and the cat relayout bit for bit, routing, every MoE branch
against its JAX function below and above 256 tokens, the init trees and
the presets. Inputs are made with numpy from fixed seeds. The CUDA
kernels run only on a card (the `cuda` marker); chip_smoke.py holds them
against their plain versions at Mixtral-8x7B's shapes.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.config import QuantConfig as JQuant
from deeppowers_tpu.config import QuantMode as JMode
from deeppowers_tpu.models import presets as jax_presets
from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.ops.pallas.dequant_matmul import (
    grouped_dequant_matmul as pallas_grouped,
    grouped_dequant_matmul_ncat as pallas_ncat)

from deeppowers_tpu_torch.config import QuantConfig, QuantMode
from deeppowers_tpu_torch.models import presets
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.ops.kernels import grouped_matmul as gm
from deeppowers_tpu_torch.quant.qtypes import (QuantizedTensor, pack_int4,
                                               unpack_int4)
from deeppowers_tpu_torch.quant.quantize import (dequantize_stacked,
                                                 quantize_stacked)

jq = importlib.import_module("deeppowers_tpu.quant.quantize")

torch.set_num_threads(1)


def _port_qw(qw) -> QuantizedTensor:
    return QuantizedTensor(torch.from_numpy(np.array(qw.data)),
                           torch.from_numpy(np.array(qw.scales)), None,
                           qw.bits, qw.group_size, qw.act_bits)


def _bf16_pair(a: np.ndarray):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _tree(t):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, t),
                             device="cpu")


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / np.abs(ref).max())


# ---------------------------------------------------------------------------
# kernels #9 and #10: plain versions against Pallas (interpret mode)
# ---------------------------------------------------------------------------

E, BM = 4, gm.BLOCK_M
COUNTS = (40, 0, 70, 9)        # ragged, expert 1 empty: 4 live tiles of 6


def _layout():
    """(tile_expert for the port, the same for Pallas with its dead tiles
    on the last live expert, as JAX's repeat pads them, live-row mask,
    m_pad): the routed rows of COUNTS in tiles of BM."""
    sorted_e = torch.repeat_interleave(torch.arange(E), torch.tensor(COUNTS))
    _, te, m_pad = gm.expert_tiles(sorted_e, torch.tensor(COUNTS))
    te_j = te.numpy().copy()
    live = te_j >= 0
    assert (~live).sum() == 2          # dead tail tiles
    te_j[~live] = te_j[live][-1]
    return te, jnp.asarray(te_j), np.repeat(live, BM), m_pad


# (bits, group, K): int4 and int8, g 32 and 128 in the Pallas kernels'
# `pre` regime (the group divides its K block), g = K/2 (one block a
# plane), K/2 = 384 zero-padded to the 512-row block, and per-channel int8
# at K = 2048 (two K blocks of 1024: a8 sets per block, not per group)
GROUPED_CASES = [(4, 32, 256), (4, 128, 256), (8, 32, 256), (8, 128, 256),
                 (4, 128, 768), (8, 0, 2048)]


def _grouped_inputs(kernel, bits, group, k, act_bits, seed, n=128):
    rng = np.random.default_rng(seed)
    te, te_j, live, m_pad = _layout()
    xj, xt = _bf16_pair(rng.standard_normal((m_pad, k)))
    if kernel == "grouped":
        w = jnp.asarray(rng.standard_normal((E, k, n)) * 0.05, jnp.float32)
        qw = jq.quantize_stacked(w, bits=bits, group_size=group)
    else:
        w = jnp.asarray(rng.standard_normal((k, E * n)) * 0.05, jnp.float32)
        qw = jq.quantize(w, bits=bits, group_size=group)
    qw = dataclasses.replace(qw, act_bits=act_bits)
    return (xj, te_j, qw), (xt, te, _port_qw(qw)), live, n


def _run_grouped(kernel, j_in, t_in, n, f32=True):
    (xj, te_j, qw), (xt, te, pw) = j_in, t_in
    jdt, tdt = ((jnp.float32, torch.float32) if f32
                else (jnp.bfloat16, torch.bfloat16))
    if kernel == "grouped":
        ref = pallas_grouped(xj, qw, te_j, out_dtype=jdt, block_m=BM)
        got = gm.grouped_dequant_matmul(xt, pw, te, out_dtype=tdt)
    else:
        ref = pallas_ncat(xj, qw, te_j, n, out_dtype=jdt, block_m=BM)
        got = gm.grouped_dequant_matmul_ncat(xt, pw, te, n, out_dtype=tdt)
    return np.asarray(ref.astype(jnp.float32)), got.float().numpy()


@pytest.mark.parametrize("bits,group,k", GROUPED_CASES)
@pytest.mark.parametrize("kernel", ["grouped", "ncat"])
def test_grouped_a8_plain_matches_pallas(kernel, bits, group, k):
    """W8A8 / W4A8: the activations quantized per (row, plane, segment) as
    the Pallas body does, the same integer sums, each segment's fused
    multiply-add in the body's order: the live rows bit for bit."""
    j_in, t_in, live, n = _grouped_inputs(kernel, bits, group, k, 8,
                                          10 * bits + group + k)
    ref, got = _run_grouped(kernel, j_in, t_in, n)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[live], ref[live])
    assert (got[~live] == 0).all()      # the plain version's dead rows


@pytest.mark.parametrize("bits,group,k", GROUPED_CASES)
@pytest.mark.parametrize("kernel", ["grouped", "ncat"])
def test_grouped_weight_only_plain_matches_pallas(kernel, bits, group, k):
    """Weight-only: sum over groups of (bf16(x)_g @ q_g) * s_g, kernel
    #1's function, within 1e-3 of max|ref| (f32 out) where the Pallas body
    keeps q exact. For grouped int8 its `pre` regime dequantizes q * s to
    bf16 before its dot, which the port does not copy (ROADMAP
    Decisions): there every output is held within that rounding's own
    bound, 2^-8 * sum |x * q * s|, and the plain version to the exact f32
    sum within 1e-6 of max|ref|."""
    j_in, t_in, live, n = _grouped_inputs(kernel, bits, group, k, 0,
                                          1000 + 10 * bits + group + k)
    ref, got = _run_grouped(kernel, j_in, t_in, n)
    if bits == 4 or not group:
        assert _rel(got[live], ref[live]) < 1e-3
        return
    xt, te, pw = t_in
    ex = torch.repeat_interleave(te.long().clamp_min(0), BM).numpy()
    w = torch.stack([
        (pw.data[e] if kernel == "grouped"
         else pw.data[:, e * n:(e + 1) * n]).float()
        * torch.repeat_interleave(
            pw.scales[e] if kernel == "grouped"
            else pw.scales[:, e * n:(e + 1) * n], group, 0)
        for e in range(E)]).double().numpy()                 # (E, K, N)
    x = xt.double().numpy()
    exact = np.einsum("mk,mkn->mn", x, w[ex])
    bound = 2.0 ** -8 * np.einsum("mk,mkn->mn", np.abs(x), np.abs(w[ex]))
    scale = np.abs(exact[live]).max()
    assert (np.abs(got - exact)[live] <= 1e-6 * scale).all()
    assert (np.abs(ref - exact)[live] <= bound[live] + 1e-6 * scale).all()


@pytest.mark.parametrize("act_bits", [0, 8])
def test_grouped_ncat_bf16_out_matches_pallas(act_bits):
    """#10 with its default bf16 output, as the MoE layer calls it: within
    1e-2 of max|ref| (a last f32 bit may flip a bf16 rounding)."""
    j_in, t_in, live, n = _grouped_inputs("ncat", 4, 32, 256, act_bits, 77)
    ref, got = _run_grouped("ncat", j_in, t_in, n, f32=False)
    assert _rel(got[live], ref[live]) < 1e-2


# (bits, group, act_bits): #10's six weight variants (w8, w4, w8g, w4g,
# w8a8g, w4a8g)
NCAT_VARIANTS = [(8, 0, 0), (4, 0, 0), (8, 32, 0), (4, 32, 0), (8, 32, 8),
                 (4, 32, 8)]


def _cat_and_stacked(bits, group, act_bits, k, n, seed):
    """Random codes and scales as #10's cat (K[/2], E·n) and as the same
    experts stacked (E, K[/2], n), the stacked one read through the cat's
    TMA view (`expert_map`): no copy of a code or a scale."""
    g = torch.Generator().manual_seed(seed)
    rows = k // 2 if bits == 4 else k
    data = torch.randint(-127, 128, (rows, E * n), generator=g,
                         dtype=torch.int8)
    srows = k // group if group else 1
    scales = 0.01 * (0.5 + torch.rand((srows, E * n), generator=g))
    cat = QuantizedTensor(data, scales, None, bits, group, act_bits)

    def view(t, r):
        dims, pitches = gm.expert_map(True, r, n, E)
        st = torch.as_strided(t, dims[::-1], pitches[::-1] + (1,))
        return st.permute(1, 0, 2)            # (rows, E, n) -> (E, rows, n)
    stacked = QuantizedTensor(view(data, rows), view(scales, srows), None,
                              bits, group, act_bits)
    return cat, stacked


@pytest.mark.parametrize("bits,group,act_bits", NCAT_VARIANTS)
def test_ncat_is_the_grouped_product_over_the_cat_view(bits, group,
                                                       act_bits):
    """The identity #10's CUDA path rests on: the cat's column block of
    expert e is expert e of the stacked weight that `expert_map`'s view
    (the kernel's TMA map) reads, so #10's plain version equals #9's over
    that view bit for bit, dead tiles included (rows of 4 experts, one
    empty, two dead tail tiles)."""
    k, n = 256, 96
    cat, stacked = _cat_and_stacked(bits, group, act_bits, k, n,
                                    bits + group + act_bits)
    te, _, _, m_pad = _layout()
    xs = torch.randn(m_pad, k, generator=torch.Generator().manual_seed(3))
    xs = xs.to(torch.bfloat16)
    for dt in (torch.float32, torch.bfloat16):
        got = gm.grouped_dequant_matmul_ncat_plain(xs, cat, te, n,
                                                   out_dtype=dt)
        ref = gm.grouped_dequant_matmul_plain(xs, stacked, te, out_dtype=dt)
        assert got.dtype == dt and torch.equal(got, ref)


# (K, n_e, E) of #10's cats: Mixtral-8x7B's w_gu (2 x 14336 a expert),
# mixtral-mini's (2 x 5632), tiny-moe's (2 x 128), and a ragged one (2 x
# 48, four experts: a 128-column block ends inside the next expert)
CAT_SHAPES = [(4096, 28672, 8), (2048, 11264, 8), (64, 256, 4), (64, 96, 4)]


@pytest.mark.parametrize("k,ne,e", CAT_SHAPES)
def test_expert_map_addresses_the_cat(k, ne, e):
    """#10's TMA view of the cat: pitches that TMA takes (multiples of 16
    bytes, each the one before times its extent, so the view is dense and
    in bounds) and coordinate (column c, expert x, stored row r) at the
    cat's byte r·E·n_e + x·n_e + c; a 128-column block of expert x reads
    past n_e only into what TMA zero-fills. The stacked map of #9 the
    same way."""
    for bits in (8, 4):
        rows = k // 2 if bits == 4 else k
        for cat in (True, False):
            dims, pitches = gm.expert_map(cat, rows, ne, e)
            assert all(p % 16 == 0 for p in pitches)
            assert pitches[0] == dims[0] and pitches[1] == dims[1] * dims[0]
            assert dims[0] == ne and sorted(dims[1:]) == sorted((rows, e))
            rng = np.random.default_rng(k + ne)
            c = rng.integers(0, ne, 64)
            x = rng.integers(0, e, 64)
            r = rng.integers(0, rows, 64)
            coords = (c, x, r) if cat else (c, r, x)
            off = coords[0] + coords[1] * pitches[0] + coords[2] * pitches[1]
            want = (r * e * ne + x * ne + c) if cat else \
                (x * rows * ne + r * ne + c)
            assert (off == want).all()
            last = sum((d - 1) * p for d, p in zip(dims, (1,) + pitches))
            assert last == rows * e * ne - 1
    if ne * k * e <= 1 << 20:           # the small cats: the whole view
        data = torch.arange(k * e * ne, dtype=torch.int32).reshape(k, e * ne)
        dims, pitches = gm.expert_map(True, k, ne, e)
        st = torch.as_strided(data, dims[::-1], pitches[::-1] + (1,))
        for xe in range(e):
            assert torch.equal(st[:, xe], data[:, xe * ne:(xe + 1) * ne])


@pytest.mark.parametrize("bits,k,group,per_group", [
    (4, 4096, 128, True), (4, 14336, 128, True), (4, 256, 32, True),
    (4, 256, 128, True), (4, 768, 128, True), (4, 1536, 0, False),
    (8, 2048, 0, False), (8, 256, 0, True), (4, 4096, 2048, False),
    (8, 4096, 2048, False), (8, 4096, 1024, True)])
def test_a8_segments(bits, k, group, per_group):
    """Which a8 weights the CUDA kernels take: those whose Pallas
    quantization segments are their scale groups. Mixtral's w_gu (K =
    4096) and w_out (K = 14336) at g = 128, tiny-moe's and moelm's are;
    per-channel int4 (a group across both planes) and groups spanning
    several K blocks are not."""
    assert gm.a8_per_group(bits, k, group) == per_group


def test_expert_tiles_layout():
    """Each expert's rows start on a tile, in sorted order; the table
    names each live tile's expert and -1 past them; m_pad holds any
    routing of the pairs."""
    counts = torch.tensor([3, 0, 70, 1])
    sorted_e = torch.repeat_interleave(torch.arange(4), counts)
    dest, te, m_pad = gm.expert_tiles(sorted_e, counts)
    assert gm.BLOCK_M == 64 and m_pad == 128 + 4 * 64
    assert dest.tolist() == [0, 1, 2] + list(range(64, 134)) + [192]
    assert te.tolist() == [0, 2, 2, 3, -1, -1]
    assert te.dtype == torch.int32


# ---------------------------------------------------------------------------
# stacked quantization, relayout, routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,group", [(8, 0), (8, 32), (4, 0), (4, 32)])
def test_quantize_stacked_bit_exact_with_jax(bits, group):
    w = np.random.default_rng(bits + group).standard_normal(
        (3, 64, 48)).astype(np.float32) * 0.05
    ref = jq.quantize_stacked(jnp.asarray(w), bits=bits, group_size=group)
    got = quantize_stacked(torch.from_numpy(w), bits=bits, group_size=group)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))
    assert (got.bits, got.group_size, got.zero_points) == (bits, group, None)
    np.testing.assert_array_equal(
        dequantize_stacked(got).numpy(),
        np.asarray(jq.dequantize_stacked(ref)))


def test_int4_pack_along_dim1_is_per_expert():
    """pack_int4(dim=1) packs each expert's K rows apart, as JAX vmaps
    pack_int4, and unpack_int4(dim=1) undoes it."""
    v = torch.randint(-8, 8, (3, 10, 5), dtype=torch.int8)
    p = pack_int4(v, dim=1)
    assert torch.equal(p, torch.stack([pack_int4(x) for x in v]))
    assert torch.equal(unpack_int4(p, dim=1), v)


def _qleaves_equal(a, b):
    assert (a.bits, a.group_size, a.act_bits) == (b.bits, b.group_size,
                                                  b.act_bits)
    assert a.zero_points is None and b.zero_points is None
    np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy())
    np.testing.assert_array_equal(np.asarray(a.scales), b.scales.numpy())


RECIPES = {
    "w4a8_g32": dict(mode="int4", group_size=32, act_bits=8),
    "w4_g32": dict(mode="int4", group_size=32),
    "w8_g32": dict(mode="int8", group_size=32),
    "w8a8_g32": dict(mode="int8", group_size=32, act_bits=8),
    "w8": dict(mode="int8"),
    "w4a8": dict(mode="int4", act_bits=8),
}


def _qcfgs(fields):
    fields = dict(fields)
    mode = fields.pop("mode")
    return (JQuant(mode=JMode(mode), **fields),
            QuantConfig(mode=QuantMode(mode), **fields))


@pytest.fixture(scope="module")
def tiny_moe():
    jcfg = jax_presets.tiny_moe_config()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    return jcfg, jp, presets.tiny_moe_config(), _tree(jp)


@pytest.fixture(scope="module")
def fused(tiny_moe):
    """recipe -> (JAX tree, port tree), each quantized by its own package
    ("bf16": float experts) and fused (JAX with fuse_moe=True); made once."""
    jcfg, jp, cfg, tp = tiny_moe
    made = {}

    def get(recipe):
        if recipe not in made:
            j, t = jp, tp
            if recipe != "bf16":
                jqc, tqc = _qcfgs(RECIPES[recipe])
                j, t = JT.quantize_params(j, jqc), T.quantize_params(t, tqc)
            made[recipe] = (JT.fuse_params(j, jcfg, fuse_moe=True),
                            T.fuse_params(t, cfg))
        return made[recipe]
    return get


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_quantize_and_fuse_params_bit_exact_with_jax(fused, recipe):
    """quantize_params (stacked experts and the router as an "mlp"
    matrix) then fuse_params (JAX's with fuse_moe=True): the port's tree
    equals JAX's leaf for leaf, bits and group sizes included; per-group experts take
    the cat layout (w_gu, w_out with per-expert int4 packing and
    plane-major scales, w_out_scales_stacked), per-channel ones stay
    stacked."""
    jf, tf = fused(recipe)
    moe = tf["layers"][0]["moe"]
    assert ("experts_cat" in moe) == ("group_size" in RECIPES[recipe])
    is_q = lambda v: hasattr(v, "bits")    # noqa: E731
    jl = jax.tree_util.tree_leaves_with_path(jf, is_leaf=is_q)
    tl = jax.tree_util.tree_leaves_with_path(tf, is_leaf=lambda v: isinstance(
        v, (QuantizedTensor, torch.Tensor)))
    assert [jax.tree_util.keystr(p) for p, _ in jl] == \
        [jax.tree_util.keystr(p) for p, _ in tl]
    for (path, a), (_, b) in zip(jl, tl):
        if is_q(a):
            _qleaves_equal(a, b)
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=jax.tree_util.keystr(path))
    assert T.param_nbytes(tf) == JT.param_nbytes(jf)


@pytest.mark.parametrize("fuse", [False, True])
def test_params_from_numpy_carries_moe_leaves(fused, tiny_moe, fuse):
    """JAX's quantized MoE tree, stacked (E, K/2, N) experts or the cat
    layout with its stacked w_out scales, crosses over through
    params_from_numpy equal to the port's own."""
    jcfg, jp, cfg, tp = tiny_moe
    jqc, tqc = _qcfgs(RECIPES["w4a8_g32"])
    jt, tt = JT.quantize_params(jp, jqc), T.quantize_params(tp, tqc)
    if fuse:
        jt, tt = fused("w4a8_g32")
    got = _tree(jt)
    leaf = lambda v: isinstance(v, (QuantizedTensor, torch.Tensor))  # noqa
    a = jax.tree_util.tree_leaves_with_path(got, is_leaf=leaf)
    b = jax.tree_util.tree_leaves_with_path(tt, is_leaf=leaf)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, x), (_, y) in zip(a, b):
        if isinstance(y, QuantizedTensor):
            assert x.data.shape == y.data.shape
            assert (x.bits, x.group_size, x.act_bits) == (
                y.bits, y.group_size, y.act_bits)
            assert torch.equal(x.data, y.data) and torch.equal(x.scales,
                                                               y.scales)
        else:
            assert torch.equal(x, y)


def test_cat_experts_keeps_int4_whose_group_splits_a_half_stacked():
    """int4 experts whose group does not divide I/2 (I = 96, g = 32) keep
    the stacked layout in both packages."""
    jcfg = jax_presets.tiny_moe_config(intermediate_size=96)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    jqc, tqc = _qcfgs(RECIPES["w4_g32"])
    jf = JT.fuse_params(JT.quantize_params(jp, jqc), jcfg, fuse_moe=True)
    tf = T.fuse_params(T.quantize_params(_tree(jp), tqc),
                       presets.tiny_moe_config(intermediate_size=96))
    assert "experts" in jf["layers"][0]["moe"]
    assert "experts" in tf["layers"][0]["moe"]


@pytest.mark.parametrize("k", [2, 3])
def test_routing_matches_lax_top_k_with_ties(k):
    """Expert ids equal lax.top_k's, ties to the lower index, and the
    softmax weights within 1e-6: logits with many exact ties (small
    integers through an identity router, exact in f32)."""
    cfg = presets.tiny_moe_config(num_experts=8, num_experts_per_tok=k)
    logits = np.random.default_rng(k).integers(-2, 3, (64, 8)).astype(
        np.float32)
    idx, w = T.route(torch.from_numpy(logits), {"w": torch.eye(8)}, cfg)
    vals, ref_idx = jax.lax.top_k(jnp.asarray(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jax.nn.softmax(vals)),
                               rtol=1e-6, atol=0)
    assert idx.dtype == torch.int64 and w.dtype == torch.float32


# (recipe, port branch, JAX function, limit of max|ref|): f32 activations
BRANCHES = [
    ("w4a8_g32", "_moe", "cat", 1e-5),
    ("w8a8_g32", "_moe", "cat", 1e-5),
    ("w4_g32", "_moe", "cat", 1e-5),
    ("w4a8_g32", "_moe_grouped_cat", "grouped_cat", 1e-5),
    ("w8a8_g32", "_moe_grouped_cat", "grouped_cat", 1e-5),
    # gu is bf16 in both (#10's output); an f32 last bit can flip its
    # rounding, one bf16 step of one gu element
    ("w4_g32", "_moe_grouped_cat", "grouped_cat", 1e-3),
    ("w8", "_moe", "quantized_dense", 1e-5),
    ("w4a8", "_moe", "quantized_dense", 1e-5),
    ("w8", "_moe_grouped", "grouped", 1e-5),
    ("bf16", "_moe", "dense", 1e-5),
    ("bf16", "_moe_grouped", "grouped", 1e-5),
]


@pytest.mark.parametrize("t", [8, 300])
@pytest.mark.parametrize("recipe,fn,branch,limit", BRANCHES)
def test_moe_branch_matches_jax(tiny_moe, fused, recipe, fn, branch, limit,
                               t):
    """Each MoE branch against its JAX function on the same tree and
    tokens (f32), at T = 8 and 300 (T only sizes the routed rows here; the
    dispatch by T is test_ffn_dispatch_follows_jax)."""
    jcfg, _, cfg, _ = tiny_moe
    jf, tf = fused(recipe)
    jl, tl = jf["layers"][1]["moe"], tf["layers"][1]["moe"]
    assert ("experts_cat" in tl) == (branch in ("cat", "grouped_cat"))
    x = np.random.default_rng(t).standard_normal((t, 64)).astype(np.float32)
    ref = getattr(JT, fn)(jnp.asarray(x), jl, jcfg)
    got = getattr(T, fn)(torch.from_numpy(x), tl, cfg)
    assert got.shape == (t, 64) and got.dtype == torch.float32
    assert _rel(got.numpy(), ref) < limit


@pytest.mark.parametrize("recipe", ["w4a8_g32", "w8", "bf16"])
def test_ffn_dispatch_follows_jax(tiny_moe, fused, monkeypatch, recipe):
    """_ffn takes JAX's branch at b·s = 255 and 256 tokens, for (1, 255),
    (1, 256) and (4, 64) inputs, and the layer's output is JAX's."""
    jcfg, _, cfg, _ = tiny_moe
    jl, tl = (tree["layers"][0] for tree in fused(recipe))
    taken = []
    for name in ("_moe", "_moe_grouped", "_moe_grouped_cat"):
        fn = getattr(T, name)
        monkeypatch.setattr(T, name, lambda *a, _f=fn, _n=name: (
            taken.append(_n), _f(*a))[1])
    grouped = "_moe_grouped_cat" if recipe == "w4a8_g32" else "_moe_grouped"
    for shape, want in (((1, 255), "_moe"), ((1, 256), grouped),
                        ((4, 64), grouped)):
        x = np.random.default_rng(sum(shape)).standard_normal(
            shape + (64,)).astype(np.float32)
        ref = JT._ffn(jnp.asarray(x), jl, jcfg)
        got = T._ffn(torch.from_numpy(x), tl, cfg)
        assert taken[-1] == want
        assert _rel(got.numpy(), ref) < 1e-5


# ---------------------------------------------------------------------------
# init trees and presets
# ---------------------------------------------------------------------------

def _shapes(tree, is_leaf=None):
    return [(jax.tree_util.keystr(p), tuple(v.shape),
             str(v.dtype).replace("torch.", ""))
            for p, v in jax.tree_util.tree_leaves_with_path(tree,
                                                            is_leaf=is_leaf)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_moe_tree_matches_jax(dtype):
    """tiny-moe: router (H, E), stacked experts (E, K, N), no mlp; the
    same keys, shapes and dtypes as JAX's tree."""
    jt = JT.init_params(jax_presets.tiny_moe_config(), jax.random.PRNGKey(0),
                        dtype=getattr(jnp, dtype))
    tt = T.init_params(presets.tiny_moe_config(),
                       torch.Generator().manual_seed(0),
                       dtype=getattr(torch, dtype))
    assert _shapes(tt) == _shapes(jt)


@pytest.mark.parametrize("qcfg", [dict(mode="int8"),
                                  dict(mode="int4", group_size=32),
                                  dict(mode="int8", group_size=32,
                                       act_bits=8)])
def test_init_quantized_params_moe_shapes_match_jax(qcfg):
    jqc, tqc = _qcfgs(qcfg)
    jt = JT.init_quantized_params(jax_presets.tiny_moe_config(), jqc,
                                  jax.random.PRNGKey(0), dtype=jnp.float32)
    tt = T.init_quantized_params(presets.tiny_moe_config(), tqc,
                                 torch.Generator().manual_seed(0),
                                 dtype=torch.float32)
    assert _shapes(tt, lambda v: isinstance(v, QuantizedTensor)) == \
        _shapes(jt, lambda v: hasattr(v, "bits"))


def test_mixtral_8x7b_w4a8_fits_one_card():
    """Mixtral-8x7B W4A8 g128 drawn quantized (on the meta device: nothing
    allocated), fused as the engine fuses it: JAX's shapes before the
    fuse, every layer in the cat layout after it, and about 25.5 GB of
    weights (22.5 GB of expert codes, 1.9 GB of f32 group scales with the
    stacked copy of w_out's)."""
    qc = dict(group_size=128, act_bits=8)
    jt = jax.eval_shape(lambda key: JT.init_quantized_params(
        jax_presets.MIXTRAL_8X7B, JQuant(mode=JMode.INT4, **qc), key),
        jax.random.PRNGKey(0))
    tt = T.init_quantized_params(presets.MIXTRAL_8X7B,
                                 QuantConfig(mode=QuantMode.INT4, **qc),
                                 torch.Generator().manual_seed(0),
                                 device="meta")
    q = lambda v: isinstance(v, QuantizedTensor) or hasattr(v, "bits")  # noqa
    assert [(k, s) for k, s, _ in _shapes(tt, q)] == [
        (k, s) for k, s, _ in _shapes(jt, q)]
    fused = T.fuse_params(tt, presets.MIXTRAL_8X7B)
    assert all("experts_cat" in layer["moe"] for layer in fused["layers"])
    cat = fused["layers"][0]["moe"]["experts_cat"]
    assert cat["w_gu"]["w"].data.shape == (2048, 8 * 2 * 14336)
    assert cat["w_out"]["w"].data.shape == (8 * 7168, 4096)
    assert 25.0e9 < T.param_nbytes(fused) < 26.0e9


@pytest.mark.parametrize("name", ["mixtral-8x7b", "mixtral-mini", "tiny-moe"])
def test_moe_presets_equal_jax(name):
    assert dataclasses.asdict(presets.PRESETS[name]) == dataclasses.asdict(
        jax_presets.PRESETS[name])


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions (a card only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py runs these "
                    "kernels on the card)")
    return torch.device("cuda")


def _card_case(dev, kernel, bits, group, act_bits, k, n):
    """Routed rows of 5 experts (one empty) in tiles of 64 with dead tail
    tiles, random codes and positive random scales, on the card."""
    g = torch.Generator(device=dev).manual_seed(bits * 100 + group + k)
    e, counts = 5, torch.tensor([70, 0, 130, 1, 64], device=dev)
    sorted_e = torch.repeat_interleave(torch.arange(e, device=dev), counts)
    _, te, m_pad = gm.expert_tiles(sorted_e, counts)
    x = torch.randn(m_pad, k, generator=g, device=dev).to(torch.bfloat16)
    rows = k // 2 if bits == 4 else k
    shape = (e, rows, n) if kernel == "grouped" else (rows, e * n)
    data = torch.randint(-127, 128, shape, generator=g, device=dev,
                         dtype=torch.int8)
    srows = k // group if group else 1
    sshape = (e, srows, n) if kernel == "grouped" else (srows, e * n)
    scales = 0.01 * (0.5 + torch.rand(sshape, generator=g, device=dev))
    return x, QuantizedTensor(data, scales, None, bits, group, act_bits), te


@pytest.mark.cuda
@pytest.mark.parametrize("bits,group,act_bits", [
    (4, 128, 8), (4, 128, 0), (8, 128, 0), (8, 128, 8), (4, 0, 0),
    (8, 0, 0), (4, 32, 8), (8, 32, 8)])
@pytest.mark.parametrize("kernel", ["grouped", "ncat"])
def test_cuda_grouped_matches_plain(cuda_device, kernel, bits, group,
                                    act_bits):
    """#9 and #10 on the card against their plain versions on the same
    inputs, live rows within 2e-2 of each row's max|ref| (chip_smoke.py's
    limit); K = 1024 (8 groups of 128, planes of 512), N = 192 (a partial
    column block)."""
    k, n = 1024, 192
    x, qw, te = _card_case(cuda_device, kernel, bits, group, act_bits, k, n)
    if kernel == "grouped":
        got = gm.grouped_dequant_matmul(x, qw, te)
        ref = gm.grouped_dequant_matmul_plain(x, qw, te)
        fn = gm.grouped_dequant_matmul
    else:
        got = gm.grouped_dequant_matmul_ncat(x, qw, te, n)
        ref = gm.grouped_dequant_matmul_ncat_plain(x, qw, te, n)
        fn = gm.grouped_dequant_matmul_ncat
    torch.cuda.synchronize()
    live = torch.repeat_interleave(te >= 0, 64)
    diff = (got.float() - ref.float())[live].abs().amax(-1)
    scale = ref.float()[live].abs().amax(-1)
    assert torch.isfinite(got[live]).all()
    assert (diff <= 2e-2 * scale).all()
    assert fn.variant_launches[gm.variant(qw)] > 0
    if kernel == "grouped" and act_bits:
        # #9's a8 pre-pass on the card: its plain version's bytes and
        # scales on every live row, bit for bit
        seg = group or k
        before = gm.quantize_segments.launches
        q, qs = gm.quantize_segments(x, seg, te)
        qp, qsp = gm.quantize_segments_plain(x, seg)
        torch.cuda.synchronize()
        assert gm.quantize_segments.launches == before + 1
        assert torch.equal(q[live], qp[live])
        assert torch.equal(qs[:, live], qsp[:, live])


@pytest.mark.cuda
@pytest.mark.parametrize("bits,group,act_bits", [
    (4, 32, 8), (4, 32, 0), (8, 32, 0), (8, 32, 8), (4, 0, 0), (8, 0, 0)])
@pytest.mark.parametrize("k,ne", [(64, 96), (64, 256), (1024, 96)])
def test_cuda_ncat_at_expert_edges_matches_plain(cuda_device, k, ne, bits,
                                                 group, act_bits):
    """#10 on the tensor-core kernel where a 128-column block of one expert
    ends inside the next expert's columns (n_e = 96, tiny-moe's 2 x 48
    shape at its K = 64, and at K = 1024) or fills its columns exactly
    (tiny-moe's n_e = 256): live rows within 2e-2 of each row's max|ref|,
    a8 through the pre-pass, and no column past n_e written (the output
    is n_e wide; the plain version reads only the expert's columns)."""
    x, qw, te = _card_case(cuda_device, "ncat", bits, group, act_bits, k, ne)
    before = gm.grouped_dequant_matmul_ncat.launches
    got = gm.grouped_dequant_matmul_ncat(x, qw, te, ne)
    ref = gm.grouped_dequant_matmul_ncat_plain(x, qw, te, ne)
    torch.cuda.synchronize()
    assert got.shape == (x.shape[0], ne)
    assert gm.grouped_dequant_matmul_ncat.launches == before + 1
    live = torch.repeat_interleave(te >= 0, 64)
    diff = (got.float() - ref.float())[live].abs().amax(-1)
    scale = ref.float()[live].abs().amax(-1)
    assert torch.isfinite(got[live]).all()
    assert (diff <= 2e-2 * scale).all()


@pytest.mark.cuda
def test_cuda_grouped_raises_on_per_block_a8(cuda_device):
    """An a8 weight whose Pallas segments are K blocks, not groups
    (per-channel int8, K = 2048), raises on the card, naming the case."""
    x, qw, te = _card_case(cuda_device, "grouped", 8, 0, 8, 2048, 64)
    with pytest.raises(NotImplementedError, match="segments"):
        gm.grouped_dequant_matmul(x, qw, te)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 300])
def test_cuda_moe_layer_makes_no_host_sync(cuda_device, t):
    """The MoE layer on the card (W4A8 g32 cat experts: #1 below 256
    tokens, #10 and #9 from 256) under CUDA sync debug mode "error": no
    call reads back from the device; and against its plain version on the
    CPU within 5e-2 rel L2 (bf16 activations)."""
    cfg = presets.tiny_moe_config(hidden_size=256, intermediate_size=512)
    tp = T.init_params(cfg, torch.Generator().manual_seed(0))
    _, tqc = _qcfgs(RECIPES["w4a8_g32"])
    layer = T.fuse_params(T.quantize_params(tp, tqc), cfg)["layers"][0]
    x = torch.randn(1, t, 256, generator=torch.Generator().manual_seed(t))
    x = x.to(torch.bfloat16)

    def on(tree, dev):
        if isinstance(tree, dict):
            return {kk: on(v, dev) for kk, v in tree.items()}
        return tree.to(dev)

    dev_layer = on(layer, cuda_device)
    xd = x.to(cuda_device)
    T._ffn(xd, dev_layer, cfg)                     # build and warm up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = T._ffn(xd, dev_layer, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = T._ffn(x, layer, cfg).float()
    rel = ((got.float().cpu() - ref).norm() / ref.norm()).item()
    assert rel <= 5e-2
