"""9q, the a8 pre-pass of #9 and #10 (`quantize_segments`), in its two
modes: plain rows, and the GLU mode that computes #9's input act(gate) *
up (SiLU or the tanh GELU) from #10's gate | up output as it quantizes
it.

CPU: the GLU mode's plain version against the two steps it replaces (the
MoE layer's eager GLU, then the plain pre-pass) bit for bit; #9 with
`glu=True` against #9 on the eager rows; the MoE layer (`_moe_grouped_cat`)
against the function it computed before the fold, bit for bit, and against
JAX's `_moe_grouped_cat`; a PyTorch emulation of the kernel's schedule
(a block's 64-row tile and chunk, each thread's slots and lanes, the
segment maxima met over lane groups and slots, the staged scales) against
the plain version, at every segment size the planner takes; the planner.

Card (`cuda` marker, skipped here): both modes against their plain
versions at Mixtral's K (4096, 14336), segments of 32 and 128, all-zero
live rows, a dead tail tile with NaN in its rows, every finite bf16 gate
value (SiLU and GELU), and one launch counted under its mode; #9 with
`glu=True` bit for bit with #9 on the eager rows; every bf16 value under
every bf16 segment max. JAX is imported only inside the CPU test
that compares with it, so the card's run of this file imports no JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deeppowers_tpu_torch.config import QuantConfig, QuantMode
from deeppowers_tpu_torch.models import presets
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.ops.activation import activation
from deeppowers_tpu_torch.ops.kernels import grouped_matmul as gm
from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor

torch.set_num_threads(1)

BM = gm.BLOCK_M
# routed rows per expert: one empty expert, a one-row tile, a dead tail
COUNTS = (40, 0, 70, 1, 64)


def _layout(counts, device="cpu"):
    """(te, live-row mask, m_pad) of routed rows in tiles of BM."""
    counts = torch.tensor(counts, device=device)
    sorted_e = torch.repeat_interleave(
        torch.arange(counts.numel(), device=device), counts)
    _, te, m_pad = gm.expert_tiles(sorted_e, counts)
    return te, torch.repeat_interleave(te >= 0, BM), m_pad


def _rows(m_pad, width, live, seed, device="cpu"):
    """bf16 rows from a numpy seed: live rows random (two of them all
    zeros, one with a zero segment's worth of values), dead rows NaN."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m_pad, width)).astype(
        np.float32)).to(torch.bfloat16)
    x[3] = 0
    x[BM + 5] = 0
    x[7, :32] = 0
    x[~live] = float("nan")
    return x.to(device)


def _eager_glu(gu, act):
    """The MoE layer's GLU before the fold (models/transformer.py
    `_moe_grouped_cat`), on a bf16 model."""
    i = gu.shape[1] // 2
    return (activation(gu[:, :i].float(), act)
            * gu[:, i:].float()).to(torch.bfloat16)


def _stacked_qw(e, k, n, bits, group, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    rows = k // 2 if bits == 4 else k
    data = torch.randint(-127, 128, (e, rows, n), generator=g, device=device,
                         dtype=torch.int8)
    scales = 0.01 * (0.5 + torch.rand((e, k // group, n), generator=g,
                                      device=device))
    return QuantizedTensor(data, scales, None, bits, group, 8)


# ---------------------------------------------------------------------------
# CPU: the GLU mode's function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_glu_plain_is_the_two_step_composition(bits, group, act):
    """The GLU mode's plain version is the eager GLU then the plain
    pre-pass, bit for bit on every live row (zero rows included); #9 with `glu=True` on the CPU equals #9 on the eager
    rows, and the pre-pass composed with the a8 product, on live rows."""
    k = 256
    te, live, m_pad = _layout(COUNTS)
    gu = _rows(m_pad, 2 * k, live, 7 * bits + group)
    q, qs = gm.quantize_segments(gu, group, te, glu=True, act=act)
    inter = _eager_glu(gu, act)
    assert torch.equal(gm.glu_rows_plain(gu, act)[live], inter[live])
    qe, qse = gm.quantize_segments_plain(inter, group)
    assert torch.equal(q[live], qe[live])
    assert torch.equal(qs[:, live], qse[:, live])
    assert (q[3] == 0).all() and (q[BM + 5] == 0).all()
    qw = _stacked_qw(len(COUNTS), k, 48, bits, group, bits + group)
    got = gm.grouped_dequant_matmul(gu, qw, te, glu=True, act=act)
    ref = gm.grouped_dequant_matmul(inter, qw, te)
    composed = gm.grouped_a8_product_plain(q, qs, qw, te)
    assert torch.equal(got[live], ref[live])
    assert torch.equal(composed[live], ref[live])


def test_glu_mode_counts_no_launch_on_the_cpu():
    """On CPU tensors both modes take the plain version and count nothing."""
    te, live, m_pad = _layout(COUNTS)
    gu = _rows(m_pad, 128, live, 3)
    before = (gm.quantize_segments.launches,
              dict(gm.quantize_segments.variant_launches))
    gm.quantize_segments(gu, 32, te, glu=True)
    gm.quantize_segments(gu, 32, te)
    assert (gm.quantize_segments.launches,
            dict(gm.quantize_segments.variant_launches)) == before


# ---------------------------------------------------------------------------
# CPU: the MoE layer, before and after the fold
# ---------------------------------------------------------------------------

def _moe_grouped_cat_before(x, p, cfg):
    """models/transformer.py `_moe_grouped_cat` as it was before the GLU
    moved into #9's pre-pass: act(gate) * up as eager ops for every
    weight."""
    t, k = x.shape[0], cfg.num_experts_per_tok
    cat, i_dim = p["experts_cat"], cfg.ffn_size
    qgu, qo = cat["w_gu"]["w"], cat["w_out"]["w"]
    e = qgu.shape[1] // (2 * i_dim)
    idx, top_w = T.route(x, p["router"], cfg)
    order, sort_t, sort_e = T._sort_pairs(idx)
    flat_e = idx.reshape(-1)
    counts = torch.zeros(e, dtype=torch.int64).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    dest, te, m_pad = gm.expert_tiles(sort_e, counts)
    xs = torch.zeros((m_pad, x.shape[1]), dtype=x.dtype)
    xs[dest] = x[sort_t]
    gu = gm.grouped_dequant_matmul_ncat(xs, qgu, te, 2 * i_dim,
                                        out_dtype=torch.bfloat16)
    inter = (activation(gu[:, :i_dim].float(), cfg.activation)
             * gu[:, i_dim:].float()).to(x.dtype)
    stacked = QuantizedTensor(qo.data.reshape(e, -1, qo.data.shape[1]),
                              cat["w_out_scales_stacked"], None, qo.bits,
                              qo.group_size, qo.act_bits)
    y = gm.grouped_dequant_matmul(inter, stacked, te, out_dtype=torch.float32)
    contrib = y[dest] * top_w.reshape(-1)[order][:, None]
    return T._combine(contrib, order, t, k).to(x.dtype)


RECIPES = {"w4a8_g32": dict(mode="int4", group_size=32, act_bits=8),
           "w8a8_g32": dict(mode="int8", group_size=32, act_bits=8),
           "w4_g32": dict(mode="int4", group_size=32)}


def _layer(cfg, recipe, seed):
    fields = dict(RECIPES[recipe])
    mode = fields.pop("mode")
    tp = T.init_params(cfg, torch.Generator().manual_seed(seed))
    tree = T.fuse_params(T.quantize_params(
        tp, QuantConfig(mode=QuantMode(mode), **fields)), cfg)
    return tp, tree["layers"][1]["moe"]


@pytest.mark.parametrize("recipe", sorted(RECIPES))
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_grouped_cat_cpu_is_unchanged(monkeypatch, recipe, act, dtype):
    """The MoE layer on the CPU gives the bits it gave before the fold, for
    a8 and weight-only experts, SiLU and GELU, f32 and bf16 tokens; a8
    experts hand gate | up to #9 (`glu=True`, the activation's name)."""
    cfg = dataclasses.replace(presets.tiny_moe_config(), activation=act)
    _, moe = _layer(cfg, recipe, 5)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (300, cfg.hidden_size)).astype(np.float32)).to(dtype)
    taken = []
    orig = T.grouped_dequant_matmul
    monkeypatch.setattr(T, "grouped_dequant_matmul", lambda *a, **kw: (
        taken.append((kw.get("glu", False), kw.get("act"))),
        orig(*a, **kw))[1])
    got = T._moe_grouped_cat(x, moe, cfg)
    ref = _moe_grouped_cat_before(x, moe, cfg)
    assert got.dtype == dtype and torch.equal(got, ref)
    a8 = recipe.startswith(("w4a8", "w8a8"))
    assert taken == [(True, act) if a8 else (False, None)]


@pytest.mark.parametrize("recipe", ["w4a8_g32", "w8a8_g32"])
def test_moe_grouped_cat_glu_route_matches_jax(recipe):
    """The a8 SiLU layer through the GLU route against JAX's
    `_moe_grouped_cat` on the same tree and tokens (f32, inputs from a
    numpy seed), within test_torch_moe.py's limit for these branches
    (1e-5 of max|ref|)."""
    import jax.numpy as jnp

    from deeppowers_tpu.config import QuantConfig as JQuant
    from deeppowers_tpu.config import QuantMode as JMode
    from deeppowers_tpu.models import presets as jax_presets
    from deeppowers_tpu.models import transformer as JT
    from deeppowers_tpu_torch.models.convert import params_from_numpy
    import jax

    jcfg = jax_presets.tiny_moe_config()
    cfg = presets.tiny_moe_config()
    assert cfg.activation == jcfg.activation == "silu"
    jp = JT.init_params(jcfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    fields = dict(RECIPES[recipe])
    mode = fields.pop("mode")
    jq = JT.quantize_params(jp, JQuant(mode=JMode(mode), **fields))
    tq = T.quantize_params(tp, QuantConfig(mode=QuantMode(mode), **fields))
    jl = JT.fuse_params(jq, jcfg, fuse_moe=True)["layers"][1]["moe"]
    tl = T.fuse_params(tq, cfg)["layers"][1]["moe"]
    x = np.random.default_rng(29).standard_normal((300, 64)).astype(
        np.float32)
    ref = np.asarray(JT._moe_grouped_cat(jnp.asarray(x), jl, jcfg),
                     np.float32)
    got = T._moe_grouped_cat(torch.from_numpy(x), tl, cfg).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


# ---------------------------------------------------------------------------
# CPU: the kernel's schedule, emulated
# ---------------------------------------------------------------------------

def _emulate(xs, te, seg, glu):
    """csrc/dequant_matmul.cu `quantize_segments_kernel`'s indexing in
    PyTorch: block (chunk, tile) of 64 rows, warp w's rows w + 8 rr;
    thread (warp, lane) slot s (of 4 a pass, csrc SEG_SLOTS; GLU 2, but 4
    for segments past 512 values) of the pass from row r0: row r0 + s / nj,
    item (s % nj) * 32 + lane of the row chunk; a slot's max over its 8
    values, met over aligned groups of `lanes` lanes (the shuffle
    butterfly), then at seg >= 256 over the slots of its row; the item
    that starts a segment stages its scale. Returns (q, qs) with dead
    tiles' entries 0 / NaN."""
    m, width = xs.shape
    k = width // 2 if glu else width
    rows = (gm.glu_rows_plain(xs) if glu else xs).float()
    chunk = gm.segment_chunk(k, seg)
    items, slots = chunk // 8, 2 if glu and seg <= 512 else 4
    nj = -(-items // 32)
    rb = slots // nj
    lanes = 32 if seg >= 256 else seg // 8
    q = torch.zeros((m, k), dtype=torch.int8)
    qs = torch.full((k // seg, m), float("nan"))
    lane = torch.arange(32)
    for tile in range(m // BM):
        if te[tile] < 0:
            continue
        for c0 in range(0, k, chunk):
            sc = torch.full((chunk // seg, BM), float("nan"))
            for warp in range(8):
                for r0 in range(0, 8, rb):
                    vals, mx, oks, its, rls = [], [], [], [], []
                    for s in range(slots):
                        rr, it = r0 + s // nj, (s % nj) * 32 + lane
                        ok = (it < items) & (s < rb * nj) & (rr < 8)
                        rl = warp + 8 * rr
                        v = torch.zeros(32, 8)
                        if ok.any():
                            idx = c0 + 8 * it[ok, None] + torch.arange(8)
                            v[ok] = rows[tile * BM + rl, idx]
                        g = v.abs().amax(-1).reshape(32 // lanes, lanes)
                        mx.append(g.amax(-1).repeat_interleave(lanes))
                        vals.append(v)
                        oks.append(ok)
                        its.append(it)
                        rls.append(rl)
                    if seg >= 256:
                        mx = [torch.stack([mx[t] for t in range(slots)
                                           if t // nj == s // nj]).amax(0)
                              for s in range(slots)]
                    for s in range(slots):
                        ok, it, rl = oks[s], its[s], rls[s]
                        if not ok.any():
                            continue
                        sv = mx[s].clamp_min(1e-30) * gm._RECIP_127
                        code = torch.round(vals[s] / sv[:, None]).clamp(
                            -127, 127)
                        row = tile * BM + rl
                        for ln in torch.nonzero(ok).flatten().tolist():
                            c = c0 + 8 * int(it[ln])
                            q[row, c:c + 8] = code[ln].to(torch.int8)
                            if (c - c0) % seg == 0:
                                sc[(c - c0) // seg, rl] = sv[ln]
            qs[c0 // seg:(c0 + chunk) // seg, tile * BM:(tile + 1) * BM] = sc
    return q, qs


# (K, segment): the served segments (32, 128) at small K, 8-64 and the
# wide ones (one segment a chunk: 256, 512, and 768 over three slots)
SCHEDULE_CASES = [(256, 32), (512, 128), (192, 64), (64, 32), (64, 8),
                  (256, 16), (384, 128), (512, 256), (1024, 512), (768, 768),
                  (1024, 1024)]


@pytest.mark.parametrize("k,seg", SCHEDULE_CASES)
@pytest.mark.parametrize("glu", [False, True])
def test_kernel_schedule_emulation_is_the_plain_version(k, seg, glu):
    """The kernel's schedule, emulated, gives the plain version's codes
    and scales on every live row, writes every (segment, live row) scale
    once, and touches no dead tile."""
    counts = (70, 0, 9)
    te, live, m_pad = _layout(counts)
    xs = _rows(m_pad, 2 * k if glu else k, live, k + seg + glu)
    q, qs = _emulate(xs, te, seg, glu)
    qp, qsp = gm.quantize_segments_plain(xs, seg, glu)
    assert torch.equal(q[live], qp[live])
    assert torch.equal(qs[:, live], qsp[:, live])
    assert torch.isnan(qs[:, ~live]).all() and (q[~live] == 0).all()


@pytest.mark.parametrize("k,seg", [(14336, 128), (4096, 128), (14336, 32),
                                   (4096, 32), (11264, 128), (512, 32),
                                   (256, 32), (128, 32), (64, 32),
                                   (1024, 1024), (768, 768), (96, 32)])
def test_segment_chunk_keeps_segments_whole(k, seg):
    """The chunk divides K, holds whole segments (at most 32 of them, the
    staged scales), and is at most 256 values (one slot a row) below
    segments of 256, else one segment."""
    c = gm.segment_chunk(k, seg)
    assert k % c == 0 and c % seg == 0 and c // seg <= 32
    if seg >= 256:
        assert c == seg
    else:
        assert c == max(d for d in range(seg, min(k, 256) + 1, seg)
                        if k % d == 0)


@pytest.mark.parametrize("seg", [24, 96, 160, 384, 2048])
def test_segment_chunk_refuses_other_segments(seg):
    """Segments whose lanes would not form aligned shuffle groups, or past
    four slots a row, raise NotImplementedError (no served weight has
    them)."""
    with pytest.raises(NotImplementedError, match="segments"):
        gm.segment_chunk(4 * seg * 3, seg)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py runs these "
                    "kernels on the card)")
    return torch.device("cuda")


def _all_bf16_gates(rows, k, device):
    """(gate, up): every finite bf16 bit pattern as gate values, in rows of
    k, and up values in [-1, 1], so that silu(gate) * up stays finite."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    g = bits.view(torch.bfloat16).float()
    g = torch.where(torch.isfinite(g), g, torch.zeros(()))
    g = torch.cat([g, torch.zeros(rows * k - g.numel())]).reshape(rows, k)
    up = torch.rand((rows, k), generator=torch.Generator().manual_seed(k))
    return (g.to(torch.bfloat16).to(device),
            (2 * up - 1).to(torch.bfloat16).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4096, 14336])
@pytest.mark.parametrize("seg", [32, 128])
@pytest.mark.parametrize("mode", ["plain", "silu", "gelu"])
def test_cuda_segments_match_plain(cuda_device, k, seg, mode):
    """Both modes on the card against their plain versions on the same
    inputs at Mixtral's K: codes and scales of every live row bit for bit
    (all-zero rows, a zero segment; NaN in the dead tail tile's rows,
    which are not read); in GLU mode the first 16 rows' gates hold every
    finite bf16 value (up in [-1, 1]); two segments hold an infinity
    (their codes are 0, the IEEE quotients' casts; a NaN, which the
    kernel's maxima skip and the plain version's keep, is left out); one
    launch, counted under its mode."""
    glu, act = mode != "plain", "gelu" if mode == "gelu" else "silu"
    te, live, m_pad = _layout(COUNTS, cuda_device)
    xs = _rows(m_pad, 2 * k if glu else k, live.cpu(), k + seg + glu,
               cuda_device)
    if glu:
        xs[:16, :k], xs[:16, k:] = _all_bf16_gates(16, k, cuda_device)
    xs[20, 5] = float("inf")          # a segment that holds an infinity
    xs[21, 300] = float("inf") if glu else -float("inf")   # act(-inf): NaN
    key = "glu" if glu else "plain"
    before = (gm.quantize_segments.launches,
              gm.quantize_segments.variant_launches[key])
    q, qs = gm.quantize_segments(xs, seg, te, glu=glu, act=act)
    qp, qsp = gm.quantize_segments_plain(xs, seg, glu, act)
    torch.cuda.synchronize()
    assert (gm.quantize_segments.launches,
            gm.quantize_segments.variant_launches[key]) == (before[0] + 1,
                                                           before[1] + 1)
    assert torch.equal(q[live], qp[live])
    assert torch.equal(qs[:, live], qsp[:, live])


def _ratio_segments():
    """Segments of 128 bf16 values (the segment's max first) that hold,
    for every bf16 max m in [1, 2), every bf16 value of magnitude up to m
    and above m / 2^10 (codes 0 to 127: every mantissa pair and exponent
    gap), both signs; the same scaled by 2^100 and 2^-100 (the latter
    straddling the scale's floor of 1e-30); and every bf16 value up to
    1e-30 under the largest such max (the floor's scale)."""
    mant = 1 + torch.arange(128, dtype=torch.float32) / 128
    cand = (mant[:, None] * 2.0 ** torch.arange(-10, 1)).flatten()
    cand = torch.cat([cand, -cand])
    bits = torch.arange(1, 0x7f80, dtype=torch.int32).to(torch.int16)
    tiny = bits.view(torch.bfloat16).float()
    tiny = tiny[tiny <= 1e-30]
    sets = [(m, cand[cand.abs() <= m]) for m in mant.tolist()]
    sets += [(m * s, c * s) for m, c in sets[:128] for s in (2.0 ** 100,
                                                             2.0 ** -100)]
    sets.append((tiny.max().item(), torch.cat([tiny, -tiny])))
    segs = []
    for m, c in sets:
        n = -(-c.numel() // 127)
        c = torch.cat([c, torch.zeros(n * 127 - c.numel())]).reshape(n, 127)
        segs.append(torch.cat([torch.full((n, 1), m), c], 1))
    segs = torch.cat(segs)
    assert torch.equal(segs.to(torch.bfloat16).float(), segs)
    return segs


@pytest.mark.cuda
def test_cuda_segment_codes_every_bf16_ratio(cuda_device):
    """9q's quotient (a reciprocal of the scale once a segment, then
    Markstein's correction) gives IEEE division's codes for every bf16
    value against every bf16 segment max (`_ratio_segments`), in both
    modes (GLU with up = 1, whose SiLU maps gate values onto other bf16
    values); scales bit for bit."""
    segs = _ratio_segments()
    k = 4096
    per_row = k // 128
    rows = -(-segs.shape[0] // per_row)
    m_pad = -(-rows // BM) * BM
    x = torch.zeros(m_pad * per_row, 128)
    x[:segs.shape[0]] = segs
    x = x.reshape(m_pad, k).to(torch.bfloat16).to(cuda_device)
    te = torch.zeros(m_pad // BM, dtype=torch.int32, device=cuda_device)
    for glu in (False, True):
        xs = torch.cat([x, torch.ones_like(x)], 1) if glu else x
        q, qs = gm.quantize_segments(xs, 128, te, glu=glu)
        qp, qsp = gm.quantize_segments_plain(xs, 128, glu)
        torch.cuda.synchronize()
        assert torch.equal(q, qp)
        assert torch.equal(qs, qsp)


@pytest.mark.cuda
@pytest.mark.parametrize("k,seg", [(64, 32), (192, 64), (256, 8),
                                   (1024, 1024), (768, 768), (4096, 256)])
@pytest.mark.parametrize("glu", [False, True])
def test_cuda_segments_at_other_shapes_match_plain(cuda_device, k, seg, glu):
    """The tiny models' widths and the other segment sizes the planner
    takes (8-64 values; one segment a chunk of one to four slots), bit for
    bit on every live row."""
    te, live, m_pad = _layout(COUNTS, cuda_device)
    xs = _rows(m_pad, 2 * k if glu else k, live.cpu(), k * seg + glu,
               cuda_device)
    q, qs = gm.quantize_segments(xs, seg, te, glu=glu)
    qp, qsp = gm.quantize_segments_plain(xs, seg, glu)
    torch.cuda.synchronize()
    assert torch.equal(q[live], qp[live])
    assert torch.equal(qs[:, live], qsp[:, live])


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_cuda_grouped_glu_is_the_eager_route(cuda_device, bits, act):
    """#9 with `glu=True` (gate | up into the pre-pass) on the card gives
    #9's bits on the eager GLU rows on every live row, at Mixtral's w_out
    K = 14336 and g128, with one GLU pre-pass launch."""
    k, n = 14336, 256
    te, live, m_pad = _layout(COUNTS, cuda_device)
    gu = _rows(m_pad, 2 * k, live.cpu(), 41 + bits, cuda_device)
    qw = _stacked_qw(len(COUNTS), k, n, bits, 128, bits, cuda_device)
    before = gm.quantize_segments.variant_launches["glu"]
    got = gm.grouped_dequant_matmul(gu, qw, te, glu=True, act=act)
    torch.cuda.synchronize()
    assert gm.quantize_segments.variant_launches["glu"] == before + 1
    ref = gm.grouped_dequant_matmul(_eager_glu(gu, act), qw, te)
    torch.cuda.synchronize()
    assert torch.equal(got[live], ref[live])
    assert torch.isfinite(got[live]).all()


@pytest.mark.cuda
def test_cuda_grouped_glu_refuses_weight_only(cuda_device):
    """The GLU is computed in the a8 pre-pass: a weight-only w_out with
    `glu=True` raises on the card."""
    te, live, m_pad = _layout(COUNTS, cuda_device)
    gu = _rows(m_pad, 512, live.cpu(), 1, cuda_device)
    qw = _stacked_qw(len(COUNTS), 256, 64, 4, 32, 2, cuda_device)
    qw = QuantizedTensor(qw.data, qw.scales, None, 4, 32, 0)
    with pytest.raises(NotImplementedError, match="pre-pass"):
        gm.grouped_dequant_matmul(gu, qw, te, glu=True)
