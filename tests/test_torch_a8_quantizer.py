"""The W8A8 / W4A8 row quantizer (1q) of the port.

CPU: a numpy emulation of the kernel's arithmetic at the planner's split
-- a row is a thread-block cluster of `quant_plan` blocks, block r its
slice, thread t its items -- takes the partial sums of squares in the
kernel's order (a thread's values in sequence with fused multiply-adds,
a warp's butterfly, the warps in order, then the cluster's blocks in rank
order), the absmax over the blocks, and each value's quantization by IEEE
f32 division and rint (half to even). It is held against the port's
`quantize_rows` behind the unfused norm or GLU and against the JAX
package's own quantization: plain rows bit for bit; behind RMSNorm or a
GLU at most one step on at most 1e-3 of the bytes (a sum of squares in
another order, an activation's last bit). Then the planners over every
a8 matmul of the presets.

Card (`cuda` marker, skipped here): the row quantizer against its plain
version at the 7B's and Mixtral's K, and the a8 GEMV after it at their
decode shapes against the plain version. JAX is imported only inside the
CPU tests that compare with it, so the card's run of this file imports no
JAX.
"""

import numpy as np
import pytest
import torch

from deeppowers_tpu_torch.config import QuantConfig, QuantMode
from deeppowers_tpu_torch.models import presets
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
from deeppowers_tpu_torch.quant.quantize import quantize_rows

torch.set_num_threads(1)

EPS = 1e-6
F32 = np.float32
# K of the emulation: the tiny configs' widths, the 7B's hidden and ffn
# widths, a row past one block (16400: a cluster of five at M = 1) and
# Mixtral's cat w_out rows (114688)
EMU_KS = [64, 128, 4096, 11008, 16400, 114688]
EMU_MS = [1, 5, 8]
MODES = ["plain", "rms", "glu"]


def _bf16(a) -> np.ndarray:
    """f32 values rounded to bf16 (to nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(a, F32)).to(
        torch.bfloat16).float().numpy()


def _inputs(seed, m, k, mode):
    """bf16 rows (M, K), or (M, 2K) gate|up for the GLU, and an RMSNorm
    weight, made with numpy from a seed; one row is zero when M > 4."""
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((m, 2 * k if mode == "glu" else k))
              * 10.0 ** rng.uniform(-2, 1, (m, 1)))
    if m > 4:
        x[3] = 0
    g = _bf16(rng.standard_normal(k) * 0.1 + 1.0)
    return x, g


def _sumsq_seq(v):
    """Sums of squares along the last axis in order, each step one fused
    multiply-add rounded to f32 (nvcc contracts ss += v * v): v holds bf16
    values, whose squares f64 holds exactly."""
    acc = np.zeros(v.shape[:-1], F32)
    for i in range(v.shape[-1]):
        acc = (acc.astype(np.float64)
               + v[..., i].astype(np.float64) ** 2).astype(F32)
    return acc


def _warp_sum(v):
    """A warp's butterfly (`warp_sum`: xor 16, 8, 4, 2, 1) over the last
    axis (32 lanes), in f32; lane 0's result."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lanes ^ o]).astype(F32)
    return v[..., 0]


def _seq_sum(v):
    """A sum along the last axis in order, in f32, from the first term."""
    acc = v[..., 0].astype(F32)
    for i in range(1, v.shape[-1]):
        acc = (acc + v[..., i]).astype(F32)
    return acc


def _act(gate):
    """The row quantizer's SiLU (`act_ops`), as XLA's unfused bf16 ops
    compute it: g * (1 / (1 + exp(-g))), each op rounded to bf16."""
    gate = gate.astype(F32)
    e = _bf16(np.exp(-gate).astype(F32))
    r = _bf16((F32(1) / _bf16(F32(1) + e)).astype(F32))
    return _bf16(gate * r)


def _a8_values(x, g, mode, k, rf):
    """The a8 matmul's input as both kernels compute it (`a8_of`):
    round_bf16(x * rf * g) with the row factor rf (M, 1), act(gate) * up
    with act in bf16 op by op and the product in f32 (exact), or x."""
    if mode == "glu":
        return (_act(x[:, :k]) * x[:, k:]).astype(F32)
    if mode == "rms":
        return _bf16((x * rf).astype(F32) * g)
    return x


def _quantize(a, amax):
    """s = max(amax, 1e-8) * fl(1/127); q = clip(rint(a / s), +-127) by
    IEEE f32 division, half to even."""
    s = (np.maximum(amax, F32(1e-8)) * F32(1.0 / 127.0)).astype(F32)
    q = np.clip(np.rint((a / s[:, None]).astype(F32)), -127, 127)
    return q.astype(np.int8), s


def _rf(tot, k):
    """rsqrt(tot / K + eps) in f32."""
    mean = (tot / F32(k)).astype(F32)
    return (F32(1) / np.sqrt(mean + F32(EPS))).astype(F32)


def emulate_row_quantizer(x, g, mode, k, plan):
    """The row quantizer's arithmetic (csrc/dequant_matmul.cu
    `quantize_rows_kernel`) at `plan`: block r of a row's cluster holds
    activations r * slice.., thread t its items i at (i * QUANT_THREADS +
    t) * QUANT_ITEM; (q (M, K) int8, s (M,) f32)."""
    m = x.shape[0]
    cap = dm.QUANT_THREADS * dm.QUANT_ITEM * dm.QUANT_ITEMS
    assert plan.slice <= cap and plan.blocks <= dm.QUANT_CLUSTER
    assert (plan.blocks - 1) * plan.slice < k <= plan.blocks * plan.slice
    rf = np.ones((m, 1), F32)
    if mode == "rms":
        held = np.zeros((m, plan.blocks * cap), F32)
        for r in range(plan.blocks):
            piece = x[:, r * plan.slice:min(k, (r + 1) * plan.slice)]
            held[:, r * cap:r * cap + piece.shape[1]] = piece
        # (M, blocks, items, threads, item) -> each thread's values in order
        held = held.reshape(m, plan.blocks, dm.QUANT_ITEMS,
                            dm.QUANT_THREADS, dm.QUANT_ITEM)
        seq = held.transpose(0, 1, 3, 2, 4).reshape(
            m, plan.blocks, dm.QUANT_THREADS, -1)
        warps = _warp_sum(_sumsq_seq(seq).reshape(m, plan.blocks, -1, 32))
        blocks = _seq_sum(warps)                       # (M, blocks)
        tot = np.zeros(m, F32)
        for r in range(plan.blocks):                   # rank order
            tot = (tot + blocks[:, r]).astype(F32)
        rf = _rf(tot, k)[:, None]
    a = _a8_values(x, g, mode, k, rf)
    return _quantize(a, np.abs(a).max(-1))


def _port_reference(x, g, mode, k):
    """The port's plain quantizer behind the unfused ops (what
    `dequant_matmul_plain` quantizes)."""
    xt = torch.from_numpy(x).to(torch.bfloat16)
    gt = torch.from_numpy(g).to(torch.bfloat16)
    q, s = dm.quantize_activations(xt, k, rms_weight=gt if mode == "rms"
                                   else None, rms_eps=EPS, glu=mode == "glu")
    return q.numpy(), s.numpy()[:, 0]


def _jax_reference(x, g, mode, k):
    """The JAX package's own: its RMSNorm in bf16 (as `rms_matmul`
    computes it ahead of `_w8a8_matmul`), then the first lines of
    `_w8a8_matmul` (deeppowers_tpu/ops/matmul.py:57-59) jitted, as the JAX
    engine runs them; a copy, since the package returns only products of
    the bytes. GLU rows are act(gate) * up as `glu_matmul`'s XLA path
    computes them (ops/matmul.py:171-173)."""
    import jax
    import jax.numpy as jnp
    from deeppowers_tpu.ops.normalization import rms_norm as jrms

    @jax.jit
    def run(xb, gb):
        a = jrms(xb, gb, eps=EPS) if mode == "rms" else xb
        if mode == "glu":
            a = jax.nn.silu(xb[:, :k]) * xb[:, k:]
        xf = a.astype(jnp.float32)
        absmax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
        xs = jnp.maximum(absmax, 1e-8) / 127.0
        return jnp.clip(jnp.round(xf / xs), -127, 127).astype(jnp.int8), xs

    q, s = run(jnp.asarray(x).astype(jnp.bfloat16),
               jnp.asarray(g).astype(jnp.bfloat16))
    return np.asarray(q), np.asarray(s)[:, 0]


def _agree(mode, q, s, q_ref, s_ref, what):
    """Plain rows bit for bit; behind a norm or a GLU at most one step on
    at most 1e-3 of the bytes, and scales within one bf16 step."""
    diff = np.abs(q.astype(np.int32) - q_ref.astype(np.int32))
    if mode == "plain":
        np.testing.assert_array_equal(q, q_ref, err_msg=what)
        np.testing.assert_array_equal(s, s_ref, err_msg=what)
        return
    assert diff.max() <= 1, what
    assert (diff > 0).mean() <= 1e-3, (what, int((diff > 0).sum()))
    np.testing.assert_allclose(s, s_ref, rtol=1e-2, err_msg=what)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", EMU_MS)
@pytest.mark.parametrize("k", EMU_KS)
def test_emulated_row_quantizer_matches_quantize_rows(k, m, mode):
    """The row quantizer's arithmetic, emulated at `quant_plan`'s split,
    against the port's plain quantizer."""
    x, g = _inputs(k + 31 * m + MODES.index(mode), m, k, mode)
    q_ref, s_ref = _port_reference(x, g, mode, k)
    plan = dm.quant_plan(m, k, mode == "glu")
    q, s = emulate_row_quantizer(x, g, mode, k, plan)
    _agree(mode, q, s, q_ref, s_ref, f"K={k} M={m} plan {plan}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m,k", [(8, 64), (8, 4096), (8, 11008), (1, 16400),
                                 (8, 114688), (40, 114688)])
def test_emulated_row_quantizer_matches_the_jax_package(m, k, mode):
    """The same emulation against the JAX package's unfused RMSNorm and
    its `_w8a8_matmul` quantization (a copy of its lines), at one block a
    row and at clusters of 5, 16 and 7."""
    x, g = _inputs(7 * k + m + MODES.index(mode), m, k, mode)
    q_ref, s_ref = _jax_reference(x, g, mode, k)
    q, s = emulate_row_quantizer(x, g, mode, k,
                                 dm.quant_plan(m, k, mode == "glu"))
    _agree(mode, q, s, q_ref, s_ref, f"K={k} M={m}")


@pytest.mark.parametrize("mode", MODES)
def test_port_quantizer_matches_the_packages_w8a8_path(mode):
    """Through the JAX package's own a8 matmuls on the XLA path, jitted
    (`quantized_matmul`; `rms_matmul` for RMSNorm rows), with an int8
    identity weight of unit scales, each output is f32(q) * s: the port's
    plain quantizer behind its unfused ops equals it bit for bit at K = 64
    and 4096. GLU rows are `glu_matmul`'s XLA path: JAX's own SiLU, then
    the product (ops/matmul.py:171-173)."""
    import jax
    import jax.numpy as jnp
    from deeppowers_tpu.ops import matmul as jmm
    from deeppowers_tpu.quant.qtypes import QuantizedTensor as JQT
    for k in (64, 4096):
        x, g = _inputs(k + MODES.index(mode), 8, k, mode)
        eye = JQT(jnp.eye(k, dtype=jnp.int8), jnp.ones((1, k), jnp.float32),
                  None, 8, 0, 8)
        gb = jnp.asarray(g).astype(jnp.bfloat16)
        if mode == "rms":
            fn = jax.jit(lambda v: jmm.rms_matmul(v, gb, eye, eps=EPS,
                                                  out_dtype=jnp.float32))
        elif mode == "glu":
            fn = jax.jit(lambda v: jmm.quantized_matmul(
                jax.nn.silu(v[:, :k]) * v[:, k:], eye,
                out_dtype=jnp.float32, prefer_pallas=False))
        else:
            fn = jax.jit(lambda v: jmm.quantized_matmul(
                v, eye, out_dtype=jnp.float32, prefer_pallas=False))
        ref = np.asarray(fn(jnp.asarray(x).astype(jnp.bfloat16)))
        q, s = _port_reference(x, g, mode, k)
        np.testing.assert_array_equal(q.astype(F32) * s[:, None], ref)


# ---------------------------------------------------------------------------
# the planners over the presets' a8 matmuls


def _a8_shapes(cfg, group):
    """(name, K, N) of every matmul a decode step of `cfg` runs through #1
    under a quantized recipe of `group`, after `fuse_params`: wqkv, wo,
    the MLP's (w_gu | w_in, w_out), or the experts: with per-group scales
    the cat (w_gu over E x 2I columns, w_out over E x I rows), else each
    expert's w_in, w_gate and w_out; and an untied lm_head."""
    h, q, kv = cfg.hidden_size, cfg.q_size, cfg.kv_size
    out = [("wqkv", h, q + 2 * kv), ("wo", q, h)]
    if cfg.num_experts and group:
        e, i = cfg.num_experts, cfg.ffn_size
        out += [("w_gu cat", h, e * 2 * i), ("w_out cat", e * i, h)]
    elif cfg.num_experts:
        out += [("w_in", h, cfg.ffn_size), ("w_out", cfg.ffn_size, h)]
    elif cfg.glu:
        out += [("w_gu", h, 2 * cfg.ffn_size), ("w_out", cfg.ffn_size, h)]
    else:
        out += [("w_in", h, cfg.ffn_size), ("w_out", cfg.ffn_size, h)]
    if not cfg.tie_embeddings:
        out.append(("lm_head", h, cfg.vocab_size))
    return out


TINY = {"tiny-test": presets.tiny_test_config(),
        "tiny-llama": presets.tiny_llama_config(),
        "tiny-moe": presets.tiny_moe_config()}
# (recipe, QuantConfig): W8A8 per-channel and W4A8 g32 on the tiny
# configs; the big presets are served W4A8 g128
TINY_RECIPES = {"w8a8": QuantConfig(act_bits=8),
                "w4a8g": QuantConfig(mode=QuantMode.INT4, group_size=32,
                                     act_bits=8)}


def _leaves(tree):
    if isinstance(tree, QuantizedTensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)


@pytest.mark.parametrize("recipe", sorted(TINY_RECIPES))
@pytest.mark.parametrize("name", sorted(TINY))
def test_a8_shapes_are_the_fused_trees(name, recipe):
    """`_a8_shapes` lists what `init_quantized_params` + `fuse_params`
    make: the a8 weights of a tiny config's tree (a stacked expert weight
    by one expert's (K, N))."""
    cfg, qcfg = TINY[name], TINY_RECIPES[recipe]
    tree = T.fuse_params(T.init_quantized_params(
        cfg, qcfg, torch.Generator().manual_seed(0)), cfg)
    got = {tuple(q.shape[-2:]) for q in _leaves(tree) if q.act_bits == 8}
    assert got == {(k, n) for _, k, n in _a8_shapes(cfg, qcfg.group_size)}


def _served():
    """(model, K, N, bits, group) of every a8 matmul the presets reach:
    the 7B and Mixtral W4A8 g128, the tiny configs under both recipes; a
    group that does not divide K is per-channel, as the inits make it."""
    out = []
    for name, cfg in (("llama2-7b", presets.LLAMA2_7B),
                      ("mixtral-8x7b", presets.MIXTRAL_8X7B)):
        out += [(name, k, n, 4, 128) for _, k, n in _a8_shapes(cfg, 128)]
    for name, cfg in TINY.items():
        for qcfg in TINY_RECIPES.values():
            bits = 4 if qcfg.mode == QuantMode.INT4 else 8
            out += [(name, k, n, bits, qcfg.group_size)
                    for _, k, n in _a8_shapes(cfg, qcfg.group_size)]
    return [(m, k, n, b, g if g and k % g == 0 else 0)
            for m, k, n, b, g in out]


SERVED = _served()


@pytest.mark.parametrize("model,k,n,bits,group", SERVED)
def test_a8_splits_over_the_presets(model, k, n, bits, group):
    """For every a8 matmul of the presets: the decode GEMV's chunks cover
    K exactly once in each nibble plane, none crosses a scale group, its
    cluster is at most GEMV_SPLITS blocks; the row quantizer's cluster is
    at most QUANT_CLUSTER blocks at a decode, verify and prefill M, its
    slices cover K once and fit a block's shared memory, and a row a block
    holds is one block."""
    rows_g = k // group if group else 1
    rows = k // 2 if bits == 4 else k
    plan = dm.gemv_plan(k, n, bits, rows_g, True)
    assert 1 <= plan.splits <= dm.GEMV_SPLITS
    cover = np.zeros(rows, np.int32)
    for r in range(plan.splits):
        cover[r * plan.chunk:min(rows, (r + 1) * plan.chunk)] += 1
    assert (cover == 1).all()
    if group:
        offs = [0, k // 2] if bits == 4 else [0]
        for g0 in range(0, k, group):
            for off in offs:
                a = max(g0, off) - off
                b = min(g0 + group, off + rows) - off
                if a < b:
                    assert a // plan.chunk == (b - 1) // plan.chunk
    cap = dm.QUANT_THREADS * dm.QUANT_ITEM * dm.QUANT_ITEMS
    for m in (1, 5, 8, 40, 512):
        for glu in (False, True):
            qp = dm.quant_plan(m, k, glu)
            assert 1 <= qp.blocks <= dm.QUANT_CLUSTER
            assert qp.slice % dm.QUANT_ITEM == 0 and qp.slice <= cap
            assert (qp.blocks - 1) * qp.slice < k <= qp.blocks * qp.slice
            if not glu:
                assert (qp.blocks == 1) == (k <= cap)
            if m * qp.blocks > 132:
                assert qp.blocks == -(-k // cap)


def test_quant_plan_fills_the_card_at_decode():
    """One block a row for plain and RMSNorm rows one block holds (the
    7B's K = 4096, at decode and prefill); GLU rows spread while each
    thread keeps an item (the 7B's 11008: three at decode, one at a
    prefill); sixteen for Mixtral's cat rows of 114688 at a decode step's
    8 rows (128 blocks on 132 SMs), seven (what holds the row) at a verify
    step's 40."""
    assert dm.quant_plan(8, 4096).blocks == 1
    assert dm.quant_plan(8, 11008).blocks == 1
    assert dm.quant_plan(8, 11008, glu=True).blocks == 3
    assert dm.quant_plan(512, 11008, glu=True).blocks == 1
    assert dm.quant_plan(1, 16384).blocks == 1
    assert dm.quant_plan(1, 16385).blocks == 5
    assert dm.quant_plan(8, 114688) == (16, 7168)
    assert dm.quant_plan(40, 114688).blocks == 7
    assert dm.quant_plan(512, 11008).blocks == 1
    assert dm.quant_plan(1, 64) == (1, 64)
    with pytest.raises(NotImplementedError):
        dm.quant_plan(8, 16 * 16384 + 1)


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (chip_smoke.py runs these "
                    "kernels on the card)")
    return torch.device("cuda")


def _random_qw(g, k, n, bits, group):
    """W[4|8]A8 codes and positive scales, made on the card."""
    data = torch.randint(-127, 128, (k // 2 if bits == 4 else k, n),
                         generator=g, device="cuda", dtype=torch.int8)
    scales = (0.02 / (7 if bits == 4 else 127)) * (0.5 + torch.rand(
        k // group if group else 1, n, generator=g, device="cuda"))
    return QuantizedTensor(data, scales, None, bits, group, 8)


# (name, K, N, fusion): the 7B's and Mixtral's a8 decode matmuls, and
# ragged ones: int4's plane boundary inside a group (K = 1408, K not
# split), N no multiple of 16 (cp.async), K = 1344 per-channel
A8_MATS = [("7b wqkv", 4096, 12288, "rms"), ("7b wo", 4096, 4096, "res"),
           ("7b w_gu", 4096, 22016, "rms"),
           ("7b w_out", 11008, 4096, "glu"),
           ("7b lm_head", 4096, 32000, "f32"),
           ("mixtral wqkv", 4096, 6144, "rms"),
           ("mixtral w_gu cat", 4096, 229376, "f32"),
           ("mixtral w_out cat", 114688, 4096, "f32"),
           ("ragged straddle", 1408, 4099, "glu"),
           ("ragged n264", 1344, 264, "rms")]


def _a8_inputs(g, m, k, n, fusion):
    qw = _random_qw(g, k, n, 4, 128 if k % 128 == 0 else 0)
    x = torch.randn(m, 2 * k if fusion == "glu" else k, generator=g,
                    device="cuda").to(torch.bfloat16)
    kw = {}
    if fusion == "rms":
        kw["rms_weight"] = (torch.randn(k, generator=g, device="cuda") * 0.1
                            + 1).to(torch.bfloat16)
    if fusion in ("res", "glu"):
        kw["residual"] = torch.randn(m, n, generator=g, device="cuda").to(
            torch.bfloat16)
    if fusion == "glu":
        kw["glu"] = True
    od = torch.float32 if fusion == "f32" else torch.bfloat16
    return qw, x, kw, od


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 8])
@pytest.mark.parametrize("name,k,n,fusion", A8_MATS)
def test_cuda_a8_gemv_after_the_row_quantizer(cuda_device, name, k, n,
                                              fusion, m):
    """A W4A8 decode product: one row quantizer launch and one GEMV launch,
    against `dequant_matmul_plain` (2e-2 of each row's max|ref|); a
    second call gives the same bits."""
    g = torch.Generator(device="cuda").manual_seed(k + n + m)
    qw, x, kw, od = _a8_inputs(g, m, k, n, fusion)
    q_before = dm.quantize_activations.launches
    before = dm.dequant_matmul.variant_launches["gemv"]
    got = dm.dequant_matmul(x, qw, out_dtype=od, **kw)
    assert dm.quantize_activations.launches == q_before + 1
    assert dm.dequant_matmul.variant_launches["gemv"] == before + 1
    again = dm.dequant_matmul(x, qw, out_dtype=od, **kw)
    ref = dm.dequant_matmul_plain(x, qw.data, qw.scales, bits=4, act_bits=8,
                                  out_dtype=od, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and torch.equal(got, again)
    lim = 2e-2 * ref.float().abs().amax(-1)
    assert ((got.float() - ref.float()).abs().amax(-1) <= lim).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 8, 40])
@pytest.mark.parametrize("k,mode", [(114688, "plain"), (4096, "rms"),
                                    (11008, "glu"), (4096, "plain"),
                                    (16400, "rms"), (114688, "glu"),
                                    (1000, "rms"), (1000, "glu")])
def test_cuda_row_quantizer_matches_plain(cuda_device, k, mode, m):
    """The row quantizer (a cluster of `quant_plan` blocks a row) against
    its plain version on the same bf16 rows, q's rows packed and padded:
    plain rows bit for bit, bytes and scales (a zero row included); behind
    RMSNorm or a GLU at most one step on at most 1e-3 of the bytes. K =
    1000 takes the scalar path (no 16-byte loads past a row's end)."""
    g = torch.Generator(device="cuda").manual_seed(k + m)
    x = torch.randn(m, 2 * k if mode == "glu" else k, generator=g,
                    device="cuda").to(torch.bfloat16)
    if m > 4:
        x[3] = 0
    kw = {"glu": mode == "glu"}
    if mode == "rms":
        kw["rms_weight"] = (torch.randn(k, generator=g, device="cuda") * 0.1
                            + 1).to(torch.bfloat16)
    ref_q, ref_s = dm.quantize_activations(
        x.cpu(), k, **{a: (v.cpu() if torch.is_tensor(v) else v)
                       for a, v in kw.items()})
    for padded in (False, True):
        q, s = dm.quantize_activations(x, k, _padded=padded, **kw)
        torch.cuda.synchronize()
        diff = (q.cpu().int() - ref_q.int()).abs()
        if mode == "plain":
            assert torch.equal(q.cpu(), ref_q) and torch.equal(s.cpu(), ref_s)
        else:
            assert diff.max() <= 1
            assert (diff > 0).float().mean() <= 1e-3
