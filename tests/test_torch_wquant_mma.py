"""Kernel #1's tensor-core route (csrc/dequant_matmul.cu `mma_kernel`):
what runs here without a card.

- The weight-only prologue's plain version (`stage_activations_plain`:
  the staged activations and the RMSNorm row factor, computed once per
  row) composed with the product-only plain version
  (`dequant_product_plain`) gives `dequant_matmul_plain`'s bits, and is
  held against the Pallas kernel in interpret mode as
  tests/test_torch_wquant.py holds the plain version.
- The host-side planner (`mma_plan`, `mma_flush_points`) at the shapes of
  the models the package serves and at ragged ones.
- The route: the GEMV for M <= GEMV_MAX_M, the tensor-core kernel above,
  one Python function whose choice the C side is handed, and the launch
  counter's keys.

Inputs are made with numpy from fixed seeds. The kernel itself runs only
on a card (the `cuda` tests of tests/test_torch_wquant.py and
chip_smoke.py).
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.ops.pallas.dequant_matmul import dequant_matmul_fused
from deeppowers_tpu.quant import quantize as jax_quantize

from deeppowers_tpu_torch.ops.kernels import dequant_matmul as dm
from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor

torch.set_num_threads(1)

CSRC = Path(dm.__file__).resolve().parents[2] / "csrc" / "dequant_matmul.cu"
GEMV_SRC = CSRC.with_name("gemv.cu")

# (rms, glu, act, residual, bias)
FOLDS = {
    "plain": (False, False, "silu", False, False),
    "plain_bias": (False, False, "silu", False, True),
    "rms": (True, False, "silu", False, False),
    "rms_bias": (True, False, "silu", False, True),
    "glu_silu_residual": (False, True, "silu", True, False),
    "glu_gelu": (False, True, "gelu", False, False),
}


def _weight(rng, k, n, bits, group):
    w = jnp.asarray(rng.standard_normal((k, n)) * 0.05, jnp.float32)
    return jax_quantize(w, bits=bits, group_size=group)


def _port_qw(qw) -> QuantizedTensor:
    return QuantizedTensor(torch.from_numpy(np.array(qw.data)),
                           torch.from_numpy(np.array(qw.scales)), None,
                           qw.bits, qw.group_size, qw.act_bits)


def _inputs(rng, fold, m, k, n, dtype):
    """x and the fold's keyword arguments, as torch tensors of `dtype`
    (bias f32), and the same values for JAX."""
    rms, glu, act, res, bias = FOLDS[fold]

    def pair(a):
        j = jnp.asarray(a, jnp.float32).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(dtype)

    xj, xt = pair(rng.standard_normal((m, 2 * k if glu else k)))
    kw_j, kw_t = {"act": act}, {"act": act}
    if rms:
        kw_j["rms_weight"], kw_t["rms_weight"] = pair(
            1.0 + 0.2 * rng.standard_normal(k))
        kw_j["rms_eps"] = kw_t["rms_eps"] = 1e-5
    if glu:
        kw_j["glu"] = kw_t["glu"] = True
    if res:
        kw_j["residual"], kw_t["residual"] = pair(rng.standard_normal((m, n)))
    if bias:
        b = np.asarray(0.1 * rng.standard_normal(n), np.float32)
        kw_j["bias"], kw_t["bias"] = jnp.asarray(b), torch.from_numpy(b)
    return (xj, kw_j), (xt, kw_t)


def _staged(x, qw, k, out_dtype, kw):
    a, rf = dm.stage_activations_plain(
        x, k, rms_weight=kw.get("rms_weight"), rms_eps=kw.get("rms_eps", 1e-6),
        glu=kw.get("glu", False), act=kw["act"])
    return dm.dequant_product_plain(
        a, qw.data, qw.scales, bits=qw.bits, rf=rf, bias=kw.get("bias"),
        residual=kw.get("residual"), out_dtype=out_dtype)


@pytest.mark.parametrize("fold", sorted(FOLDS))
@pytest.mark.parametrize("bits,group", [(8, 0), (8, 32), (4, 0), (4, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_staged_product_is_the_plain_version_bit_for_bit(dtype, bits, group,
                                                         fold):
    """The prologue once per row, then the product: the same bits as
    `dequant_matmul_plain`, in f32 and in bf16, for every fold (K = 96
    puts int4's plane boundary inside group 1 of 32)."""
    rng = np.random.default_rng(7 + bits + group + len(fold))
    m, k, n = 24, 96, 72
    qw = _port_qw(_weight(rng, k, n, bits, group))
    _, (x, kw) = _inputs(rng, fold, m, k, n, dtype)
    got = _staged(x, qw, k, dtype, kw)
    ref = dm.dequant_matmul_plain(x, qw.data, qw.scales, bits=bits,
                                  out_dtype=dtype, **kw)
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("fold", ["plain", "rms_bias", "glu_silu_residual"])
@pytest.mark.parametrize("bits,group", [(4, 0), (4, 128), (8, 0), (8, 128)])
def test_staged_product_matches_pallas(bits, group, fold):
    """The composition against the Pallas kernel in interpret mode, with
    test_weight_only_plain_matches_pallas's blocks and tolerance (1e-3 of
    max|ref| for f32 out): the same bf16 activation block on both sides;
    left over the f32 summation order and silu's last bit."""
    rng = np.random.default_rng(300 + bits + group)
    m, k, n = 40, 256, 384
    qw = _weight(rng, k, n, bits, group)
    (xj, kw_j), (xt, kw_t) = _inputs(rng, fold, m, k, n, torch.bfloat16)
    kw_j.pop("act")
    ref = dequant_matmul_fused(xj, qw, out_dtype=jnp.float32, block_n=256,
                               block_k=min(128, group or 128), **kw_j)
    got = _staged(xt, _port_qw(qw), k, torch.float32, kw_t)
    ref = np.asarray(ref, np.float32)
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err < 1e-3


def test_stage_activations_on_cpu_is_the_plain_version():
    x = torch.randn(20, 128).to(torch.bfloat16)
    g = torch.randn(64).to(torch.bfloat16)
    before = dm.stage_activations.launches
    a, rf = dm.stage_activations(x[:, :64], 64, rms_weight=g)
    a2, rf2 = dm.stage_activations_plain(x[:, :64], 64, rms_weight=g)
    assert torch.equal(a, a2) and torch.equal(rf, rf2)
    a, rf = dm.stage_activations(x, 64, glu=True, act="gelu")
    assert rf is None and a.shape == (20, 64) and a.dtype == torch.bfloat16
    assert dm.stage_activations.launches == before


# (K, N) of each matrix a served model's matmuls take through #1, and
# ragged ones: TinyLlama-1.1B (wqkv, wo, w_gu, w_out, lm_head), Llama-2-7B,
# Mixtral-8x7B's attention, router-free cat path and head, lm124_ckpt's
# GPT-2 shapes with its 260-wide head, and the odd widths chip_smoke.py
# holds (N % 16 != 0, K % 32 != 0, int4's plane boundary inside a group)
SHAPES = {
    "tinyllama": [(2048, 2560), (2048, 2048), (2048, 11264), (5632, 2048),
                  (2048, 32000)],
    "llama2-7b": [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
                  (4096, 32000)],
    "mixtral": [(4096, 6144), (4096, 4096), (4096, 229376), (14336, 4096),
                (4096, 32000)],
    "lm124": [(768, 2304), (768, 768), (768, 3072), (3072, 768), (768, 260)],
    "ragged": [(96, 128), (1408, 260), (1344, 4099), (1000, 4099),
               (2048, 4099), (768, 260)],
}
MS = [9, 16, 17, 24, 32, 33, 40, 48, 49, 64, 65, 100, 128, 300, 512, 1024]


def _cases():
    for model, shapes in SHAPES.items():
        for k, n in shapes:
            for bits in (8, 4):
                for group in (0, 32, 128):
                    if group and k % group or bits == 4 and k % 2:
                        continue
                    for a8 in (False, True):
                        rows = k // 2 if bits == 4 else k
                        if a8 and rows % 4:
                            continue
                        yield model, k, n, bits, group, a8


@pytest.mark.parametrize("model", sorted(SHAPES))
def test_mma_plan_keeps_tiles_groups_and_flushes(model):
    """Brute force over M and every weight variant: the token tile is a
    wgmma N of both atoms (a multiple of 8 in 8..256) that holds M when M
    <= 64; the stage depth divides the group; the chunks tile K in
    multiples of the stage depth, itself a multiple of 32 (so a8 chunks hold
    whole quads of stored rows, in either int4 plane); no chunk crosses a
    scale group, a straddling int4 group included (groups are counted in
    unpacked rows, which the kernel walks in order); every group end and
    every chunk end is a flush point, and nothing else is."""
    for mod, k, n, bits, group, a8 in _cases():
        if mod != model:
            continue
        rows_g = k // group if group else 1
        g = group or k
        for m in MS:
            p = dm.mma_plan(m, k, n, rows_g)
            assert p.bn % 8 == 0 and 8 <= p.bn <= 256
            assert p.bn in dm.MMA_TOKEN_TILES
            if m <= 64:
                assert p.bn >= m and p.m_tiles == 1
            assert p.m_tiles == -(-m // p.bn)
            assert p.n_tiles == -(-n // dm.MMA_NT)
            assert p.bk in dm.MMA_BKS and (not group or g % p.bk == 0)
            assert p.chunk % p.bk == 0 and p.chunk % 4 == 0
            assert p.splits == -(-k // p.chunk)
            if group:
                assert p.chunk % g == 0 or g % p.chunk == 0
            points = dm.mma_flush_points(k, g, p.chunk, p.bk)
            assert len(points) == p.splits
            ends = set()
            for s, pts in enumerate(points):
                k0, end = s * p.chunk, min(k, (s + 1) * p.chunk)
                assert pts[-1] == end
                start = k0
                for e in pts:
                    # the rows flushed at e lie in one group
                    assert start // g == (e - 1) // g
                    start = e
                ends.update(pts)
            group_ends = set(range(g, k + 1, g)) | {k}
            assert group_ends <= ends
            assert ends <= group_ends | {min(k, c) for c in range(
                p.chunk, k + p.chunk, p.chunk)}


@pytest.mark.parametrize("model", ["tinyllama", "llama2-7b"])
def test_mma_plan_fills_the_card_at_a_verify_step(model):
    """At M = 40 (8 slots x a window of 5) every matrix of TinyLlama and
    of the 7B runs at least two blocks an SM of an H100 (264), for
    per-channel and g128 scales alike: the step is bytes-bound and the
    weight has to stream from every SM."""
    for k, n in SHAPES[model]:
        for rows_g in (1, k // 128):
            p = dm.mma_plan(40, k, n, rows_g)
            assert p.bn == 48
            assert p.m_tiles * p.n_tiles * p.splits >= 264


def test_mma_plan_does_not_split_a_full_prefill():
    """A 512-token prefill of the 7B fills the card without a split;
    TinyLlama's narrow wo does not, and is split in two."""
    for k, n in SHAPES["llama2-7b"]:
        assert dm.mma_plan(512, k, n, 1).splits == 1
    assert dm.mma_plan(512, 2048, 2048, 1).splits == 2


def test_route_is_one_function_the_c_side_is_handed():
    """`route` alone picks the kernel: the GEMV at or below GEMV_MAX_M,
    the tensor-core kernel above; the wrapper passes its index in
    `ROUTES`, which is the C side's numbering, and the C side's GEMV
    takes at most the rows of its guard (one n8 token tile), so
    GEMV_MAX_M may not exceed it. No other row count decides a route in
    the source."""
    for m in range(1, 600):
        assert dm.route(m) == ("gemv" if m <= dm.GEMV_MAX_M else "mma")
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (ROUTE_\w+) = (\d+);", src))
    assert consts == {"ROUTE_GEMV": str(dm.ROUTES.index("gemv")),
                      "ROUTE_MMA": str(dm.ROUTES.index("mma"))}
    guard = re.search(r"if \(route == ROUTE_GEMV\) \{\s*if \(M > (\d+)", src)
    assert guard and dm.GEMV_MAX_M <= int(guard.group(1))
    assert "M <= 16" not in src
    assert "tiled_wq_kernel" not in src and "tiled_a8_kernel" not in src


def test_gemv_route_is_one_kernel_and_the_old_gemv_is_gone():
    """The GEMV route of the C side launches one kernel, gemv_kernel
    (csrc/gemv.cu; a cluster of its K splits), and no epilogue after it
    (the splits meet in distributed shared memory); the split-K GEMV it
    replaced (gemv_wq_kernel, gemv_a8_kernel and the host's gemv_chunk)
    is gone from the sources and the wrapper."""
    src = CSRC.read_text()
    body = src[src.index("if (route == ROUTE_GEMV) {"):]
    body = body[:body.index("\n  }\n")]
    assert "gemv_route(" in body and "epilogue_kernel" not in body
    assert "<<<" not in body
    launcher = GEMV_SRC.read_text()
    launcher = launcher[launcher.index("cudaError_t launch_gemv("):]
    launcher = launcher[:launcher.index("\n}\n")]
    assert launcher.count("cudaLaunchKernelEx(") == 1
    assert "<<<" not in launcher and "gemv_kernel<" in launcher
    for old in ("gemv_wq_kernel", "gemv_a8_kernel", "gemv_dp4a",
                "gemv_nibbles", "launch_gemv_ct"):
        assert old not in src and old not in GEMV_SRC.read_text()
    assert not hasattr(dm, "gemv_chunk") and not hasattr(dm, "_fit_chunk")


@pytest.mark.parametrize("m,n,bits,group,act_bits,keys", [
    (8, 4096, 8, 0, 0, ("n8", "w8", "gemv")),
    (40, 260, 8, 0, 0, ("n4", "w8", "mma")),
    (512, 4099, 4, 128, 8, ("n1", "w4a8g", "mma")),
    (8, 256, 4, 0, 8, ("n8", "w4a8", "gemv")),
    (16, 256, 4, 0, 8, ("n8", "w4a8", "mma")),
    (17, 256, 8, 128, 0, ("n8", "w8g", "mma")),
])
def test_launch_keys(m, n, bits, group, act_bits, keys):
    """Each launch is counted under its width class, its weight variant
    and its route ("gemv" / "mma"), the keys chip_smoke.py's phases read."""
    k = 256
    data = torch.zeros((k // 2 if bits == 4 else k, n), dtype=torch.int8)
    scales = torch.ones((k // group if group else 1, n))
    qw = QuantizedTensor(data, scales, None, bits, group, act_bits)
    assert dm.launch_keys(m, qw) == keys
