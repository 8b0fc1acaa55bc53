"""#4 with a start offset (`flash_attention_chunk`, chunked prefill's
attention) and #9's a8 pre-pass (`quantize_segments`) on the CPU, against
the JAX package, and the host-side planners of both CUDA kernels.

CPU tensors take the plain versions; the kernels run only on a card (the
`cuda` tests in tests/test_torch_kernels.py and tests/test_torch_moe.py,
and chip_smoke.py at the main path's shapes). Inputs are made with numpy
from fixed seeds and handed to both packages.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.ops.attention import attention_chunk as jax_attention_chunk
from deeppowers_tpu.ops.attention import attention_prefill as jax_attention_prefill
from deeppowers_tpu.ops.pallas.dequant_matmul import (
    grouped_dequant_matmul as pallas_grouped)
from deeppowers_tpu.ops.pallas.flash_attention import flash_attention_prefill as jax_flash

from deeppowers_tpu_torch.models import presets
from deeppowers_tpu_torch.ops.attention import attention_chunk, attention_prefill
from deeppowers_tpu_torch.ops.kernels import flash_attention as fa
from deeppowers_tpu_torch.ops.kernels import grouped_matmul as gm
from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor

jq = importlib.import_module("deeppowers_tpu.quant.quantize")

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# #4: the start offset, and prefill unchanged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,c,extra", [(0, 37, 19), (130, 61, 19),
                                           (517, 200, 19), (896, 200, -72)])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_chunk_plain_matches_jax(d, rep, start, c, extra):
    """A chunk of C queries at positions start..start+C (C ragged against
    the kernel's 128-row tiles) over a view of start + C + extra rows:
    longer than the chunk reaches, or (extra < 0, a last chunk padded past
    the cache's end) shorter, where a query past the view sees all of it.
    The entry point's plain version and `attention_chunk` against JAX's
    `attention_chunk`, f32 on both sides, within 1e-5; the CPU path
    launches nothing."""
    rng = np.random.default_rng(1000 * d + 10 * rep + start)
    kh = 2
    h, s = kh * rep, start + c + extra
    q = rng.standard_normal((1, c, h, d)).astype(np.float32)
    k = rng.standard_normal((1, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((1, s, kh, d)).astype(np.float32)
    ref = np.asarray(jax_attention_chunk(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), jnp.int32(start)))
    launches = fa.flash_attention_chunk.launches
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = fa.flash_attention_chunk(tq, tk, tv, start)
    assert fa.flash_attention_chunk.launches == launches
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    # the view cut at start + C, as the model passes it, gives the same rows
    cut = attention_chunk(tq, tk[:, :start + c], tv[:, :start + c], start)
    np.testing.assert_allclose(cut.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_prefill_plain_matches_pallas(d, rep):
    """attention_prefill (dense on the CPU) and #4's plain version, at the
    heads of the 7B / Mixtral (D = 128) and TinyLlama (D = 64), MHA and
    GQA, S not a multiple of the block, against the Pallas kernel in
    interpret mode (2e-3, its block-wise exp) and JAX's dense path (1e-5):
    valid rows only; rows past a length finite."""
    rng = np.random.default_rng(7 * d + rep)
    b, s, kh = 2, 200, 2
    h = kh * rep
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kh, d)).astype(np.float32)
    lens = np.array([1, 157], np.int32)
    kern = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(lens),
                                block_q=128, block_k=128))
    dense = np.asarray(jax_attention_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        lengths=jnp.asarray(lens), use_flash=False))
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lens))
    for got in (fa.flash_attention_prefill(tq, tk, tv, tl).numpy(),
                attention_prefill(tq, tk, tv, lengths=tl).numpy()):
        assert np.isfinite(got).all()
        for i, n in enumerate(lens):
            np.testing.assert_allclose(got[i, :n], kern[i, :n], atol=2e-3)
            np.testing.assert_allclose(got[i, :n], dense[i, :n], atol=1e-5)


# the models whose heads the kernel serves: (H, Kh, D)
HEADS = {name: (c.num_heads, c.kv_heads, c.dim_head) for name, c in (
    ("tinyllama", presets.TINYLLAMA_1_1B), ("llama2-7b", presets.LLAMA2_7B),
    ("mixtral-8x7b", presets.MIXTRAL_8X7B), ("lm124", presets.LM124))}


@pytest.mark.parametrize("model", sorted(HEADS))
def test_tma_view_reads_every_view_the_path_makes(model):
    """The tensor maps read, without a copy, every view the main path
    hands #4 at each served model's heads: q, k, v split from the fused
    projection, contiguous tensors, a slot's cache view cut at any
    length; a base off 16 bytes or heads not contiguous is copied (and
    the copy is readable and equal)."""
    h, kh, d = HEADS[model]
    assert d in fa.HEAD_DIMS
    b, s = 2, 24
    qkv = torch.zeros(b, s, (h + 2 * kh) * d, dtype=torch.bfloat16)
    views = [qkv[..., :h * d].view(b, s, h, d),
             qkv[..., h * d:(h + kh) * d].view(b, s, kh, d),
             qkv[..., (h + kh) * d:].view(b, s, kh, d),
             torch.zeros(b, s, h, d, dtype=torch.bfloat16)]
    cache = torch.zeros(3, 40, kh, d, dtype=torch.bfloat16)
    views += [cache[slot:slot + 1, :w] for slot in range(3)
              for w in range(1, 41)]
    for t in views:
        assert fa.tma_view(t.shape, t.stride(), t.data_ptr()), t.shape
        assert fa._readable(t) is t
    flat = torch.zeros(b * s * kh * d + 8, dtype=torch.bfloat16)
    for off in range(1, 8):                     # bases 2..14 bytes off
        odd = flat[off:off + b * s * kh * d].view(b, s, kh, d)
        assert not fa.tma_view(odd.shape, odd.stride(), odd.data_ptr())
    heads_apart = torch.zeros(b, kh, s, d, dtype=torch.bfloat16).transpose(1, 2)
    for t in (odd, heads_apart):
        r = fa._readable(t)
        assert r is not t and torch.equal(r, t)
        assert fa.tma_view(r.shape, r.stride(), r.data_ptr())


# ---------------------------------------------------------------------------
# #9: the a8 pre-pass, composed with the product
# ---------------------------------------------------------------------------

E, BM = 4, gm.BLOCK_M
COUNTS = (40, 0, 70, 9)


def _routed(k, seed):
    """Routed rows of COUNTS in tiles of BM: (te, te for Pallas with its
    dead tiles on the last live expert, live-row mask, bf16 rows as a JAX
    array and a torch tensor)."""
    sorted_e = torch.repeat_interleave(torch.arange(E), torch.tensor(COUNTS))
    _, te, m_pad = gm.expert_tiles(sorted_e, torch.tensor(COUNTS))
    te_j = te.numpy().copy()
    live = te_j >= 0
    te_j[~live] = te_j[live][-1]
    rng = np.random.default_rng(seed)
    xj = jnp.asarray(rng.standard_normal((m_pad, k)),
                     jnp.float32).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    return te, jnp.asarray(te_j), np.repeat(live, BM), xj, xt


# (bits, group, K): Mixtral's g = 128 and tiny-moe's g = 32, int4 (half-
# split planes of K/2) and int8; per-channel int8 within one K block
A8_CASES = [(4, 128, 512), (8, 128, 512), (4, 32, 256), (8, 32, 256),
            (8, 0, 512)]


@pytest.mark.parametrize("bits,group,k", A8_CASES)
def test_quantize_segments_composed_is_grouped_plain(bits, group, k):
    """#9 under a8 on the card is the pre-pass then the product. Their
    plain versions composed give `grouped_dequant_matmul_plain`'s bits,
    and the Pallas kernel's (interpret mode) on every live row; the
    pre-pass's codes reconstruct each row within half a step."""
    te, te_j, live, xj, xt = _routed(k, 31 * bits + group + k)
    rng = np.random.default_rng(k + bits)
    w = jnp.asarray(rng.standard_normal((E, k, 96)) * 0.05, jnp.float32)
    qw = dataclasses.replace(jq.quantize_stacked(w, bits=bits,
                                                 group_size=group), act_bits=8)
    pw = QuantizedTensor(torch.from_numpy(np.array(qw.data)),
                         torch.from_numpy(np.array(qw.scales)), None, bits,
                         group, 8)
    seg = group or k
    assert gm.a8_per_group(bits, k, group)
    launches = gm.quantize_segments.launches
    q, qs = gm.quantize_segments(xt, seg, te)
    assert gm.quantize_segments.launches == launches     # the CPU path
    assert q.dtype == torch.int8 and q.shape == xt.shape
    assert qs.shape == (k // seg, xt.shape[0]) and qs.dtype == torch.float32
    assert q.abs().max() <= 127
    step = qs.t().repeat_interleave(seg, 1)
    # half a step, and the f32 rounding of q * step at an exact tie
    assert ((q.float() * step - xt.float()).abs()
            <= step / 2 + xt.float().abs() * 2 ** -22).all()
    got = gm.grouped_a8_product_plain(q, qs, pw, te).numpy()
    plain = gm.grouped_dequant_matmul_plain(xt, pw, te).numpy()
    np.testing.assert_array_equal(got[live], plain[live])
    ref = np.asarray(pallas_grouped(xj, qw, te_j, out_dtype=jnp.float32,
                                    block_m=BM))
    np.testing.assert_array_equal(got[live], ref[live])


def test_grouped_a8_product_refuses_per_block_segments():
    """Where the Pallas segments are K blocks, not groups (per-channel
    int8 over two blocks), the product behind the pre-pass refuses, as the
    card path does."""
    pw = QuantizedTensor(torch.zeros(E, 2048, 64, dtype=torch.int8),
                         torch.ones(E, 1, 64), None, 8, 0, 8)
    q = torch.zeros(BM, 2048, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="not scale groups"):
        gm.grouped_a8_product_plain(q, torch.ones(1, BM), pw,
                                    torch.zeros(1, dtype=torch.int32))


# the served MoE models' expert matrices: (K, group) of w_out and w_gu
MOE_SHAPES = [(14336, 128), (4096, 128), (512, 32), (256, 32), (1024, 0)]


@pytest.mark.parametrize("k,group", MOE_SHAPES)
def test_stage_depth_keeps_groups_whole(k, group):
    """#9's stage depth over every group size that divides K (a multiple
    of 32), and the served ones: 64 rows where the group allows, else 32;
    a stage never crosses a group."""
    for g in [group or k] + [g for g in range(32, k + 1, 32) if k % g == 0]:
        bk = gm.stage_depth(g)
        assert bk in (32, 64) and g % bk == 0
        assert (bk == 64) == (g % 64 == 0)
