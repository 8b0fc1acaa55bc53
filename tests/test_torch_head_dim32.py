"""Heads of 32 dims (moelm_ckpt: 8 query and 4 kv heads of 32) in the
attention kernels, which compute them at 64: #3 and its int8-dot variant
3i over contiguous caches read a stored head's bytes followed by as many
zeros (csrc `stored_feature`), and #4 reads 64-dim boxes that the tensor
maps zero-fill past the head's 32 dims.

On the CPU: that layout's arithmetic, by the plain versions themselves.
A 32-dim cache of each store with its head bytes padded by zeros to a
64-dim head, and q placed at the features `stored_feature` maps (int4's
nibble halves apart), gives the 32-dim function: the same codes, scales
and sums, so the outputs agree within f32 rounding. On the card (the
`cuda` marker): both kernels at 32 dims against their plain versions.
No JAX here.
"""

import pytest
import torch

from deeppowers_tpu_torch.ops.kernels import decode_attention as da
from deeppowers_tpu_torch.ops.kernels import flash_attention as fa
from deeppowers_tpu_torch.quant.kvquant import STORE_BITS, quant_side

torch.set_num_threads(1)

STORES = ("bf16", "int8", "int4", "k8v4")
#: (store, int8-dot path): the bf16-dot kernel in every store, 3i in those
#: whose K is int8 bytes
PATHS = [(st, False) for st in STORES] + [(st, True) for st in STORES[1:]]
HQ, KH, D, WIDE = 8, 4, 32, 64


def stored_feature(bits: int, f: int, d: int = WIDE, dr: int = D) -> int:
    """csrc `stored_feature`: the stored feature of wide feature f, or -1."""
    if bits == 4:
        if f < dr // 2:
            return f
        return f - d // 2 + dr // 2 if d // 2 <= f < d // 2 + dr // 2 else -1
    return f if f < dr else -1


def _cache(store, b, s, lens, g):
    """(k, v, kwargs) of a 32-dim cache; rows and scales past each length
    hold NaN or random codes and NaN."""
    kb, vb = STORE_BITS[store]
    stale = torch.arange(s)[None, :] >= torch.tensor(lens)[:, None]

    def side(bits):
        x = torch.randn(b, s, KH, D, generator=g)
        if bits == 16:
            x = x.reshape(b, s, KH * D).to(torch.bfloat16)
            x[stale] = float("nan")
            return x, None
        st, sc = quant_side(x, bits, 2 if bits == 4 else 1)
        sc = sc.transpose(-1, -2).contiguous()
        sc.masked_fill_(stale[:, None, :], float("nan"))
        return st.reshape(b, s, -1), sc
    (kc, ks), (vc, vs) = side(kb), side(vb)
    kw = {} if store == "bf16" else dict(k_scale=ks, v_scale=vs, kv_bits=kb,
                                        v_bits=vb)
    return kc, vc, kw


def _pad_store(c):
    """Each head's stored bytes followed by as many zeros."""
    b, s, f = c.shape
    x = c.reshape(b, s, KH, f // KH)
    return torch.cat([x, torch.zeros_like(x)], -1).reshape(b, s, 2 * f)


def _pad_q(q, bits):
    """q (B, O, 32) at the wide head's features (`stored_feature`)."""
    wide = torch.zeros(*q.shape[:-1], WIDE, dtype=q.dtype)
    for f in range(WIDE):
        r = stored_feature(bits, f)
        if r >= 0:
            wide[..., f] = q[..., r]
    return wide


def _unpad_out(out, bits):
    idx = [next(f for f in range(WIDE) if stored_feature(bits, f) == r)
           for r in range(D)]
    return out[..., idx]


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("store,dots", PATHS, ids=str)
def test_zero_padded_head_keeps_the_function(store, dots, t):
    """The plain versions over the padded layout equal them over the
    32-dim cache (the int8-dot one at the 32-dim cache's block)."""
    kb, vb = STORE_BITS[store]
    g = torch.Generator().manual_seed(len(store) + t + dots)
    b, s = 4, 256
    lens = [1, 60, 130, 256] if t == 1 else [5, 60, 130, 256]
    kc, vc, kw = _cache(store, b, s, lens, g)
    q = torch.randn(b, HQ * t, D, generator=g).to(torch.bfloat16)
    lengths = torch.tensor(lens)
    if dots:
        blk = da.int8_dots_block(s, kc.shape[2])
        ref = da.decode_attention_int8_dots_plain(
            q, kc, vc, lengths, tokens=t, block_s=blk, **kw)
        got = da.decode_attention_int8_dots_plain(
            _pad_q(q, kb), _pad_store(kc), _pad_store(vc), lengths,
            tokens=t, block_s=blk, scale=D ** -0.5, **kw)
    else:
        ref = da.decode_attention_plain(q, kc, vc, lengths, tokens=t, **kw)
        got = da.decode_attention_plain(
            _pad_q(q, kb), _pad_store(kc), _pad_store(vc), lengths,
            tokens=t, scale=D ** -0.5, **kw)
    got = _unpad_out(got, vb)
    assert torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().amax(-1)
    top = ref.float().abs().amax(-1)
    assert (err <= 8e-3 * top).all()


def test_narrow_head_plans_as_the_wide_one():
    """The planner and the int8-dot shared memory take the computed width:
    a 32-dim head plans as a 64-dim one."""
    assert da.compute_dim(32) == 64
    assert da.compute_dim(64) == 64 and da.compute_dim(128) == 128
    for rows in (2, 10, 40):
        assert da.attention_plan(8, KH, 512, rows, da.compute_dim(D)) == \
            da.attention_plan(8, KH, 512, rows, 64)


def test_zero_filled_boxes_keep_flash_attention():
    """#4's narrow head: q, k, v zero-padded from 32 to 64 dims attend as
    the 32-dim head (scale 32^-0.5) in the first 32 output dims, the rest
    zero."""
    g = torch.Generator().manual_seed(4)
    b, s = 2, 96
    q = torch.randn(b, s, HQ, D, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(b, s, KH, D, generator=g).to(torch.bfloat16)
            for _ in range(2))
    lens = torch.tensor([96, 40])
    pad = [torch.nn.functional.pad(x, (0, WIDE - D)) for x in (q, k, v)]
    ref = fa.flash_attention_plain(q, k, v, lens)
    got = fa.flash_attention_plain(*pad, lens, scale=D ** -0.5)
    assert torch.equal(got[..., D:], torch.zeros_like(got[..., D:]))
    err = (got[..., :D].float() - ref.float()).abs().max()
    assert err <= 8e-3 * ref.float().abs().max()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no "
                    "CPU mode): python -m pytest -m cuda "
                    "tests/test_torch_head_dim32.py")
    return torch.device("cuda")


def _check_rows(out, ref):
    assert torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs().amax(-1)
    top = ref.float().abs().amax(-1)
    assert (err <= 1e-2 * top).all(), (err / top.clamp_min(1e-30)).max()


@pytest.mark.cuda
@pytest.mark.parametrize("with_rows", [False, True], ids=["read", "rows"])
@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("store,dots", PATHS, ids=str)
def test_cuda_narrow_head_decode_matches_plain(cuda_device, store, dots, t,
                                               with_rows):
    """#3 (DPT_ATTN_INT8 aside: `int8_dots=` names the kernel) at moelm's
    heads, 8 slots of S = 512 at lengths 0, 1 and across tiles and splits,
    NaN past them; with `rows`, the step's rows written by the launch
    first: bytes and scales equal to the plain route's, each (slot, row)
    within 1e-2 of its max|ref|, two calls identical, one counted launch
    each."""
    dev, s, b = cuda_device, 512, 8
    kb, vb = STORE_BITS[store]
    g = torch.Generator().manual_seed(len(store) * 10 + t + 2 * dots)
    lens = [0, 1, 17, 63, 64, 129, 300, 512]
    if t > 1:
        lens = [n if n == 0 else max(n, t) for n in lens]
    kc, vc, kw = _cache(store, b, s, lens, g)
    q = torch.randn(b, HQ * t, D, generator=g).to(torch.bfloat16)
    new = None
    if with_rows:
        k_new, v_new = (torch.randn(b, t, KH * D, generator=g)
                        .to(torch.bfloat16) for _ in range(2))
        pos = torch.tensor([[n - t + j if n else -1 for j in range(t)]
                            for n in lens], dtype=torch.int32)
        new = da.NewRows(k_new, v_new, pos)
    on = lambda x: None if x is None else x.to(dev)  # noqa: E731
    state = [kc, vc, kw.get("k_scale"), kw.get("v_scale")]
    card = [on(x) for x in state]
    ckw = dict(kw, k_scale=card[2], v_scale=card[3]) if kw else {}
    plain = (da.decode_attention_int8_dots_plain if dots
             else da.decode_attention_plain)
    ref = plain(q, kc, vc, torch.tensor(lens), tokens=t, new=new, **kw)
    cnew = None if new is None else da.NewRows(*(on(x) for x in new[:3]))
    key = ("i8:" if dots else "") + (store if t == 1 else f"{store}:t{t}")
    before = da.decode_attention.variant_launches[key]
    args = (on(q), card[0], card[1], torch.tensor(lens, device=dev))
    out = da.decode_attention(*args, tokens=t, new=cnew, int8_dots=dots,
                              **ckw)
    again = da.decode_attention(*args, tokens=t, new=cnew, int8_dots=dots,
                                **ckw)
    torch.cuda.synchronize()
    _check_rows(out.cpu(), ref)
    assert torch.equal(out, again)
    for x, y in zip(card, state):
        if y is not None:
            bits = torch.int32 if y.dtype == torch.float32 else (
                torch.int16 if y.dtype == torch.bfloat16 else torch.int8)
            assert torch.equal(x.cpu().view(bits), y.view(bits))
    assert da.decode_attention.variant_launches[key] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("s", [128, 512, 700])
def test_cuda_narrow_head_flash_matches_plain(cuda_device, s):
    """#4 at moelm's heads: the prefill over 4 prompts (lengths to S) and a
    chunk of 128 queries at start s - 128, against the plain versions,
    each (position, head) within 1e-2 of its max|ref|."""
    g = torch.Generator().manual_seed(s)
    b = 4
    q = torch.randn(b, s, HQ, D, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(b, s, KH, D, generator=g).to(torch.bfloat16)
            for _ in range(2))
    lens = torch.tensor([s, s - 1, s // 2, 1])
    dev = cuda_device
    before = fa.flash_attention_prefill.launches
    out = fa.flash_attention_prefill(q.to(dev), k.to(dev), v.to(dev),
                                     lens.to(dev))
    torch.cuda.synchronize()
    assert fa.flash_attention_prefill.launches == before + 1
    ref = fa.flash_attention_plain(q, k, v, lens)
    valid = torch.arange(s)[None, :] < lens[:, None]
    _check_rows(out.cpu()[valid], ref[valid])
    start = s - 128
    qc = q[:, start:]
    got = fa.flash_attention_chunk(qc.to(dev), k.to(dev), v.to(dev), start)
    torch.cuda.synchronize()
    _check_rows(got.cpu(), fa.flash_attention_chunk_plain(qc, k, v, start))
