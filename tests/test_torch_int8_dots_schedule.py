"""The schedule of 3i, #3's int8-dot variant (csrc/decode_attention.cuh,
template flag I8), emulated on the CPU in plain PyTorch and held against
`decode_attention_int8_dots_plain`.

The kernel walks each (slot, kv head) in the splits of its launch's plan
(`attention_plan`: nsplit splits of `chunk` positions) and p's granule in
blocks of `int8_dots_block` positions. For each block, each split keeps
its positions' final scores from a first pass over K and finds each row's
max score and max of p times the V scale relative to it; those maxima meet
over the splits (the block's max Mb and max Wb); the second pass takes p
from the kept scores in the frame max(m, Mb), rs = max(Wb in that frame,
1e-30) * fl(1/127), the codes rint(p * vs / rs) (0 where p is 0), and the
exact p.V of the codes times rs; the splits' partials merge at the end.
`emulate` below is that function, split by split and block by block; the
position groups inside a split merge the same way and are left out.

The cases: TinyLlama's, the 7B's and Mixtral's heads (8 slots, the
served launch), tokens 1 and 5, int8 / int4 / k8v4 stores, lengths 0, 1,
at a split's end, at a JAX block's end and at S; rows past each length
hold random bytes and NaN scales. The limit is the kernel's, LIMIT of a
row's max|ref|; the worst row ratio is printed.
"""

import numpy as np
import pytest
import torch

from deeppowers_tpu_torch.ops.kernels import decode_attention as da
from deeppowers_tpu_torch.quant.kvquant import STORE_BITS, quant_side, unpack4

torch.set_num_threads(1)

#: (query heads, kv heads, head_dim) of the served models
MODELS = {"tinyllama": (32, 4, 64), "llama2-7b": (32, 32, 128),
          "mixtral-8x7b": (32, 8, 128)}
B, S = 8, 1024
#: a row's max error over its max|ref| (the kernel's card gate)
LIMIT = 1e-2
NEG = da.NEG_INF


def _lengths(plan, blk, t):
    """0, 1, at and below a split's end, at and below a JAX block's end,
    inside, and S (a window's lengths keep its T rows)."""
    lens = [0, 1, plan.chunk - 1, plan.chunk, blk - 1, blk, 515, S]
    return [0 if n == 0 else max(min(n, S), t) for n in lens]


def _cache(rng, store, kh, d, lens):
    """Stores (B, S, F') and head-major scales (B, R, S) of K and V
    quantized by the port's quantizer from seeded normals; past each
    length random bytes and NaN scales."""
    kb, vb = STORE_BITS[store]
    out = []
    for bits in (kb, vb):
        x = torch.from_numpy(rng.standard_normal((B, S, kh, d)).astype(
            np.float32) * rng.uniform(0.5, 2, (B, S, kh, 1)).astype(
                np.float32))
        st, sc = quant_side(x, bits, 2 if bits == 4 else 1)
        st = st.reshape(B, S, -1).clone()
        sc = sc.transpose(-1, -2).contiguous()
        for i, n in enumerate(lens):
            st[i, n:] = torch.from_numpy(rng.integers(
                -128, 128, st[i, n:].shape).astype(np.int8))
            sc[i, :, n:] = float("nan")
        out += [st, sc]
    return out


def emulate(q, kc, vc, lengths, k_scale, v_scale, kb, vb, tokens, plan,
            blk):
    """The int8-dot kernel's function, split by split and block by block
    (module docstring); q (B, Kh*R, D) bf16 query rows, R = rep * tokens."""
    b, o, d = q.shape
    s = kc.shape[1]
    kh = k_scale.shape[1] // (2 if kb == 4 else 1)
    rows = o // kh
    inv127 = torch.ones((), dtype=torch.float32) / 127.0
    x = q.float().reshape(b, kh, rows, d) * torch.tensor(d ** -0.5)
    qs = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) * inv127
    k4, v4 = kc.reshape(b, s, kh, -1), vc.reshape(b, s, kh, -1)
    pos = torch.arange(s)
    lens = lengths.long()
    valid = pos[None, :] < lens[:, None]                        # (B, S)
    t = torch.arange(rows) % tokens
    bound = lens[:, None] - (tokens - 1) + t[None, :]           # (B, R)
    seen = pos[None, None, None, :] < bound[:, None, :, None]   # (B,1,R,S)
    zero = torch.zeros(())
    # the kept scores: exact integer dots, then the scales in the TPU
    # kernel's order, masked at each row's bound
    if kb == 4:
        halves = (x[..., :d // 2], x[..., d // 2:])
        kcodes = unpack4(k4)
        ks = torch.where(valid[:, None], k_scale.float(), zero).reshape(
            b, kh, 2, s)
    else:
        halves, kcodes = (x,), (k4,)
        ks = torch.where(valid[:, None], k_scale.float(), zero)[:, :, None]
    dots = [torch.einsum("bkrd,bskd->bkrs",
                         torch.clamp(torch.round(h / qs), -127, 127),
                         c.float()) for h, c in zip(halves, kcodes)]
    sc = ((dots[0] * ks[:, :, None, 0] + dots[1] * ks[:, :, None, 1]) * qs
          if kb == 4 else (dots[0] * qs) * ks)
    sc = torch.where(seen, sc, torch.full((), NEG))
    if vb == 4:
        vparts = [torch.where(valid[:, :, None, None], h.float(), zero)
                  for h in unpack4(v4)]
        vs = torch.where(valid[:, None], v_scale.float(), zero).reshape(
            b, kh, 2, s)
        vscales = [vs[:, :, None, 0], vs[:, :, None, 1]]
    else:
        vparts = [torch.where(valid[:, :, None, None], v4.float(), zero)]
        vscales = [torch.where(valid[:, None], v_scale.float(),
                               zero)[:, :, None]]
    ns = plan.nsplit
    shape = (b, kh, rows, 1)
    m = [torch.full(shape, NEG) for _ in range(ns)]
    l = [torch.zeros(shape) for _ in range(ns)]
    acc = [[torch.zeros((b, kh, rows, v.shape[-1])) for v in vparts]
           for _ in range(ns)]
    for bi in range(-(-s // blk)):
        live = (bi * blk < lens)[:, None, None, None]   # the block is walked
        lo, hi = bi * blk, min((bi + 1) * blk, s)
        # pass 1 of each split: max score and max p * vs relative to it
        mine = []
        for sp in range(ns):
            a, z = max(lo, sp * plan.chunk), min(hi, (sp + 1) * plan.chunk)
            inb = (pos >= a) & (pos < z)
            ss = torch.where(inb, sc, torch.full((), NEG))
            msp = ss.amax(-1, keepdim=True)
            p = torch.where(seen & inb, torch.exp(ss - msp), zero)
            wsp = [(p * vsc).amax(-1, keepdim=True) for vsc in vscales]
            mine.append((inb, msp, wsp))
        # the exchange: the block's maxima over the splits
        mb = torch.stack([e[1] for e in mine]).amax(0)
        wb = [torch.stack([e[2][i] * torch.exp(e[1] - mb) for e in mine])
              .amax(0) for i in range(len(vparts))]
        # pass 2 of each split, in the frame max(m, Mb), from the kept
        # scores
        for sp, (inb, _, _) in enumerate(mine):
            mn = torch.maximum(m[sp], mb)
            al = torch.exp(m[sp] - mn)
            rs = [(w * torch.exp(mb - mn)).clamp_min(1e-30) * inv127
                  for w in wb]
            p = torch.where(seen & inb, torch.exp(sc - mn), zero)
            l[sp] = torch.where(live, l[sp] * al + p.sum(-1, keepdim=True),
                                l[sp])
            for i, (v, vsc) in enumerate(zip(vparts, vscales)):
                codes = torch.where(p > 0, torch.clamp(torch.round(
                    p * vsc / rs[i]), max=127), zero)
                dv = torch.einsum("bkrs,bskd->bkrd", codes, v)
                acc[sp][i] = torch.where(live, acc[sp][i] * al + dv * rs[i],
                                         acc[sp][i])
            m[sp] = torch.where(live, mn, m[sp])
    # the splits' merge
    big = torch.stack(m).amax(0)
    wt = [torch.exp(e - big) for e in m]
    lsum = sum(e * w for e, w in zip(l, wt))
    out = torch.cat([sum(acc[sp][i] * wt[sp] for sp in range(ns))
                     for i in range(len(vparts))], -1)
    out = out / lsum.clamp_min(1e-30)
    return out.reshape(b, o, d).to(q.dtype)


@pytest.mark.parametrize("store", ("int8", "int4", "k8v4"))
@pytest.mark.parametrize("tokens", (1, 5))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_schedule_matches_int8_dots_plain(model, tokens, store):
    """The emulated schedule at the served launch's plan (8 slots) against
    the plain version, every (slot, row) within LIMIT of its max|ref|,
    finite; zero rows where the length is 0."""
    hq, kh, d = MODELS[model]
    kb, vb = STORE_BITS[store]
    rows = hq // kh * tokens
    width = kh * d // 2 if kb == 4 else kh * d
    plan = da.attention_plan(B, kh, S, rows, d)
    blk = da.int8_dots_block(S, width)
    rng = np.random.default_rng(sum(map(ord, model + store)) + tokens)
    lens = _lengths(plan, blk, tokens)
    kc, ks, vc, vs = _cache(rng, store, kh, d, lens)
    q = torch.from_numpy(rng.standard_normal((B, hq * tokens, d)).astype(
        np.float32)).to(torch.bfloat16)
    lengths = torch.tensor(lens, dtype=torch.int32)
    got = emulate(q, kc, vc, lengths, ks, vs, kb, vb, tokens, plan, blk)
    ref = da.decode_attention_int8_dots_plain(
        q, kc, vc, lengths, k_scale=ks, v_scale=vs, kv_bits=kb, v_bits=vb,
        tokens=tokens)
    g, r = got.float(), ref.float()
    assert torch.isfinite(g).all()
    ratio = ((g - r).abs().amax(-1)
             / r.abs().amax(-1).clamp_min(1e-30)).amax().item()
    print(f"{model} {store} tokens {tokens}: plan {tuple(plan)}, block "
          f"{blk}, lengths {lens}: worst row ratio {ratio:.3e}")
    assert ratio <= LIMIT
    assert not g[lengths == 0].any()
