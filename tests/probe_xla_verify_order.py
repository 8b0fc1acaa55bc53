"""Probe of the f32 order of XLA's CPU verify attention, which found the
dot order the port's CPU function for bf16 verify rows
(`decode_attention_plain(xla=True)`) now follows, with XLA's exp and
softmax from deeppowers_tpu_torch/ops/xla_cpu.py (held bit for bit by
tests/test_torch_xla_cpu.py). Not collected by pytest; run it on the CPU:

    JAX_PLATFORMS=cpu python tests/probe_xla_verify_order.py

JAX's `attention_verify` (ops/attention.py:126-155) contracts
(B, T, Kh, R) query rows. XLA's optimized HLO of it swaps the operands of
both dots: the scores are dot(K (S x D), q (D x R*T)) and the output
dot(V^T (D x S), p^T (S x R*T)), where the decode einsum keeps q on the
left. It prints, for the separate pieces and for whole verify rows, the
share of values equal to JAX's (eager, as the tests call it):
1. the scores dot and the p.V dot against candidate f32 orders: PyTorch's
   matmul with either operand order (a sequential fused multiply-add over
   the contraction), and four partial sums over k mod 4, combined as
   (s0 + s1) + (s2 + s3);
2. the softmax over the masked scores: torch.softmax against
   jax.nn.softmax, and torch.exp against jnp.exp;
3. bf16 verify rows of a bf16 store at D 64 and 128: the port's fold
   (PyTorch's order) and XLA's operand order with the four-sum dots,
   the softmax PyTorch's in both.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deeppowers_tpu.ops import attention as jatt

torch.set_num_threads(1)


def dot4(a, b):
    """a (..., M, K) @ b (..., K, N) as four sequential partial sums over
    k = 0, 1, 2, 3 mod 4, added (s0 + s1) + (s2 + s3)."""
    s = [torch.matmul(a[..., i::4], b[..., i::4, :]) for i in range(4)]
    return (s[0] + s[1]) + (s[2] + s[3])


def _t(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


def dots(b=2, t=5, kh=2, r=4, s=256):
    for d in (64, 128):
        rng = np.random.default_rng(d)
        q = jnp.asarray(rng.standard_normal((b, t, kh, r, d)), jnp.bfloat16
                        ).astype(jnp.float32)
        k = jnp.asarray(rng.standard_normal((b, s, kh, d)), jnp.bfloat16
                        ).astype(jnp.float32)
        p = jnp.asarray(rng.random((b, kh, r, t, s)), jnp.float32)
        ref_s = _t(jnp.einsum("btkrd,bskd->bkrts", q, k)).reshape(
            b, kh, r * t, s)
        ref_o = _t(jnp.einsum("bkrts,bskd->btkrd", p, k)).permute(
            0, 2, 3, 1, 4).reshape(b, kh, r * t, d)
        qt = _t(q).permute(0, 2, 3, 1, 4).reshape(b, kh, r * t, d)
        kt, pt = _t(k).permute(0, 2, 1, 3), _t(p).reshape(b, kh, r * t, s)
        cands = {
            "scores q @ K^T": torch.matmul(qt, kt.transpose(-1, -2)),
            "scores (K @ q^T)^T": torch.matmul(
                kt, qt.transpose(-1, -2)).transpose(-1, -2),
            "scores four sums": dot4(kt, qt.transpose(-1, -2)).transpose(
                -1, -2),
            "out p @ V": torch.matmul(pt, kt),
            "out four sums": dot4(kt.transpose(-1, -2), pt.transpose(
                -1, -2)).transpose(-1, -2)}
        print(f"D {d}: " + ", ".join(
            f"{n} {float((c == (ref_s if n.startswith('scores') else ref_o)
                           ).float().mean()):.4f}"
            for n, c in cands.items()))


def softmax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 2, 20, 256)) * 3).astype(np.float32)
    x[..., 128:] = jatt.NEG_INF
    sj = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
    st = torch.softmax(torch.from_numpy(x), -1).numpy()
    e = (rng.standard_normal(100000) * 5 - 5).astype(np.float32)
    ej = np.asarray(jnp.exp(jnp.asarray(e)))
    et = torch.exp(torch.from_numpy(e)).numpy()
    cr = np.exp(e.astype(np.float64)).astype(np.float32)
    print(f"softmax equal {float((sj == st).mean()):.4f}; exp equal "
          f"{float((ej == et).mean()):.4f}, XLA's exp correctly rounded "
          f"{float((ej == cr).mean()):.4f}, PyTorch's "
          f"{float((et == cr).mean()):.4f}")


def verify_rows(q, k, v, lengths, four_sums):
    """bf16 verify rows of a bf16 store, PyTorch's softmax; the dots in
    the fold's order or in XLA's operand order with the four-sum dots."""
    b, t, h, d = q.shape
    s, kh = k.shape[1], k.shape[2]
    r = h // kh
    sc = torch.tensor(d ** -0.5, dtype=q.dtype).float()
    qg = (q.float() * sc).to(q.dtype).float().reshape(b, t, kh, r, d)
    qg = qg.permute(0, 2, 3, 1, 4).reshape(b, kh, r * t, d)
    kf, vf = (a.float().permute(0, 2, 1, 3) for a in (k, v))
    if four_sums:
        scores = dot4(kf, qg.transpose(-1, -2)).transpose(-1, -2)
    else:
        scores = torch.matmul(qg, kf.transpose(-1, -2))
    tpos = torch.arange(r * t) % t
    mask = torch.arange(s)[None, None] <= (lengths[:, None]
                                           + tpos[None])[:, :, None]
    scores = torch.where(mask[:, None], scores,
                         torch.tensor(float(jatt.NEG_INF)))
    p = torch.softmax(scores, -1)
    if four_sums:
        out = dot4(vf.transpose(-1, -2), p.transpose(-1, -2)).transpose(
            -1, -2)
    else:
        out = torch.matmul(p, vf)
    out = out.reshape(b, kh, r, t, d).permute(0, 3, 1, 2, 4)
    return out.reshape(b, t, h, d).to(q.dtype)


def rows(b=4, t=5, h=8, kh=2, s=256):
    for d in (64, 128):
        rng = np.random.default_rng(d + 1)
        q, k, v = (jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
                   for shape in ((b, t, h, d), (b, s, kh, d), (b, s, kh, d)))
        lens = np.array([0, 60, 125, 251], np.int32)
        ref = np.asarray(jatt.attention_verify(q, k, v, jnp.asarray(lens))
                         .astype(jnp.float32))
        tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
        for name, four in (("fold", False), ("XLA's dot order", True)):
            got = verify_rows(tq, tk, tv, torch.tensor(lens).long(), four)
            n = int((got.float().numpy() != ref).sum())
            print(f"bf16 verify rows, D {d}, {name}: {n} of {ref.size} "
                  f"differ from JAX's")


if __name__ == "__main__":
    dots()
    softmax()
    rows()
