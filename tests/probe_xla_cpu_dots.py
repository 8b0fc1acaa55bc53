"""Probe of XLA's CPU dots that the port's CPU route follows or does not
(ROADMAP.md, Decisions: the one-row weight-only product and the small-M
sum order). Not collected by pytest; run it on the CPU:

    JAX_PLATFORMS=cpu python tests/probe_xla_cpu_dots.py

It prints, for jitted JAX against candidate functions in PyTorch / numpy,
the share of outputs that are bit-equal:
1. `quantized_matmul` with int8 per-channel and int4 g32 weights and a
   bf16 output at one row, shaped (1, K) and (1, 1, K): the weight's
   products kept in f32 (q * bf16(s)) or rounded to bf16 as at two rows;
2. a float32 dot of 1, 2 and 4 rows: PyTorch's order, a sequential sum
   over K with one fused multiply-add a term, and with a rounded product.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deeppowers_tpu.ops import matmul as jmm
from deeppowers_tpu.quant import quantize as jax_quantize
from deeppowers_tpu.quant.qtypes import unpack_int4

torch.set_num_threads(1)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def one_row_products(k=256, n=384, seeds=3):
    for bits, group in ((8, 0), (4, 32)):
        for lead in ((1,), (1, 1)):
            shares = {"q * bf16(s) in f32": [], "bf16(q * s), two rows'": []}
            for seed in range(seeds):
                rng = np.random.default_rng(seed)
                qw = jax_quantize(jnp.asarray(rng.standard_normal((k, n))
                                              * 0.05, jnp.float32),
                                  bits=bits, group_size=group)
                x = _bf16(rng.standard_normal(lead + (k,)))
                ref = np.asarray(jax.jit(lambda a, w: jmm.quantized_matmul(
                    a, w))(jnp.asarray(x, jnp.bfloat16), qw).astype(
                        jnp.float32)).reshape(-1)
                q = np.asarray(unpack_int4(qw.data) if bits == 4
                               else qw.data).astype(np.float32)
                s = np.asarray(qw.scales, np.float32)
                rows = s.size // n
                w32 = (q.reshape(rows, k // rows, n)
                       * _bf16(s).reshape(rows, 1, n)).reshape(k, n)
                for name, w in (("q * bf16(s) in f32", w32),
                                ("bf16(q * s), two rows'", _bf16(w32))):
                    y = torch.matmul(torch.from_numpy(x.reshape(1, k).copy()),
                                     torch.from_numpy(w)).numpy()
                    shares[name].append(float((_bf16(y).reshape(-1)
                                               == ref).mean()))
            print(f"one row {lead + (k,)}, bits {bits} group {group}: "
                  + ", ".join(f"{a} {np.mean(b):.4f}"
                              for a, b in shares.items()))


def _sequential(x, w, fma):
    acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
    for i in range(x.shape[1]):
        if fma:     # the product exact in f64, one rounding a term
            acc = (acc.astype(np.float64) + x[:, i:i + 1].astype(np.float64)
                   * w[i].astype(np.float64)).astype(np.float32)
        else:
            acc = (acc + (x[:, i:i + 1] * w[i]).astype(np.float32)).astype(
                np.float32)
    return acc


def small_m_order(k=256, n=384):
    for m in (1, 2, 4):
        rng = np.random.default_rng(m)
        x = rng.standard_normal((m, k)).astype(np.float32)
        w = rng.standard_normal((k, n)).astype(np.float32)
        ref = np.asarray(jax.jit(lambda a, b: jnp.dot(
            a, b, preferred_element_type=jnp.float32))(x, w))
        cands = {"PyTorch": torch.matmul(torch.from_numpy(x),
                                         torch.from_numpy(w)).numpy(),
                 "sequential fma": _sequential(x, w, True),
                 "sequential": _sequential(x, w, False)}
        print(f"f32 dot of {m} rows, K = {k}: " + ", ".join(
            f"{a} {float((b == ref).mean()):.4f}" for a, b in cands.items()))


if __name__ == "__main__":
    one_row_products()
    small_m_order()
