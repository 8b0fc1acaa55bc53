"""The port's copy of XLA's CPU f32 arithmetic (deeppowers_tpu_torch/ops/
xla_cpu.py) against JAX on the CPU, bit for bit: `xla_exp` against eager
and jitted `jnp.exp` over 10^6 inputs in [-100, 88] plus the edges (0,
-0, +-inf, NaN, -1e30, the flush to zero below the smallest normal and
the overflow above 88.72); `xla_sum` against `jnp.sum` over rows of many
lengths (the reduce-window order); `xla_softmax` against
`jax.nn.softmax` over masked score rows as the verify attention makes
them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu_torch.ops.xla_cpu import xla_exp, xla_softmax, xla_sum

torch.set_num_threads(1)

EDGES = [0.0, -0.0, np.inf, -np.inf, np.nan, -1e30, 1e30, -87.33654,
         -87.33655, -87.3366, -103.0, 88.3762, 88.72283, 88.72284, 89.0]


def _bits_equal(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    same = a.view(np.int32) == b.view(np.int32)
    return same | (np.isnan(a) & np.isnan(b))


@pytest.mark.parametrize("jitted", [False, True])
def test_exp_is_xla_bit_for_bit(jitted):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-100.0, 88.0, 1_000_000),
                        np.linspace(-87.5, -87.0, 20001),
                        np.linspace(88.0, 88.8, 20001), EDGES]
                       ).astype(np.float32)
    fn = jax.jit(jnp.exp) if jitted else jnp.exp
    want = np.asarray(fn(jnp.asarray(x)))
    got = xla_exp(torch.from_numpy(x)).numpy()
    eq = _bits_equal(got, want)
    assert eq.all(), (x[~eq][:5], got[~eq][:5], want[~eq][:5])


@pytest.mark.parametrize("n", [1, 7, 31, 32, 33, 100, 129, 256, 1000, 2048,
                               5000])
def test_row_sum_order_is_xla(n):
    rng = np.random.default_rng(n)
    x = (rng.random((16, n)) * rng.choice([1e-3, 1.0, 1e3], (16, 1))
         ).astype(np.float32)
    want = np.asarray(jnp.sum(jnp.asarray(x), axis=-1))
    assert _bits_equal(xla_sum(torch.from_numpy(x)).numpy(), want).all()


@pytest.mark.parametrize("s", [64, 100, 256, 1024])
def test_softmax_is_jax_bit_for_bit(s):
    """Scores of a verify window: rows masked to -1e30 past a causal bound,
    one row wholly visible, values of a few units."""
    rng = np.random.default_rng(s)
    x = (rng.standard_normal((2, 2, 20, s)) * 3).astype(np.float32)
    bound = rng.integers(1, s, (2, 2, 20, 1))
    x = np.where(np.arange(s) < bound, x, np.float32(-1e30))
    x[0, 0, 0] = rng.standard_normal(s) * 3
    want = np.asarray(jax.nn.softmax(jnp.asarray(x), axis=-1))
    got = xla_softmax(torch.from_numpy(x)).numpy()
    assert _bits_equal(got, want).all()
    # PyTorch's own softmax is not this function
    assert not _bits_equal(torch.softmax(torch.from_numpy(x), -1).numpy(),
                           want).all()
