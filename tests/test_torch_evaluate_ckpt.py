"""The port's perplexity on the repo's trained checkpoints against the JAX
package on the CPU: each checkpoint loaded by its own package's loader,
two sequences of 128 tokens from the checkpoint's `ppl_eval.txt` (bytes
20000 on, past the licence text the model has memorised).

Bounds, relative to JAX's perplexity, with what was measured:
- f32 prefill: 1e-4 (measured at most 1e-7);
- f32 decode through an int8 or k8v4 cache: 5e-4 (measured 4.3e-5 to
  1.6e-4). The f32 sums run in another order than XLA's, and a K or V
  value that lands on the other side of a quantization step moves a
  trained model's sharp attention further than the order does (the tiny
  random configs of tests/test_torch_evaluate.py agree within 1.4e-6);
- bf16 activations: 1e-2 (measured 6e-5 to 3.4e-3), the bf16 rounding of
  the residual stream at other points than XLA's.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.runtime import evaluate as jev
from deeppowers_tpu.runtime.checkpoint import load_checkpoint as jax_load

from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.runtime import evaluate as ev
from deeppowers_tpu_torch.runtime.checkpoint import load_checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START, SEQ_LEN, N_SEQS = 20000, 128, 2
PREFILL_F32_REL = 1e-4
CACHED_F32_REL = 5e-4
BF16_REL = 1e-2


@functools.lru_cache(maxsize=None)
def _trained(name):
    """(JAX config, JAX params, port config, port params, sequences)."""
    path = os.path.join(REPO, name)
    tp, cfg, _ = load_checkpoint(path, device="cpu")
    jp, jcfg, _ = jax_load(path)
    with open(os.path.join(path, "ppl_eval.txt"), encoding="utf-8") as f:
        ids = [b + 4 for b in f.read().encode()]
    seqs = [ids[START + i * SEQ_LEN:START + (i + 1) * SEQ_LEN]
            for i in range(N_SEQS)]
    return jcfg, jp, cfg, tp, seqs


def _rel(got, want):
    return abs(got / want - 1)


DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["moelm_ckpt", "lm124_ckpt"])
def test_trained_perplexity_matches_jax(name, dtype):
    jcfg, jp, cfg, tp, seqs = _trained(name)
    jd, td = DTYPES[dtype]
    want = jev.perplexity(jp, jcfg, seqs, batch_size=N_SEQS, dtype=jd)
    got = ev.perplexity(tp, cfg, seqs, batch_size=N_SEQS, dtype=td)
    assert 1 < got < 2                 # trained text: near-memorised bytes
    assert _rel(got, want) <= (PREFILL_F32_REL if dtype == "f32"
                               else BF16_REL), (got, want)


@pytest.mark.parametrize("name,store,dtype", [
    ("moelm_ckpt", "int8", "f32"), ("moelm_ckpt", "k8v4", "f32"),
    ("moelm_ckpt", "int8", "bf16"), ("lm124_ckpt", "int8", "f32")])
def test_trained_cached_perplexity_matches_jax(name, store, dtype):
    """The decode path over a quantized cache; lm124 (300 MB of f32
    weights read a decode step) in one case only, for the file's time."""
    jcfg, jp, cfg, tp, seqs = _trained(name)
    jd, td = DTYPES[dtype]
    want = jev.cached_perplexity(jp, jcfg, seqs, batch_size=N_SEQS,
                                 kv_cache_dtype=store, dtype=jd)
    got = ev.cached_perplexity(tp, cfg, seqs, batch_size=N_SEQS,
                               kv_cache_dtype=store, dtype=td)
    assert _rel(got, want) <= (CACHED_F32_REL if dtype == "f32"
                               else BF16_REL), (got, want)


def test_float_grouped_branch_matches_jax():
    """The grouped branch of float stacked experts (the card's bf16
    control of eval_ppl on moelm_ckpt, T >= 256) over moelm's trained
    layer 0, f32, against JAX's `_moe_grouped`."""
    jcfg, jp, cfg, tp, _ = _trained("moelm_ckpt")
    moe = tp["layers"][0]["moe"]
    x = torch.randn(300, cfg.hidden_size,
                    generator=torch.Generator().manual_seed(0))
    got = T._moe_grouped(x, moe, cfg)
    ref = np.asarray(JT._moe_grouped(jnp.asarray(x.numpy()),
                                     jp["layers"][0]["moe"], jcfg))
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-5
