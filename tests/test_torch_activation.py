"""The port's SiLU and tanh-GELU against the JAX package's.

bf16 activations must equal the jitted `jax.nn.silu` / `jax.nn.gelu(
approximate=True)` bit for bit at every site that mirrors XLA's unfused
ops (ops/activation.py): `activation` itself, the model's `_act` and
`glu_matmul`'s float path (through an identity weight, which keeps the
product's values). f32 activations stay F.silu / F.gelu exactly. Then
greedy streams of tiny-llama (SiLU) and tiny-test (GELU) in bf16, with
float weights and a bf16 KV cache, against the JAX engine.

Inputs are made with numpy from seeds: 1e5 values a case at sigma 1 and 3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeppowers_tpu.config import GenerationConfig as JGen
from deeppowers_tpu.config import QuantConfig as JQuant
from deeppowers_tpu.config import QuantMode as JQuantMode
from deeppowers_tpu.config import RuntimeConfig as JRuntime
from deeppowers_tpu.models import presets as jpresets
from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.ops import matmul as jmm
from deeppowers_tpu.runtime.engine import InferenceEngine as JEngine

from deeppowers_tpu_torch.config import GenerationConfig, RuntimeConfig
from deeppowers_tpu_torch.models import presets
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.ops.activation import activation
from deeppowers_tpu_torch.ops.matmul import glu_matmul
from deeppowers_tpu_torch.runtime.engine import InferenceEngine

torch.set_num_threads(1)

N = 100_000
#: glu_matmul's cases: rows of K gates (and K ups) through a K x K identity
K = 500


def _jax_act(act):
    if act == "silu":
        return jax.nn.silu
    return lambda v: jax.nn.gelu(v, approximate=True)


def _gates(sigma, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(N) * sigma).astype(np.float32)


def _port(site, x, act, dtype):
    """The port's activation at `site` over the values x (numpy f32), in
    `dtype`; glu_matmul takes up = 1 in the second half of each row."""
    xt = torch.from_numpy(x).to(dtype)
    if site == "activation":
        return activation(xt, act)
    if site == "transformer":
        cfg = presets.tiny_llama_config(activation=act)
        return T._act(xt, cfg)
    gate = xt.reshape(-1, K)
    gu = torch.cat([gate, torch.ones_like(gate)], -1)
    eye = torch.eye(K, dtype=dtype)
    return glu_matmul(gu, eye, act=act).reshape(-1)


@pytest.mark.parametrize("site", ["activation", "transformer", "glu_matmul"])
@pytest.mark.parametrize("sigma", [1.0, 3.0])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_bf16_activation_is_jax_bit_for_bit(act, sigma, site):
    x = _gates(sigma, int(sigma) + 7 * len(site))
    got = _port(site, x, act, torch.bfloat16).float().numpy()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    if site == "glu_matmul":
        gate = xb.reshape(-1, K)
        gu = jnp.concatenate([gate, jnp.ones_like(gate)], -1)
        want = jax.jit(lambda v: jmm.glu_matmul(
            v, jnp.eye(K, dtype=jnp.bfloat16), act=act))(gu).reshape(-1)
    else:
        want = jax.jit(_jax_act(act))(xb)
    np.testing.assert_array_equal(got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("site", ["activation", "transformer", "glu_matmul"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_f32_activation_is_unchanged(act, site):
    """f32 keeps PyTorch's one-rounding functions (glu_matmul's on the
    gate half's view, as before)."""
    x = _gates(2.0, 11)
    got = _port(site, x, act, torch.float32)
    xt = torch.from_numpy(x)
    if site == "glu_matmul":
        xt = torch.chunk(torch.cat([xt.reshape(-1, K),
                                    torch.ones(N // K, K)], -1), 2, -1)[0]
    want = F.silu(xt) if act == "silu" else F.gelu(xt, approximate="tanh")
    assert torch.equal(got, want.reshape(-1))


def _bf16_tree(tree):
    """The JAX tree with its float leaves in bf16, as numpy."""
    def cast(a):
        a = jnp.asarray(a)
        if a.dtype == jnp.float32:
            a = a.astype(jnp.bfloat16)
        return np.asarray(a)
    return jax.tree_util.tree_map(cast, tree)


@pytest.mark.parametrize("name", ["tiny_llama_config", "tiny_test_config"])
def test_bf16_greedy_streams_match_jax_engine(name):
    """bf16 activations, float weights in bf16 and a bf16 KV cache on both
    engines: SiLU (tiny-llama) and the tanh GELU (tiny-test) in JAX's
    rounding keep the greedy streams equal token for token. (Weight-only
    matrices in bf16: tests/test_torch_weight_only_bf16.py.)"""
    jcfg = getattr(jpresets, name)()
    cfg = getattr(presets, name)()
    jparams = JT.quantize_params(
        JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32),
        JQuant(mode=JQuantMode.NONE))
    np_tree = _bf16_tree(jparams)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tparams = params_from_numpy(np_tree, device="cpu")
    rt = dict(max_batch_size=4, max_seq_len=64, prefill_buckets=(16, 32, 64))
    jeng = JEngine(jparams, jcfg, runtime=JRuntime(**rt),
                   act_dtype=jnp.bfloat16)
    teng = InferenceEngine(tparams, cfg, runtime=RuntimeConfig(**rt),
                           act_dtype=torch.bfloat16, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, 128, n)]
               for n in (5, 12, 20, 3)]
    jr = jeng.generate_batch(prompts, JGen(max_tokens=24, temperature=0.0,
                                           do_sample=False))
    tr = teng.generate_batch(prompts, GenerationConfig(
        max_tokens=24, temperature=0.0, do_sample=False))
    assert [r.token_ids for r in tr] == [r.token_ids for r in jr]
