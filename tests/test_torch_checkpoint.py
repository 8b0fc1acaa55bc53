"""The port's checkpoint loader and saver (deeppowers_tpu_torch/runtime/
checkpoint.py) against the JAX package's, on the CPU.

Both trained checkpoints of the repo load leaf for leaf bit-equal to the
JAX loader's tree converted by `params_from_numpy`, with equal configs;
checkpoints written by either package load in the other, bit for bit, for
a tree of f32 and bf16 leaves and int8, int4 g32, act_bits 8 and
zero-point QuantizedTensors; a v1 `arrays.npz` checkpoint loads; and a v2
load reads one leaf at a time.
"""

import dataclasses
import json
import os
import tracemalloc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.quant import quantize as jax_quantize
from deeppowers_tpu.quant.qtypes import QuantizedTensor as JQT
from deeppowers_tpu.runtime.checkpoint import load_checkpoint as jax_load
from deeppowers_tpu.runtime.checkpoint import save_checkpoint as jax_save

from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_moe_config
from deeppowers_tpu_torch.models.transformer import TransformerConfig
from deeppowers_tpu_torch.quant.qtypes import QuantizedTensor
from deeppowers_tpu_torch.runtime.checkpoint import (load_checkpoint,
                                                     save_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = ("lm124_ckpt", "moelm_ckpt")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same(got, want, path="params"):
    """Same nesting and keys; every tensor of the same dtype, shape and
    bits; QuantizedTensor metadata equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, QuantizedTensor):
        assert isinstance(got, QuantizedTensor), path
        assert (got.bits, got.group_size, got.act_bits) == \
            (want.bits, want.group_size, want.act_bits), path
        _assert_same(got.data, want.data, path + ".data")
        _assert_same(got.scales, want.scales, path + ".scales")
        assert (got.zero_points is None) == (want.zero_points is None), path
        if want.zero_points is not None:
            _assert_same(got.zero_points, want.zero_points,
                         path + ".zero_points")
    else:
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        assert got.shape == want.shape, path
        assert got.device.type == "cpu", path
        assert torch.equal(_bits(got), _bits(want)), path


def _bits(t):
    """A float tensor's bit patterns as integers (NaN compares equal)."""
    if not t.is_floating_point():
        return t
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def _assert_jax_same(got, want, path="params"):
    """A JAX tree against another, leaf bits and QuantizedTensor metadata."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_jax_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_jax_same(g, w, f"{path}[{i}]")
    elif isinstance(want, JQT):
        assert isinstance(got, JQT), path
        assert (got.bits, got.group_size, got.act_bits) == \
            (want.bits, want.group_size, want.act_bits), path
        for f in ("data", "scales", "zero_points"):
            a, b = getattr(got, f), getattr(want, f)
            assert (a is None) == (b is None), path
            if b is not None:
                _assert_jax_same(a, b, f"{path}.{f}")
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_trained_checkpoint_loads_like_the_jax_loader(name):
    """Every leaf bit-equal to the JAX loader's tree converted, the config
    and the extra metadata equal."""
    path = os.path.join(REPO, name)
    params, cfg, extra = load_checkpoint(path, device="cpu")
    jparams, jcfg, jextra = jax_load(path)
    _assert_same(params, params_from_numpy(_np_tree(jparams), device="cpu"))
    assert isinstance(cfg, TransformerConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert extra == jextra and extra["trained"]["tokenizer"] == "byte"


def _jax_tree():
    """f32 and bf16 leaves and every QuantizedTensor kind the manifest
    carries: int8 per-channel, int4 g32, act_bits 8, zero points."""
    rng = np.random.default_rng(0)
    w = lambda *s: jnp.asarray(rng.standard_normal(s), jnp.float32)  # noqa
    int4a8 = jax_quantize(w(64, 48), bits=4, group_size=32)
    int4a8 = JQT(int4a8.data, int4a8.scales, None, 4, 32, act_bits=8)
    return {
        "embedding": w(32, 16),
        "final_norm": {"w": w(16).astype(jnp.bfloat16)},
        "layers": [
            {"attn": {"wq": {"w": jax_quantize(w(64, 48), bits=8)},
                      "wo": {"w": jax_quantize(w(64, 48), bits=4,
                                               group_size=32)},
                      "bias": w(48).astype(jnp.bfloat16)}},
            {"mlp": {"w_in": {"w": int4a8},
                     "w_gate": {"w": jax_quantize(w(64, 48), bits=8,
                                                  group_size=32,
                                                  symmetric=False)},
                     "w_out": {"w": jax_quantize(w(64, 48), bits=4,
                                                 group_size=32,
                                                 symmetric=False)}}},
        ],
        "scalar": jnp.asarray(3.5, jnp.float32),
        "ids": jnp.arange(7, dtype=jnp.int32),
    }


def test_port_save_loads_in_jax(tmp_path):
    """A checkpoint the port writes loads in the JAX package bit for bit,
    with its config and extra metadata."""
    jtree = _jax_tree()
    cfg = tiny_moe_config()
    save_checkpoint(str(tmp_path), params_from_numpy(_np_tree(jtree),
                                                     device="cpu"),
                    cfg, extra={"note": "port"})
    got, jcfg, extra = jax_load(str(tmp_path))
    _assert_jax_same(got, jtree)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert extra == {"note": "port"}


def test_jax_save_loads_in_the_port(tmp_path):
    """A checkpoint the JAX package writes loads in the port bit for bit
    (bf16 through its uint16 view, QuantizedTensor metadata carried)."""
    jtree = _jax_tree()
    jax_save(str(tmp_path), jtree, None, extra={"a": 1})
    got, cfg, extra = load_checkpoint(str(tmp_path), device="cpu")
    _assert_same(got, params_from_numpy(_np_tree(jtree), device="cpu"))
    assert cfg is None and extra == {"a": 1}
    qt = got["layers"][1]["mlp"]["w_in"]["w"]
    assert (qt.bits, qt.group_size, qt.act_bits) == (4, 32, 8)
    assert got["layers"][1]["mlp"]["w_out"]["w"].zero_points is not None


@pytest.mark.parametrize("leaf", ["f32", "bf16", "int8", "int4_g32",
                                  "a8", "zero_points"])
def test_round_trip_both_ways_per_leaf_kind(tmp_path, leaf):
    """One leaf of each kind through port save -> JAX load -> JAX save ->
    port load: the same bytes and the same manifest entry both ways."""
    rng = np.random.default_rng(len(leaf))
    w = jnp.asarray(rng.standard_normal((64, 32)), jnp.float32)
    q8 = jax_quantize(w, bits=8, group_size=32)
    jleaf = {"f32": w, "bf16": w.astype(jnp.bfloat16),
             "int8": jax_quantize(w, bits=8),
             "int4_g32": jax_quantize(w, bits=4, group_size=32),
             "a8": JQT(q8.data, q8.scales, None, 8, 32, act_bits=8),
             "zero_points": jax_quantize(w, bits=4, group_size=32,
                                         symmetric=False)}[leaf]
    tree = {"m": {"w": jleaf}}
    port = params_from_numpy(_np_tree(tree), device="cpu")
    save_checkpoint(str(tmp_path / "p"), port)
    via_jax, _, _ = jax_load(str(tmp_path / "p"))
    _assert_jax_same(via_jax, tree)
    jax_save(str(tmp_path / "j"), via_jax)
    back, _, _ = load_checkpoint(str(tmp_path / "j"), device="cpu")
    _assert_same(back, port)
    manifests = [json.load(open(tmp_path / d / "manifest.json"))
                 for d in ("p", "j")]
    assert manifests[0] == manifests[1]


def test_v1_npz_checkpoint_loads(tmp_path):
    """The legacy format (one arrays.npz, a manifest without "files")."""
    jtree = {"a": jnp.asarray(np.arange(12.0).reshape(3, 4), jnp.float32),
             "b": {"w": jax_quantize(jnp.asarray(
                 np.random.default_rng(1).standard_normal((8, 6)),
                 jnp.float32), bits=8)}}
    jax_save(str(tmp_path / "v2"), jtree)
    man = json.load(open(tmp_path / "v2" / "manifest.json"))
    files = man.pop("files")
    man["format_version"] = 1
    os.makedirs(tmp_path / "v1")
    np.savez(tmp_path / "v1" / "arrays.npz", **{
        key: np.load(tmp_path / "v2" / "arrays" / f)
        for key, f in files.items()})
    json.dump(man, open(tmp_path / "v1" / "manifest.json", "w"))
    got, _, _ = load_checkpoint(str(tmp_path / "v1"), device="cpu")
    _assert_same(got, params_from_numpy(_np_tree(jtree), device="cpu"))


def test_unknown_version_raises(tmp_path):
    jax_save(str(tmp_path), {"a": jnp.zeros(3)})
    man = json.load(open(tmp_path / "manifest.json"))
    man["format_version"] = 3
    json.dump(man, open(tmp_path / "manifest.json", "w"))
    with pytest.raises(ValueError, match="unsupported checkpoint version"):
        load_checkpoint(str(tmp_path), device="cpu")


def test_dtype_casts_float_leaves_only(tmp_path):
    """dtype= casts float leaves; quantized data and scales stay as
    stored (int8, f32)."""
    jtree = _jax_tree()
    jax_save(str(tmp_path), jtree)
    got, _, _ = load_checkpoint(str(tmp_path), device="cpu",
                                dtype=torch.bfloat16)
    assert got["embedding"].dtype == torch.bfloat16
    assert torch.equal(got["embedding"], torch.from_numpy(
        np.array(jtree["embedding"])).to(torch.bfloat16))
    qt = got["layers"][0]["attn"]["wq"]["w"]
    assert qt.data.dtype == torch.int8 and qt.scales.dtype == torch.float32
    assert got["ids"].dtype == torch.int32


def test_default_device_is_cuda():
    """An entry point runs on the card unless the caller asks for the CPU:
    without one, the default raises instead of loading on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_checkpoint(os.path.join(REPO, "moelm_ckpt"))


def test_v2_load_streams_one_leaf_at_a_time(tmp_path):
    """The host's traced peak during a v2 load stays under three leaves of
    a sixteen-leaf model: each leaf is read from its mmap straight into its
    own tensor."""
    k = 512
    rng = np.random.default_rng(2)
    big = {f"w{i}": rng.standard_normal((k, k)).astype(np.float32)
           for i in range(16)}
    save_checkpoint(str(tmp_path), {n: torch.from_numpy(a)
                                    for n, a in big.items()})
    load_checkpoint(str(tmp_path), device="cpu")       # warm imports
    tracemalloc.start()
    got, _, _ = load_checkpoint(str(tmp_path), device="cpu")
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < 3 * k * k * 4, peak
    assert all(np.array_equal(got[n].numpy(), a) for n, a in big.items())
