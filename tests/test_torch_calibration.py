"""The port's calibration observers and accuracy report
(deeppowers_tpu_torch/quant/{calibration,validate}.py) against the JAX
package's on the CPU.

The observers and the report are numpy arithmetic in both packages (the
port's copy takes torch tensors and moves them to the host), so every
range, scale and metric is held bit for bit, for each CalibrationMethod,
per tensor and per channel, with a second batch that widens the histogram.
`validate_quantized_params` walks trees quantized by each package's own
`quantize_params` from the same float weights (codes and scales bit-equal,
tests/test_torch_model.py), dense and with stacked experts: the counts,
histograms and largest errors equal, the f64 means within 1e-12 relative
(numpy's pairwise sums take their SIMD steps by the buffer's alignment,
which a torch allocation and a numpy one do not share, and the two trees
list their tensors in another order). Inputs are made with numpy from
seeds.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.config import CalibrationMethod as JMethod
from deeppowers_tpu.config import QuantConfig as JQuant
from deeppowers_tpu.config import QuantMode as JMode
from deeppowers_tpu.models import presets as jpresets
from deeppowers_tpu.models import transformer as JT

from deeppowers_tpu_torch.config import CalibrationMethod, QuantConfig, QuantMode
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.quant import Calibrator, Observer
from deeppowers_tpu_torch.quant.validate import (ErrorMetrics,
                                                 validate_quantized_params)

jcal = importlib.import_module("deeppowers_tpu.quant.calibration")
jval = importlib.import_module("deeppowers_tpu.quant.validate")

torch.set_num_threads(1)


def _batches(seed):
    """Two batches of activations, the second wider (the histogram
    rescales), with a few outliers."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((16, 24)).astype(np.float32)
    b = (rng.standard_normal((16, 24)) * 1.7).astype(np.float32)
    b[3, 5] = 9.0
    return a, b


@pytest.mark.parametrize("axis", [None, 1])
@pytest.mark.parametrize("method", [m.value for m in CalibrationMethod])
def test_observer_matches_jax(method, axis):
    """Ranges, statistics and symmetric scales of an Observer fed the same
    two batches: the port's (torch tensors in) equal JAX's (jnp arrays in)
    bit for bit."""
    ours = Observer(CalibrationMethod(method), percentile=99.0, axis=axis)
    theirs = jcal.Observer(JMethod(method), percentile=99.0, axis=axis)
    for x in _batches(3):
        ours.update(torch.from_numpy(x))
        theirs.update(jnp.asarray(x))
    for got, want in ((ours.finalize(), theirs.finalize()),
                      (ours.minmax, theirs.minmax)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    np.testing.assert_array_equal(ours.mean, theirs.mean)
    np.testing.assert_array_equal(ours.var, theirs.var)
    np.testing.assert_array_equal(ours.scale_symmetric(127),
                                  theirs.scale_symmetric(127))
    assert ours.num_samples == theirs.num_samples == 2
    if ours._hist is not None:
        np.testing.assert_array_equal(ours._hist, theirs._hist)
        assert ours._hist_absmax == theirs._hist_absmax


def test_observer_without_samples_raises():
    with pytest.raises(RuntimeError, match="no samples"):
        Observer().finalize()


@pytest.mark.parametrize("method", ["minmax", "entropy"])
def test_calibrator_matches_jax(method):
    """The named registry: per-name ranges and scales, and its sample
    count, as JAX's Calibrator gives them."""
    ours = Calibrator(CalibrationMethod(method))
    theirs = jcal.Calibrator(JMethod(method))
    a, b = _batches(4)
    for name, x, axis in (("q", a, None), ("q", b, None), ("k", b, 1)):
        ours.observe(name, torch.from_numpy(x), axis=axis)
        theirs.observe(name, jnp.asarray(x), axis=axis)
    got, want = ours.finalize(), theirs.finalize()
    assert set(got) == set(want) == {"q", "k"}
    for name in got:
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for name, s in ours.scales(7).items():
        np.testing.assert_array_equal(s, theirs.scales(7)[name])
    assert ours.num_samples == theirs.num_samples == 2
    assert Calibrator().num_samples == 0


def _same_metrics(got, want):
    assert got.max_abs_error == want.max_abs_error
    assert got.num_outliers == want.num_outliers
    assert got.histogram == want.histogram
    for f in ("mean_abs_error", "mse", "rmse", "mean_relative_error"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12)


def test_error_metrics_match_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((32, 16)).astype(np.float32)
    b = a + rng.standard_normal((32, 16)).astype(np.float32) * 0.01
    b[0, 0] += 1.0
    got = ErrorMetrics.compare(torch.from_numpy(a), torch.from_numpy(b))
    want = jval.ErrorMetrics.compare(a, b)
    _same_metrics(got, want)
    assert got.num_outliers >= 1


@pytest.mark.parametrize("preset,mode,group", [
    ("tiny_llama_config", "int8", 0), ("tiny_llama_config", "int4", 32),
    ("tiny_moe_config", "int4", 32)])
def test_validate_quantized_params_matches_jax(preset, mode, group,
                                               tmp_path):
    """The report over a whole quantized tree (stacked experts
    dequantized per expert): the same tensors, metrics, summary and
    verdict as JAX's; `save` writes the JSON JAX's writes."""
    jcfg = getattr(jpresets, preset)()
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    jq = JT.quantize_params(jp, JQuant(mode=JMode(mode), group_size=group))
    tq = T.quantize_params(tp, QuantConfig(mode=QuantMode(mode),
                                           group_size=group))
    for tol in (0.1, 1e-4):
        got = validate_quantized_params(tp, tq, tolerance=tol)
        want = jval.validate_quantized_params(jp, jq, tolerance=tol)
        assert set(got.per_tensor) == set(want.per_tensor)
        assert got.passed == want.passed
        assert set(got.summary) == set(want.summary)
        for key, v in got.summary.items():
            assert v == pytest.approx(want.summary[key], rel=1e-12)
        for name, m in got.per_tensor.items():
            _same_metrics(m, want.per_tensor[name])
    assert not got.passed and got.summary["tensors"] > 0
    got.save(str(tmp_path / "ours.json"))
    want.save(str(tmp_path / "theirs.json"))
    ours = json.load(open(tmp_path / "ours.json"))
    theirs = json.load(open(tmp_path / "theirs.json"))
    assert set(ours) == set(theirs)
    assert ours["passed"] == theirs["passed"]
    assert set(ours["per_tensor"]) == set(theirs["per_tensor"])
