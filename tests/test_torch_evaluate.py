"""The port's perplexity evaluation (deeppowers_tpu_torch/runtime/
evaluate.py) and its gate script (deeppowers_tpu_torch/scripts/
eval_ppl.py) against the JAX package on the CPU, at tiny size.

The same weights (the JAX tree converted by `params_from_numpy`) and the
same sequences, batched as JAX batches them (a partial batch padded with
empty rows): `perplexity` and `cached_perplexity` through every KV store
agree with JAX's within 1e-5 relative in f32 (measured at most 1.4e-6:
the stores' codes are the same, the sums' order is PyTorch's), and
`delta_ppl` likewise. The script's synthetic harness runs in seconds and
ends with its JSON line; its exit code is 1 when a gated row passes the
limit. Trained checkpoints: tests/test_torch_evaluate_ckpt.py.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppowers_tpu.config import QuantConfig as JQuant
from deeppowers_tpu.models import transformer as JT
from deeppowers_tpu.models.presets import tiny_llama_config as jax_tiny_llama
from deeppowers_tpu.models.presets import tiny_moe_config as jax_tiny_moe
from deeppowers_tpu.runtime import evaluate as jev

from deeppowers_tpu_torch.config import QuantConfig
from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.models.convert import params_from_numpy
from deeppowers_tpu_torch.models.presets import tiny_moe_config
from deeppowers_tpu_torch.runtime import evaluate as ev
from deeppowers_tpu_torch.runtime.checkpoint import save_checkpoint
from deeppowers_tpu_torch.scripts import eval_ppl

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_REL = 1e-5
CONFIGS = {"tiny-llama": jax_tiny_llama, "tiny-moe": jax_tiny_moe}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def tiny(request):
    jcfg = CONFIGS[request.param]()
    cfg = T.TransformerConfig(**{f: getattr(jcfg, f) for f in
                                 jcfg.__dataclass_fields__})
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    rng = np.random.default_rng(0)
    # three sequences in batches of 2: the second batch has an empty row
    seqs = [rng.integers(0, jcfg.vocab_size, n).tolist() for n in (40, 33,
                                                                   64)]
    return jcfg, jp, cfg, tp, seqs


def _rel(got, want):
    return abs(got / want - 1)


def test_perplexity_matches_jax(tiny):
    jcfg, jp, cfg, tp, seqs = tiny
    want = jev.perplexity(jp, jcfg, seqs, batch_size=2)
    got = ev.perplexity(tp, cfg, seqs, batch_size=2)
    assert _rel(got, want) <= F32_REL, (got, want)


@pytest.mark.parametrize("store", ["bf16", "int8", "int4", "k8v4"])
def test_cached_perplexity_matches_jax(tiny, store):
    """Every position through forward_decode over the store: the cache
    written, quantized and read as JAX's is."""
    jcfg, jp, cfg, tp, seqs = tiny
    want = jev.cached_perplexity(jp, jcfg, seqs, batch_size=2,
                                 kv_cache_dtype=store)
    got = ev.cached_perplexity(tp, cfg, seqs, batch_size=2,
                               kv_cache_dtype=store)
    assert _rel(got, want) <= F32_REL, (got, want)


def test_cached_equals_prefill_on_a_float_store(tiny):
    """An f32 store holds what the prefill computes: the two perplexities
    agree (JAX's docstring: numerically equivalent)."""
    _, _, cfg, tp, seqs = tiny
    a = ev.perplexity(tp, cfg, seqs, batch_size=2)
    b = ev.cached_perplexity(tp, cfg, seqs, batch_size=2)
    assert _rel(a, b) <= F32_REL


def test_delta_ppl_matches_jax(tiny):
    jcfg, jp, cfg, tp, seqs = tiny
    want = jev.delta_ppl(jp, JT.quantize_params(jp, JQuant()), jcfg, seqs,
                         batch_size=2)
    got = ev.delta_ppl(tp, T.quantize_params(tp, QuantConfig()), cfg, seqs,
                       batch_size=2)
    assert set(got) == {"ppl_ref", "ppl_quant", "delta_ppl"}
    for k in ("ppl_ref", "ppl_quant"):
        assert _rel(got[k], want[k]) <= F32_REL
    assert abs(got["delta_ppl"] - want["delta_ppl"]) <= \
        2 * F32_REL * want["ppl_ref"]


def test_short_sequences_are_dropped_and_empty_input_raises(tiny):
    _, _, cfg, tp, seqs = tiny
    assert ev.perplexity(tp, cfg, seqs[:1] + [[5]], batch_size=2) == \
        ev.perplexity(tp, cfg, seqs[:1], batch_size=2)
    with pytest.raises(ValueError, match="length >= 2"):
        ev.perplexity(tp, cfg, [[1]])


def test_max_len_cuts_sequences(tiny):
    jcfg, jp, cfg, tp, seqs = tiny
    want = jev.perplexity(jp, jcfg, seqs, batch_size=4, max_len=20)
    got = ev.perplexity(tp, cfg, seqs, batch_size=4, max_len=20)
    assert _rel(got, want) <= F32_REL


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_eval_ppl_synthetic_runs_on_the_cpu(capsys):
    """The harness self-check: the JAX script's rows, every one run (GPTQ
    and AWQ too) and gated as JAX gates them, and the last line a JSON
    object with every row, the device and the dtype. The shipped
    round-to-nearest and KV rows (int8, W8A8, bf16 + k8v4, W4A8 GPTQ +
    k8v4) stay within the gate. On the port's seeded draw (its own random
    tiny-llama, not JAX's) the GPTQ prefill rows land at +0.509 (int4) and
    +0.589 (W4A8) against the 0.516 limit, so the verdict is FAIL and the
    exit code 1 (JAX's gptq_quantize gives the same two deltas on these
    weights); on JAX's draw both scripts pass
    (tests/test_torch_quant_recipes.py holds those rows against JAX's)."""
    rc = eval_ppl.main(["--synthetic", "--device", "cpu", "--seq-len", "48",
                        "--max-seqs", "3"])
    out = capsys.readouterr().out
    res = _last_json(out)
    assert {"rows", "device", "dtype", "gate", "worst_delta", "status",
            "reference", "kv_reference", "sequences"} <= set(res)
    assert (res["device"], res["dtype"], res["status"]) == ("cpu", "f32",
                                                            "FAIL")
    assert rc == 1
    over = [r["name"] for r in res["rows"]
            if r["gated"] and r["delta"] > res["gate"]]
    assert over == ["W4A8 g128 + GPTQ"]
    names = [r["name"] for r in res["rows"]]
    assert names == ["int8 per-channel", "int4 g128", "int4 g128 + AWQ",
                     "int4 g128 + GPTQ", "W4A8 g128", "W4A8 g128 + GPTQ",
                     "W8A8", "bf16 weights + k8v4 KV",
                     "W4A8 g128 GPTQ + k8v4 KV"]
    gated = [r["name"] for r in res["rows"] if r["gated"]]
    assert gated == ["int8 per-channel", "int4 g128 + GPTQ",
                     "W4A8 g128 + GPTQ", "W8A8", "bf16 weights + k8v4 KV",
                     "W4A8 g128 GPTQ + k8v4 KV"]
    for r in res["rows"]:
        assert "not ported" not in r.get("note", "")
        assert np.isfinite(r["ppl"]) and r["ppl"] > 1
    assert res["worst_delta"] == max(
        [0.0] + [r["delta"] for r in res["rows"] if r["gated"]])
    assert res["gate"] == max(0.1, 1e-3 * res["reference"]["ppl"])
    assert "fp32 reference" in out and "gate (gated rows" in out


def test_eval_ppl_checkpoint_fails_its_gate_with_exit_code_1(tmp_path):
    """`python -m` on a native checkpoint the port saved (tiny-moe with
    random weights, the byte tokenizer, its own ppl_eval.txt; the GPTQ and
    MoE rows included) with a limit no row can meet: the gate fails, the
    JSON line says so, and the exit code is 1."""
    cfg = tiny_moe_config(vocab_size=260, max_seq_len=64)
    params = T.init_params(cfg, torch.Generator().manual_seed(3),
                           dtype=torch.float32, device="cpu")
    save_checkpoint(str(tmp_path), params, cfg,
                    extra={"trained": {"tokenizer": "byte"}})
    (tmp_path / "ppl_eval.txt").write_text("the cat sat on the mat. " * 8)
    proc = subprocess.run(
        [sys.executable, "-m", "deeppowers_tpu_torch.scripts.eval_ppl",
         "--checkpoint", str(tmp_path), "--device", "cpu", "--seq-len", "32",
         "--max-seqs", "3", "--group-size", "32", "--gate", "-1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 1, proc.stderr
    res = _last_json(proc.stdout)
    assert res["status"] == "FAIL" and res["gate"] == -1
    assert res["sequences"] == 3 and res["text"].endswith("ppl_eval.txt")
    names = [r["name"] for r in res["rows"]]
    assert "W4A8 g32 GPTQ grouped-cat prefill" in names
    assert "W4A8 g32 GPTQ cat decode + int8 KV" in names
    assert "W4A8 g32 GPTQ EP=2 prefill" in names
    assert [r["name"] for r in res["rows"] if "not ported" in
            r.get("note", "")] == ["W4A8 g32 GPTQ EP=2 prefill"]
    # JAX's gated rows: int8, int4 / W4A8 GPTQ, W8A8, the four KV rows
    # but int4 KV, and the two MoE layouts
    assert len([r for r in res["rows"] if r["gated"]]) == 10
    assert res["calibration"] == 6       # 16 asked, the text has 6 windows


def test_eval_ppl_refuses_a_huggingface_directory(tmp_path):
    (tmp_path / "config.json").write_text("{}")
    with pytest.raises(SystemExit, match="not yet ported"):
        eval_ppl.main(["--checkpoint", str(tmp_path), "--device", "cpu"])
