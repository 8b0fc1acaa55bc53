"""Float (unquantized) stacked experts at prefill sizes: the grouped branch
`_moe_grouped` that `_ffn` takes from MOE_GROUPED_MIN_TOKENS tokens on
(JAX `_moe_grouped`, `lax.ragged_dot` over the routed pairs), at the width
of the repo's trained MoE checkpoint, moelm_ckpt (hidden 256, 8 experts of
768, top-2), with its trained layer-0 weights.

On the CPU: the branch against the port's dense branch (every expert on
every token, combined by the routing weights); against the JAX package's
in tests/test_torch_evaluate_ckpt.py (this file imports no JAX, so that
the card runs it without). On the card (the `cuda` marker): the branch on
CUDA tensors against the same function on the CPU, bf16 activations, at
300 tokens and at the 4096 routed tokens of an 8 x 512 prefill; rows
whose top-2 set differs between the two (a router near-tie that the f32
sum order tipped) are left out of the bound and counted (at most 1%, as
chip_smoke.py's Mixtral path allows). Last, chip_smoke.py's trained phase
(moelm_ckpt scored on the card) rehearsed on the CPU at a small size.
"""

import os
import sys

import pytest
import torch

from deeppowers_tpu_torch.models import transformer as T
from deeppowers_tpu_torch.runtime.checkpoint import load_checkpoint
from deeppowers_tpu_torch.scripts.eval_ppl import sequences

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOELM = os.path.join(REPO, "moelm_ckpt")
FLIPS_MAX = 1e-2


@pytest.fixture(scope="module")
def moelm():
    params, cfg, _ = load_checkpoint(MOELM, device="cpu")
    return params["layers"][0]["moe"], cfg


def _x(t, h, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(t, h, generator=g).to(dtype)


@pytest.mark.parametrize("t", [256, 300])
def test_ffn_takes_the_grouped_branch_for_float_experts(moelm, t,
                                                        monkeypatch):
    """From MOE_GROUPED_MIN_TOKENS tokens on, a float stacked MoE layer
    goes through `_moe_grouped`, which equals the dense branch."""
    moe, cfg = moelm
    calls = []
    grouped = T._moe_grouped
    monkeypatch.setattr(T, "_moe_grouped",
                        lambda *a: calls.append(1) or grouped(*a))
    x = _x(t, cfg.hidden_size, t)
    got = T._ffn(x[None], {"moe": moe}, cfg)[0]
    assert calls == [1]
    dense = T._moe(x, moe, cfg)
    err = (got - dense).abs().max() / dense.abs().max()
    assert err <= 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card: python -m "
                    "pytest -m cuda tests/test_torch_moe_float.py)")
    return torch.device("cuda")


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["f32", "bf16"])
@pytest.mark.parametrize("t", [300, 4096])
def test_cuda_float_grouped_branch_matches_plain(cuda_device, moelm, t,
                                                 weights):
    """The float grouped branch on the card against the CPU's: each row
    whose routes agree within 1e-2 of the largest |ref| of its row."""
    moe, cfg = moelm
    if weights == "bf16":
        moe = _on(moe, torch.bfloat16)
    x = _x(t, cfg.hidden_size, t, torch.bfloat16)
    routes = []
    route = T.route

    def recorded(*args):
        idx, w = route(*args)
        routes.append(idx.cpu())
        return idx, w

    T.route = recorded
    try:
        got = T._ffn(x.to(cuda_device)[None], {"moe": _on(moe, cuda_device)},
                     cfg)[0]
        torch.cuda.synchronize()
        ref = T._ffn(x[None], {"moe": moe}, cfg)[0]
    finally:
        T.route = route
    assert got.device.type == "cuda" and got.dtype == torch.bfloat16
    same = (routes[0].sort(-1).values == routes[1].sort(-1).values).all(-1)
    assert (~same).sum() <= FLIPS_MAX * t
    diff = (got.float().cpu() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    assert torch.isfinite(got).all()
    assert (diff[same] <= 1e-2 * scale[same]).all()


def test_chip_smoke_trained_helpers_run_on_cpu():
    """chip_smoke.py's trained phase rehearsed on the CPU at a small size:
    its weights (float, int8, W4A8 g128 and W4A8 g128 + GPTQ over two
    windows, fused), every row's perplexity
    through `trained_ppl` (2 windows of 64 tokens, cached rows 2 of 16),
    the experts' share of the routed pairs, and the stream helpers."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    params, cfg, _ = load_checkpoint(MOELM, device="cpu")
    ids = [b + 4 for b in cs.trained_text(REPO).encode()]
    seqs = sequences(ids, 64)[:2]
    cached = sequences(ids, 16)[:2]
    assert [len(x) for x in seqs] == [64, 64] and seqs[1][0] == ids[64]
    weights, gptq_s = cs.trained_weights(torch, T, params, cfg,
                                         sequences(ids, 64)[2:4])
    assert gptq_s > 0
    assert set(weights) == {name for _, name, _, _ in cs.TRAINED_ROWS}
    assert "experts_cat" in weights["w4a8 g128"]["layers"][0]["moe"]
    assert "experts_cat" in weights["w4a8 g128 gptq"]["layers"][0]["moe"]
    assert "experts" in weights["int8"]["layers"][0]["moe"]
    for row in cs.TRAINED_ROWS:
        with cs.recorded_routes(T) as routes:
            ppl = cs.trained_ppl(torch, weights, cfg, seqs, cached, row)
        assert 1 < ppl < 50, row
        if row[0] == "bf16":
            share = cs.expert_share(torch, routes, cfg.num_experts)
            assert abs(sum(share["all"]) - 1) < 1e-3
            assert len(share["layer_min"]) == cfg.num_layers
    assert cs.first_split([1, 2, 3], [1, 2, 4]) == 2
    assert cs.first_split([1, 2], [1, 2, 3]) == 2
    fused = T.fuse_params(params, cfg)
    x = torch.tensor([seqs[0]])
    lens = torch.tensor([64], dtype=torch.int32)
    logits, _ = T.forward_prefill(fused, cfg, x, lens, dtype=torch.bfloat16,
                                  logits_at=lens - 1)
    top = logits[0].float().topk(2)
    gap = cs.tie_gap(torch, T, fused, cfg, seqs[0], top.indices.tolist())
    assert gap == pytest.approx(float(top.values[0] - top.values[1]))
    assert cs.tie_gap(torch, T, fused, cfg, seqs[0], (0, 1)) is None
