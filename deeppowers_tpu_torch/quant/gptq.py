"""GPTQ: second-order (Hessian-compensated) weight quantization, ported
from deeppowers_tpu/quant/gptq.py.

GPTQ (Frantar et al., 2022) quantizes the K (input) rows of each weight
matrix in order and, after each row, moves its quantization error onto
the rows not yet quantized through the inverse Hessian H^-1 = (X^T X +
lambda I)^-1 of the layer's calibration inputs, minimizing ||XW - XQ||^2
rather than ||W - Q||^2. Weights are (K, N) with y = x @ W, so the
recursion runs over rows k, and per-group scales (g | K) are recomputed
from the current, error-compensated rows as the walk enters each group.
The result is the port's QuantizedTensor (half-split int4 packing, (K/g,
N) f32 scales), which kernel #1 and the expert kernels take unchanged.

Everything runs in torch on the weights' device: the Hessians' sums in
f32 (TF32 stays off, PyTorch's default), the damped inverse and its
Cholesky factor in f64, the row walk in f32 with JAX's operations one by
one (the row update an outer product, then a subtraction, as numpy
computes them), so that on the CPU the codes and scales are JAX's bit for
bit or within the share the tests state. The walk is column-separable:
every operation acts on each column apart, so matrices that share a
Hessian (wq | wk | wv, w_in | w_gate) are walked together, as one (K, N1 +
N2 + ...) matrix, with the same result for each column.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from ..config import QuantConfig, QuantMode
from ..models import transformer as T
from ..models.transformer import TransformerConfig
from .qtypes import QuantizedTensor, pack_int4
from .smooth import _glu_inter, _is_glu, calibration_forward


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def gptq_matrix(w: torch.Tensor, xtx: torch.Tensor, *, bits: int,
                group_size: int = 0, percdamp: float = 0.01
                ) -> QuantizedTensor:
    """Quantize one (K, N) matrix against its input second moments
    (K, K), on w's device (JAX :45-91)."""
    dev = w.device
    w = w.detach().to(torch.float32).clone()      # the compensated copy
    k_dim, n = w.shape
    qmax = _qmax(bits)
    g = group_size if (group_size and k_dim % group_size == 0) else 0
    n_groups = (k_dim // g) if g else 1

    H = xtx.detach().to(device=dev, dtype=torch.float64).clone()
    dead = torch.nonzero(torch.diagonal(H) <= 0).reshape(-1)
    H[dead, dead] = 1.0
    w[dead] = 0.0
    damp = percdamp * float(torch.diagonal(H).mean())
    H.diagonal().add_(damp)
    # upper-triangular U with H^-1 = U^T U; U[k, k:] drives row k's update
    U = torch.linalg.cholesky(torch.linalg.inv(H)).T.to(torch.float32)

    qmax_t = torch.tensor(float(qmax), dtype=torch.float32, device=dev)
    q_codes = torch.empty((k_dim, n), dtype=torch.int8, device=dev)
    scales = torch.zeros((n_groups, n), dtype=torch.float32, device=dev)
    s = None
    for k in range(k_dim):
        if k == 0 or (g and k % g == 0):
            # the scale from the current rows of the group: they have
            # absorbed the earlier rows' errors
            gi = k // g if g else 0
            rows = w[k:k + g] if g else w
            scales[gi] = rows.abs().amax(0).clamp_min(1e-10) / qmax_t
            s = scales[gi]
        q = torch.round(w[k] / s).clamp_(-qmax - 1, qmax)
        q_codes[k] = q.to(torch.int8)
        err = (w[k] - q * s) / U[k, k]
        if k + 1 < k_dim:
            w[k + 1:] -= torch.outer(U[k, k + 1:], err)
    data = pack_int4(q_codes) if bits == 4 else q_codes
    return QuantizedTensor(data=data, scales=scales, zero_points=None,
                           bits=bits, group_size=g)


def collect_xtx(params: Any, cfg: TransformerConfig,
                sample_ids: Sequence[Sequence[int]],
                *, dtype=torch.float32) -> List[Dict[str, torch.Tensor]]:
    """Per-layer input second moments X^T X of every quantized matmul,
    f32 on the params' device (JAX :94-189): [{"qkv", "wo", "mlp_in",
    "mlp_out"} per layer] and a last {"lm_head"}. wq / wk / wv share xn,
    w_in / w_gate share xn2. An MoE layer has "mlp_in" (the router's) and
    per-expert Hessians "moe_in" (E, H, H) and "moe_out" (E, I, I), each
    row weighted by the router's top-k softmax weight of the expert (the
    top k with ties to the lower expert id, as `jax.lax.top_k`)."""

    def xtx_of(t, valid):
        t = torch.where(valid, t, 0.0).float()
        flat = t.reshape(-1, t.shape[-1])
        return flat.T @ flat

    stats: List[Dict[str, torch.Tensor]] = []
    final: Dict[str, torch.Tensor] = {}
    st: Dict[str, torch.Tensor] = {}
    gen = calibration_forward(params, cfg, sample_ids, dtype=dtype)
    ffn = None
    while True:
        try:
            layer, valid, (stage, t) = gen.send(ffn)
        except StopIteration:
            break
        ffn = None
        if stage == "ln1":
            st["qkv"] = xtx_of(t, valid)
        elif stage == "attn":
            st["wo"] = xtx_of(t, valid)
        elif stage == "ln2":
            st["mlp_in"] = xtx_of(t, valid)
            if _is_glu(layer, cfg):
                inter, ffn = _glu_inter(t, layer["mlp"], cfg)
                st["mlp_out"] = xtx_of(inter, valid)
            elif "moe" in layer:
                st["moe_in"], st["moe_out"] = _expert_hessians(
                    t, valid, layer["moe"], cfg)
            elif "mlp" in layer and "w_in" in layer["mlp"]:
                inter = T._act(T._dense(t, layer["mlp"]["w_in"]), cfg)
                st["mlp_out"] = xtx_of(inter, valid)
            stats.append(st)
            st = {}
        elif "lm_head" in params:                       # "final"
            xf = (T._norm(t, params["final_norm"], cfg)
                  if "final_norm" in params else t)
            final["lm_head"] = xtx_of(xf, valid)
    stats.append(final)
    return stats


def _expert_hessians(xn2, valid, moe, cfg: TransformerConfig):
    """Per-expert X^T diag(w_e) X of the ln2 output and of each expert's
    GLU input, w_e the router's softmax weight of expert e for each row
    (zero where e is not in the row's top k; JAX :143-174)."""
    xf = torch.where(valid, xn2, 0.0).float().reshape(-1, xn2.shape[-1])
    logits = xf @ moe["router"]["w"].float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    kk = cfg.num_experts_per_tok
    top_w = torch.softmax(vals[:, :kk], dim=-1)
    wts = torch.zeros((xf.shape[0], cfg.num_experts), dtype=torch.float32,
                      device=xf.device)
    wts.scatter_add_(1, idx[:, :kk], top_w)
    ex = moe["experts"]
    w_in, w_gate = ex["w_in"]["w"].float(), ex["w_gate"]["w"].float()
    h_in, h_out = [], []
    for e in range(cfg.num_experts):
        we = wts[:, e:e + 1]
        h_in.append(xf.T @ (xf * we))
        inter = T._act(xf @ w_gate[e], cfg) * (xf @ w_in[e])
        h_out.append(inter.T @ (inter * we))
    return torch.stack(h_in), torch.stack(h_out)


#: the Hessian of each matrix, and the matrices walked together
_KEY_BY_NAME = {"wq": "qkv", "wk": "qkv", "wv": "qkv", "wo": "wo",
                "w_in": "mlp_in", "w_gate": "mlp_in", "w_out": "mlp_out"}


def _joint(ws: List[torch.Tensor], xtx, bits, group_size, percdamp,
           act_bits) -> List[QuantizedTensor]:
    """`gptq_matrix` of matrices sharing one Hessian, walked as their
    column concatenation and split again (each column's result is its
    own walk's)."""
    qt = gptq_matrix(torch.cat([w.float() for w in ws], dim=1), xtx,
                     bits=bits, group_size=group_size, percdamp=percdamp)
    out, c0 = [], 0
    for w in ws:
        c1 = c0 + w.shape[1]
        out.append(QuantizedTensor(
            data=qt.data[:, c0:c1].contiguous(),
            scales=qt.scales[:, c0:c1].contiguous(), zero_points=None,
            bits=bits, group_size=qt.group_size,
            act_bits=8 if act_bits == 8 else 0))
        c0 = c1
    return out


def gptq_quantize(params: Any, cfg: TransformerConfig,
                  sample_ids: Sequence[Sequence[int]],
                  qcfg: QuantConfig, *, percdamp: float = 0.01,
                  smooth: bool = False,
                  stats: Optional[List[Dict[str, torch.Tensor]]] = None
                  ) -> Any:
    """`quantize_params` with GPTQ's error compensation on every matrix
    whose calibration input is observed: attention and MLP projections,
    the MoE router and each expert (against its routed-token Hessian), and
    the lm_head; anything else quantizes round-to-nearest through
    `quantize_params` (JAX :195-314). smooth=True runs AWQ's 4-edge
    smoothing first and collects the Hessians on the smoothed model.
    `stats`, when given, are `collect_xtx`'s of these params."""
    if qcfg.mode not in (QuantMode.INT8, QuantMode.INT4):
        raise ValueError(
            f"gptq_quantize supports INT8/INT4, not {qcfg.mode.value!r} "
            "(per-layer MIXED calibrated quantization goes through AWQ)")
    if smooth:
        from .smooth import collect_awq_stats, smooth_params_ex
        params, _ = smooth_params_ex(
            params, cfg, collect_awq_stats(params, cfg, sample_ids))
        stats = None
    bits = {QuantMode.INT8: 8, QuantMode.INT4: 4}[qcfg.mode]
    if stats is None:
        stats = collect_xtx(params, cfg, sample_ids)
    layer_stats, final_stats = stats[:-1], stats[-1]
    gs, act = qcfg.group_size, qcfg.act_bits

    out = dict(params)
    out["layers"] = []
    for layer, st in zip(params["layers"], layer_stats):
        new_layer = {}
        for part_name, part in layer.items():
            if not isinstance(part, dict):
                new_layer[part_name] = part
            elif part_name == "moe" and "moe_in" in st:
                new_layer[part_name] = _gptq_moe(part, st, bits, gs,
                                                 percdamp, act)
            else:
                new_layer[part_name] = _gptq_part(part, st, bits, gs,
                                                  percdamp, act)
        out["layers"].append(new_layer)

    node = params.get("lm_head")
    if (isinstance(node, dict) and "lm_head" in final_stats
            and isinstance(node.get("w"), torch.Tensor)
            and node["w"].dim() == 2):
        out["lm_head"] = dict(node, w=_joint(
            [node["w"]], final_stats["lm_head"], bits, gs, percdamp,
            act)[0])
    # anything not walked above (odd K for int4, experts of odd K) still
    # quantizes round-to-nearest, so the model is uniformly quantized
    return T.quantize_params(out, qcfg)


def _gptq_part(part, st, bits, gs, percdamp, act):
    """The dense matrices of an "attn" or "mlp" part, those sharing a
    Hessian walked together."""
    groups: Dict[str, List[str]] = {}
    for name, node in part.items():
        key = _KEY_BY_NAME.get(name)
        if (key is not None and key in st and isinstance(node, dict)
                and isinstance(node.get("w"), torch.Tensor)
                and node["w"].dim() == 2
                and not (bits == 4 and node["w"].shape[0] % 2)):
            groups.setdefault(key, []).append(name)
    new_part = dict(part)
    for key, names in groups.items():
        qts = _joint([part[nm]["w"] for nm in names], st[key], bits, gs,
                     percdamp, act)
        for nm, qt in zip(names, qts):
            new_part[nm] = dict(part[nm], w=qt)
    return new_part


def _gptq_moe(part, st, bits, gs, percdamp, act):
    """The router against the shared input Hessian; each expert's w_in |
    w_gate against its routed-token Hessian of the input, w_out against
    that of its GLU input."""
    moe = dict(part)
    r = dict(part["router"])
    if not (bits == 4 and r["w"].shape[0] % 2):
        r["w"] = _joint([r["w"]], st["mlp_in"], bits, gs, percdamp, act)[0]
    moe["router"] = r
    ex = dict(part["experts"])
    w_in, w_gate, w_out = (ex[nm]["w"] for nm in ("w_in", "w_gate", "w_out"))
    done: Dict[str, List[QuantizedTensor]] = {"w_in": [], "w_gate": [],
                                              "w_out": []}
    for e in range(w_in.shape[0]):
        if not (bits == 4 and w_in.shape[1] % 2):
            qi, qg = _joint([w_in[e], w_gate[e]], st["moe_in"][e], bits, gs,
                            percdamp, act)
            done["w_in"].append(qi)
            done["w_gate"].append(qg)
        if not (bits == 4 and w_out.shape[1] % 2):
            done["w_out"].append(_joint([w_out[e]], st["moe_out"][e], bits,
                                        gs, percdamp, act)[0])
    for nm, slices in done.items():
        if slices:
            ex[nm] = dict(ex[nm], w=QuantizedTensor(
                data=torch.stack([q.data for q in slices]),
                scales=torch.stack([q.scales for q in slices]),
                zero_points=None, bits=bits,
                group_size=slices[0].group_size,
                act_bits=8 if act == 8 else 0))
    moe["experts"] = ex
    return moe
