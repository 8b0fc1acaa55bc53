"""Decoder-only transformer, ported from deeppowers_tpu/models/transformer.py.

Plain functions over a parameter tree of nested dicts and lists with the
JAX package's structure and key names (embedding, final_norm, layers[i] =
{ln1, ln2, attn{wq, wk, wv, wo | wqkv, wo}, mlp{w_in, w_gate, w_out | w_gu,
w_out}}, lm_head), so a JAX tree converts leaf by leaf
(models/convert.py). Any weight matrix may be a QuantizedTensor; the
decode step folds RMSNorm, GLU and the residual adds into the
dequant-matmul kernel exactly where the JAX package folds them into its
Pallas kernel (`_qkv_norm` :1435, `_attn_tail` :1453). MoE layers
(Mixtral: top-k routing over stacked experts, JAX :404-799) take the JAX
package's branches at the same token counts: the cat-fused experts
(`fuse_params`) through two wide matmuls of kernel #1 below
256 tokens and through the grouped kernels #9 and #10 from 256 on; stacked
experts through #1 per expert or plain PyTorch. Expert parallelism is not
ported (ROADMAP.md).

The KV cache is the unrolled per-layer layout, contiguous or paged, or the
stacked layout of scan-over-layers (runtime/kvcache_stacked.py, JAX
:1383-1680), bf16 or quantized (int8, int4, k8v4). The scan forwards take
stacked parameters (`stack_layer_params`) and loop over their per-layer
views where JAX's `lax.scan` walks the stacked leaves; their rows go
through kernel #8 and their attention reads layer i's views of the stacked
cache, which copy nothing. A decode or verify step writes each layer's
rows and attends in one call, `kvcache.append_attend` (JAX `_decode_attn`
:1288-1330, `_verify_attn` :1215-1256 and their stacked forms :1166-1212):
the attention launch (#3, or #5 paged) writes the rows before it reads
them, where JAX appends first. An int8-K contiguous cache may carry the kt
mirror (runtime/kvcache.py); decode and verify over it append through #2,
then take kernel #7 (JAX `_kt_path` :1259-1285). Decode over a paged cache
calls the table-walking attention kernel on the pools directly and never
gathers; decode over a quantized cache reads the raw stores and folds the
scales in the kernel. Chunked prefill attends over
the slot's dequantized rows, the chunk's own included (JAX :1103), and a
whole-prompt prefill over its fresh K/V (JAX :1040-1046), so greedy
streams follow JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..config import QuantConfig, QuantMode
from ..ops.activation import activation
from ..ops.attention import attention_chunk, attention_prefill
from ..ops.kernels.grouped_matmul import (expert_tiles,
                                         grouped_dequant_matmul,
                                         grouped_dequant_matmul_ncat)
from ..ops.matmul import glu_matmul, matmul_residual, quantized_matmul, rms_matmul
from ..ops.normalization import layer_norm, rms_norm
from ..ops.rotary import apply_rope_tables, rope_tables
from ..quant.qtypes import QuantizedTensor, pack_int4, unpack_int4
from ..quant.quantize import dequantize_stacked, quantize, quantize_stacked
from ..runtime import kvcache
from ..runtime import kvcache_stacked as st

Params = Dict[str, Any]


@dataclass(frozen=True)
class TransformerConfig:
    """Architecture hyperparameters (fields of the JAX package's config)."""

    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int = 0          # 0 => = num_heads (MHA)
    head_dim: int = 0              # 0 => hidden // heads
    intermediate_size: int = 0     # 0 => 4 * hidden
    max_seq_len: int = 2048
    norm: str = "layernorm"        # "layernorm" | "rmsnorm"
    norm_eps: float = 1e-5
    activation: str = "gelu"       # "gelu" | "silu"
    glu: bool = False
    positions: str = "learned"     # "learned" | "rope"
    rope_theta: float = 10000.0
    qkv_bias: bool = True
    attn_out_bias: bool = True
    mlp_bias: bool = True
    tie_embeddings: bool = True
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_impl: str = "auto"
    moe_capacity_slack: float = 2.0

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def dim_head(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        return self.intermediate_size or 4 * self.hidden_size

    @property
    def q_size(self) -> int:
        return self.num_heads * self.dim_head

    @property
    def kv_size(self) -> int:
        return self.kv_heads * self.dim_head


# ---------------------------------------------------------------------------
# Initialization and quantization
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator, *,
                dtype=torch.bfloat16, device=None) -> Params:
    """Random-init parameters (normal * 0.02, norms at 1), drawn on the
    generator's device. The numbers differ from JAX's threefry streams;
    parity tests convert the JAX tree instead (models/convert.py)."""
    device = device if device is not None else generator.device

    def normal(*shape):
        w = torch.randn(*shape, generator=generator, device=device,
                        dtype=torch.float32) * 0.02
        return w.to(dtype)

    def dense(k, n, bias):
        d = {"w": normal(k, n)}
        if bias:
            d["b"] = torch.zeros(n, dtype=dtype, device=device)
        return d

    def norm_p(h):
        p = {"w": torch.ones(h, dtype=dtype, device=device)}
        if cfg.norm == "layernorm":
            p["b"] = torch.zeros(h, dtype=dtype, device=device)
        return p

    h = cfg.hidden_size
    params: Params = {"embedding": normal(cfg.vocab_size, h),
                      "final_norm": norm_p(h), "layers": []}
    if cfg.positions == "learned":
        params["pos_embedding"] = normal(cfg.max_seq_len, h)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(h, cfg.vocab_size, bias=False)
    for _ in range(cfg.num_layers):
        layer = {"ln1": norm_p(h), "ln2": norm_p(h),
                 "attn": {"wq": dense(h, cfg.q_size, cfg.qkv_bias),
                          "wk": dense(h, cfg.kv_size, cfg.qkv_bias),
                          "wv": dense(h, cfg.kv_size, cfg.qkv_bias),
                          "wo": dense(cfg.q_size, h, cfg.attn_out_bias)}}
        if cfg.num_experts > 0:
            # experts stacked (E, K, N), as the JAX package keeps them
            e = cfg.num_experts
            layer["moe"] = {
                "router": dense(h, e, bias=False),
                "experts": {"w_in": {"w": normal(e, h, cfg.ffn_size)},
                            "w_gate": {"w": normal(e, h, cfg.ffn_size)},
                            "w_out": {"w": normal(e, cfg.ffn_size, h)}}}
        else:
            mlp = {"w_in": dense(h, cfg.ffn_size, cfg.mlp_bias),
                   "w_out": dense(cfg.ffn_size, h, cfg.mlp_bias)}
            if cfg.glu:
                mlp["w_gate"] = dense(h, cfg.ffn_size, cfg.mlp_bias)
            layer["mlp"] = mlp
        params["layers"].append(layer)
    return params


def init_quantized_params(cfg: TransformerConfig, qcfg: QuantConfig,
                          generator: torch.Generator, *,
                          dtype=torch.bfloat16, device=None) -> Params:
    """Random-init parameters directly in quantized form (JAX
    `init_quantized_params`, deeppowers_tpu/models/transformer.py:188-295):
    int data uniform in [-127, 127] (packed bytes for int4), scales 0.02 /
    qmax with K/g rows (1 per-channel), act_bits from `qcfg`; MoE experts
    stacked (E, K[/2], N) with (E, G, N) scales and a float router; no
    float copy of a weight is ever made. Drawn on the generator's device.
    For models whose float weights would not fit (7B, Mixtral-8x7B on one
    card); a matmul's cost does not depend on the values."""
    device = device if device is not None else generator.device
    bits = {QuantMode.INT8: 8, QuantMode.INT4: 4}[qcfg.mode]
    gs = qcfg.group_size
    scale = 0.02 / (127 if bits == 8 else 7)

    def qdense(k, n, bias, lead=()):
        g = gs if (gs and k % gs == 0) else 0
        data = torch.randint(-127, 128,
                             (*lead, k // 2 if bits == 4 else k, n),
                             generator=generator, device=device,
                             dtype=torch.int8)
        scales = torch.full((*lead, k // g if g else 1, n), scale,
                            dtype=torch.float32, device=device)
        d = {"w": QuantizedTensor(data, scales, None, bits, g,
                                  qcfg.act_bits or 0)}
        if bias:
            d["b"] = torch.zeros(n, dtype=dtype, device=device)
        return d

    def norm_p(h):
        p = {"w": torch.ones(h, dtype=dtype, device=device)}
        if cfg.norm == "layernorm":
            p["b"] = torch.zeros(h, dtype=dtype, device=device)
        return p

    def normal(*shape):
        return (torch.randn(*shape, generator=generator, device=device,
                            dtype=torch.float32) * 0.02).to(dtype)

    h = cfg.hidden_size
    params: Params = {"embedding": normal(cfg.vocab_size, h),
                      "final_norm": norm_p(h), "layers": []}
    if cfg.positions == "learned":
        params["pos_embedding"] = normal(cfg.max_seq_len, h)
    if not cfg.tie_embeddings:
        params["lm_head"] = qdense(h, cfg.vocab_size, bias=False)
    for _ in range(cfg.num_layers):
        layer = {"ln1": norm_p(h), "ln2": norm_p(h),
                 "attn": {"wq": qdense(h, cfg.q_size, cfg.qkv_bias),
                          "wk": qdense(h, cfg.kv_size, cfg.qkv_bias),
                          "wv": qdense(h, cfg.kv_size, cfg.qkv_bias),
                          "wo": qdense(cfg.q_size, h, cfg.attn_out_bias)}}
        if cfg.num_experts > 0:
            e = (cfg.num_experts,)
            layer["moe"] = {
                "router": {"w": normal(h, cfg.num_experts)},
                "experts": {"w_in": qdense(h, cfg.ffn_size, False, e),
                            "w_gate": qdense(h, cfg.ffn_size, False, e),
                            "w_out": qdense(cfg.ffn_size, h, False, e)}}
        else:
            mlp = {"w_in": qdense(h, cfg.ffn_size, cfg.mlp_bias),
                   "w_out": qdense(cfg.ffn_size, h, cfg.mlp_bias)}
            if cfg.glu:
                mlp["w_gate"] = qdense(h, cfg.ffn_size, cfg.mlp_bias)
            layer["mlp"] = mlp
        params["layers"].append(layer)
    return params


_LAYER_KIND_BY_PATH = (("attn", "attention"), ("mlp", "mlp"),
                       ("moe", "mlp"), ("lm_head", "lm_head"))


def quantize_params(params: Params, qcfg: QuantConfig) -> Params:
    """Quantize the weight matrices ("w" under attn / mlp / moe / lm_head)
    per QuantConfig; embeddings, norms and biases stay float. Every mode
    the JAX package makes (int8 or int4, per-channel or per-group, act_bits
    0 or 8, MIXED per layer kind) runs end to end, asymmetric weights
    (`symmetric=False`: zero points, weight-only) too. Stacked experts
    (E, K, N) quantize per expert, always symmetric, and the router as an
    "mlp" matrix, as JAX `quantize_params` (:297-343) does."""

    def kind_of(path):
        for fragment, kind in _LAYER_KIND_BY_PATH:
            if fragment in path:
                return kind
        return None

    def maybe_quantize(w, path):
        kind = kind_of(path)
        if kind is None or w.dim() not in (2, 3):
            return w
        if any(s in "/".join(path) for s in qcfg.skip_layers):
            return w
        mode = qcfg.mode_for_layer(kind)
        if mode in (QuantMode.NONE, QuantMode.FP16):
            return w
        bits = {QuantMode.INT8: 8, QuantMode.INT4: 4}[mode]
        kdim = w.shape[-2]
        gs = qcfg.group_size if (qcfg.group_size
                                 and kdim % qcfg.group_size == 0) else 0
        if bits == 4 and kdim % 2:
            return w
        if w.dim() == 3:
            qt = quantize_stacked(w, bits=bits, group_size=gs)
        else:
            qt = quantize(w, bits=bits, group_size=gs,
                          symmetric=qcfg.symmetric)
        if qcfg.act_bits == 8 and qt.zero_points is None:
            qt.act_bits = 8
        return qt

    def walk(node, path):
        if isinstance(node, dict):
            return {key: (maybe_quantize(val, path)
                          if key == "w" and isinstance(val, torch.Tensor)
                          else walk(val, path + (key,)))
                    for key, val in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        return node

    return walk(params, ())


def _concat_dense(nodes):
    """Fuse dense param dicts along the output axis (one device, tp = 1)."""
    ws = [n["w"] for n in nodes]
    if isinstance(ws[0], QuantizedTensor):
        if not all(isinstance(w, QuantizedTensor) and w.bits == ws[0].bits
                   and w.group_size == ws[0].group_size
                   and w.act_bits == ws[0].act_bits
                   and w.zero_points is None for w in ws):
            return None
        fused = QuantizedTensor(
            data=torch.cat([w.data for w in ws], dim=-1).contiguous(),
            scales=torch.cat([w.scales for w in ws], dim=-1).contiguous(),
            zero_points=None, bits=ws[0].bits, group_size=ws[0].group_size,
            act_bits=ws[0].act_bits)
    else:
        fused = torch.cat(ws, dim=-1)
    out = {"w": fused}
    if "b" in nodes[0]:
        out["b"] = torch.cat([n["b"] for n in nodes], dim=0)
    return out


def fuse_params(params: Params, cfg: TransformerConfig) -> Params:
    """Fuse q|k|v into wqkv and gate|up into w_gu: 4 matmul launches per
    decode layer instead of 7; and lay quantized stacked experts out again
    as the two wide matrices of `_cat_experts`, as JAX's
    `fuse_params(fuse_moe=True)` (:872-910) does on one device (the JAX
    engine without a mesh, engine.py:600-614; ep = 1)."""
    out = dict(params)
    out["layers"] = []
    for layer in params["layers"]:
        layer = dict(layer)
        ap = dict(layer["attn"])
        if "wqkv" not in ap:
            fused = _concat_dense([ap["wq"], ap["wk"], ap["wv"]])
            if fused is not None:
                ap = {"wqkv": fused, "wo": ap["wo"]}
        layer["attn"] = ap
        if "mlp" in layer and cfg.glu and "w_gu" not in layer["mlp"]:
            mlp = dict(layer["mlp"])
            fused = _concat_dense([mlp["w_gate"], mlp["w_in"]])
            if fused is not None:
                mlp = {"w_gu": fused, "w_out": mlp["w_out"]}
            layer["mlp"] = mlp
        if ("moe" in layer and cfg.glu and cfg.moe_impl != "grouped"
                and "experts_cat" not in layer["moe"]):
            cat = _cat_experts(layer["moe"]["experts"])
            if cat is not None:
                layer["moe"] = {"router": layer["moe"]["router"],
                                "experts_cat": cat}
        out["layers"].append(layer)
    return out


def _cat_experts(experts) -> Optional[Params]:
    """Lay stacked symmetric per-group experts out again (JAX
    `_cat_experts` :912-991, ep = 1), the same codes and scales:
    - w_gu (K[/2], E·2I): expert-major columns [gate_e | up_e], int4
      packed half-split over K as any 2-D weight;
    - w_out (E·I[/2], H): int8 rows expert by expert; int4 packs each
      expert apart (its I rows half-split), so the same bytes are the
      stacked (E, I/2, H) planes of the grouped kernel, and its scales are
      plane-major ([every expert's low-plane groups | high-plane groups]),
      which the 2-D matmul reads as [all lo halves | all hi halves];
    - w_out_scales_stacked: the original (E, I/g, H) scales, for #9.
    None for float, asymmetric or per-channel experts (and int4 whose
    group does not divide I/2): they keep the stacked layout."""
    qts = [experts[k]["w"] for k in ("w_gate", "w_in", "w_out")]
    if not all(isinstance(q, QuantizedTensor) and q.zero_points is None
               and q.group_size > 0 for q in qts):
        return None
    qg, qi, qo = qts
    if qo.bits == 4 and (qo.shape[1] // 2) % qo.group_size:
        return None

    def codes(qt):                       # (E, K, N) int8 codes
        return unpack_int4(qt.data, dim=1) if qt.bits == 4 else qt.data

    def replace(ref, data, scales):
        return {"w": QuantizedTensor(data.contiguous(), scales.contiguous(),
                                     None, ref.bits, ref.group_size,
                                     ref.act_bits)}

    cg, ci = codes(qg), codes(qi)
    e, k_dim, i_dim = cg.shape
    gu = torch.cat([cg, ci], dim=2).transpose(0, 1).reshape(k_dim,
                                                             e * 2 * i_dim)
    sgu = torch.cat([qg.scales, qi.scales], dim=2).transpose(0, 1).reshape(
        qg.scales.shape[1], e * 2 * i_dim)
    out = {"w_gu": replace(qg, pack_int4(gu) if qg.bits == 4 else gu, sgu)}
    co = codes(qo)                       # (E, I, H)
    h_dim = co.shape[2]
    if qo.bits == 4:
        half_g = i_dim // 2 // qo.group_size     # scale rows per half
        data = pack_int4(co, dim=1).reshape(e * i_dim // 2, h_dim)
        scales = torch.cat([qo.scales[:, :half_g].reshape(-1, h_dim),
                            qo.scales[:, half_g:].reshape(-1, h_dim)])
    else:
        data = co.reshape(e * i_dim, h_dim)
        scales = qo.scales.reshape(-1, h_dim)
    out["w_out"] = replace(qo, data, scales)
    out["w_out_scales_stacked"] = qo.scales
    return out


def param_nbytes(params: Params) -> int:
    """Model size in bytes (quantized-aware)."""
    total = 0

    def visit(node):
        nonlocal total
        if isinstance(node, dict):
            for v in node.values():
                visit(v)
        elif isinstance(node, list):
            for v in node:
                visit(v)
        elif isinstance(node, StackedLayers):
            visit(node.tree)
        elif isinstance(node, QuantizedTensor):
            total += node.nbytes
        elif isinstance(node, torch.Tensor):
            total += node.numel() * node.element_size()

    visit(params)
    return total


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _norm(x, p, cfg: TransformerConfig):
    if cfg.norm == "rmsnorm":
        return rms_norm(x, p["w"], eps=cfg.norm_eps)
    return layer_norm(x, p["w"], p.get("b"), eps=cfg.norm_eps)


def _dense(x, p, out_dtype=None):
    y = quantized_matmul(x, p["w"], out_dtype=out_dtype or x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def _act(x, cfg: TransformerConfig):
    """cfg.activation as JAX's unfused ops compute it (transformer.py:394-
    396): op by op in x's dtype below f32, F.silu / F.gelu on f32
    (ops/activation.py)."""
    return activation(x, cfg.activation)


def _mlp(x, p, cfg: TransformerConfig):
    if "w_gu" in p:
        gate, up = torch.chunk(_dense(x, p["w_gu"]), 2, dim=-1)
        return _dense(_act(gate, cfg) * up, p["w_out"])
    if cfg.glu:
        return _dense(_act(_dense(x, p["w_gate"]), cfg) * _dense(x, p["w_in"]),
                      p["w_out"])
    return _dense(_act(_dense(x, p["w_in"]), cfg), p["w_out"])


def _split_heads(x, n_heads, dim_head):
    return x.reshape(*x.shape[:-1], n_heads, dim_head)


def _split_qkv(qkv, cfg: TransformerConfig):
    q = qkv[..., :cfg.q_size]
    k = qkv[..., cfg.q_size:cfg.q_size + cfg.kv_size]
    v = qkv[..., cfg.q_size + cfg.kv_size:]
    return (_split_heads(q, cfg.num_heads, cfg.dim_head),
            _split_heads(k, cfg.kv_heads, cfg.dim_head),
            _split_heads(v, cfg.kv_heads, cfg.dim_head))


def _qkv(xn, ap, cfg: TransformerConfig):
    """Project to head-split (q, k, v), through the fused wqkv if present."""
    if "wqkv" in ap:
        return _split_qkv(_dense(xn, ap["wqkv"]), cfg)
    return (_split_heads(_dense(xn, ap["wq"]), cfg.num_heads, cfg.dim_head),
            _split_heads(_dense(xn, ap["wk"]), cfg.kv_heads, cfg.dim_head),
            _split_heads(_dense(xn, ap["wv"]), cfg.kv_heads, cfg.dim_head))


def _qkv_norm(x, layer, cfg: TransformerConfig):
    """ln1 + QKV projection; with RMSNorm and a fused wqkv the norm folds
    into the matmul kernel (one launch)."""
    ap = layer["attn"]
    if cfg.norm == "rmsnorm" and "wqkv" in ap:
        qkv = rms_matmul(x, layer["ln1"]["w"], ap["wqkv"]["w"],
                         eps=cfg.norm_eps, bias=ap["wqkv"].get("b"))
        return _split_qkv(qkv, cfg)
    return _qkv(_norm(x, layer["ln1"], cfg), ap, cfg)


# ---------------------------------------------------------------------------
# Mixture of experts (JAX :404-799, ep_axis None)
# ---------------------------------------------------------------------------

#: tokens per forward (b·s) from which MoE takes the grouped branches
#: (JAX `_MOE_GROUPED_MIN_TOKENS` :651)
MOE_GROUPED_MIN_TOKENS = 256


def route(x, router, cfg: TransformerConfig):
    """Top-k routing of x (T, H): (expert ids (T, k) int64, weights (T, k)
    f32). Router logits in f32 through `_dense`; the k largest with ties
    to the lower expert index, as `lax.top_k` breaks them (a stable sort:
    torch.topk promises no order among ties); a softmax over the k values
    in f32."""
    logits = _dense(x, router, out_dtype=torch.float32)
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    top = vals[:, :k]
    ex = torch.exp(top - top.amax(-1, keepdim=True))
    return idx[:, :k], ex / ex.sum(-1, keepdim=True)


def _sort_pairs(idx):
    """The T·k routed (token, expert) pairs sorted by expert, stably (token
    order within an expert, as `jnp.argsort`): (order, token, expert)."""
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    return order, order // idx.shape[1], flat_e[order]


def _combine(contrib, order, t, k):
    """out[t] = sum of its k contributions (P, H) f32, given in sorted
    order, added from 0 in expert order as JAX's scatter-add adds them
    (`.at[sort_t].add`): exact and the same on every run, with no atomics.
    Returns (T, H) f32."""
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device)
    sel = torch.sort(pos.reshape(t, k), dim=1).values   # expert order
    out = torch.zeros((t, contrib.shape[1]), dtype=torch.float32,
                      device=contrib.device)
    for j in range(k):
        out = out + contrib[sel[:, j]]
    return out


def _expert(qt: QuantizedTensor, e: int) -> QuantizedTensor:
    return QuantizedTensor(
        qt.data[e], qt.scales[e],
        None if qt.zero_points is None else qt.zero_points[e], qt.bits,
        qt.group_size, qt.act_bits)


def _stacked_w(node, dtype):
    """Stacked expert weights (E, K, N) in the compute dtype."""
    w = node["w"]
    if isinstance(w, QuantizedTensor):
        return dequantize_stacked(w, dtype)
    return w.to(dtype)


def _moe_quantized_dense(x, experts, cfg: TransformerConfig, weights):
    """Quantized stacked experts, every expert on every token: #1 per
    expert and projection, weighted and summed in expert order (JAX
    `_moe_quantized_dense` :420-449)."""
    acc = None
    for e in range(weights.shape[1]):
        up = quantized_matmul(x, _expert(experts["w_in"]["w"], e),
                              out_dtype=torch.float32)
        gate = _act(quantized_matmul(x, _expert(experts["w_gate"]["w"], e),
                                     out_dtype=torch.float32), cfg)
        y = quantized_matmul((gate * up).to(x.dtype),
                             _expert(experts["w_out"]["w"], e),
                             out_dtype=torch.float32)
        contrib = y * weights[:, e:e + 1]
        acc = contrib if acc is None else acc + contrib
    return acc


def _moe(x, p, cfg: TransformerConfig):
    """Top-k MoE with every expert on every token, combined by the routing
    weights (JAX `_moe` :457-545): the cat-fused experts as two wide
    matmuls through #1, quantized stacked GLU experts through #1 per
    expert, else a float einsum over the stacked weights."""
    t = x.shape[0]
    idx, top_w = route(x, p["router"], cfg)
    weights = torch.zeros((t, cfg.num_experts), dtype=torch.float32,
                          device=x.device).scatter_add_(1, idx, top_w)
    if "experts_cat" in p:
        cat, i_dim = p["experts_cat"], cfg.ffn_size
        gu = quantized_matmul(x, cat["w_gu"]["w"], out_dtype=torch.float32)
        gu = gu.reshape(t, -1, 2 * i_dim)
        inter = _act(gu[..., :i_dim], cfg) * gu[..., i_dim:] \
            * weights[:, :, None]                       # (T, E, I)
        qo = cat["w_out"]["w"]
        if qo.bits == 4:     # the per-expert packing's plane order
            half = i_dim // 2
            xo = torch.cat([inter[..., :half].reshape(t, -1),
                            inter[..., half:].reshape(t, -1)], dim=1)
        else:
            xo = inter.reshape(t, -1)
        y = quantized_matmul(xo.to(x.dtype), qo, out_dtype=torch.float32)
        return y.to(x.dtype)
    ex = p["experts"]
    if cfg.glu and all(isinstance(ex[k]["w"], QuantizedTensor)
                       for k in ("w_in", "w_gate", "w_out")):
        return _moe_quantized_dense(x, ex, cfg, weights).to(x.dtype)
    w_in = _stacked_w(ex["w_in"], x.dtype)               # (E, H, I)
    w_gate = _stacked_w(ex["w_gate"], x.dtype)
    w_out = _stacked_w(ex["w_out"], x.dtype)             # (E, I, H)
    up = torch.einsum("th,ehi->tei", x, w_in)
    gate = _act(torch.einsum("th,ehi->tei", x, w_gate), cfg)
    y = torch.einsum("tei,eih->teh", gate * up, w_out)
    return torch.einsum("teh,te->th", y.float(), weights).to(x.dtype)


def _moe_grouped(x, p, cfg: TransformerConfig):
    """Routed pairs only, over stacked float or dequantized experts (JAX
    `_moe_grouped` :548-595, ep_axis None). The pairs sorted by expert go
    through each expert's matmul in turn, a row keeping its own expert's
    result (for `lax.ragged_dot`, which no Pallas kernel computes): the
    sizes stay static and nothing is read back to the host, at E times
    the routed rows' compute."""
    t, k = x.shape[0], cfg.num_experts_per_tok
    idx, top_w = route(x, p["router"], cfg)
    order, sort_t, sort_e = _sort_pairs(idx)
    ex = p["experts"]

    def ragged(a, node):
        w = _stacked_w(node, x.dtype)
        out = None
        for e in range(w.shape[0]):
            y = torch.matmul(a, w[e])
            out = y if out is None else torch.where(
                (sort_e == e)[:, None], y, out)
        return out

    xs = x[sort_t]
    up = ragged(xs, ex["w_in"])
    gate = _act(ragged(xs, ex["w_gate"]), cfg)
    y = ragged((gate * up).to(x.dtype), ex["w_out"])
    contrib = y.float() * top_w.reshape(-1)[order][:, None]
    return _combine(contrib, order, t, k).to(x.dtype)


def _moe_grouped_cat(x, p, cfg: TransformerConfig):
    """Routed pairs only, over the cat-fused experts: the prefill branch
    (JAX `_moe_grouped_cat` :654-762, ep_axis None). The pairs sorted by
    expert are scattered into a buffer whose every expert segment starts
    on a tile of BLOCK_M rows (`expert_tiles`: static sizes, built on the
    device), then #10 over w_gu's column blocks into bf16, act(gate) * up,
    #9 over w_out viewed as stacked (E, I[/2], H) planes (a reshape, no
    copy) into f32, and the weighted combine. An a8 w_out takes gate | up
    itself: its pre-pass computes the same bf16 rows (9q's GLU mode); a
    weight-only one runs act(gate) * up as ops."""
    t, k = x.shape[0], cfg.num_experts_per_tok
    cat, i_dim = p["experts_cat"], cfg.ffn_size
    qgu, qo = cat["w_gu"]["w"], cat["w_out"]["w"]
    e = qgu.shape[1] // (2 * i_dim)
    idx, top_w = route(x, p["router"], cfg)
    order, sort_t, sort_e = _sort_pairs(idx)
    flat_e = idx.reshape(-1)         # bincount would read its max back
    counts = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    dest, te, m_pad = expert_tiles(sort_e, counts)
    xs = torch.zeros((m_pad, x.shape[1]), dtype=x.dtype, device=x.device)
    xs[dest] = x[sort_t]
    gu = grouped_dequant_matmul_ncat(xs, qgu, te, 2 * i_dim,
                                     out_dtype=torch.bfloat16)
    stacked = QuantizedTensor(qo.data.reshape(e, -1, qo.data.shape[1]),
                              cat["w_out_scales_stacked"], None, qo.bits,
                              qo.group_size, qo.act_bits)
    if qo.act_bits == 8:
        # #9's a8 pre-pass computes act(gate) * up from gu as it quantizes
        y = grouped_dequant_matmul(gu, stacked, te, out_dtype=torch.float32,
                                   glu=True, act=cfg.activation)
    else:
        inter = (_act(gu[:, :i_dim].float(), cfg)
                 * gu[:, i_dim:].float()).to(x.dtype)
        y = grouped_dequant_matmul(inter, stacked, te,
                                   out_dtype=torch.float32)
    contrib = y[dest] * top_w.reshape(-1)[order][:, None]
    return _combine(contrib, order, t, k).to(x.dtype)


def _ffn(x, layer, cfg: TransformerConfig):
    """The layer's FFN. MoE takes the JAX package's branch for the
    forward's flattened token count T = b·s (JAX `_ffn` :769-799): the
    cat-fused experts go grouped from MOE_GROUPED_MIN_TOKENS on, else
    dense-combine; stacked experts follow `cfg.moe_impl`. Under int8
    activations the cat branches compute different functions (row-wide
    against per-group quantization), so the branch is part of the
    result."""
    if "moe" not in layer:
        return _mlp(x, layer["mlp"], cfg)
    b, s, h = x.shape
    moe = layer["moe"]
    if "experts_cat" in moe:
        grouped = (b * s >= MOE_GROUPED_MIN_TOKENS
                   and "w_out_scales_stacked" in moe["experts_cat"])
        fn = _moe_grouped_cat if grouped else _moe
    else:
        impl = cfg.moe_impl
        if impl == "auto":
            impl = "grouped" if b * s >= MOE_GROUPED_MIN_TOKENS else "dense"
        fn = _moe_grouped if impl == "grouped" else _moe
    return fn(x.reshape(b * s, h), moe, cfg).reshape(b, s, h)


def _attn_tail(x, attn, ap, layer, cfg: TransformerConfig):
    """Output projection + residual, ln2, FFN + residual, with the residual
    adds, RMSNorm and GLU folded into the matmul kernels."""
    x = matmul_residual(attn, ap["wo"]["w"], x, bias=ap["wo"].get("b"))
    mlp = layer.get("mlp")
    if mlp is not None and cfg.norm == "rmsnorm" and "w_gu" in mlp:
        gu = rms_matmul(x, layer["ln2"]["w"], mlp["w_gu"]["w"],
                        eps=cfg.norm_eps, bias=mlp["w_gu"].get("b"))
        return glu_matmul(gu, mlp["w_out"]["w"], act=cfg.activation,
                          residual=x, bias=mlp["w_out"].get("b"))
    return x + _ffn(_norm(x, layer["ln2"], cfg), layer, cfg)


def _embed(params, cfg: TransformerConfig, input_ids, positions, dtype):
    """Token (+ learned position) embedding. Ids outside the vocabulary
    (the engine's padding) read row 0: torch's embedding would fault on
    them, and only positions below each prompt's length are ever used."""
    ids = torch.where((input_ids >= 0) & (input_ids < cfg.vocab_size),
                      input_ids, torch.zeros_like(input_ids))
    x = F.embedding(ids, params["embedding"]).to(dtype)
    if cfg.positions == "learned":
        x = x + F.embedding(positions, params["pos_embedding"]).to(dtype)
    return x


def _logits(params, cfg: TransformerConfig, x):
    x = _norm(x, params["final_norm"], cfg)
    if cfg.tie_embeddings:
        return torch.matmul(x.float(), params["embedding"].float().T)
    return quantized_matmul(x, params["lm_head"]["w"], out_dtype=torch.float32)


def _residual_tail(x, attn, ap, layer, cfg: TransformerConfig):
    """The unrolled prefill forwards' tail (JAX :1047-1055, :1105-1114):
    the output projection and the FFN, each added to the residual after its
    own rounding."""
    x = x + _dense(attn, ap["wo"])
    return x + _ffn(_norm(x, layer["ln2"], cfg), layer, cfg)


def _prefill(params, cfg: TransformerConfig, input_ids, lengths, dtype,
             logits_at, on_kv, tail):
    """The whole-prompt forward over padded prompts (B, S): `on_kv(i, k,
    v)` receives layer i's K/V (B, S, Kh, D), `tail` ends each layer.
    Returns the logits, (B, S, V) f32 or (B, V) at `logits_at`."""
    b, s = input_ids.shape
    positions = torch.arange(s, device=input_ids.device).expand(b, s)
    x = _embed(params, cfg, input_ids, positions, dtype)
    if cfg.positions == "rope":
        rope = rope_tables(positions, cfg.dim_head, theta=cfg.rope_theta)
    for i, layer in enumerate(_scan_layers(params)):
        ap = layer["attn"]
        q, k, v = _qkv(_norm(x, layer["ln1"], cfg), ap, cfg)
        if cfg.positions == "rope":
            q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
        on_kv(i, k, v)
        attn = attention_prefill(q, k, v, lengths=lengths)
        x = tail(x, attn.reshape(b, s, cfg.q_size), ap, layer, cfg)
    if logits_at is not None:
        x = x[torch.arange(b, device=x.device), logits_at.long()]
    return _logits(params, cfg, x)


def forward_prefill(params: Params, cfg: TransformerConfig,
                    input_ids: torch.Tensor, lengths: torch.Tensor, *,
                    dtype=torch.bfloat16,
                    logits_at: Optional[torch.Tensor] = None):
    """Full-prompt forward over padded prompts (B, S) with valid lengths
    (B,). Returns (logits, per-layer [(k, v)] each (B, S, Kh, D)); logits
    are (B, S, V) f32, or (B, V) at positions `logits_at` (B,) when given
    (the engine needs only each prompt's last position)."""
    kv_out = []
    logits = _prefill(params, cfg, input_ids, lengths, dtype, logits_at,
                      lambda i, k, v: kv_out.append((k, v)), _residual_tail)
    return logits, kv_out


def _prefill_chunk(params, cfg: TransformerConfig, input_ids, caches, slot,
                   start, dtype, logits_at, tail):
    c = input_ids.shape[0]
    positions = start + torch.arange(c, device=input_ids.device)
    x = _embed(params, cfg, input_ids[None], positions[None], dtype)
    if cfg.positions == "rope":
        rope = rope_tables(positions[None], cfg.dim_head, theta=cfg.rope_theta)
    for layer, cache in zip(_scan_layers(params), caches):
        ap = layer["attn"]
        q, k, v = _qkv(_norm(x, layer["ln1"], cfg), ap, cfg)
        if cfg.positions == "rope":
            q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
        kvcache.write_chunk(cache, k[0], v[0], slot, start)
        kc, vc = kvcache.slot_view(cache, slot, start + c, dtype)
        attn = attention_chunk(q, kc, vc, start)
        x = tail(x, attn.reshape(1, c, cfg.q_size), ap, layer, cfg)
    x = x[0] if logits_at is None else x[0, logits_at]
    return _logits(params, cfg, x)


def forward_prefill_chunk(params: Params, cfg: TransformerConfig,
                          input_ids: torch.Tensor, caches, slot: int,
                          start: int, *, dtype=torch.bfloat16,
                          logits_at: Optional[int] = None):
    """One prefill chunk (C,) of one request (JAX :1060-1109): writes the
    chunk's K/V into the slot's rows start..start+C and attends over the
    slot's rows up to start + C with the causal frontier at start + i.
    Returns (logits, caches): (C, V) f32, or (V,) at chunk index
    `logits_at` when given. Positions past the prompt's length produce K/V
    that decode never reads (it masks by length)."""
    logits = _prefill_chunk(params, cfg, input_ids, caches, slot, start,
                            dtype, logits_at, _residual_tail)
    return logits, tuple(caches)


def forward_decode(params: Params, cfg: TransformerConfig,
                   token_ids: torch.Tensor, caches, lengths: torch.Tensor, *,
                   dtype=torch.bfloat16, active: Optional[torch.Tensor] = None):
    """One decode step for all slots: appends each slot's token K/V at
    position lengths[b] (in place) and attends over lengths + 1 entries.
    With `active` (B,) bool, an inactive slot neither writes nor reads its
    cache: its rows may belong to a prompt in chunked prefill or to a
    retired prompt kept for prefix reuse (the JAX engine writes them at
    row lengths[b] = 0). Returns (logits (B, V) f32, caches)."""
    b = token_ids.shape[0]
    positions = lengths.long()
    x = _embed(params, cfg, token_ids[:, None], positions[:, None], dtype)
    if cfg.positions == "rope":
        rope = rope_tables(positions[:, None], cfg.dim_head,
                           theta=cfg.rope_theta)
    attn_lengths = lengths + 1
    write_pos = positions
    if active is not None:
        write_pos = torch.where(active, positions,
                                torch.full_like(positions, -1))
        attn_lengths = torch.where(active, attn_lengths,
                                   torch.zeros_like(attn_lengths))
    at = kvcache.decode_rows(caches[0], write_pos[:, None])
    for layer, cache in zip(_scan_layers(params), caches):
        ap = layer["attn"]
        q, k, v = _qkv_norm(x, layer, cfg)
        if cfg.positions == "rope":
            q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
        attn = kvcache.append_attend(cache, q, k, v, attn_lengths, at)
        x = _attn_tail(x, attn.reshape(b, 1, cfg.q_size), ap, layer, cfg)
    return _logits(params, cfg, x)[:, 0], tuple(caches)


def forward_verify(params: Params, cfg: TransformerConfig,
                   token_ids: torch.Tensor, caches, lengths: torch.Tensor, *,
                   dtype=torch.bfloat16,
                   active: Optional[torch.Tensor] = None):
    """Speculative-verification forward (JAX :1119-1163): T tokens a slot
    in one pass. token_ids (B, T): column 0 is each slot's current token
    (its K/V goes to position lengths[b]), columns 1..T-1 are drafts.
    All T positions' K/V are written (rows of rejected drafts stay stale
    past the slot's length, masked on every later read, then overwritten);
    positions past the cache are dropped. Returns (logits (B, T, V) f32,
    caches); logits[:, t] is the distribution after input t. With `active`
    (B,) bool, an inactive slot neither writes nor reads its cache, as in
    `forward_decode`. The forward's token count for an MoE layer's branch
    is B*T, as JAX's."""
    b, t = token_ids.shape
    positions = lengths.long()[:, None] + torch.arange(
        t, device=token_ids.device)[None, :]                  # (B, T)
    # a window near the cache end runs past a learned position table; those
    # rows are dropped and never emitted, so they read its last row
    x = _embed(params, cfg, token_ids,
               positions.clamp(max=cfg.max_seq_len - 1), dtype)
    if cfg.positions == "rope":
        rope = rope_tables(positions, cfg.dim_head, theta=cfg.rope_theta)
    attn_lengths = lengths + t
    write_pos = positions
    if active is not None:
        write_pos = torch.where(active[:, None], positions,
                                torch.full_like(positions, -1))
        attn_lengths = torch.where(active, attn_lengths,
                                   torch.zeros_like(attn_lengths))
    at = kvcache.decode_rows(caches[0], write_pos)
    for layer, cache in zip(_scan_layers(params), caches):
        ap = layer["attn"]
        q, k, v = _qkv_norm(x, layer, cfg)
        if cfg.positions == "rope":
            q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
        attn = kvcache.append_attend(cache, q, k, v, attn_lengths, at)
        x = _attn_tail(x, attn.reshape(b, t, cfg.q_size), ap, layer, cfg)
    return _logits(params, cfg, x), tuple(caches)


# ---------------------------------------------------------------------------
# Scan over layers (RuntimeConfig.scan_layers, JAX :1383-1680)
# ---------------------------------------------------------------------------

@dataclass
class StackedLayers:
    """params["layers"] of a scan model: `tree`, the layers' common
    structure with every leaf stacked on a leading L axis (JAX
    `stack_layer_params`), and `views`, layer i's parameters as views of
    those leaves (built once: a forward loops over them)."""

    tree: Any
    views: List[Any]


def _signature(node):
    """Structure, shapes, dtypes and quantization of a layer's tree: layers
    stack only where these agree."""
    if isinstance(node, dict):
        return ("dict", tuple((k, _signature(v)) for k, v in node.items()))
    if isinstance(node, list):
        return ("list", tuple(_signature(v) for v in node))
    if isinstance(node, QuantizedTensor):
        return ("qt", node.bits, node.group_size, node.act_bits,
                node.zero_points is None, tuple(node.data.shape),
                tuple(node.scales.shape), node.data.dtype)
    if isinstance(node, torch.Tensor):
        return ("tensor", tuple(node.shape), node.dtype)
    return ("leaf", node)


def _stack(nodes):
    first = nodes[0]
    if isinstance(first, dict):
        return {k: _stack([n[k] for n in nodes]) for k in first}
    if isinstance(first, list):
        return [_stack([n[i] for n in nodes]) for i in range(len(first))]
    if isinstance(first, QuantizedTensor):
        zp = (None if first.zero_points is None
              else torch.stack([n.zero_points for n in nodes]))
        return QuantizedTensor(torch.stack([n.data for n in nodes]),
                               torch.stack([n.scales for n in nodes]), zp,
                               first.bits, first.group_size, first.act_bits)
    if isinstance(first, torch.Tensor):
        return torch.stack(nodes)
    return first


def _index(node, i: int):
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    if isinstance(node, list):
        return [_index(v, i) for v in node]
    if isinstance(node, QuantizedTensor):
        return QuantizedTensor(
            node.data[i], node.scales[i],
            None if node.zero_points is None else node.zero_points[i],
            node.bits, node.group_size, node.act_bits)
    if isinstance(node, torch.Tensor):
        return node[i]
    return node


def stack_layer_params(params: Params) -> Params:
    """Stack params["layers"] into one tree whose leaves lead with the
    layer axis (JAX `stack_layer_params` :1395). The layers must agree in
    structure, shapes, dtypes and quantization; mixed precision across
    depth raises ValueError, as in JAX. Stacked params pass through."""
    layers = params["layers"]
    if not isinstance(layers, list):
        return params
    ref = _signature(layers[0])
    for i, layer in enumerate(layers[1:], 1):
        if _signature(layer) != ref:
            raise ValueError(
                f"scan_layers needs homogeneous layers; layer {i} differs "
                f"from layer 0 (mixed per-depth precision or structure)")
    tree = _stack(layers)
    out = dict(params)
    out["layers"] = StackedLayers(
        tree, [_index(tree, i) for i in range(len(layers))])
    return out


def _scan_layers(params: Params):
    """Each layer's parameters, in order: the list of an unrolled tree, or
    the views of a stacked one (JAX `_scan_layers` :1418 runs `lax.scan`
    over the stacked leaves; an eager loop has nothing to compile once)."""
    layers = params["layers"]
    return layers.views if isinstance(layers, StackedLayers) else layers


def forward_decode_scan(params: Params, cfg: TransformerConfig,
                        token_ids: torch.Tensor, cache, lengths: torch.Tensor,
                        *, dtype=torch.bfloat16,
                        active: Optional[torch.Tensor] = None):
    """`forward_decode` over stacked layers and the stacked cache (JAX
    :1480): each layer appends through kernel #8 and attends over its views
    of the stacked cache. Returns (logits (B, V) f32, cache)."""
    logits, _ = forward_decode(params, cfg, token_ids, st.layers(cache),
                               lengths, dtype=dtype, active=active)
    return logits, cache


def forward_verify_scan(params: Params, cfg: TransformerConfig,
                        token_ids: torch.Tensor, cache, lengths: torch.Tensor,
                        *, dtype=torch.bfloat16,
                        active: Optional[torch.Tensor] = None):
    """`forward_verify` over stacked layers and the stacked cache (JAX
    :1590). Returns (logits (B, T, V) f32, cache)."""
    logits, _ = forward_verify(params, cfg, token_ids, st.layers(cache),
                               lengths, dtype=dtype, active=active)
    return logits, cache


def forward_prefill_scan_batch(params: Params, cfg: TransformerConfig,
                               input_ids: torch.Tensor, lengths: torch.Tensor,
                               slots: torch.Tensor, cache, *,
                               dtype=torch.bfloat16):
    """Batched prefill over stacked layers (JAX :1543): B padded prompts
    (B, S) with lengths (B,), each layer's K/V written into [layer, slots]
    through kernel #8 (a slot out of range drops its rows), and JAX's
    scan-body tail (`_attn_tail`, with the residual adds, RMSNorm and GLU
    folded into the matmul kernels, where the unrolled prefill adds after
    each rounding). Returns (cache, last-position logits (B, V) f32)."""
    last = _prefill(params, cfg, input_ids, lengths, dtype, lengths - 1,
                    lambda i, k, v: st.write_prompts_layer(cache, i, k, v,
                                                           slots),
                    _attn_tail)
    return cache, last


def forward_prefill_scan(params: Params, cfg: TransformerConfig,
                         input_ids: torch.Tensor, length, slot, cache, *,
                         dtype=torch.bfloat16):
    """One padded prompt (S,) into `slot` (JAX :1516): the B = 1 wrapper of
    `forward_prefill_scan_batch`. Returns (cache, last logits (V,) f32)."""
    dev = input_ids.device
    cache, last = forward_prefill_scan_batch(
        params, cfg, input_ids[None],
        torch.as_tensor(length, device=dev).reshape(1),
        torch.as_tensor(slot, device=dev).reshape(1), cache, dtype=dtype)
    return cache, last[0]


def forward_prefill_chunk_scan(params: Params, cfg: TransformerConfig,
                               input_ids: torch.Tensor, cache, slot: int,
                               start: int, *, dtype=torch.bfloat16,
                               logits_at: Optional[int] = None):
    """`forward_prefill_chunk` over stacked layers (JAX :1624): the chunk's
    rows go through kernel #8, attention reads the slot's rows of each
    layer, and each layer ends with `_attn_tail`, as JAX's scan body does.
    Returns (logits, cache)."""
    logits = _prefill_chunk(params, cfg, input_ids, st.layers(cache), slot,
                            start, dtype, logits_at, _attn_tail)
    return logits, cache
