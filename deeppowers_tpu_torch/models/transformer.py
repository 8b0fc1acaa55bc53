"""Decoder-only transformer, ported from deeppowers_tpu/models/transformer.py.

Plain functions over a parameter tree of nested dicts and lists with the
JAX package's structure and key names (embedding, final_norm, layers[i] =
{ln1, ln2, attn{wq, wk, wv, wo | wqkv, wo}, mlp{w_in, w_gate, w_out | w_gu,
w_out}}, lm_head), so a JAX tree converts leaf by leaf
(models/convert.py). Any weight matrix may be a QuantizedTensor; the
decode step folds RMSNorm, GLU and the residual adds into the
dequant-matmul kernel exactly where the JAX package folds them into its
Pallas kernel (`_qkv_norm` :1435, `_attn_tail` :1453). Dense (non-MoE)
layers only in this slice.

The KV cache is the unrolled per-layer layout, contiguous or paged, bf16
or quantized (int8, int4, k8v4): the JAX package's stacked
scan-over-layers layout exists to cut XLA compile time, which an eager
PyTorch program does not have. Decode over a paged cache calls the
table-walking attention kernel on the pools directly and never gathers;
decode over a quantized cache reads the raw stores and folds the scales in
the kernel (JAX `_decode_attn` :1288-1330). Chunked prefill attends over
the slot's dequantized rows, the chunk's own included (JAX :1103), and a
whole-prompt prefill over its fresh K/V (JAX :1040-1046), so greedy
streams follow JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..config import QuantConfig, QuantMode
from ..ops.attention import (attention_chunk, attention_decode_auto,
                             attention_prefill)
from ..ops.kernels.decode_attention import decode_attention_paged
from ..ops.matmul import glu_matmul, matmul_residual, quantized_matmul, rms_matmul
from ..ops.normalization import layer_norm, rms_norm
from ..ops.rotary import apply_rope_tables, rope_tables
from ..quant.qtypes import QuantizedTensor
from ..quant.quantize import quantize
from ..runtime import kvcache

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


def _dense_only(cfg: TransformerConfig) -> None:
    if cfg.num_experts > 0:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP.md)")


# ---------------------------------------------------------------------------
# Initialization and quantization
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator, *,
                dtype=torch.bfloat16, device=None) -> Params:
    """Random-init parameters (normal * 0.02, norms at 1), drawn on the
    generator's device. The numbers differ from JAX's threefry streams;
    parity tests convert the JAX tree instead (models/convert.py)."""
    _dense_only(cfg)
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
        mlp = {"w_in": dense(h, cfg.ffn_size, cfg.mlp_bias),
               "w_out": dense(cfg.ffn_size, h, cfg.mlp_bias)}
        if cfg.glu:
            mlp["w_gate"] = dense(h, cfg.ffn_size, cfg.mlp_bias)
        params["layers"].append({
            "ln1": norm_p(h), "ln2": norm_p(h),
            "attn": {"wq": dense(h, cfg.q_size, cfg.qkv_bias),
                     "wk": dense(h, cfg.kv_size, cfg.qkv_bias),
                     "wv": dense(h, cfg.kv_size, cfg.qkv_bias),
                     "wo": dense(cfg.q_size, h, cfg.attn_out_bias)},
            "mlp": mlp})
    return params


def init_quantized_params(cfg: TransformerConfig, qcfg: QuantConfig,
                          generator: torch.Generator, *,
                          dtype=torch.bfloat16, device=None) -> Params:
    """Random-init parameters directly in quantized form (JAX
    `init_quantized_params`, deeppowers_tpu/models/transformer.py:188-295,
    dense layers): int data uniform in [-127, 127] (packed bytes for
    int4), scales 0.02 / qmax with K/g rows (1 per-channel), act_bits from
    `qcfg`; no float copy of a weight is ever made. Drawn on the
    generator's device. For models whose float weights would not fit
    (7B on one card); a matmul's cost does not depend on the values."""
    _dense_only(cfg)
    device = device if device is not None else generator.device
    bits = {QuantMode.INT8: 8, QuantMode.INT4: 4}[qcfg.mode]
    gs = qcfg.group_size
    scale = 0.02 / (127 if bits == 8 else 7)

    def qdense(k, n, bias):
        g = gs if (gs and k % gs == 0) else 0
        data = torch.randint(-127, 128, (k // 2 if bits == 4 else k, n),
                             generator=generator, device=device,
                             dtype=torch.int8)
        scales = torch.full((k // g if g else 1, n), scale,
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
        mlp = {"w_in": qdense(h, cfg.ffn_size, cfg.mlp_bias),
               "w_out": qdense(cfg.ffn_size, h, cfg.mlp_bias)}
        if cfg.glu:
            mlp["w_gate"] = qdense(h, cfg.ffn_size, cfg.mlp_bias)
        params["layers"].append({
            "ln1": norm_p(h), "ln2": norm_p(h),
            "attn": {"wq": qdense(h, cfg.q_size, cfg.qkv_bias),
                     "wk": qdense(h, cfg.kv_size, cfg.qkv_bias),
                     "wv": qdense(h, cfg.kv_size, cfg.qkv_bias),
                     "wo": qdense(cfg.q_size, h, cfg.attn_out_bias)},
            "mlp": mlp})
    return params


_LAYER_KIND_BY_PATH = (("attn", "attention"), ("mlp", "mlp"),
                       ("moe", "mlp"), ("lm_head", "lm_head"))


def quantize_params(params: Params, qcfg: QuantConfig) -> Params:
    """Quantize the weight matrices ("w" under attn / mlp / lm_head) per
    QuantConfig; embeddings, norms and biases stay float. Every mode the
    JAX package makes (int8 or int4, per-channel or per-group, act_bits 0
    or 8, MIXED per layer kind) runs end to end; asymmetric weights are
    made but the matmul raises on them."""

    def kind_of(path):
        for fragment, kind in _LAYER_KIND_BY_PATH:
            if fragment in path:
                return kind
        return None

    def maybe_quantize(w, path):
        kind = kind_of(path)
        if kind is None or w.dim() != 2:
            return w
        if any(s in "/".join(path) for s in qcfg.skip_layers):
            return w
        mode = qcfg.mode_for_layer(kind)
        if mode in (QuantMode.NONE, QuantMode.FP16):
            return w
        bits = {QuantMode.INT8: 8, QuantMode.INT4: 4}[mode]
        gs = qcfg.group_size if (qcfg.group_size
                                 and w.shape[0] % qcfg.group_size == 0) else 0
        if bits == 4 and w.shape[0] % 2:
            return w
        qt = quantize(w, bits=bits, group_size=gs, symmetric=qcfg.symmetric)
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
    decode layer instead of 7."""
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
        out["layers"].append(layer)
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
    if cfg.activation == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="tanh")


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


def _ffn(x, layer, cfg: TransformerConfig):
    if "moe" in layer:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP.md)")
    return _mlp(x, layer["mlp"], cfg)


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


def forward_prefill(params: Params, cfg: TransformerConfig,
                    input_ids: torch.Tensor, lengths: torch.Tensor, *,
                    dtype=torch.bfloat16,
                    logits_at: Optional[torch.Tensor] = None):
    """Full-prompt forward over padded prompts (B, S) with valid lengths
    (B,). Returns (logits, per-layer [(k, v)] each (B, S, Kh, D)); logits
    are (B, S, V) f32, or (B, V) at positions `logits_at` (B,) when given
    (the engine needs only each prompt's last position)."""
    _dense_only(cfg)
    b, s = input_ids.shape
    positions = torch.arange(s, device=input_ids.device).expand(b, s)
    x = _embed(params, cfg, input_ids, positions, dtype)
    if cfg.positions == "rope":
        rope = rope_tables(positions, cfg.dim_head, theta=cfg.rope_theta)
    kv_out = []
    for layer in params["layers"]:
        ap = layer["attn"]
        q, k, v = _qkv(_norm(x, layer["ln1"], cfg), ap, cfg)
        if cfg.positions == "rope":
            q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
        kv_out.append((k, v))
        attn = attention_prefill(q, k, v, lengths=lengths)
        x = x + _dense(attn.reshape(b, s, cfg.q_size), ap["wo"])
        x = x + _ffn(_norm(x, layer["ln2"], cfg), layer, cfg)
    if logits_at is not None:
        x = x[torch.arange(b, device=x.device), logits_at.long()]
    return _logits(params, cfg, x), kv_out


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
    _dense_only(cfg)
    c = input_ids.shape[0]
    positions = start + torch.arange(c, device=input_ids.device)
    x = _embed(params, cfg, input_ids[None], positions[None], dtype)
    if cfg.positions == "rope":
        rope = rope_tables(positions[None], cfg.dim_head, theta=cfg.rope_theta)
    for layer, cache in zip(params["layers"], caches):
        ap = layer["attn"]
        q, k, v = _qkv(_norm(x, layer["ln1"], cfg), ap, cfg)
        if cfg.positions == "rope":
            q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
        kvcache.write_chunk(cache, k[0], v[0], slot, start)
        kc, vc = kvcache.slot_view(cache, slot, start + c, dtype)
        attn = attention_chunk(q, kc, vc, start)
        x = x + _dense(attn.reshape(1, c, cfg.q_size), ap["wo"])
        x = x + _ffn(_norm(x, layer["ln2"], cfg), layer, cfg)
    x = x[0] if logits_at is None else x[0, logits_at]
    return _logits(params, cfg, x), tuple(caches)


def _decode_attn(cache, q1, attn_lengths):
    """Single-token decode attention over either layout and any store
    (JAX `_decode_attn` :1288-1330): the paged layout walks its pools (and
    scale pools) through the table in kernel #5; the contiguous layout
    hands its raw bf16, int8 or packed int4 caches and their scales to
    kernel #3, never a dequantized copy."""
    store = kvcache.store_args(cache)
    if kvcache._is_paged(cache):
        return decode_attention_paged(q1, cache.k_pool, cache.v_pool,
                                      cache.table, attn_lengths, **store)
    return attention_decode_auto(q1, cache.k, cache.v, attn_lengths, **store)


def forward_decode(params: Params, cfg: TransformerConfig,
                   token_ids: torch.Tensor, caches, lengths: torch.Tensor, *,
                   dtype=torch.bfloat16, active: Optional[torch.Tensor] = None):
    """One decode step for all slots: appends each slot's token K/V at
    position lengths[b] (in place) and attends over lengths + 1 entries.
    With `active` (B,) bool, an inactive slot neither writes nor reads its
    cache: its rows may belong to a prompt in chunked prefill or to a
    retired prompt kept for prefix reuse (the JAX engine writes them at
    row lengths[b] = 0). Returns (logits (B, V) f32, caches)."""
    _dense_only(cfg)
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
    rows = kvcache.decode_rows(caches[0], write_pos)
    for layer, cache in zip(params["layers"], caches):
        ap = layer["attn"]
        q, k, v = _qkv_norm(x, layer, cfg)
        if cfg.positions == "rope":
            q, k = apply_rope_tables(q, *rope), apply_rope_tables(k, *rope)
        kvcache.append_token(cache, k[:, 0], v[:, 0], write_pos, rows)
        attn = _decode_attn(cache, q[:, 0], attn_lengths)
        x = _attn_tail(x, attn.reshape(b, 1, cfg.q_size), ap, layer, cfg)
    return _logits(params, cfg, x)[:, 0], tuple(caches)
