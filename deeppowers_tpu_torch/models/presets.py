"""Model presets, ported from deeppowers_tpu/models/presets.py.

Presets are random-initialized (init_params); no weights are downloaded."""

from __future__ import annotations

from .transformer import TransformerConfig

# GPT-2 124M (learned positions, LayerNorm, GELU, tied embeddings)
GPT2_SMALL = TransformerConfig(
    vocab_size=50257, hidden_size=768, num_layers=12, num_heads=12,
    max_seq_len=1024, norm="layernorm", activation="gelu", positions="learned",
    qkv_bias=True, attn_out_bias=True, mlp_bias=True, tie_embeddings=True,
)

GPT2_MEDIUM = TransformerConfig(
    vocab_size=50257, hidden_size=1024, num_layers=24, num_heads=16,
    max_seq_len=1024, norm="layernorm", activation="gelu", positions="learned",
)

# TinyLlama 1.1B (GQA 32/4, RMSNorm, SiLU-GLU, RoPE): slice 1's main path
TINYLLAMA_1_1B = TransformerConfig(
    vocab_size=32000, hidden_size=2048, num_layers=22, num_heads=32,
    num_kv_heads=4, intermediate_size=5632, max_seq_len=2048,
    norm="rmsnorm", activation="silu", glu=True, positions="rope",
    qkv_bias=False, attn_out_bias=False, mlp_bias=False, tie_embeddings=False,
)

# Llama-2-7B (MHA 32 heads, RMSNorm, SiLU-GLU, RoPE): BASELINE config 3,
# served W4A8 g128 with a k8v4 KV cache
LLAMA2_7B = TransformerConfig(
    vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
    intermediate_size=11008, max_seq_len=4096,
    norm="rmsnorm", activation="silu", glu=True, positions="rope",
    qkv_bias=False, attn_out_bias=False, mlp_bias=False, tie_embeddings=False,
)

# The repo's trained byte-level checkpoint lm124_ckpt/ (its manifest's
# config): GQA 12/6, SiLU-GLU, RoPE, and an untied 260-wide lm_head, a width
# no multiple of 8
LM124 = TransformerConfig(
    vocab_size=260, hidden_size=768, num_layers=12, num_heads=12,
    num_kv_heads=6, intermediate_size=2048, max_seq_len=512,
    norm="rmsnorm", norm_eps=1e-5, activation="silu", glu=True,
    positions="rope", rope_theta=10000.0, qkv_bias=False,
    attn_out_bias=False, mlp_bias=False, tie_embeddings=False,
)

# Mixtral-8x7B (8 experts, top-2, GQA 32/8): BASELINE config 5, served
# W4A8 g128 with an int8 KV cache; it fits one H100 whole (about 25.5 GB)
MIXTRAL_8X7B = TransformerConfig(
    vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
    num_kv_heads=8, intermediate_size=14336, max_seq_len=4096,
    norm="rmsnorm", activation="silu", glu=True, positions="rope",
    qkv_bias=False, attn_out_bias=False, mlp_bias=False, tie_embeddings=False,
    num_experts=8, num_experts_per_tok=2,
)

# Mixtral's routing at a quarter of its width (the JAX package's one-chip
# stand-in for it on a TPU); a preset only here
MIXTRAL_MINI = TransformerConfig(
    vocab_size=32000, hidden_size=2048, num_layers=16, num_heads=16,
    num_kv_heads=4, intermediate_size=5632, max_seq_len=4096,
    norm="rmsnorm", activation="silu", glu=True, positions="rope",
    qkv_bias=False, attn_out_bias=False, mlp_bias=False, tie_embeddings=False,
    num_experts=8, num_experts_per_tok=2,
)

PRESETS = {"gpt2": GPT2_SMALL, "gpt2-medium": GPT2_MEDIUM,
           "tinyllama-1.1b": TINYLLAMA_1_1B, "llama2-7b": LLAMA2_7B,
           "lm124": LM124, "mixtral-8x7b": MIXTRAL_8X7B,
           "mixtral-mini": MIXTRAL_MINI}


def tiny_test_config(**overrides) -> TransformerConfig:
    """A tiny GPT-2-style config for fast tests."""
    base = dict(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
        max_seq_len=64, norm="layernorm", activation="gelu",
        positions="learned",
    )
    base.update(overrides)
    return TransformerConfig(**base)


def tiny_llama_config(**overrides) -> TransformerConfig:
    """A tiny Llama-style (GQA + RoPE + GLU) config for fast tests."""
    base = dict(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, max_seq_len=64,
        norm="rmsnorm", activation="silu", glu=True, positions="rope",
        qkv_bias=False, attn_out_bias=False, mlp_bias=False,
        tie_embeddings=False,
    )
    base.update(overrides)
    return TransformerConfig(**base)


def tiny_moe_config(**overrides) -> TransformerConfig:
    """A tiny Mixtral-style MoE config for fast tests."""
    base = dict(
        vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, intermediate_size=128, max_seq_len=64,
        norm="rmsnorm", activation="silu", glu=True, positions="rope",
        qkv_bias=False, attn_out_bias=False, mlp_bias=False,
        tie_embeddings=False, num_experts=4, num_experts_per_tok=2,
    )
    base.update(overrides)
    return TransformerConfig(**base)


PRESETS["tiny-test"] = tiny_test_config()
PRESETS["tiny-llama"] = tiny_llama_config()
PRESETS["tiny-moe"] = tiny_moe_config()
