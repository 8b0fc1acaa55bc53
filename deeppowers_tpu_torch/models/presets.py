"""Model presets, ported from deeppowers_tpu/models/presets.py.

Presets are random-initialized (init_params); no weights are downloaded."""

from __future__ import annotations

from .transformer import TransformerConfig

# TinyLlama 1.1B (GQA 32/4, RMSNorm, SiLU-GLU, RoPE): the slice's main path
TINYLLAMA_1_1B = TransformerConfig(
    vocab_size=32000, hidden_size=2048, num_layers=22, num_heads=32,
    num_kv_heads=4, intermediate_size=5632, max_seq_len=2048,
    norm="rmsnorm", activation="silu", glu=True, positions="rope",
    qkv_bias=False, attn_out_bias=False, mlp_bias=False, tie_embeddings=False,
)

PRESETS = {"tinyllama-1.1b": TINYLLAMA_1_1B}


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


PRESETS["tiny-test"] = tiny_test_config()
PRESETS["tiny-llama"] = tiny_llama_config()
