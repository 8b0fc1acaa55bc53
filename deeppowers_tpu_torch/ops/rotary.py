"""Rotary position embeddings, ported from deeppowers_tpu/ops/rotary.py.

Llama/NeoX half-split convention: the head dim splits into two halves
rotated against each other. Computed in f32, returned in x's dtype."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, *, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), f32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_tables(positions: torch.Tensor, head_dim: int, *,
                theta: float = 10000.0):
    """(cos, sin) f32 tables (..., S, D/2) for `positions` (..., S). A
    forward computes them once and rotates every layer's q and k with
    them (the JAX package recomputes them per call; XLA folds that)."""
    inv_freq = rope_frequencies(head_dim, theta=theta, device=positions.device)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope_tables(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., S, H, D) or (..., S, D) by tables from rope_tables."""
    if x.dim() == cos.dim() + 1:                 # (..., S, H, D): head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate q or k. x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    return apply_rope_tables(x, *rope_tables(positions, x.shape[-1],
                                             theta=theta))
